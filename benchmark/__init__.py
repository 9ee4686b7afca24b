"""The benchmark of ``otters_tpu_torch`` on NVIDIA H100s (a cell's ``chips``).

Run one cell (a workload of ``BENCHMARK.json``) from the root of a checkout:

    python3 benchmark/run.py --workload cohere10m.f1p --seed 7 --seconds 10 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by its name: ``configs/<config>.json``
(the file that ``BENCHMARK.json`` names), ``traffic/<traffic>.json`` (a
mix's parameters, read by the generator of its ``kind``,
``traffic/<kind>.py``), the parts a configuration names
(``inputs/<name>.py``, ``columns/<values>.py``, ``rerank/<name>.py``) and
``metrics/<metric>.py`` (a reader of the run's record). Nothing here imports
JAX or the JAX package.
"""
