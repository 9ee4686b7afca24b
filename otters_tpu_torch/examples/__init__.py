"""Twins of the JAX package's ``examples/`` on the port.

Each module prints what its JAX twin prints (timing lines aside) and runs
as ``python -m otters_tpu_torch.examples.<name>``; its ``main`` takes the
device (``multichip``: the mesh's devices), the current CUDA device by
default. The twin of ``examples/demo.py`` is ``otters_tpu_torch.demo``.
"""
