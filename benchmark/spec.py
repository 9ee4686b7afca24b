"""Find a cell's configuration, traffic mix, metrics and parts by name.

``BENCHMARK.json`` at the root of the checkout maps each workload to a
configuration and a traffic mix; the configuration's file is the one the
entry names, the mix is ``traffic/<traffic>.json``. Code that belongs to one
name sits in a file of that name, loaded by ``part``: ``traffic/<kind>.py``
(the mix's ``kind``), ``inputs/<name>.py`` (the configuration's ``inputs``),
``columns/<values>.py`` (each column's ``values``), ``rerank/<name>.py``
(the configuration's ``rerank_source``) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict] = field(default_factory=list)

    @property
    def rows(self) -> int:
        return int(self.config["rows"])


def keep_from(mix: Dict, n: int) -> int:
    """The filter's value: ``id >= share_out x n`` drops the first share of
    the rows (VectorDBBench's ``id >= rate x N``)."""
    return int(round(float(mix["filter"]["share_out"]) * n))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def part(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark's folder."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {folder}/{name}.py in {BENCH_DIR}")
    found = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The workload ``name`` with its configuration, mix and the metrics it
    reports; raises KeyError for an unknown name."""
    spec = benchmark(root)
    work = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[work["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic", f"{work['traffic']}.json"))
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=config,
        mix=mix,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )
