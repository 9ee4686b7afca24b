"""Every cell, configuration, traffic mix, part and metric file loads; every
cell, with its traffic kind, runs end to end against ``otters_tpu_torch`` at
a small size on the CPU; the metrics each run reports are the ones
``BENCHMARK.json`` gives the cell; the command refuses to run without a
CUDA device."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, spec

ROOT = spec.ROOT
SMALL = {"rows": 30_000, "dim": 64, "batch": 32}  # the CPU rehearsal's sizes
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names) and len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", CELLS)) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = spec.cell(name)
    conf = {c["name"]: c for c in BENCH["configs"]}[
        {w["name"]: w for w in BENCH["workloads"]}[name]["config"]]
    assert cell.config["name"] == conf["name"] and cell.config["reduced"] == conf["reduced"]
    assert conf["file"].startswith("benchmark/configs/")
    for key in ("rows", "dim", "metric", "inputs", "columns", "storage_dtype", "chunk_size",
                "rerank_source", "scan_kernels", "roofline", "limits", "assumed", "reduced"):
        assert key in cell.config, key
    for key in ("kind", "batch", "pool_requests", "filter", "k", "finish"):
        assert key in cell.mix, key
    assert cell.mix["finish"] in ("resolve", "result")
    # every part the cell names is a file of that name
    assert callable(spec.part("inputs", cell.config["inputs"]).make)
    assert all(callable(spec.part("columns", c["values"]).make) for c in cell.config["columns"])
    assert callable(spec.part("rerank", cell.config["rerank_source"]).apply)
    kind = spec.part("traffic", cell.mix["kind"])
    assert callable(kind.warm) and callable(kind.run)
    assert cell.mix["filter"]["column"] in {c["name"] for c in cell.config["columns"]}
    # every metric the cell reports has its reader; setup_s, another end-to-end
    # metric, and per-layer metrics that each move one the cell reports
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(m["name"]))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= e2e


def test_every_configuration_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_part_is_found_by_its_name(tmp_path, monkeypatch):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "open_loop.py").write_text("def run():\n    return 'open'\n")
    monkeypatch.setattr(spec, "BENCH_DIR", str(tmp_path))
    assert spec.part("traffic", "open_loop").run() == "open"
    with pytest.raises(FileNotFoundError):
        spec.part("traffic", "no_such_kind")


def expected_metrics(cell, traced):
    """What a run on the CPU reports: every end-to-end metric of the cell, or
    every per-layer one that reads no device trace. ``strict_reruns`` reads
    only where the fast-exact check ran, which b x rows under 2^22 (the
    direct program of these sizes) never does."""
    if not traced:
        return {m["name"] for m in cell.end_to_end}
    return {m["name"] for m in cell.per_layer
            if m["source"] != "device_trace" and m["name"] != "strict_reruns"}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cells_run_end_to_end_on_the_cpu(name, traced):
    cell = spec.cell(name)
    sizes = dict(SMALL, batch=min(SMALL["batch"], int(cell.mix["batch"])))
    out = harness.run_cell(cell, 2**40 + 17, 0.5, traced, "cpu", time.perf_counter(),
                           overrides=sizes)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"]["worst_gap"]["value"] < out["checks"]["worst_gap"]["limit"]
    assert set(out["metrics"]) == expected_metrics(cell, traced)
    if traced:
        assert "busy_s" in out["device"] and out["breakdown"]["idle_gaps"]
    else:
        assert all(m["value"] > 0 for m in out["metrics"].values())


def _record(op_s, busy_s):
    from benchmark import trace, window

    reqs = [window.Request(0, 0.0, 0.001, 0.01, [1], [0.5], 10, 9, 0.0, True)] * 4
    return harness.Record(cell=spec.cell(CELLS[0]), batch=256, live_rows=9_900_000,
                          setup_s=1.0, build_s=1.0,
                          window=window.Window(requests=reqs, queries=1024, seconds=1.0),
                          trace=trace.DeviceTrace(window_s=1.0, busy_s=busy_s, op_s=op_s))


def test_scan_readers_fail_a_device_trace_without_the_scan_kernel():
    read_roof, read_other = harness.reader("scan_roofline"), harness.reader("other_device_ms")
    renamed = _record({"void renamed_scan_kernel<signed char>": 0.04, "memcpy": 0.01}, 0.05)
    for read in (read_roof, read_other):
        with pytest.raises(RuntimeError, match="binmax"):
            read(renamed)
    found = _record({"void cert_cos_binmax_kernel<signed char>": 0.04, "memcpy": 0.01}, 0.05)
    assert 0 < read_roof(found) <= 105
    assert read_other(found) == pytest.approx(1e3 * 0.01 / 4)
    no_device = _record({}, 0.0)  # the CPU rehearsal: nothing to read
    assert read_roof(no_device) is None and read_other(no_device) is None


def test_same_seed_same_inputs():
    from benchmark import data

    config = spec.cell(CELLS[0]).config
    a = data.make(config, 100, 8, 2, 3, 2**35 + 1, "cpu")
    b = data.make(config, 100, 8, 2, 3, 2**35 + 1, "cpu")
    c = data.make(config, 100, 8, 2, 3, 2**35 + 2, "cpu")
    assert torch.equal(a.rows, b.rows) and torch.equal(a.queries, b.queries)
    assert not torch.equal(a.rows, c.rows)


def _command(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cohere10m.f1p", "--seed", "5",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_command_fails_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "traces"))
    out = _command(tmp_path)  # on a card: no otters_tpu_torch; here: no card either
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_traced_run_on_the_card_reads_every_metric():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = spec.cell("cohere10m.f1p")
    out = harness.run_cell(cell, 11, 1.0, True, "cuda", time.perf_counter(),
                           overrides={"rows": 2_000_000})
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < out["metrics"]["scan_roofline"]["value"] <= 105
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    json.dumps(out)
