"""Exact f32 stores on the fast-exact path (K4 with its check, a strict K3
rerun where the check fails), against the benchmark's plain reference, on
the CPU:

- a fused-size f32 store (b x rows > 2^22) through ``query_batch`` /
  ``meta_filter`` / ``take(10)`` / ``collect_async`` / ``resolve`` gives the
  reference's rows, every request on the fast path with no rerun;
- a near-tie store, where the check fails: the strict rerun runs, is
  counted once under a profiler, and the answer is still the reference's;
- the slab-wise norms of every f32 ingest equal one pass over the whole
  store, bit for bit;
- the benchmark cell ``cohere10m.f32.f1p`` runs end to end at a small size.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import profile

import otters_tpu_torch as tx
from otters_tpu_torch.ops import scoring
from otters_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import reference, spec  # noqa: E402

D, K, B = 64, 10, 256
# Both sides compute each Cosine score in f32 from the same rows, in other
# orders (the program scales the dot by the two inverse norms, the reference
# normalises first): each is within gamma_D = D 2^-24 of the exact value.
SCORE_TOL = 2 * D * 2.0**-24
CELL = "cohere10m.f32.f1p"


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    return fresh


def _store(rows: np.ndarray):
    n = rows.shape[0]
    return (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64)
                                       .from_values(range(n))])
            .with_vectors(torch.from_numpy(rows), n_rows=n).with_device("cpu").build())


def _submit(store, q, keep_from):
    return (store.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("id").gte(keep_from))
            .take(K).collect_async())


def _assert_reference(rows, queries, keep_from, results):
    keep = reference.keep_mask(np.arange(rows.shape[0]), "gte", keep_from)
    ref = reference.topk(torch.from_numpy(rows), keep, torch.from_numpy(np.stack(queries)), K)
    for i, res in enumerate(results):
        assert list(res.indices) == ref.rows[i]
        assert np.allclose(res.scores, ref.keys[i], rtol=0.0, atol=SCORE_TOL)


def _counts():
    return {name: e.get("value") for name, e in profiling.summary().items()}


def test_fused_f32_store_takes_the_fast_path_and_equals_the_reference(log):
    n, keep_from = 20_480, 205  # id >= 1% of the rows
    rng = np.random.default_rng(230)
    rows = rng.normal(size=(n, D)).astype(np.float32)
    queries = [rng.normal(size=(B, D)).astype(np.float32) for _ in range(3)]
    store = _store(rows)
    assert B * store._dv.vectors.shape[0] > scoring.DIRECT_LIMIT  # the fused path
    with profile():
        results = tx.resolve([_submit(store, q, keep_from) for q in queries])
    _assert_reference(rows, queries, keep_from, results)
    counts = _counts()
    assert counts["otters.fast_checks"] == len(queries)
    assert "otters.strict_reruns" not in counts and "otters.finish.strict" not in counts


def test_near_ties_fail_the_check_and_rerun_strictly(log):
    """Rows that one query scores within the bf16x3 slack of each other, one
    in each of 48 bins: the 10th exact key cannot clear the 41st bin maximum
    plus the slack, so the scan reruns in exact f32. The ties' scores lie
    1.5e-6 apart, far above the rounding of either side."""
    n, keep_from = 32_768, 328
    slack = scoring.high_precision_bound(D)
    rng = np.random.default_rng(231)
    rows = rng.normal(size=(n, D)).astype(np.float32)
    gaps = 1e-5 + 1.5e-6 * np.arange(48)  # 1 - cosine of each tie
    assert gaps[-1] - gaps[K - 1] < slack
    ties = np.zeros((48, D), np.float32)
    ties[:, 0] = 1.0
    ties[:, 1] = np.sqrt(2.0 * gaps)
    rows[512 * np.arange(1, 49) + 100] = ties[rng.permutation(48)]
    q = rng.normal(size=(B, D)).astype(np.float32)
    q[0] = 0.0
    q[0, 0] = 1.0
    store = _store(rows)
    with profile():
        pending = _submit(store, q, keep_from)
        res = tx.resolve([pending])[0]
    _assert_reference(rows, [q], keep_from, [res])
    counts = _counts()
    assert counts["otters.fast_checks"] == 1 and counts["otters.strict_reruns"] == 1
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    strict = [r for r in recs if r.name == "otters.finish.strict"]
    assert len(strict) == 1 and strict[0].request == pending._seq
    assert by_id[strict[0].parent].name == "otters.finish"
    rerun = [r for r in recs if r.name == "otters.strict_reruns"]
    assert rerun[0].parent == strict[0].id
    # the rerun's own wait lies inside its span
    assert any(r.name == "otters.finish.wait" and r.parent == strict[0].id for r in recs)


def _whole_pass(v: torch.Tensor):
    v32 = v.float()
    nsq = (v32 * v32).sum(dim=1)
    return nsq, torch.where(nsq != 0.0, 1.0 / torch.sqrt(nsq), 0.0)


def _rows_cases():
    n, d = 2_900, 20  # a depth the store pads to 32, rows it pads to 3,072
    rng = np.random.default_rng(232)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows[5] = 0.0  # a zero row: its inverse norm is 0
    order = torch.from_numpy(rng.permutation(n))
    src = torch.from_numpy(rows)
    return rows, {
        "materialize": lambda: scoring.materialize(rows, torch.float32, device="cpu"),
        "from_device": lambda: scoring.materialize_from_device(src, n_valid=n),
        "from_device_ordered": lambda: scoring.materialize_from_device(src, n_valid=n,
                                                                       order=order),
        "from_device_f64": lambda: scoring.materialize_from_device(src.double(), n_valid=n,
                                                                   dtype=torch.float32),
        "f32_slabs": lambda: scoring.materialize_f32_slabs(
            lambda s, r: np.concatenate([rows, np.zeros((r, d), np.float32)])[s:s + r],
            n, d, 333, device="cpu"),
    }, order


@pytest.mark.parametrize("case", ["materialize", "from_device", "from_device_ordered",
                                  "from_device_f64", "f32_slabs"])
def test_slab_norms_equal_the_whole_store_pass(case, monkeypatch):
    rows, cases, order = _rows_cases()
    monkeypatch.setattr(scoring, "INGEST_SLAB_ROWS", 257)  # uneven: a short last slab
    dv = cases[case]()
    n, d = rows.shape
    want = torch.from_numpy(rows)
    if case == "from_device_ordered":
        want = want[order]
    assert dv.vectors.shape == (scoring.pad_rows(n), d) and dv.vectors.stride(0) == 32
    assert torch.equal(dv.vectors[:n], want) and not dv.vectors[n:].any()
    nsq, inv = _whole_pass(dv.vectors)
    assert torch.equal(dv.norms_sq, nsq) and torch.equal(dv.inv_norms, inv)
    assert torch.equal(dv.inv_norms[:n] == 0.0, (want == 0.0).all(dim=1))
    assert int(dv.valid.sum()) == n


def test_device_norms_slab_size_changes_no_bit(monkeypatch):
    rng = np.random.default_rng(233)
    v = torch.from_numpy(rng.normal(size=(1_000, 48)).astype(np.float32) * 1e3)
    whole = _whole_pass(v)
    for slab in (1, 7, 999, 1_000, 4_096):
        monkeypatch.setattr(scoring, "INGEST_SLAB_ROWS", slab)
        got = scoring._device_norms(v)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


# the harness refuses a process that has loaded JAX, as this one has (the
# parity tests' conftest): the cell runs in a process of its own
_RUN_CELL = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness, spec
out = harness.run_cell(spec.cell({cell!r}), 2**40 + 23, 0.3, {traced!r}, "cpu",
                       time.perf_counter(), overrides={sizes!r})
print(json.dumps(out))
"""


@pytest.mark.parametrize("traced", [False, True])
def test_benchmark_cell_runs_on_the_cpu(traced):
    cell = spec.cell(CELL)
    assert cell.config["storage_dtype"] == "float32" and "rerank_from" not in cell.mix
    sizes = {"rows": 20_480, "dim": D, "batch": B, "pool": 4}  # b x rows > 2^22: fused
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "-c", _RUN_CELL.format(root=ROOT, cell=CELL, traced=traced,
                                                sizes=sizes)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["worst_gap"]["value"] < out["checks"]["worst_gap"]["limit"]
    if not traced:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        return
    # on the CPU every per-layer metric but the device trace's reads something
    want = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert "strict_reruns" in want and set(out["metrics"]) == want
    assert out["metrics"]["strict_reruns"]["value"] == 0.0
