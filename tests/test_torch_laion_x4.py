"""The configuration ``laion-100m-768-l2`` and its four-card cell
``laion100m.x4`` (bfloat16 rows made by id, certified squared L2 over K5,
the rerank remaking rows by id), on four CPU shards at small sizes:

- the cell runs end to end through ``harness.run_cell``, untraced and
  traced, with every request certified and every per-layer metric that
  reads no device trace given a value (``shard_programs`` 4 a request);
- the sharded store answers ``query_batch(q, Euclidean).meta_filter(id >= 0)
  .take(10, rerank_from=100)`` with the plain reference's rows, in its
  take-min order, and distances within the configuration's limit;
- the sharding layer's spans nest inside ``otters.submit``, each once a
  request, and a single store records none of them; each shard computes
  its certificate terms once a request, in its fused scan (whose maxima
  the mesh's slack reuses) or in the direct programs' pre-pass;
- the configuration's inputs keep their bits (a pinned digest).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch.profiler import profile

import otters_tpu_torch as tx
from otters_tpu_torch.ops import fused_topk, scoring
from otters_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import data, reference, spec, system  # noqa: E402

CELL = "laion100m.x4"
CONFIG = spec.cell(CELL).config
SHARDS = 4
D, K, B, RERANK_FROM = 64, 10, 256, 100
# 20,480 padded rows a shard: b x rows a shard > 2^22, so each shard takes
# the fused tile (K5's plain function on the CPU)
ROWS = SHARDS * 20_480 - 1_000
SHARD_SPANS = ("otters.submit.mesh_cert", "otters.submit.shards", "otters.submit.compose")
# data.make at 300 rows, 2 x 3 queries, seed 2**40 + 29, on the CPU: the
# bytes of the rows (made by id), the queries and the columns
PINNED = "c5c686f6512aea14a8419e910e401cd53140ecf45420e0df425a36ae292ae7f1"


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    return fresh


def _sharded(seed: int, pool: int = 2):
    """-> (inputs, the four-shard store built as the benchmark builds it)."""
    inputs = data.make(CONFIG, ROWS, D, pool, B, seed, "cpu")
    store, _ = system.build(tx, CONFIG, inputs, ["cpu"] * SHARDS)
    return inputs, store


def _submit(store, q):
    return (store.query_batch(q, tx.Metric.Euclidean).meta_filter(tx.col("id").gte(0))
            .take(K, rerank_from=RERANK_FROM).collect_async())


def test_the_configuration_is_the_source_uncut():
    assert CONFIG["rows"] == 100_000_000 and CONFIG["dim"] == 768 and CONFIG["reduced"] == []
    assert (CONFIG["metric"], CONFIG["storage_dtype"], CONFIG["rerank_source"]) == (
        "l2", "bfloat16", "by_row_id")
    assert CONFIG["certified"] is True and spec.cell(CELL).chips == SHARDS
    assert spec.keep_from(spec.cell(CELL).mix, CONFIG["rows"]) == 0  # no filter: id >= 0


def test_the_configurations_inputs_keep_their_bits():
    inputs = data.make(CONFIG, 300, CONFIG["dim"], 2, 3, 2**40 + 29, "cpu")
    h = hashlib.sha256()
    for t in (inputs.rows.slab(0, 300, "cpu"), inputs.queries):
        h.update(t.contiguous().numpy().tobytes())
    for column in sorted(inputs.columns):
        h.update(np.ascontiguousarray(inputs.columns[column]).tobytes())
    assert h.hexdigest() == PINNED


@pytest.mark.parametrize("seed", [2**40 + 41, 2**40 + 42, 2**33 + 3])
def test_the_sharded_store_answers_as_the_reference(seed):
    inputs, store = _sharded(seed)
    assert store.mesh.shape["rows"] == SHARDS and store._storage_dtype == "bfloat16"
    n_local = store._dv.vectors.shape[0] // SHARDS
    assert B * n_local > scoring.DIRECT_LIMIT  # the fused tile on every shard
    pendings = [_submit(store, q) for q in inputs.queries]
    results = tx.resolve(pendings)
    keep = np.ones(ROWS, dtype=bool)
    ref = reference.topk(inputs.rows, keep, inputs.queries, K, "l2")
    limit = CONFIG["limits"]["worst_gap"]
    for i, (p, res) in enumerate(zip(pendings, results)):
        assert p.stats().certified is True
        assert list(res.indices) == ref.rows[i]
        distances = -np.asarray(ref.keys[i])
        assert list(res.scores) == sorted(res.scores)  # nearest first
        np.testing.assert_allclose(res.scores, distances, rtol=0.0, atol=limit)


@pytest.mark.parametrize("tile", ["fused", "direct"])
def test_the_sharding_spans_nest_once_a_request(log, tile, monkeypatch):
    """The sharding spans, each once a request; each shard computes its
    certificate terms once: in its fused scan, which hands its maxima to
    the mesh (``otters.shard_maxima_reused``, one a shard), or in the
    direct programs' pre-pass inside ``otters.submit.mesh_cert``, counting
    none."""
    inputs, store = _sharded(2**40 + 43)
    cert_terms = scoring.cert_terms

    def counted(*a, **kw):
        profiling.count("test.cert_terms")
        return cert_terms(*a, **kw)

    monkeypatch.setattr(scoring, "cert_terms", counted)
    monkeypatch.setattr(fused_topk, "cert_terms", counted)
    # a few queries: b x rows a shard within DIRECT_LIMIT, the direct tile
    queries = inputs.queries if tile == "fused" else inputs.queries[:, :4]
    with profile():
        pendings = [_submit(store, q) for q in queries]
        tx.resolve(pendings)
    assert all(p.stats().certified is True for p in pendings)
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    seqs = {p._seq for p in pendings}
    for name in SHARD_SPANS:
        spans = [r for r in recs if r.name == name]
        assert sorted(r.request for r in spans) == sorted(seqs), name
    for r in recs:
        if r.name in ("otters.submit.mesh_cert", "otters.submit.shards"):
            assert by_id[r.parent].name == "otters.submit"
        if r.name == "otters.submit.compose":
            outer = by_id[r.parent]
            assert outer.name == "otters.submit.phase2"
            assert by_id[outer.parent].name == "otters.submit"
    shards = {r.id for r in recs if r.name == "otters.submit.shards"}
    # each shard's program, with the single store's spans, inside the loop
    for name in ("otters.submit.masks", "otters.submit.scan_setup", "otters.submit.launch"):
        inner = [r for r in recs if r.name == name]
        assert len(inner) == SHARDS * len(pendings) and all(r.parent in shards for r in inner)
    counted = [r for r in recs if r.name == "otters.shard_programs"]
    assert len(counted) == SHARDS * len(pendings) and all(r.parent in shards for r in counted)
    assert sum(r.value for r in counted) == SHARDS * len(pendings)
    reused = [r for r in recs if r.name == "otters.shard_maxima_reused"]
    terms = [by_id[r.parent] for r in recs if r.name == "test.cert_terms"]
    assert len(terms) == SHARDS * len(pendings)
    if tile == "fused":
        assert len(reused) == SHARDS * len(pendings) and all(r.parent in shards for r in reused)
        assert sum(r.value for r in reused) == SHARDS * len(pendings)
        assert all(s.name == "otters.submit.scan_setup" and s.parent in shards for s in terms)
    else:
        assert reused == []
        assert all(s.name == "otters.submit.mesh_cert" for s in terms)


def test_a_single_store_records_no_sharding_span(log):
    rng = np.random.default_rng(280)
    rows = rng.normal(size=(20_480, D)).astype(np.float32)
    store = (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64)
                                        .from_values(range(rows.shape[0]))])
             .with_storage_dtype("bfloat16").with_vectors(rows)
             .with_rerank_source(keep_host_f32=True)
             .with_device("cpu").build())
    q = rng.normal(size=(B, D)).astype(np.float32)
    with profile():
        pending = _submit(store, q)
        tx.resolve([pending])
    assert pending.stats().certified is True
    names = {r.name for r in profiling.records()}
    assert "otters.submit" in names and "otters.submit.phase2" in names
    assert not names & {*SHARD_SPANS, "otters.shard_programs"}


# the harness refuses a process that has loaded JAX, as this one has (the
# parity tests' conftest): the cell runs in a process of its own
_RUN_CELL = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness, spec
out = harness.run_cell(spec.cell({cell!r}), 2**40 + 37, 0.3, {traced!r}, ["cpu"] * {shards},
                       time.perf_counter(), overrides={sizes!r})
print(json.dumps(out))
"""


@pytest.mark.parametrize("traced", [False, True])
def test_benchmark_cell_runs_on_four_cpu_shards(traced):
    cell = spec.cell(CELL)
    sizes = {"rows": ROWS, "dim": D, "batch": B, "pool": 4}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run(
        [sys.executable, "-c", _RUN_CELL.format(root=ROOT, cell=CELL, traced=traced,
                                                shards=SHARDS, sizes=sizes)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["uncertified"]["value"] == 0
    assert out["checks"]["worst_gap"]["value"] < out["checks"]["worst_gap"]["limit"]
    if not traced:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        return
    want = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert {"shard_issue_ms", "mesh_cert_ms", "compose_ms", "shard_programs"} <= want
    assert set(out["metrics"]) == want
    assert out["metrics"]["shard_programs"]["value"] == SHARDS
    assert out["metrics"]["live_chunks_pct"]["value"] == 100.0
    for name in ("shard_issue_ms", "mesh_cert_ms", "compose_ms"):
        assert out["metrics"][name]["value"] > 0
