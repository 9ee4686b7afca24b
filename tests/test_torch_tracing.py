"""The query path's spans and counters (``otters_tpu_torch.utils.profiling``)
and ``MetaQueryStats``' timers, on the CPU.

A 20,000-row int8 store at d = 32 with an f32 rerank source, queried with
256 vectors a request (b x rows > 2^22: the fused path, its plain scan
behind ``otters.submit.launch``), ``take(10, rerank_from=300)`` with the
certificate:

- with no profiler a span is one shared no-op context that constructs no
  profiler event and records nothing;
- under ``torch.profiler.profile`` one ``collect_async`` + ``result()``
  records every span of the query path with its parent and the query's id,
  each also an event of the profiler;
- eight requests pipelined through ``resolve`` give eight ``otters.submit``
  roots with distinct ids and one ``otters.finish`` root carrying them; the
  children of each root cover it to within 10%; the eight
  ``score_duration``s sum to no more than the round's wall time; each
  ``merge_duration`` lies within its query's ``otters.finish.merge``;
- ``trace()`` clears the records; the ring counts what it drops;
  ``summary()``'s self time is a span's duration less its children's.
"""

import gc
import time

import numpy as np
import pytest
from torch.profiler import profile

import otters_tpu_torch as tx
from otters_tpu_torch.utils import profiling

N, D, B, K, K_WIDE, DEPTH = 20_000, 32, 256, 10, 300, 8

SUBMIT_PARTS = {"otters.submit.plan", "otters.submit.masks", "otters.submit.scan_setup",
                "otters.submit.launch", "otters.submit.phase2"}
FINISH_PARTS = {"otters.finish.wait", "otters.finish.rerank", "otters.finish.certify",
                "otters.finish.merge"}


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    return (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64)
                                       .from_values(range(N))])
            .with_vectors(vecs).with_storage_dtype("int8")
            .with_rerank_source(fetch_vectors=lambda ids: vecs[np.asarray(ids, dtype=np.int64)])
            .with_device("cpu").build())


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(22)
    return [rng.normal(size=(B, D)).astype(np.float32) for _ in range(DEPTH)]


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    return fresh


def _submit(store, q):
    return (store.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("id").gte(500))
            .take(K, rerank_from=K_WIDE).collect_async())


def _children(recs, root):
    return [r for r in recs if r.parent == root.id and r.value is None]


def _covered(recs, roots) -> float:
    """The share of the roots' time that their child spans cover."""
    inside = sum(c.end - c.start for r in roots for c in _children(recs, r))
    return inside / sum(r.end - r.start for r in roots)


def test_span_without_a_profiler_is_one_shared_no_op(store, queries, log, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler event made with no profiler running")

    monkeypatch.setattr(profiling, "_RecordFunction", refuse)
    assert profiling.enabled() is False
    a, b = profiling.span("otters.submit"), profiling.span("otters.finish", (1, 2))
    assert a is b
    with a:
        profiling.count("otters.fetch_rows", 5)
    res = tx.resolve([_submit(store, q) for q in queries[:2]])
    assert len(res) == 2 and all(len(r) == K for r in res)
    assert _submit(store, queries[0]).result().indices == res[0].indices
    assert profiling.records() == [] and profiling.summary() == {}
    with profile():
        assert profiling.enabled() is True


def test_one_query_records_every_span_with_its_parent_and_id(store, queries, log):
    with profile() as prof:
        pending = _submit(store, queries[0])
        res = pending.result()
    assert len(res) == K and pending.stats().certified is True
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    names = {r.name for r in recs}
    assert names == {"otters.submit", "otters.finish", "otters.fetch_vectors",
                     "otters.fetch_rows"} | SUBMIT_PARTS | FINISH_PARTS
    roots = [r for r in recs if r.parent is None]
    assert sorted(r.name for r in roots) == ["otters.finish", "otters.submit"]
    seq = pending._seq
    assert all(r.request == seq for r in recs)
    for r in recs:
        if r.name in SUBMIT_PARTS:
            assert by_id[r.parent].name == "otters.submit"
        elif r.name in FINISH_PARTS:
            assert by_id[r.parent].name == "otters.finish"
        elif r.name == "otters.fetch_vectors":
            assert by_id[r.parent].name == "otters.finish.rerank"
        elif r.name == "otters.fetch_rows":
            assert by_id[r.parent].name == "otters.fetch_vectors" and r.value > 0
        assert r.start <= r.end
    # the stats() after result() opens no second finish
    assert sum(r.name == "otters.finish" for r in profiling.records()) == 1
    events = {e.name for e in prof.events()}
    assert names - {"otters.fetch_rows"} <= events


def test_a_resolved_round_splits_into_its_queries_and_parts(store, queries, log):
    gc.disable()  # a collection is no part of the work
    try:
        with profile():
            tx.resolve([_submit(store, q) for q in queries])  # the profiler's first events
            log.clear()
            t0 = time.perf_counter()
            pendings = [_submit(store, q) for q in queries]
            tx.resolve(pendings)
            wall = time.perf_counter() - t0
    finally:
        gc.enable()
    recs = profiling.records()
    submits = [r for r in recs if r.name == "otters.submit"]
    finishes = [r for r in recs if r.name == "otters.finish"]
    ids = [p._seq for p in pendings]
    assert len(set(ids)) == DEPTH and sorted(r.request for r in submits) == sorted(ids)
    assert all(r.parent is None for r in submits + finishes)
    assert len(finishes) == 1 and finishes[0].request == tuple(ids)
    assert {c.name for c in _children(recs, finishes[0])} == FINISH_PARTS
    for r in submits:
        assert {c.name for c in _children(recs, r)} == SUBMIT_PARTS
    assert _covered(recs, submits) >= 0.9
    assert _covered(recs, finishes) >= 0.9
    stats = [p.stats() for p in pendings]
    assert all(s.certified is True for s in stats)
    assert 0 < sum(s.score_duration for s in stats) <= wall
    assert all(0 < s.prune_duration < s.score_duration <= s.total_duration for s in stats)
    merges = {r.request: r.end - r.start for r in recs if r.name == "otters.finish.merge"}
    for p, s in zip(pendings, stats):
        assert 0 < s.merge_duration <= merges[p._seq]


def test_trace_clears_the_records_and_the_ring_counts_its_drops(tmp_path, log, monkeypatch):
    with profile():
        with profiling.span("outer", 7):
            with profiling.span("inner"):
                time.sleep(0.002)
            profiling.count("rows", 3)
    recs = profiling.records()
    assert [r.name for r in recs] == ["inner", "rows", "outer"]
    assert all(r.request == 7 for r in recs)
    outer = profiling.summary()["outer"]
    inner = profiling.summary()["inner"]
    assert outer["count"] == 1 and inner["total_ms"] >= 2.0
    assert outer["self_ms"] == pytest.approx(outer["total_ms"] - inner["total_ms"])
    assert profiling.summary()["rows"] == {"count": 1, "value": 3}

    with profiling.trace(str(tmp_path / "tr")):
        assert profiling.records() == []
        with profiling.span("again"):
            pass
    assert [r.name for r in profiling.records()] == ["again"]

    small = profiling.SpanLog(size=4)
    monkeypatch.setattr(profiling, "_LOG", small)
    with profile():
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    assert [r.name for r in profiling.records()] == ["s6", "s7", "s8", "s9"]
    assert profiling.dropped() == 6
    small.clear()
    assert profiling.dropped() == 0 and profiling.records() == []

