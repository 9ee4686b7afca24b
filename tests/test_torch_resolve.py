"""``resolve``'s rerank groups and union prefetch against the JAX package.

The JAX package's ``tests/test_rerank.py`` cases on the port, each run in
both packages on the same inputs: a rerank group takes one ``fetch_vectors``
call and one device rerank; a group the device rerank does not take (a VPU
metric) fetches its members' candidates in one sorted call, which each
member's host rerank reads (``_rerank_prefetch``), and a widened rescan
drops it. Every answer equals a sequential ``collect()`` and
``otters_tpu``'s. Also the shape route's ``OTTERS_DISABLE_PALLAS``: every
kernel refused, the queries counted as routed.
"""

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
from otters_tpu_torch.ops import fused_topk as ft
from test_cert_exact import _near_tie_vectors
from test_torch_meta import _count_modes
from torch_parity import columns, stats_tuple


def _store(pkg, vecs, fetch, storage="int8", spec=()):
    b = (
        pkg.MetaStore.from_columns(columns(pkg, list(spec)))
        .with_vectors(vecs)
        .with_storage_dtype(storage)
        .with_rerank_source(fetch_vectors=fetch)
    )
    if pkg is tx:
        b = b.with_device("cpu")
    return b.build()


def _twins(vecs, storage="int8", spec=()):
    """(jax store, torch store, jax fetch calls, torch fetch calls): each
    store's ``fetch_vectors`` records the distinct ids of every call (JAX
    pads its device rerank's union by repeating an id; the port does not)."""
    calls = {jx: [], tx: []}

    def fetcher(pkg):
        def fetch(ids):
            calls[pkg].append(np.unique(np.asarray(ids)).tolist())
            return vecs[np.asarray(ids, dtype=np.int64)]

        return fetch

    sj, st = (_store(pkg, vecs, fetcher(pkg), storage, spec) for pkg in (jx, tx))
    return sj, st, calls[jx], calls[tx]


def _pending(store, pkg, q, metric, k, k_wide, flt=None):
    plan = store.query_batch(q, getattr(pkg.Metric, metric))
    if flt is not None:
        plan = plan.meta_filter(flt(pkg))
    return plan.take(k, rerank_from=k_wide).collect_async()


def _resolve_both(sj, st, qs, metric, k, k_wide, flt=None):
    pj = [_pending(sj, jx, q, metric, k, k_wide, flt) for q in qs]
    pt = [_pending(st, tx, q, metric, k, k_wide, flt) for q in qs]
    return pj, jmeta.resolve(pj), pt, tx.resolve(pt)


def _assert_sequential(st, qs, results, metric, k, k_wide, rtol, flt=None):
    for q, r in zip(qs, results):
        want = _pending(st, tx, q, metric, k, k_wide, flt).result()
        assert r.indices == want.indices
        np.testing.assert_allclose(r.scores, want.scores, rtol=rtol, atol=rtol)


def _assert_jax(rj, rt, tol):
    for a, b in zip(rj, rt):
        assert b.indices == a.indices
        np.testing.assert_allclose(b.scores, a.scores, rtol=tol, atol=tol)


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
@pytest.mark.parametrize("n_pend", [1, 2, 7])
def test_group_fetches_once_like_jax(n_pend, storage):
    """JAX's ``test_resolve_group_max_chunks_match_sequential`` at its
    default: the pendings of one group take one fetch and one device
    rerank, with JAX's ids and rows."""
    rng = np.random.default_rng(12)
    n, d = 4_000, 32
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    sj, st, cj, ct = _twins(vecs, storage)
    qs = [rng.normal(size=(2, d)).astype(np.float32) for _ in range(n_pend)]
    pj, rj, pt, rt = _resolve_both(sj, st, qs, "Cosine", 5, 40)
    assert len(ct) == 1, ct
    assert ct == cj
    assert all(p._device_rerank is not None for p in pt)
    assert all(p._rerank_prefetch is None for p in pt)
    _assert_jax(rj, rt, 1e-6)
    _assert_sequential(st, qs, rt, "Cosine", 5, 40, 1e-6)


def test_groups_dispatch_before_any_drains(monkeypatch):
    """Every scan is waited for before the first dispatch, and every
    group's rerank is enqueued before the first is drained."""
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(3_000, 16)).astype(np.float32)
    st = _store(tx, vecs, lambda ids: vecs[np.asarray(ids, dtype=np.int64)])
    qs = [rng.normal(size=(2, 16)).astype(np.float32) for _ in range(4)]
    pend = [_pending(st, tx, q, "Cosine", 5 + i % 2, 40) for i, q in enumerate(qs)]
    events = []
    dispatch, finish = tmeta._device_rerank_dispatch, tmeta._device_rerank_finish

    def spy_dispatch(store, plist):
        events.append(("dispatch", len(plist), all(p._fetched is not None for p in pend)))
        return dispatch(store, plist)

    def spy_finish(plist, *a):
        events.append(("finish", len(plist), True))
        return finish(plist, *a)

    monkeypatch.setattr(tmeta, "_device_rerank_dispatch", spy_dispatch)
    monkeypatch.setattr(tmeta, "_device_rerank_finish", spy_finish)
    got = tx.resolve(pend)
    assert events == [("dispatch", 2, True)] * 2 + [("finish", 2, True)] * 2
    for q, p, r in zip(qs, pend, got):
        want = _pending(st, tx, q, "Cosine", p._plan._take_count, 40).result()
        assert r.indices == want.indices


@pytest.mark.parametrize("n_pend", [1, 3])
def test_vpu_group_one_union_fetch_like_jax(n_pend):
    """JAX's ``test_resolve_device_rerank_vpu_metric_falls_back``: a
    Manhattan group is not taken by the device rerank; its members'
    candidates come from one sorted fetch, kept as the prefetch."""
    rng = np.random.default_rng(14)
    n, d = 3_000, 16
    vecs = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    sj, st, cj, ct = _twins(vecs, storage="bfloat16")
    qs = [np.abs(rng.normal(size=(2, d))).astype(np.float32) for _ in range(n_pend)]
    pj, rj, pt, rt = _resolve_both(sj, st, qs, "Manhattan", 4, 32)
    assert len(ct) == 1, ct
    assert ct == cj
    assert all(p._device_rerank is None for p in pt)
    assert all(p._rerank_prefetch is not None for p in pt)
    ids, mat = pt[0]._rerank_prefetch
    assert (np.diff(ids) > 0).all() and tuple(mat.shape) == (len(ids), d)
    _assert_jax(rj, rt, 1e-4)
    _assert_sequential(st, qs, rt, "Manhattan", 4, 32, 1e-4)


def test_vpu_prefetch_on_a_sorted_store_uses_original_ids():
    """On a sorted store the union is of original row ids (``_index_map``):
    one fetch, and JAX's rows."""
    rng = np.random.default_rng(21)
    n, d = 2_500, 12
    vecs = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    price = rng.uniform(0, 100, n)
    calls = {jx: [], tx: []}
    stores = {}
    for pkg in (jx, tx):
        def fetch(ids, _c=calls[pkg]):
            _c.append(np.asarray(ids).copy())
            return vecs[np.asarray(ids, dtype=np.int64)]

        b = (pkg.MetaStore.from_columns(columns(pkg, [("price", "Float64", price)]))
             .with_vectors(vecs).with_storage_dtype("bfloat16").with_sort_by("price")
             .with_rerank_source(fetch_vectors=fetch))
        stores[pkg] = (b.with_device("cpu") if pkg is tx else b).build()
    qs = [np.abs(rng.normal(size=(2, d))).astype(np.float32) for _ in range(3)]
    flt = lambda pkg: pkg.col("price").lt(60.0)  # noqa: E731
    pj, rj, pt, rt = _resolve_both(stores[jx], stores[tx], qs, "Manhattan", 5, 30, flt)
    assert len(calls[tx]) == 1 and len(calls[jx]) == 1
    assert calls[tx][0].tolist() == np.unique(calls[jx][0]).tolist()
    _assert_jax(rj, rt, 1e-4)
    for r in rt:
        assert all(price[i] < 60.0 for i in r.indices)


def test_widened_rescan_drops_the_prefetch(monkeypatch):
    """A host group (the device rerank refused in both packages) whose
    certificate widens: the widened scan changes the candidate set, the
    prefetch is dropped and the rerank fetches anew, as in JAX (the same
    rows, the same fetch count, the same stats)."""
    monkeypatch.setattr(tmeta, "_device_rerank_dispatch", lambda store, plist: None)
    monkeypatch.setattr(jmeta, "_device_rerank_dispatch", lambda store, plist: None)
    vecs, q, order = _near_tie_vectors(n=4096, n_tie=600, d=32, seed=3)
    sj, st, cj, ct = _twins(vecs)
    qs = [q, q[:, ::-1].copy()]
    pj, rj, pt, rt = _resolve_both(sj, st, qs, "Cosine", 10, 20)
    assert pt[0].stats().scan_k_wide > 20 and pt[0]._rerank_prefetch is None
    assert pt[1].stats().scan_k_wide == 20 and pt[1]._rerank_prefetch is not None
    assert rt[0].indices == order[:10].tolist()
    assert ct == cj and len(ct) > 1
    _assert_jax(rj, rt, 1e-6)
    assert stats_tuple(st) == stats_tuple(sj)


def test_collision_redo_reads_the_prefetch(monkeypatch):
    """A forced hash collision on a VPU group: the redo with the exact host
    mask finds the same rows, so the members' reranks read the union
    prefetch (one fetch in both packages) and give JAX's rows."""
    rng = np.random.default_rng(9)
    n, d = 3_000, 16
    vecs = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    tags = [f"t{(i // 256) % 3}" for i in range(n)]
    sj, st, cj, ct = _twins(vecs, storage="bfloat16", spec=[("tag", "String", tags)])
    qs = [np.abs(rng.normal(size=(2, d))).astype(np.float32) for _ in range(2)]
    flt = lambda pkg: pkg.col("tag").eq("t1")  # noqa: E731
    for mod in (tmeta, jmeta):
        seen = []
        monkeypatch.setattr(mod.MetaQueryPlan, "_row_satisfies",
                            lambda self, i, _s=seen: bool(_s) or _s.append(i) or False)
    pj, rj, pt, rt = _resolve_both(sj, st, qs, "Manhattan", 5, 30, flt)
    assert ct == cj and len(ct) == 1
    _assert_jax(rj, rt, 1e-4)
    for r in rt:
        assert all(tags[i] == "t1" for i in r.indices)


def test_ids_outside_the_union_fall_through():
    """A candidate set that left the union (as after a redo) is fetched
    anew: one more call, for those ids, and the rerank a pending without a
    prefetch gives."""
    rng = np.random.default_rng(4)
    n, d = 3_000, 16
    vecs = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    sj, st, cj, ct = _twins(vecs, storage="bfloat16")
    qs = [np.abs(rng.normal(size=(2, d))).astype(np.float32) for _ in range(2)]
    pend = [_pending(st, tx, q, "Manhattan", 4, 32) for q in qs]
    tx.resolve(pend)
    union = pend[0]._rerank_prefetch[0]
    outside = np.setdiff1d(np.arange(n), union)[:40].tolist()
    assert len(ct) == 1
    got = pend[0]._exact_rerank(outside)
    assert len(ct) == 2 and ct[1] == outside
    inside = union[:40].tolist()
    assert pend[0]._exact_rerank(inside) is not None and len(ct) == 2
    fresh = _pending(st, tx, qs[0], "Manhattan", 4, 32)
    fresh._fetch()
    assert fresh._exact_rerank(outside) == got


# ---------------------------------------------------------------------------
# OTTERS_DISABLE_PALLAS: the shape route refuses every kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(ft.KERNELS))
def test_disable_pallas_refuses_every_kernel(mode, monkeypatch):
    for d in (16, 100, 768, 2048):
        assert ft.kernel_takes(mode, d)
    monkeypatch.setenv("OTTERS_DISABLE_PALLAS", "1")
    for d in (16, 100, 768, 2048):
        assert not ft.kernel_takes(mode, d)


def _switch_stores(route, storage, vecs):
    """(JAX store, port store) on ``route``: one device, a ``rows=4,
    batch=2`` mesh, or a VecStore."""
    from torch_parity import twin_meshes

    if route == "vecstore":
        out = []
        for pkg in (jx, tx):
            kw = {"device": "cpu"} if pkg is tx else {}
            vs = pkg.VecStore(vecs.shape[1], storage, **kw)
            vs.add_vectors(vecs)
            out.append(vs)
        return tuple(out)
    meshes = twin_meshes("4x2") if route == "sharded" else (None, None)
    out = []
    for pkg, mesh in zip((jx, tx), meshes):
        b = pkg.MetaStore.from_columns([]).with_vectors(vecs).with_chunk_size(1024)
        b = b.with_storage_dtype(storage)
        if pkg is tx and mesh is None:
            b = b.with_device("cpu")
        out.append(b.build() if mesh is None else b.build_sharded(mesh))
    return tuple(out)


@pytest.mark.parametrize("route", ["single", "sharded", "vecstore"])
@pytest.mark.parametrize("storage", ["float32", "int8", "bfloat16"])
def test_disable_pallas_routes_to_the_scan_program(route, storage, monkeypatch):
    """Under the switch a fused-size query runs no kernel: every query is
    counted in ``kernel_takes.routed`` and the answers are JAX's under its
    own switch (its XLA paths), and the kernels' answers without it."""
    from torch_parity import use_fused_path

    use_fused_path(monkeypatch)
    rng = np.random.default_rng(31)
    vecs = rng.normal(size=(16384, 32)).astype(np.float32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    sj, st = _switch_stores(route, storage, vecs)
    calls = _count_modes(monkeypatch)

    def run(store, pkg):
        plan = store.query(q, pkg.Metric.Cosine) if route == "vecstore" else store.query_batch(
            q, pkg.Metric.Cosine)
        return plan.take(10).collect()

    ft.reset_launches()
    kernel = run(st, tx)
    assert calls and ft.kernel_takes.routed == 0
    monkeypatch.setenv("OTTERS_DISABLE_PALLAS", "1")
    calls.clear()
    scan = run(st, tx)
    assert calls == []
    assert ft.kernel_takes.routed == (4 if route == "sharded" else 3)
    want = _rows_scores(run(sj, jx))
    for got in map(_rows_scores, (scan, kernel)):
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _rows_scores(res):
    if isinstance(res, list):  # VecStore: SearchResults
        return [r.index for r in res], [r.score for r in res]
    return res.indices, res.scores


# ---------------------------------------------------------------------------
# differential_fuzz: the on-card fuzz's driver, at a small size on the CPU
# ---------------------------------------------------------------------------


def test_fuzz_run_draws_until_covered(monkeypatch):
    """``run`` draws from the script's space until ``trials`` fused-size
    trials ran, a batch of 8 and chunks of 1000 rows among them, then the
    tie trial; every trial held the two routes equal and routed its batch
    under the switch (the fused path on the CPU runs the kernels' plain
    versions)."""
    from torch_parity import use_fused_path
    from otters_tpu_torch import differential_fuzz as fz

    use_fused_path(monkeypatch)
    seen = []
    recs = fz.run(trials=3, device="cpu", n_choices=(3000,), log=seen.append)
    assert seen == recs and [r["trial"] for r in recs] == list(range(len(recs)))
    drawn, tie = recs[:-1], recs[-1]
    assert all(r["route"] == "fused" for r in recs) and len(drawn) >= 3
    assert any(r["b"] == fz.COVER_B for r in drawn)
    assert any(r["chunk"] == fz.COVER_CHUNK for r in drawn)
    assert tie["ties"] and tie["dtype"] == "float32" and not any(r["ties"] for r in drawn)
    for r in recs:
        assert r["idx_match"] and r["scores_close"] and r["filter_ok"]
        assert r["routed"] == r["b"] and not r["switch_launches"]
        assert r["results"] == min(r["k"], r["b"] * r["n"])


def test_fuzz_run_counts_only_fused_size_trials(monkeypatch):
    """At its real direct limit every 3000-row trial is of direct size: run
    and checked, but counted toward no fused trial, so the draws run out."""
    from otters_tpu_torch import differential_fuzz as fz

    monkeypatch.setattr(fz, "MAX_DRAWS", 4)
    seen = []
    with pytest.raises(RuntimeError, match="4 draws gave 1 fused-size trials"):
        fz.run(trials=1, device="cpu", n_choices=(3000,), log=seen.append)
    assert len(seen) == 4 and all(r["route"] == "direct" and r["idx_match"] for r in seen)


def test_fuzz_refuses_a_set_switch(monkeypatch):
    from otters_tpu_torch import differential_fuzz as fz

    monkeypatch.setenv("OTTERS_DISABLE_PALLAS", "1")
    with pytest.raises(RuntimeError, match="OTTERS_DISABLE_PALLAS is set"):
        fz.run(trials=1, device="cpu", n_choices=(3000,))


@pytest.mark.parametrize("seed", [1, 2])
def test_fuzz_tie_trial_reruns_strictly(seed, monkeypatch):
    """The tie trial's rows are copies of a few vectors: the fast check
    fails, the query re-runs strictly (K3 on the card), and both routes
    keep the same lowest-indexed copies."""
    import torch
    from otters_tpu_torch import differential_fuzz as fz

    monkeypatch.setattr(fz, "D_CHOICES", (64,))
    monkeypatch.setattr(fz, "K_CHOICES", (5, 10))  # 4k + 1 bins fewer than the store's
    calls = []
    fused_topk = ft.fused_topk

    def spy(*a, **kw):
        calls.append(kw.get("fast"))
        return fused_topk(*a, **kw)

    monkeypatch.setattr(ft, "fused_topk", spy)
    rec = fz.trial(0, np.random.default_rng(seed), seed, torch.device("cpu"), (60_000,),
                   ties=True)
    assert rec["ties"] and rec["route"] == "fused" and calls == [True, False]
    assert rec["idx_match"] and rec["scores_close"] and rec["filter_ok"]
