"""The port's certified int8 filtered MetaStore path against the JAX package.

Same numpy inputs through ``otters_tpu`` (JAX, CPU) and ``otters_tpu_torch``
(CPU device): identical indices in order, scores within 1e-6, and the same
``certified`` / ``scan_k_wide`` / pruned / evaluated counts — through
``collect()`` and through ``collect_async`` + ``resolve``. Both the direct
program (small stores) and the fused-kernel path (JAX's Pallas kernel in
interpret mode, the port's K1 through its plain version) are covered.
"""

import contextlib
import io
import os

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.meta import resolve as jresolve
from test_cert_exact import _near_tie_vectors
from torch_parity import (
    assert_same_results,
    twin_stores,
    use_fused_path,
)


def _id_spec(n):
    return [("id", "Int64", list(range(n)))]


def _price_version_spec(n, chunk):
    """bench.py's price/version columns: even chunks expensive v1, odd
    chunks cheap v3, so the bench filter prunes exactly half the chunks."""
    idx = np.arange(n)
    even = (idx // chunk) % 2 == 0
    price = np.where(even, 80.0 + (idx % 20), 10.0 + (idx % 20))
    version = np.where(even, 1, 3).astype(np.int32)
    return [("price", "Float64", price), ("version", "Int32", version)]


def _run(store, pkg, q, *, k=10, rerank_from=20, vf=None, flt=None):
    plan = store.query_batch(q, pkg.Metric.Cosine)
    if flt is not None:
        plan = plan.meta_filter(flt(pkg))
    if vf is not None:
        plan = plan.vec_filter(vf, pkg.Cmp.Gt)
    return plan.take(k, rerank_from=rerank_from).collect()


def _bench_filter(pkg):
    return pkg.col("price").lt(50.0) & pkg.col("version").gte(2)


def _normal_data():
    from otters_tpu.datasets import synthetic_catalog

    vecs, _ = synthetic_catalog(8192, 64, seed=3)
    rng = np.random.default_rng(0)
    q = (vecs[:4] + 0.05 * rng.normal(size=(4, 64))).astype(np.float32)
    return vecs, q


def _fewer_than_k():
    rng = np.random.default_rng(5)
    d = 64
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    vecs = rng.normal(size=(4096, d))
    vecs -= (vecs @ u)[:, None] * u[None, :]
    vecs[:3] = u[None, :] + 0.05 * rng.normal(size=(3, d))
    return vecs.astype(np.float32), u.astype(np.float32)[None]


def _gt_threshold(vecs, q):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    return float(np.sort((qn @ vn.T)[0])[::-1][40])


def _case(name):
    """-> (vectors, queries, column spec, chunk, run kwargs)."""
    if name == "normal":
        vecs, q = _normal_data()
        return vecs, q, _id_spec(len(vecs)), 512, dict(rerank_from=200)
    if name == "near_ties":
        vecs, q, _ = _near_tie_vectors()
        return vecs, q, _id_spec(len(vecs)), 512, dict(rerank_from=20)
    if name == "gt_filter":
        vecs, q, _ = _near_tie_vectors(seed=23)
        return vecs, q, _id_spec(len(vecs)), 512, dict(vf=_gt_threshold(vecs, q))
    if name == "fewer_than_k":
        vecs, q = _fewer_than_k()
        return vecs, q, _id_spec(len(vecs)), 512, dict(vf=0.5, rerank_from=10)
    # price / version store with the bench filter, chunk 1024
    rng = np.random.default_rng(17)
    vecs = rng.normal(size=(16384, 64)).astype(np.float32)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    return (vecs, q, _price_version_spec(len(vecs), 1024), 1024,
            dict(flt=_bench_filter, rerank_from=40))


CASES = ["normal", "near_ties", "gt_filter", "fewer_than_k", "price_version"]


@pytest.mark.parametrize("name", CASES)
def test_collect_direct_program_matches_jax(name):
    vecs, q, spec, chunk, kw = _case(name)
    sj, st = twin_stores(vecs, spec, chunk=chunk)
    rj = _run(sj, jx, q, **kw)
    rt = _run(st, tx, q, **kw)
    assert_same_results(rj, rt, sj, st)
    assert st.last_query_stats().certified is True


@pytest.mark.parametrize("name", ["near_ties", "gt_filter", "price_version"])
def test_collect_fused_path_matches_jax(name, monkeypatch):
    use_fused_path(monkeypatch)
    from otters_tpu_torch.ops import fused_topk

    calls = []
    plain = fused_topk.cert_cos_binmax_plain
    monkeypatch.setattr(
        fused_topk, "cert_cos_binmax_plain",
        lambda *a, **k: calls.append(1) or plain(*a, **k),
    )
    vecs, q, spec, chunk, kw = _case(name)
    sj, st = twin_stores(vecs, spec, chunk=chunk)
    rj = _run(sj, jx, q, **kw)
    rt = _run(st, tx, q, **kw)
    assert calls  # the port's query went through K1 (its CPU version)
    assert_same_results(rj, rt, sj, st)
    assert st.last_query_stats().certified is True
    if name == "price_version":
        assert st.last_query_stats().pruned_chunks == st.n_chunks() // 2


def test_collect_async_resolve_three_batches_match_jax(monkeypatch):
    """Three pipelined batches through collect_async + resolve, on the fused
    path with the bench filter: each batch equals JAX's and equals its own
    plain collect()."""
    use_fused_path(monkeypatch)
    vecs, _, spec, chunk, kw = _case("price_version")
    sj, st = twin_stores(vecs, spec, chunk=chunk)
    rng = np.random.default_rng(3)
    batches = [rng.normal(size=(4, 64)).astype(np.float32) for _ in range(3)]

    def pend(store, pkg, q):
        return (
            store.query_batch(q, pkg.Metric.Cosine)
            .meta_filter(_bench_filter(pkg))
            .take(10, rerank_from=40)
            .collect_async()
        )

    res_j = jresolve([pend(sj, jx, q) for q in batches])
    res_t = tx.resolve([pend(st, tx, q) for q in batches])
    for rj, rt, q in zip(res_j, res_t, batches):
        assert rt.indices == rj.indices
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)
        again = _run(st, tx, q, **kw)
        assert again.indices == rt.indices
    assert st.last_query_stats().certified is True
    assert st.last_query_stats().pruned_chunks == st.n_chunks() // 2


def test_widening_hint_and_scan_width_match_jax():
    """The adversarial near-ties widen identically, and both packages then
    remember the same certified width for the plan shape."""
    vecs, q, _ = _near_tie_vectors(seed=11)
    sj, st = twin_stores(vecs, _id_spec(len(vecs)), chunk=512)
    rj = _run(sj, jx, q, rerank_from=20)
    rt = _run(st, tx, q, rerank_from=20)
    assert_same_results(rj, rt, sj, st)
    assert st.last_query_stats().scan_k_wide > 20
    assert list(st.cert_hints().values()) == list(sj.cert_hints().values())


def test_demo_twin_prints_the_same_tables():
    import runpy
    import sys

    from otters_tpu_torch.demo import main as torch_demo

    out_t, out_j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_t):
        torch_demo(1000, 100, "cpu")
    argv = sys.argv
    sys.argv = ["demo.py", "1000", "100"]
    try:
        with contextlib.redirect_stdout(out_j):
            runpy.run_path(
                os.path.join(os.path.dirname(__file__), "..", "examples", "demo.py"),
                run_name="__main__",
            )
    finally:
        sys.argv = argv

    def tables(text):
        # timing rows differ run to run, and their widths with them
        lines = [ln for ln in text.splitlines() if "_ms " not in ln]
        return [ln for ln in lines if not set(ln) <= set("+-")]

    def column_cells(text):
        return [
            [c.strip() for c in ln.split("|")] for ln in tables(text)
        ]

    assert column_cells(out_t.getvalue()) == column_cells(out_j.getvalue())
    assert "| pruned_chunks    | 4" in out_t.getvalue()


def test_widening_past_the_fused_kernel_into_scan_matches_jax(monkeypatch):
    """3000 near-ties: the certificate widens 20 -> 80 -> 320 -> 1024 on the
    fused kernel, then leaves it for the scan program at 4096; both
    packages certify there with the same rows."""
    use_fused_path(monkeypatch)
    vecs, q, order = _near_tie_vectors(n=16384, n_tie=3000, d=32, seed=3)
    sj, st = twin_stores(vecs, _id_spec(len(vecs)), chunk=512)
    rj = _run(sj, jx, q, rerank_from=20)
    rt = _run(st, tx, q, rerank_from=20)
    assert_same_results(rj, rt, sj, st)
    assert st.last_query_stats().scan_k_wide == 4096
    assert rt.indices == order[:10].tolist()


def test_string_filter_verify_and_collision_redo(monkeypatch):
    """A String-Eq filter is verified host-side; a (forced) failed
    verification re-runs with the exact host mask: same rows as JAX, and
    the certificate declines (its bound no longer speaks for the rows)."""
    rng = np.random.default_rng(9)
    n = 6000
    vecs = rng.normal(size=(n, 32)).astype(np.float32)
    tags = [None if i % 41 == 0 else f"t{(i // 512) % 3}" for i in range(n)]
    spec = [("tag", "String", tags), ("id", "Int64", list(range(n)))]
    sj, st = twin_stores(vecs, spec, chunk=512)
    q = rng.normal(size=(2, 32)).astype(np.float32)

    def flt(pkg):
        return pkg.col("tag").eq("t1")

    rj = _run(sj, jx, q, flt=flt, rerank_from=30)
    rt = _run(st, tx, q, flt=flt, rerank_from=30)
    assert_same_results(rj, rt, sj, st)
    assert all(tags[i] == "t1" for i in rt.indices)

    from otters_tpu_torch.meta import MetaQueryPlan

    seen = []
    monkeypatch.setattr(
        MetaQueryPlan, "_row_satisfies",
        lambda self, i: bool(seen) or seen.append(i) or False,
    )
    with pytest.warns(UserWarning, match="certificate did not pass"):
        redo = _run(st, tx, q, flt=flt, rerank_from=30)
    assert redo.indices == rj.indices
    assert st.last_query_stats().certified is False


def test_unported_kernel_modes_raise_through_the_api(monkeypatch):
    """Queries that need a TPU kernel mode the port lacks raise, naming it."""
    use_fused_path(monkeypatch)
    vecs = np.random.default_rng(2).normal(size=(8192, 16)).astype(np.float32)
    f32_store, int8_store = (
        tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64).from_values(range(8192))])
        .with_vectors(vecs).with_storage_dtype(dt).with_device("cpu").build()
        for dt in ("float32", "int8")
    )
    with pytest.raises(NotImplementedError, match="K3/K4"):
        f32_store.query(vecs[0], tx.Metric.Cosine).take(5).collect()
    with pytest.raises(NotImplementedError, match="K2"):
        int8_store.query(vecs[0], tx.Metric.Cosine).take(5).collect()
