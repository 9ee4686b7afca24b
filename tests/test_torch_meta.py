"""The port's MetaStore query paths against the JAX package.

Same numpy inputs through ``otters_tpu`` (JAX, CPU) and ``otters_tpu_torch``
(CPU device): identical indices in order, scores within 1e-6 (Euclid within
the ulps of q^2 + v^2 its formula cancels), and the same ``certified`` /
``scan_k_wide`` / pruned / evaluated counts — through ``collect()`` and
through ``collect_async`` + ``resolve``. Both the direct program (small
stores) and the fused-kernel path (JAX's Pallas kernel in interpret mode,
the port's kernels through their plain versions) are covered: the certified
int8 path (K1), f32 storage (K4 fast-exact, its failed check and strict K3
redo, Eq filters and wide k on K3, precision "high"), and uncertified int8
(K2).
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
    stats_tuple,
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
    """No store precision raises any more: f32, bfloat16 and int8 stores
    answer fused-size queries, and the one-pass precisions "default" /
    "bf16" run K6 over f32 and bfloat16 rows (their answers against JAX
    and a float64 reference are in tests/test_torch_precision.py)."""
    use_fused_path(monkeypatch)
    vecs = np.random.default_rng(2).normal(size=(8192, 16)).astype(np.float32)
    cols = [tx.Column("id", tx.DataType.Int64).from_values(range(8192))]
    f32_store, bf16_store, int8_store = (
        tx.MetaStore.from_columns(cols).with_vectors(vecs).with_storage_dtype(dt)
        .with_device("cpu").build()
        for dt in ("float32", "bfloat16", "int8")
    )
    for store in (f32_store, bf16_store, int8_store):
        assert len(store.query(vecs[0], tx.Metric.Cosine).take(5).collect()) == 5
    calls = _count_modes(monkeypatch)
    for store, mode in ((f32_store, "K6"), (bf16_store, "K6-bf16")):
        for prec in ("default", "bf16"):
            store.precision = prec
            calls.clear()
            res = store.query(vecs[0], tx.Metric.Cosine).take(5).collect()
            assert len(res) == 5 and res.indices[0] == 0
            assert calls == [mode]


# ---------------------------------------------------------------------------
# f32 storage (K4 fast-exact + K3 strict) and uncertified int8 (K2)
# ---------------------------------------------------------------------------


def _count_modes(monkeypatch):
    """Record which kernel modes the port's queries run (their plain
    versions serve the CPU tensors)."""
    from otters_tpu_torch.ops import fused_topk

    calls = []
    plain = fused_topk.binmax_plain
    monkeypatch.setattr(
        fused_topk, "binmax_plain",
        lambda *a, **k: calls.append(a[0]) or plain(*a, **k),
    )
    return calls


def _price_version_twins(storage, rerank=False, n=16384, d=64, seed=17):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    spec = _price_version_spec(n, 1024)
    return vecs, twin_stores(vecs, spec, chunk=1024, storage=storage, rerank=rerank)


def _query(store, pkg, q, metric, *, k, vf=None, flt=True, **take):
    plan = store.query_batch(q, getattr(pkg.Metric, metric))
    if flt:
        plan = plan.meta_filter(_bench_filter(pkg))
    if vf is not None:
        plan = plan.vec_filter(vf[0], getattr(pkg.Cmp, vf[1]))
    return plan.take(k, **take)


F32_CASES = [
    ("Cosine", 10, None, "K4"),
    ("DotProduct", 10, (1.0, "Gt"), "K4"),
    ("Euclidean", 10, None, "K4"),
    ("Cosine", 200, None, "K3"),
    ("Euclidean", 10, (100.0, "Lte"), "K4"),
]


@pytest.mark.parametrize("metric,k,vf,mode", F32_CASES)
def test_f32_store_matches_jax(monkeypatch, metric, k, vf, mode):
    use_fused_path(monkeypatch)
    calls = _count_modes(monkeypatch)
    _, (sj, st) = _price_version_twins("float32")
    q = np.random.default_rng(5).normal(size=(3, 64)).astype(np.float32)
    rj = _query(sj, jx, q, metric, k=k, vf=vf).collect()
    rt = _query(st, tx, q, metric, k=k, vf=vf).collect()
    assert calls == [mode]
    assert len(rt) == k
    # Dot scores (~30 here) agree to 1e-6 relative, the dot orders differing;
    # Euclid's q^2 + v^2 - 2 q.v cancels: ulps of q^2 + v^2 (~128 here)
    atol = {"Cosine": 1e-6, "DotProduct": 0.0, "Euclidean": 4e-5}[metric]
    assert rt.indices == rj.indices
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-6, atol=atol)
    assert stats_tuple(st) == stats_tuple(sj)
    assert st.last_query_stats().pruned_chunks == st.n_chunks() // 2


def test_f32_eq_filter_runs_k3_and_matches_jax(monkeypatch):
    """An Eq score filter takes the strict mode directly (no two-sided
    slack in the fast mode): integer rows make the Dot scores exact."""
    use_fused_path(monkeypatch)
    calls = _count_modes(monkeypatch)
    rng = np.random.default_rng(7)
    n, d = 16384, 64
    vecs = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    q = rng.integers(-2, 3, size=(2, d)).astype(np.float32)
    target = float(vecs[5000] @ q[0])
    sj, st = twin_stores(vecs, _id_spec(n), chunk=512, storage="float32", rerank=False)
    rj = _query(sj, jx, q, "DotProduct", k=50, vf=(target, "Eq"), flt=False).collect()
    rt = _query(st, tx, q, "DotProduct", k=50, vf=(target, "Eq"), flt=False).collect()
    assert calls == ["K3"]
    assert_same_results(rj, rt, sj, st)
    assert len(rt) == 50 and set(rt.scores) == {target}


def _tie_store(n=16384, d=64, k=5, seed=19):
    """The k-th best row copied into more than 4k bins: the fast mode
    cannot examine them all and its check fails (in both packages)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(1, d)).astype(np.float32)
    vecs[: k - 1] = q + 0.1 * rng.normal(size=(k - 1, d))
    vecs[np.arange(4 * k + 3) * 512 + 300] = q[0] + 0.5 * rng.normal(size=d)
    return vecs, q


def test_f32_failed_check_redoes_strictly_like_jax(monkeypatch):
    use_fused_path(monkeypatch)
    calls = _count_modes(monkeypatch)
    vecs, q = _tie_store()
    sj, st = twin_stores(vecs, _id_spec(len(vecs)), chunk=512, storage="float32",
                         rerank=False)
    rj = _query(sj, jx, q, "Cosine", k=5, flt=False).collect()
    rt = _query(st, tx, q, "Cosine", k=5, flt=False).collect()
    assert calls == ["K4", "K3"]
    assert_same_results(rj, rt, sj, st)
    assert rt.indices[-1] == 300  # the lowest tied copy
    # pipelined: the redo happens where resolve() fetches the scan outputs
    calls.clear()
    pend = [_query(st, tx, qq, "Cosine", k=5, flt=False).collect_async()
            for qq in (q, q + 0.0)]
    assert calls == ["K4", "K4"]
    res = tx.resolve(pend)
    assert calls == ["K4", "K4", "K3", "K3"]
    assert all(r.indices == rj.indices for r in res)


def test_f32_precision_high_runs_k4_strictly(monkeypatch):
    use_fused_path(monkeypatch)
    calls = _count_modes(monkeypatch)
    _, (sj, st) = _price_version_twins("float32", seed=23)
    sj.precision = st.precision = "high"
    q = np.random.default_rng(9).normal(size=(2, 64)).astype(np.float32)
    rj = _query(sj, jx, q, "Cosine", k=10).collect()
    rt = _query(st, tx, q, "Cosine", k=10).collect()
    assert calls == ["K4"]
    assert_same_results(rj, rt, sj, st)


@pytest.mark.parametrize("take", [dict(), dict(rerank_from=40, certify=False)])
def test_uncertified_int8_matches_jax(monkeypatch, take):
    """take(k) with no rerank, and bench.py's filtered_uncert shape
    take(k, rerank_from=..., certify=False): K2 in the port."""
    use_fused_path(monkeypatch)
    calls = _count_modes(monkeypatch)
    _, (sj, st) = _price_version_twins("int8", rerank=True, seed=29)
    q = np.random.default_rng(11).normal(size=(3, 64)).astype(np.float32)
    rj = _query(sj, jx, q, "Cosine", k=10, **take).collect()
    rt = _query(st, tx, q, "Cosine", k=10, **take).collect()
    assert calls == ["K2"]
    assert_same_results(rj, rt, sj, st)
    assert st.last_query_stats().certified is None
    assert st.last_query_stats().pruned_chunks == st.n_chunks() // 2


def test_f32_direct_program_matches_jax():
    """A small f32 store takes the direct program in both packages."""
    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(3000, 32)).astype(np.float32)
    sj, st = twin_stores(vecs, _id_spec(3000), chunk=512, storage="float32", rerank=False)
    q = rng.normal(size=(2, 32)).astype(np.float32)
    for metric in ("Cosine", "DotProduct", "Euclidean"):
        rj = _query(sj, jx, q, metric, k=7, flt=False).collect()
        rt = _query(st, tx, q, metric, k=7, flt=False).collect()
        assert rt.indices == rj.indices
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=2e-5)
