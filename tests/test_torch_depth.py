"""Depths the Hopper kernels' layouts do not fit directly, on the CPU.

- A depth that is not a multiple of 16 (d = 100): every ingest pads the
  stored rows' depth to 112 with zeros (``scoring.pad_depth``); the store
  keeps the logical depth as the rows' shape and ``dim``, and the padded
  one as their row stride, which only the kernel launch reads. Through
  ``MetaStore`` the port answers as ``otters_tpu`` does (JAX on the CPU,
  its Pallas kernel in interpret mode on the fused path; the port's kernels
  through their plain versions): certified int8 Cosine, certified bf16 Dot
  and Euclid, exact f32 and the one-pass "default", each with the same
  rows in order, the same ``certified`` flag and chunk counts, and scores
  within 1e-6 (Euclid: 4 ulps of q^2 + v^2, which its formula cancels).
- Deep rows: ``fused_topk.kernel_takes`` (the counterpart of JAX's
  ``pallas_ok``) sends a shape whose kernel would not fit a block's shared
  memory to the scan program before any launch, and counts it; K1, K5 and
  K6 over f32 rows take any depth through the deep-row plan of
  ``csrc/cert_scan_sm90.cuh``, mirrored by ``sm90_plan`` (the card tests
  hold the mirror against the C side).
- The f32-row fragment order of K6 (``f32_query_perm``), replayed.
"""

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.meta import resolve as jresolve
from otters_tpu.ops import scoring as js
from otters_tpu_torch.ops import fused_topk as ft
from otters_tpu_torch.ops import scoring as ts
from otters_tpu_torch.state import device_vecs_from_numpy
from torch_parity import stats_tuple, twin_stores, use_fused_path

import jax.numpy as jnp

SMEM_MAX = 232448
D = 100  # logical depth; stored as 112


def _price_version_spec(n, chunk):
    idx = np.arange(n)
    even = (idx // chunk) % 2 == 0
    price = np.where(even, 80.0 + (idx % 20), 10.0 + (idx % 20))
    version = np.where(even, 1, 3).astype(np.int32)
    return [("price", "Float64", price), ("version", "Int32", version)]


def _bench_filter(pkg):
    return pkg.col("price").lt(50.0) & pkg.col("version").gte(2)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _stored(v):
    """The padded [n, stride] buffer behind a store's rows view."""
    n, d = v.shape
    return v.as_strided((n, v.stride(0)), (v.stride(0), 1))


# ---------------------------------------------------------------------------
# the padded store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_ingest_pads_depth_and_keeps_the_logical_dim(dtype):
    """Every ingest path stores d = 100 as 112 zero-padded columns behind a
    [n, 100] view, with the same values, norms and residuals as JAX's
    unpadded store; the store and its builder report dim 100."""
    rng = np.random.default_rng(0)
    n = 1500
    v = rng.normal(size=(n, D)).astype(np.float32)
    tdt = getattr(torch, dtype)
    n_pad = ts.pad_rows(n)
    padded = torch.zeros((n_pad, D))
    padded[:n] = torch.from_numpy(v)
    dj = js.materialize(v, dtype=getattr(jnp, dtype))
    built = [ts.materialize(v, dtype=tdt, device="cpu"),
             ts.materialize_from_device(torch.from_numpy(v), dtype=tdt),
             device_vecs_from_numpy(*[None if x is None else np.asarray(x) for x in dj],
                                    device="cpu")]
    if dtype == "int8":
        built.append(ts.materialize_int8_slabs(lambda s, r: padded[s : s + r], n, D, 700,
                                               device="cpu"))
    if dtype == "float32":
        built.append(ts.materialize_f32_slabs(lambda s, r: padded[s : s + r], n, D, 700,
                                              device="cpu"))
    want = np.asarray(jnp.asarray(dj.vectors, jnp.float32))
    for dv in built:
        assert dv.vectors.shape == (n_pad, D) and dv.vectors.dtype == tdt
        assert dv.vectors.stride() == (112, 1) and ft.stored_depth(dv.vectors) == 112
        full = _stored(dv.vectors)
        assert bool((full[:, D:] == 0).all())
        np.testing.assert_array_equal(dv.vectors.float().numpy(), want)
        np.testing.assert_allclose(dv.norms_sq.numpy(), np.asarray(dj.norms_sq), rtol=4e-7)
        if dj.resid is not None and dv.resid is not None:
            np.testing.assert_allclose(dv.resid.numpy(), np.asarray(dj.resid), rtol=2e-5,
                                       atol=1e-12)
    store = (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64).from_values(
        np.arange(n))]).with_vectors(v).with_storage_dtype(dtype).with_device("cpu").build())
    assert store.build_stats().dim == D and store._dv.vectors.shape[1] == D
    assert ts.pad_depth(D) == 112 and ts.pad_depth(768) == 768 and ts.pad_depth(1) == 16


def test_rows_stored_otherwise_raise_at_launch():
    """The kernels read the stored depth; rows whose stride is not a
    multiple of 16 (built by hand, not by the store) are refused."""
    v = torch.zeros((512, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="padded to a multiple of 16"):
        ft.stored_depth(v)
    assert ft.stored_depth(ts._depth_padded(v)) == 112


# ---------------------------------------------------------------------------
# MetaStore at d = 100 against otters_tpu
# ---------------------------------------------------------------------------

CASES = [
    # (storage, metric, certified take, precision, bf16-representable data)
    ("int8", "Cosine", True, "highest", False),
    ("bfloat16", "DotProduct", True, "highest", False),
    ("bfloat16", "Euclidean", True, "highest", False),
    ("float32", "Cosine", False, "highest", False),
    ("float32", "Euclidean", False, "highest", False),
    ("float32", "Cosine", False, "default", True),
    ("bfloat16", "DotProduct", False, "default", True),
]


def _route(path, monkeypatch):
    """Put both packages on ``path`` and record the plain kernels the
    port's fused path runs."""
    calls = []
    if path == "fused":
        use_fused_path(monkeypatch)
    for name in ("cert_cos_binmax_plain", "cert_fold_binmax_plain", "binmax_plain"):
        f = getattr(ft, name)
        monkeypatch.setattr(ft, name,
                            lambda *a, _f=f, _n=name, **kw: calls.append(_n) or _f(*a, **kw))
    return calls


@pytest.mark.parametrize("path", ["direct", "fused"])
@pytest.mark.parametrize("storage,metric,certify,prec,representable", CASES)
def test_metastore_at_d100_matches_jax(storage, metric, certify, prec, representable, path,
                                       monkeypatch):
    calls = _route(path, monkeypatch)
    rng = np.random.default_rng(7)
    n = 16384
    v = rng.normal(size=(n, D)).astype(np.float32)
    batches = [rng.normal(size=(4, D)).astype(np.float32) for _ in range(2)]
    if representable:  # JAX's CPU DEFAULT is full f32: equal to one bf16 pass
        v, batches = _bf16(v), [_bf16(q) for q in batches]
    sj, st = twin_stores(v, _price_version_spec(n, 1024), chunk=1024, storage=storage,
                         rerank=certify)
    sj.precision = st.precision = prec
    take = dict(rerank_from=60) if certify else {}

    def pend(store, pkg, q):
        return (store.query_batch(q, getattr(pkg.Metric, metric))
                .meta_filter(_bench_filter(pkg)).take(10, **take).collect_async())

    before = ft.kernel_takes.routed
    res_j = jresolve([pend(sj, jx, q) for q in batches])
    res_t = tx.resolve([pend(st, tx, q) for q in batches])
    assert ft.kernel_takes.routed == before  # d = 100: every kernel takes it
    for rj, rt in zip(res_j, res_t):
        assert len(rt) == 10
        assert rt.indices == rj.indices
        atol = 1e-6
        if metric == "Euclidean":  # the ulps of q^2 + v^2 its formula cancels
            atol = 4 * float(np.spacing(np.float32(max(np.abs(rj.scores)))))
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-6, atol=atol)
    assert stats_tuple(st) == stats_tuple(sj)
    stats = st.last_query_stats()
    assert stats.certified is (True if certify else None)
    assert stats.pruned_chunks == st.n_chunks() // 2
    if path == "fused":
        want = ("cert_cos_binmax_plain" if metric == "Cosine" else "cert_fold_binmax_plain") \
            if certify else "binmax_plain"
        assert want in calls, calls
    else:
        assert calls == []


# ---------------------------------------------------------------------------
# the shape route (pallas_ok's counterpart)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,d,takes", [
    ("K6-bf16", 1392, True), ("K6-bf16", 1408, False), ("K6-bf16", 2048, False),
    ("K2", 2976, True), ("K2", 2992, False), ("K2", 3072, False),
    ("K1", 2048, True), ("K1-bf16", 2048, True), ("K5", 2048, True), ("K6", 2048, True),
    ("K1", 8192, True), ("K5", 4096, True), ("K6", 4096, True),
    ("K3", 4096, True), ("K4", 4096, True), ("K4-bf16", 4096, True), ("K3-bf16", 4096, True),
    ("K6-bf16", 100, True), ("K2", 100, True)])
def test_shape_check_routes_only_what_cannot_fit(mode, d, takes):
    """K6 over bf16 rows stops at d = 1,392 and K2 at d = 2,976 (their
    shared memory); K1, K5 and K6 over f32 rows take any depth (their
    deep-row plan), K3 and K4 need no depth-sized shared memory."""
    assert ft.kernel_takes(mode, d) is takes
    assert (ft.kernel_smem_bytes(mode, ts.pad_depth(d)) <= SMEM_MAX) is takes


@pytest.mark.parametrize("case", ["K6-bf16", "K2"])
def test_meta_routes_deep_rows_to_the_scan_program(case, monkeypatch):
    """A 2,048-deep bf16 store at precision "default" (K6 over bf16 rows)
    and a 3,072-deep int8 store queried uncertified (K2) take the scan
    program on the fused path's shape, counted, with no kernel call; the
    answer equals what the kernel's path returns for the same query
    (forced here through the plain version)."""
    use_fused_path(monkeypatch, direct_limit=1 << 12)
    rng = np.random.default_rng(3)
    n, d = 1024, (2048 if case == "K6-bf16" else 3072)
    v = _bf16(rng.normal(size=(n, d)).astype(np.float32))
    q = _bf16(rng.normal(size=(5, d)).astype(np.float32))
    store = (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64).from_values(
        np.arange(n))]).with_vectors(v).with_chunk_size(256)
        .with_storage_dtype("bfloat16" if case == "K6-bf16" else "int8")
        .with_device("cpu").build())
    if case == "K6-bf16":
        store.precision = "default"

    def run():
        return store.query_batch(q, tx.Metric.Cosine).take(10).collect()

    calls = _route("direct", monkeypatch)
    ft.reset_launches()
    routed = run()
    assert ft.kernel_takes.routed == 5 and calls == []
    monkeypatch.setattr(ft, "kernel_takes", lambda mode, d: True)
    kernel = run()
    assert calls == ["binmax_plain"]
    assert routed.indices == kernel.indices
    np.testing.assert_allclose(routed.scores, kernel.scores, rtol=1e-6, atol=1e-6)


def test_vecstore_routes_deep_rows_to_the_scan_program(monkeypatch):
    """The VecStore path (``run_vec_topk``) consults the same check."""
    use_fused_path(monkeypatch, direct_limit=1 << 12)
    rng = np.random.default_rng(4)
    n, d = 1024, 2048
    v = _bf16(rng.normal(size=(n, d)).astype(np.float32))
    q = _bf16(rng.normal(size=(5, d)).astype(np.float32))
    store = tx.VecStore(d, dtype="bfloat16", device="cpu")
    store.add_vectors(v)
    store.precision = "default"
    ft.reset_launches()
    res = store.query(q, tx.Metric.DotProduct).take(10).collect()
    assert ft.kernel_takes.routed == 5
    s = (q.astype(np.float64) @ v.astype(np.float64).T).reshape(-1)
    want = np.argsort(-s, kind="stable")[:10] % n
    assert [r.index for r in res] == want.tolist()


# ---------------------------------------------------------------------------
# the sm90 plans (the C side's sm90::plan_for, cert_scan_sm90.cuh)
# ---------------------------------------------------------------------------

DEPTHS = [16, 100, 768, 1392, 1536, 2048, 4096]


@pytest.mark.parametrize("mode", ["K1", "K1-bf16", "K5", "K6"])
@pytest.mark.parametrize("d", DEPTHS)
def test_sm90_plan_fits_every_depth(mode, d):
    """An even ring of at least 2 stages within 232,448 B at every depth;
    the query block is streamed exactly when the resident block would leave
    fewer than 2 stages of the narrow shape; at d = 768 K1 keeps its plans
    and K5 / K6 take their wide shapes."""
    dp = ts.pad_depth(d)
    row_bytes, wide, narrow = ft.SM90_SHAPES[mode]
    plan = ft.sm90_plan(mode, dp)
    assert plan.stages >= 2 and plan.stages % 2 == 0 and plan.stages <= ft.SM90_MAX_STAGES
    smem = ft.sm90_smem_bytes(dp, row_bytes, plan.stages, plan.ks, plan.rows, plan.streamed)
    assert smem == ft.kernel_smem_bytes(mode, dp) <= SMEM_MAX
    resident_fits = ft.sm90_smem_bytes(dp, row_bytes, 2, *narrow) <= SMEM_MAX
    assert plan.streamed is (not resident_fits)
    if plan.streamed:
        # every stage carries its query k-blocks; one more stage would not fit
        assert (plan.ks, plan.rows) == narrow
        assert plan.stages == ft.SM90_MAX_STAGES or ft.sm90_smem_bytes(
            dp, row_bytes, plan.stages + 2, *narrow, True) > SMEM_MAX
    elif ft.sm90_smem_bytes(dp, row_bytes, 4, *wide) <= SMEM_MAX:
        assert (plan.ks, plan.rows) == wide and plan.stages >= 4
    else:
        assert (plan.ks, plan.rows) == narrow
    geom = ft.sm90_geometry(mode, 600, dp, 132)
    assert geom.dq % 64 == 0 and 0 <= geom.dq - dp < 64
    assert (geom.ks, geom.rows, geom.stages, geom.streamed) == plan
    assert geom.n_qb == 10 and geom.per_group == 13
    if d == 768:
        assert plan == {"K1": (2, 128, 8, False), "K1-bf16": (1, 256, 4, False),
                        "K5": (2, 128, 4, False), "K6": (1, 128, 4, False)}[mode]
    if d >= 2048:
        assert plan.streamed


@pytest.mark.parametrize("dq", [64, 128, 768, 2048])
def test_f32_query_perm_matches_the_fragment_order(dq):
    """Replays how a consumer thread builds its f32 A fragment: for step
    kk, lane t loads 16-byte chunk c = 2 t + kk % 2 of half kk // 2 of the
    row's 64-deep k-block (elements 32 h + 4 c + e), whose elements e = 0,
    1 go to register a0 (depth 16 kk + 2 t + e) and e = 2, 3 to a2 (depth
    16 kk + 2 t + 8 + e - 2). The query element multiplying stored element
    p must sit at that depth. A quarter-warp's loads (g = 0, 1; t = 0..3)
    touch 8 distinct bank groups under the 128-byte swizzle (physical chunk
    c ^ (row % 8))."""
    perm = ft.f32_query_perm(dq)
    assert sorted(perm.tolist()) == list(range(dq))
    for c0 in range(0, dq, 64):
        for t in range(4):
            for kk in range(4):
                for e in range(4):
                    p = 32 * (kk // 2) + 4 * (2 * t + kk % 2) + e
                    depth = 16 * kk + 2 * t + (e if e < 2 else 8 + e - 2)
                    assert perm[c0 + depth] == c0 + p
    for kk in range(4):
        for row0 in range(0, 16, 2):
            groups = {(2 * t + kk % 2) ^ ((row0 + g) % 8) for g in (0, 1) for t in range(4)}
            assert len(groups) == 8
    rng = np.random.default_rng(dq)
    v = rng.normal(size=(5, dq))
    q = rng.normal(size=(3, dq))
    np.testing.assert_allclose(v[:, perm.numpy()] @ q[:, perm.numpy()].T, v @ q.T,
                               rtol=1e-12)
