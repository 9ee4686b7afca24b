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
  memory (K2 past d = 2,976) to the scan program before any launch, and
  counts it; K1, K5, K6 over f32 and bf16 rows and K4 over bf16 rows take
  any depth through the deep-row plan of ``csrc/cert_scan_sm90.cuh``,
  mirrored by ``sm90_plan`` (the card tests hold the mirror against the C
  side); K4 over bf16 rows streams its two query planes at every depth.
- The f32-row fragment order of K6 (``f32_query_perm``), replayed; the
  query planes of K4 over bf16 rows (``query_planes``) against JAX's split.
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
    ("K6-bf16", 1392, True), ("K6-bf16", 1408, True), ("K6-bf16", 2048, True),
    ("K2", 2976, True), ("K2", 2992, False), ("K2", 3072, False),
    ("K1", 2048, True), ("K1-bf16", 2048, True), ("K5", 2048, True), ("K6", 2048, True),
    ("K1", 8192, True), ("K5", 4096, True), ("K6", 4096, True),
    ("K3", 4096, True), ("K4", 4096, True), ("K4-bf16", 4096, True), ("K3-bf16", 4096, True),
    ("K6-bf16", 100, True), ("K2", 100, True)])
def test_shape_check_routes_only_what_cannot_fit(mode, d, takes):
    """K2 stops at d = 2,976 (its shared memory); K1, K5, K6 over f32 and
    bf16 rows and K4 over bf16 rows take any depth (their deep-row plan),
    K3 and K4 over f32 rows need no depth-sized shared memory."""
    assert ft.kernel_takes(mode, d) is takes
    assert (ft.kernel_smem_bytes(mode, ts.pad_depth(d)) <= SMEM_MAX) is takes


@pytest.mark.parametrize("case", ["K6-bf16", "K2"])
def test_meta_routes_deep_rows_to_the_scan_program(case, monkeypatch):
    """A 3,072-deep int8 store queried uncertified (K2) takes the scan
    program on the fused path's shape, counted, with no kernel call; a
    2,048-deep bf16 store at precision "default" (K6 over bf16 rows, on the
    Hopper scan's deep-row plan) takes the kernel's wrapper with nothing
    routed. Either answer equals what the other path returns for the same
    query (forced here: the kernel through its plain version, or the
    route)."""
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
    if case == "K2":
        routed = run()
        assert ft.kernel_takes.routed == 5 and calls == []
        monkeypatch.setattr(ft, "kernel_takes", lambda mode, d: True)
        kernel = run()
        assert calls == ["binmax_plain"]
    else:
        kernel = run()
        assert ft.kernel_takes.routed == 0 and calls == ["binmax_plain"]
        refuse = lambda mode, d: False  # noqa: E731
        refuse.routed = 0
        monkeypatch.setattr(ft, "kernel_takes", refuse)
        routed = run()
        assert refuse.routed == 5 and calls == ["binmax_plain"]
    assert routed.indices == kernel.indices
    np.testing.assert_allclose(routed.scores, kernel.scores, rtol=1e-6, atol=1e-6)


def test_vecstore_routes_deep_rows_to_the_scan_program(monkeypatch):
    """The VecStore path (``run_vec_topk``) consults the same check: a
    3,072-deep int8 VecStore (K2, past its shared memory) takes the scan
    program, counted, and answers as the kernel's path does (forced here
    through the plain version)."""
    use_fused_path(monkeypatch, direct_limit=1 << 12)
    rng = np.random.default_rng(4)
    n, d = 1024, 3072
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    store = tx.VecStore(d, dtype="int8", device="cpu")
    store.add_vectors(v)
    calls = _route("direct", monkeypatch)
    ft.reset_launches()
    res = store.query(q, tx.Metric.Cosine).take(10).collect()
    assert ft.kernel_takes.routed == 5 and calls == []
    monkeypatch.setattr(ft, "kernel_takes", lambda mode, d: True)
    kernel = store.query(q, tx.Metric.Cosine).take(10).collect()
    assert calls == ["binmax_plain"]
    assert [r.index for r in res] == [r.index for r in kernel]
    np.testing.assert_allclose([r.score for r in res], [r.score for r in kernel],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the sm90 plans (the C side's sm90::plan_for, cert_scan_sm90.cuh)
# ---------------------------------------------------------------------------

DEPTHS = [16, 100, 768, 1392, 1536, 2048, 4096]


@pytest.mark.parametrize("mode", ["K1", "K1-bf16", "K5", "K6", "K6-bf16", "K4-bf16"])
@pytest.mark.parametrize("d", DEPTHS)
def test_sm90_plan_fits_every_depth(mode, d):
    """An even ring of at least 2 stages within 232,448 B at every depth;
    the query block (of every query plane) is streamed exactly when the
    resident block would leave fewer than 2 stages of the narrow shape, or
    always for a mode with no resident plan (K4-bf16); at d = 768 K1 keeps
    its plans, K5 / K6 / K6-bf16 take their wide shapes and K4-bf16 its 6
    streamed stages of 128 rows with both planes."""
    dp = ts.pad_depth(d)
    row_bytes, planes, wide, narrow = ft.SM90_SHAPES[mode]
    plan = ft.sm90_plan(mode, dp)
    assert plan.stages >= 2 and plan.stages % 2 == 0 and plan.stages <= ft.SM90_MAX_STAGES
    smem = ft.sm90_smem_bytes(dp, row_bytes, plan.stages, plan.ks, plan.rows, plan.streamed,
                              planes)
    assert smem == ft.kernel_smem_bytes(mode, dp) <= SMEM_MAX
    resident_fits = wide is not None and ft.sm90_smem_bytes(
        dp, row_bytes, 2, *narrow, planes=planes) <= SMEM_MAX
    assert plan.streamed is (not resident_fits)
    if plan.streamed:
        # every stage carries its query k-blocks; one more stage would not fit
        assert (plan.ks, plan.rows) == narrow
        assert plan.stages == ft.SM90_MAX_STAGES or ft.sm90_smem_bytes(
            dp, row_bytes, plan.stages + 2, *narrow, True, planes) > SMEM_MAX
    elif ft.sm90_smem_bytes(dp, row_bytes, 4, *wide, planes=planes) <= SMEM_MAX:
        assert (plan.ks, plan.rows) == wide and plan.stages >= 4
    else:
        assert (plan.ks, plan.rows) == narrow
    geom = ft.sm90_geometry(mode, 600, dp, 132)
    assert geom.dq % 64 == 0 and 0 <= geom.dq - dp < 64
    assert (geom.ks, geom.rows, geom.stages, geom.streamed) == plan
    assert geom.n_qb == 10 and geom.per_group == 13
    if d == 768:
        assert plan == {"K1": (2, 128, 8, False), "K1-bf16": (1, 256, 4, False),
                        "K5": (2, 128, 4, False), "K6": (1, 128, 4, False),
                        "K6-bf16": (1, 256, 4, False), "K4-bf16": (1, 128, 6, True)}[mode]
    if d >= 2048:
        assert plan.streamed


@pytest.mark.parametrize("d", [16, 768, 832, 848, 896, 2048, 4096])
def test_k4_bf16_streams_its_planes_at_every_depth(d):
    """K4 over bf16 rows has no resident plan: resident, its two query
    planes (16 KB per 64 deep) would leave at d = 768 room for 4 ring
    stages of [64 rows x 64 deep] bf16 or 2 of 128 rows (32 KB of rows in
    flight), and would not fit beside 2 stages of 64 rows past d = 832 (13
    blocks; 14 from d = 833, which the store pads to 848). Streamed, a
    stage carries a 128-row k-block (16 KB) and both planes' k-blocks (16
    KB), so 6 stages fit at every depth: 96 KB of rows in flight. The
    arithmetic: 1 KB slack + planes + ring + 520 B of maxima, scales and
    flag + 8 B a barrier."""
    plan = ft.sm90_plan("K4-bf16", d)
    assert plan == (1, 128, 6, True)
    assert ft.kernel_smem_bytes("K4-bf16", d) == 1024 + 6 * 32768 + 520 + 13 * 8 <= SMEM_MAX
    assert 1024 + 8 * 32768 + 520 + 17 * 8 > SMEM_MAX
    nk = -(-d // 64)
    resident_64 = 1024 + nk * 2 * 8192 + 2 * 8192 + 520 + 5 * 8
    assert (resident_64 <= SMEM_MAX) is (d <= 832)
    if d == 768:
        assert 1024 + 12 * 2 * 8192 + 4 * 8192 + 520 + 9 * 8 <= SMEM_MAX
        assert 1024 + 12 * 2 * 8192 + 2 * 16384 + 520 + 5 * 8 <= SMEM_MAX
        assert 1024 + 12 * 2 * 8192 + 6 * 8192 + 520 + 13 * 8 > SMEM_MAX


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_query_planes_equal_jax_split(seed):
    """The K4 wrapper's query split over bf16 rows (``query_planes``) is
    JAX's (``otters_tpu/ops/pallas_topk.py`` at prec="high": qh =
    q.astype(bf16), ql = (q - qh.astype(f32)).astype(bf16)) bit for bit,
    on normal values, values a bf16 ulp apart, exact bf16 ties (half-way
    between two bf16 values: round to even, both ways), their neighbours
    one f32 ulp away, tiny, huge and zero values."""
    rng = np.random.default_rng(seed)
    b, d = 7, 100
    q = rng.normal(size=(b, d)).astype(np.float32)
    base = rng.normal(size=d).astype(np.float32)
    bits = base.view(np.uint32) & np.uint32(0xFFFF0000)  # exact bf16 values
    tie = (bits | np.uint32(0x8000)).view(np.float32)    # half-way to the next bf16
    q[1] = tie
    q[2] = np.nextafter(tie, np.float32(np.inf))
    q[3] = np.nextafter(tie, np.float32(-np.inf))
    q[4] = bits.view(np.float32)
    q[5] = q[0] * np.float32(1e-30)
    q[6, : d // 2] = q[0, : d // 2] * np.float32(1e30)
    q[6, d // 2 :] = 0.0
    planes = ft.query_planes(torch.from_numpy(q))
    qh = jnp.asarray(q).astype(jnp.bfloat16)
    ql = (jnp.asarray(q) - qh.astype(jnp.float32)).astype(jnp.bfloat16)
    want = np.concatenate([np.asarray(qh.astype(jnp.float32)),
                           np.asarray(ql.astype(jnp.float32))])
    got = planes.float().numpy()
    assert planes.dtype == torch.bfloat16 and planes.shape == (2 * b, d)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a tie rounds to even: both directions occur
    assert {bool(x) for x in (got[1] > q[1])} == {True, False}


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
