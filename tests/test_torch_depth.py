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
  ``pallas_ok``) would send a shape whose kernel does not fit a block's
  shared memory to the scan program before any launch, and count it; every
  kernel (K1, K2, K5, K6, K4 and K3 over their row types) takes any depth
  through the deep-row plan of ``csrc/cert_scan_sm90.cuh``, mirrored by
  ``sm90_plan`` (the card tests hold the mirror against the C side), so
  the route is held here by a refusing check; K4 streams its two query
  planes and K3 its f32 query block at every depth.
- The f32-row fragment order of K6 and K4 (``f32_query_perm``), replayed;
  the query planes of K4 (``query_planes``; over f32 rows after the
  fragment permutation) against JAX's split.
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
    ("K2", 2976, True), ("K2", 2992, True), ("K2", 3072, True), ("K2", 8192, True),
    ("K1", 2048, True), ("K1-bf16", 2048, True), ("K5", 2048, True), ("K6", 2048, True),
    ("K1", 8192, True), ("K5", 4096, True), ("K6", 4096, True),
    ("K3", 4096, True), ("K4", 4096, True), ("K4-bf16", 4096, True), ("K3-bf16", 4096, True),
    ("K6-bf16", 100, True), ("K2", 100, True),
    ("K4", 100, True), ("K4", 2048, True), ("K4", 8192, True)])
def test_shape_check_routes_only_what_cannot_fit(mode, d, takes):
    """Every kernel runs on the Hopper scan and takes any depth: K1, K2,
    K5 and K6 over f32 and bf16 rows through their resident or deep-row
    plans, K4 and K3 stream their query blocks at every depth."""
    assert ft.kernel_takes(mode, d) is takes
    assert (ft.kernel_smem_bytes(mode, ts.pad_depth(d)) <= SMEM_MAX) is takes


@pytest.mark.parametrize("case", ["K6-bf16", "K2"])
def test_meta_routes_deep_rows_to_the_scan_program(case, monkeypatch):
    """A 3,072-deep int8 store queried uncertified (K2, on the Hopper
    scan's resident plan with two ring stages) and a 2,048-deep bf16 store at precision "default" (K6 over
    bf16 rows, on the deep-row plan) take the kernel's wrapper with nothing
    routed; a check that refuses the shape sends the same query to the scan
    program, counted, with no kernel call. Both answers are equal (the
    kernel here through its plain version)."""
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
    assert ft.kernel_takes(case, d)
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
    3,072-deep int8 VecStore (K2) takes the kernel's wrapper with nothing
    routed, and a refusing check sends it to the scan program, counted,
    with the same answer."""
    use_fused_path(monkeypatch, direct_limit=1 << 12)
    rng = np.random.default_rng(4)
    n, d = 1024, 3072
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    store = tx.VecStore(d, dtype="int8", device="cpu")
    store.add_vectors(v)
    calls = _route("direct", monkeypatch)
    ft.reset_launches()
    kernel = store.query(q, tx.Metric.Cosine).take(10).collect()
    assert ft.kernel_takes.routed == 0 and calls == ["binmax_plain"]
    refuse = lambda mode, d: False  # noqa: E731
    refuse.routed = 0
    monkeypatch.setattr(ft, "kernel_takes", refuse)
    res = store.query(q, tx.Metric.Cosine).take(10).collect()
    assert refuse.routed == 5 and calls == ["binmax_plain"]
    assert [r.index for r in res] == [r.index for r in kernel]
    np.testing.assert_allclose([r.score for r in res], [r.score for r in kernel],
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the sm90 plans (the C side's sm90::plan_for, cert_scan_sm90.cuh)
# ---------------------------------------------------------------------------

DEPTHS = [16, 100, 768, 1392, 1536, 2048, 3072, 4096, 8192]
SM90_MODES = ["K1", "K1-bf16", "K2", "K3", "K3-bf16", "K5", "K6", "K6-bf16", "K4", "K4-bf16",
              "k_mm", "k_mm_bins"]


@pytest.mark.parametrize("mode", SM90_MODES)
@pytest.mark.parametrize("d", DEPTHS)
def test_sm90_plan_fits_every_depth(mode, d):
    """An even ring of at least 2 stages within 232,448 B at every depth;
    the query block (of every query plane) is streamed exactly when the
    resident block would leave fewer than 2 stages of the narrow shape, or
    always for a mode with no resident plan (K3, K4, the probes k_mm /
    k_mm_bins on K3's); at d = 768 K1 keeps its plans, K2 / K5 / K6 /
    K6-bf16 take their wide shapes, K4 its 4 streamed stages of 128 f32
    rows and K4-bf16 its 6 of 128 bf16 rows, both with both planes, K3
    and the FFMA probes 4 streamed stages of 256 f32 rows and K3-bf16 6 of
    128 bf16 rows, with the f32 queries. K2's 128-deep int8 query k-blocks (8 KB) stay
    resident up to d = 3,072 (two stages of the narrow shape there) and are
    streamed at 8,192; the other resident plans stream from d = 2,048."""
    dp = ts.pad_depth(d)
    row_bytes, planes, wide, narrow, q_bytes = ft.SM90_SHAPES[mode]
    plan = ft.sm90_plan(mode, dp)
    assert plan.stages >= 2 and plan.stages % 2 == 0 and plan.stages <= ft.SM90_MAX_STAGES
    smem = ft.sm90_smem_bytes(dp, row_bytes, plan.stages, plan.ks, plan.rows, plan.streamed,
                              planes, q_bytes)
    assert smem == ft.kernel_smem_bytes(mode, dp) <= SMEM_MAX
    resident_fits = wide is not None and ft.sm90_smem_bytes(
        dp, row_bytes, 2, *narrow, planes=planes, q_bytes=q_bytes) <= SMEM_MAX
    assert plan.streamed is (not resident_fits)
    if plan.streamed:
        # every stage carries its query k-blocks; one more stage would not fit
        assert (plan.ks, plan.rows) == narrow
        assert plan.stages == ft.SM90_MAX_STAGES or ft.sm90_smem_bytes(
            dp, row_bytes, plan.stages + 2, *narrow, True, planes, q_bytes) > SMEM_MAX
    elif ft.sm90_smem_bytes(dp, row_bytes, 4, *wide, planes=planes, q_bytes=q_bytes) <= SMEM_MAX:
        assert (plan.ks, plan.rows) == wide and plan.stages >= 4
    else:
        assert (plan.ks, plan.rows) == narrow
    kd = ft.kblock_depth(q_bytes)
    assert kd == (128 if mode == "K2" else 64)
    geom = ft.sm90_geometry(mode, 600, dp, 132)
    assert geom.dq % kd == 0 and 0 <= geom.dq - dp < kd
    assert (geom.ks, geom.rows, geom.stages, geom.streamed) == plan
    assert geom.n_qb == 10 and geom.per_group == 13
    if d == 768:
        assert plan == {"K1": (2, 128, 8, False), "K1-bf16": (1, 256, 4, False),
                        "K2": (1, 256, 4, False), "K3": (1, 256, 4, True),
                        "K3-bf16": (1, 128, 6, True), "k_mm": (1, 256, 4, True),
                        "k_mm_bins": (1, 256, 4, True),
                        "K5": (2, 128, 4, False), "K6": (1, 128, 4, False),
                        "K6-bf16": (1, 256, 4, False), "K4": (1, 128, 4, True),
                        "K4-bf16": (1, 128, 6, True)}[mode]
    if mode == "K2":
        assert plan.streamed is (d > 3072)
        if d == 3072:
            assert plan == (1, 128, 2, False)
    elif d >= 2048:
        assert plan.streamed


@pytest.mark.parametrize("d", [16, 100, 768, 2048, 3072, 8192])
def test_k3_streams_its_queries_at_every_depth(d):
    """K3 has no resident plan: its f32 query block (16 KB per 64 deep)
    would take 192 KB at d = 768. A stage carries one 128-byte box of rows
    and the 64 queries' f32 of the same depth (one or two 128-byte boxes
    of 32 deep): over f32 rows 256 rows (32 KB, 32 deep) and 8 KB of
    queries, 4 stages; over bf16 rows 128 rows (16 KB, 64 deep) and 16 KB
    of queries, 6 stages; 128 and 96 KB of rows in flight at every depth.
    The probes k_mm / k_mm_bins take K3's plan over f32 rows. The C side's
    f32_binmax_smem_bytes / f32_binmax_bf16_smem_bytes /
    probe_mm*_smem_bytes, mirrored (the card test holds them equal). The
    arithmetic: 1 KB slack + ring + 520 B of maxima, scales and flag + 8 B
    a barrier. The queries stream at every depth (the stored depth of 100
    is 112)."""
    dp = ts.pad_depth(d)
    for mode, row_bytes, rows, stages in (("K3", 4, 256, 4), ("K3-bf16", 2, 128, 6),
                                          ("k_mm", 4, 256, 4), ("k_mm_bins", 4, 256, 4)):
        assert ft.stage_depth(row_bytes, 4) == 128 // row_bytes
        stage = rows * 128 + 64 * (128 // row_bytes) * 4
        assert stage == {4: 40960, 2: 32768}[row_bytes]
        assert ft.sm90_plan(mode, dp) == (1, rows, stages, True)
        assert ft.kernel_smem_bytes(mode, dp) == 1024 + stages * stage + 520 \
            + (2 * stages + 1) * 8 <= SMEM_MAX
        assert 1024 + (stages + 2) * stage + 520 + (2 * stages + 5) * 8 > SMEM_MAX
        geom = ft.sm90_geometry(mode, 256, dp, 132)
        assert (geom.planes, geom.n_qb, geom.per_group, geom.dq) == (1, 4, 33, -(-dp // 64) * 64)
        assert geom.streamed and geom.smem == ft.kernel_smem_bytes(mode, dp)


@pytest.mark.parametrize("d", [16, 768, 2048, 3072, 8192])
def test_k2_plan_mirrors_the_kernel(d):
    """K2's k-blocks are 128 int8 codes deep, 128 B a row as a bf16 k-block
    of 64: 8 KB per resident query k-block and 128 B a row of a stage. At
    d = 768 the resident block (48 KB) leaves 4 stages of 256 rows (32 KB
    each); at 3,072 (192 KB) 2 stages of 128 rows; at 8,192 the query
    k-blocks ride in the stages. The arithmetic: 1 KB slack + resident
    block + ring + 520 B of maxima, scales and flag + 8 B a barrier."""
    nk = -(-d // 128)
    plan = ft.sm90_plan("K2", d)
    if plan.streamed:
        want = 1024 + plan.stages * (plan.rows * 128 + 8192) + 520 + (2 * plan.stages + 1) * 8
    else:
        want = 1024 + nk * 8192 + plan.stages * plan.ks * plan.rows * 128 + 520 \
            + (2 * plan.stages + 1) * 8
    assert ft.kernel_smem_bytes("K2", d) == want <= SMEM_MAX
    assert plan == {16: (1, 256, 6, False), 768: (1, 256, 4, False),
                    2048: (1, 128, 6, False), 3072: (1, 128, 2, False),
                    8192: (1, 128, 8, True)}[d]


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


@pytest.mark.parametrize("d", [16, 768, 832, 848, 896, 2048, 4096])
def test_k4_streams_its_planes_at_every_depth(d):
    """K4 over f32 rows has no resident plan either. Its rows land as f32
    and are split in the kernel, so a k-block holds 4 bytes a row element,
    as the probe k_planes' two bf16 row planes do (the same plan). Resident,
    the two query planes (16 KB per 64 deep) would take 192 KB at d = 768
    and leave room for 2 ring stages of [64 rows x 64 deep] f32 (32 KB of
    rows in flight) and none of 128 rows. Streamed, a stage carries a
    128-row k-block (32 KB) and both planes' k-blocks (16 KB), so 4 stages
    fit at every depth: 128 KB of rows in flight (6 stages of 64 rows, 32
    KB each, would hold 96 KB). The arithmetic: 1 KB slack + planes + ring
    + 520 B of maxima, scales and flag + 8 B a barrier."""
    plan = ft.sm90_plan("K4", d)
    assert plan == (1, 128, 4, True) == ft.sm90_plan("k_planes", d)
    stage = 128 * 64 * 4 + 2 * 8192
    assert stage == 49152
    assert ft.kernel_smem_bytes("K4", d) == 1024 + 4 * stage + 520 + 9 * 8 <= SMEM_MAX
    assert ft.kernel_smem_bytes("k_planes", d) == ft.kernel_smem_bytes("K4", d)
    assert 1024 + 6 * stage + 520 + 13 * 8 > SMEM_MAX
    narrow = 64 * 64 * 4 + 2 * 8192
    assert ft.sm90_smem_bytes(d, 4, 6, 1, 64, True, 2) == 1024 + 6 * narrow + 520 + 13 * 8 \
        <= SMEM_MAX < 1024 + 8 * narrow + 520 + 17 * 8
    nk = -(-d // 64)
    if d == 768:
        assert 1024 + nk * 2 * 8192 + 2 * 16384 + 520 + 5 * 8 <= SMEM_MAX
        assert 1024 + nk * 2 * 8192 + 2 * 32768 + 520 + 5 * 8 > SMEM_MAX
    geom = ft.sm90_geometry("K4", 256, d, 132)
    assert (geom.planes, geom.n_qb, geom.per_group) == (2, 4, 33)


@pytest.mark.parametrize("b,d", [(70, 100), (64, 768), (1, 16), (130, 2048)])
def test_k4_pad_queries_equal_jax_split(b, d):
    """K4's query operands over f32 rows (``sm90_pad_queries`` with
    ``f32_query_perm``): the batch padded to whole 64-query blocks, the
    depth to a multiple of 64 with zeros, each 64-deep block permuted to
    the fragment order, then split into qh and ql stacked, bit for bit
    JAX's split (``jnp.astype``, as ``otters_tpu/ops/pallas_topk.py`` at
    prec="high") of the permuted, padded queries; the per-query operands
    padded with zeros (q_ok = 0 keeps padded lanes out of every bin max)."""
    rng = np.random.default_rng(d + b)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[0, : d // 2] *= np.float32(1e-30)  # subnormal low planes
    q_ok = np.ones(b, np.float32)
    geom = ft.sm90_geometry("K4", b, ts.pad_depth(d), 132)
    perm = ft.f32_query_perm(geom.dq)
    qk, (ok,) = ft.sm90_pad_queries(torch.from_numpy(q), (torch.from_numpy(q_ok),), geom, perm)
    n = geom.n_qb * 64
    padded = np.zeros((n, geom.dq), np.float32)
    padded[:b, :d] = q
    padded = padded[:, perm.numpy()]
    qh = jnp.asarray(padded).astype(jnp.bfloat16)
    ql = (jnp.asarray(padded) - qh.astype(jnp.float32)).astype(jnp.bfloat16)
    want = np.concatenate([np.asarray(qh.astype(jnp.float32)),
                           np.asarray(ql.astype(jnp.float32))])
    assert qk.dtype == torch.bfloat16 and qk.shape == (2 * n, geom.dq) and qk.is_contiguous()
    np.testing.assert_array_equal(qk.float().numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(ok.numpy(), np.r_[q_ok, np.zeros(n - b, np.float32)])


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
