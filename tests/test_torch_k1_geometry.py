"""K1's launch geometry, shared-memory plan and query layout, on the CPU.

The Hopper kernel (``csrc/cert_cos_binmax.cu`` on ``csrc/cert_scan_sm90.cuh``)
runs only on the card; what surrounds it is Python that these tests reach:
``sm90_geometry`` (query blocks and the persistent grid), ``sm90_plan`` /
``sm90_smem_bytes`` (the ring, mirroring the C side's ``smem_bytes``;
``tests/test_torch_kernels_cuda.py`` checks the two agree on the card),
``sm90_pad_queries`` and ``k1_query_perm`` (the int8-row fragment order),
and over int8 rows at more than one query block the pair plan (a CTA of
128 queries) with its caller-side f16 rewrite (``f16_queries``).
The kernel's CTA -> (query block, bin slots) mapping is replayed here from
the geometry; so are the two-plane query layout of K4 over bf16 rows
(``query_planes``), K4's pair plan over f32 rows (a CTA of 128 queries)
and K2's int8 query blocks (128-deep k-blocks, no permutation). The other
sm90 kernels' plans (K2, K3, K5, K6, K4) and the deep-row plan:
``tests/test_torch_depth.py``.
"""

import numpy as np
import pytest
import torch

from otters_tpu_torch.ops import fused_topk as ft

SMEM_MAX = 232448
N_SMS = 132  # an H100 SXM


def _walk(geom, n_surv):
    """The (query group, survivor slot) pairs the kernel's CTAs visit: CTA
    c takes query group c % n_qp (a block of 64 queries, or a pair of them
    on K4's pair plan) and slots p, p + per_group, ... with p = c // n_qp."""
    seen = []
    for cta in range(geom.n_ctas):
        p, qblk = divmod(cta, geom.n_qp)
        seen += [(qblk, slot) for slot in range(p, n_surv, geom.per_group)]
    return seen


@pytest.mark.parametrize("row_bytes", [1, 2], ids=["int8", "bf16"])
@pytest.mark.parametrize("d", [16, 96, 768, 1392])
@pytest.mark.parametrize("b", [1, 64, 70, 256, 300, 512, 600, 1024])
def test_k1_geometry_covers_the_batch(b, d, row_bytes):
    """Over bf16 rows, and over int8 rows at one query block, 64 queries a
    CTA; over int8 rows at more than one block the pair plan (128 queries a
    CTA, the queries rewritten to f16 pair by pair). Either way every
    (query group, live bin) pair is computed once, padded lanes carry q_ok
    = 0 and zero queries, and the kernel's query operand gives back the
    queries."""
    mode = "K1" if row_bytes == 1 else "K1-bf16"
    geom = ft.sm90_geometry(mode, b, d, N_SMS)
    pair = row_bytes == 1 and b > 64
    assert geom.wide is geom.f16 is pair
    assert geom.queries == (ft.PAIR_QUERIES if pair else ft.QUERY_BLOCK)
    assert geom.smem == ft.sm90_smem_bytes(d, row_bytes, geom.stages, geom.ks, geom.rows,
                                           geom.streamed, resident=geom.resident,
                                           queries=geom.queries)
    assert geom.smem <= SMEM_MAX
    assert geom.stages >= 2 and (pair or geom.stages % 2 == 0)
    plan = ft.sm90_plan(mode, d, b)
    assert (geom.ks, geom.rows, geom.stages, geom.streamed, geom.resident) == plan
    if pair:
        # the pair's query block: its first 6 k-blocks resident (all of
        # them below d = 384), the rest riding in 256-row stages
        assert geom.streamed and geom.resident == min(-(-d // 64), 6)
    else:
        # the query block stays resident up to d = 1,392 (over bf16 rows
        # at 1,392 its first 8 k-blocks: the split plan)
        assert geom.resident == (8 if (d, row_bytes) == (1392, 2) else -(-d // 64))
    assert geom.split is plan.split is ((d, row_bytes) == (1392, 2))
    assert geom.n_qb == -(-b // ft.QUERY_BLOCK)
    assert geom.n_qp == (-(-geom.n_qb // 2) if pair else geom.n_qb)
    assert geom.dq % 64 == 0 and 0 <= geom.dq - d < 64
    # the persistent grid: an equal share of the card per query group
    assert geom.per_group == max(1, N_SMS // geom.n_qp)
    assert geom.n_ctas <= max(N_SMS, geom.n_qp)
    # every (query group, live bin) pair is computed exactly once
    n_surv = 37
    seen = _walk(geom, n_surv)
    assert len(seen) == len(set(seen)) == geom.n_qp * n_surv
    assert {q for q, _ in seen} == set(range(geom.n_qp))
    # padded lanes carry q_ok = 0 and zero queries
    rng = np.random.default_rng(b + d)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).bfloat16()
    perm = ft.k1_query_perm(geom.dq) if row_bytes == 1 else None
    qk, (qi, qo, *f16) = ft.sm90_pad_queries(q, (torch.ones(b), torch.ones(b)), geom, perm)
    assert qk.shape == (geom.n_qp * geom.queries, geom.dq) and qk.is_contiguous()
    assert qo[:b].eq(1).all() and qo[b:].eq(0).all() and qi[b:].eq(0).all()
    assert qk[b:].eq(0).all()
    perm = ft.k1_query_perm(geom.dq) if row_bytes == 1 else torch.arange(geom.dq)
    back = qk[:b, torch.argsort(perm)][:, :d]
    if pair:
        # every pair of these queries takes f16 products: f16 bits of each
        # query times 2^s, and 2^-s gives the bf16 query back exactly
        unscale, flags = f16
        assert flags.dtype == torch.int32 and flags.tolist() == [1] * geom.n_qp
        back = (back.view(torch.float16).float() * unscale[:b, None]).bfloat16()
    else:
        assert not f16
    assert torch.equal(back, q)


def _pair_s8_plan(d):
    """The C side's pair plan over int8 rows (``sm90::pair_s8_resident``,
    ``pair_s8_stages``, ``pair_s8_smem_bytes``): the head of the pair's
    query block (16 KB a k-block) the largest that leaves 4 stages of 256
    int8 rows (16 KB) and the pair's query k-block (16 KB), then the most
    stages that fit; 1 KB of slack, 1,032 B of maxima (half of it unused),
    8 B a barrier."""
    def smem(s, r):
        return 1024 + r * 16384 + s * 32768 + 2 * 128 * 4 + 8 + (2 * s + 1) * 8

    r = -(-d // 64)
    while r > 0 and smem(4, r) > SMEM_MAX:
        r -= 1
    s = 12
    while s > 2 and smem(s, r) > SMEM_MAX:
        s -= 1
    return (1, 256, s, True, r), smem(s, r)


@pytest.mark.parametrize("d", [16, 96, 384, 768, 1392])
@pytest.mark.parametrize("b", [1, 64, 65, 128, 192, 256, 600, 1024])
def test_k1_pair_geometry_covers_the_batch(b, d):
    """K1 over int8 rows takes the pair plan from two query blocks (b >=
    65; ``sm90_queries``), and the 64-query plan below: a CTA holds a pair
    of query blocks (the batch padded to whole pairs, q_ok = 0 lanes: a
    whole block where the count of blocks is odd, 63 lanes at b = 65),
    ``per_group`` = 132 // n_qp CTAs a pair (66 at b = 256), each (pair,
    live bin) computed once; its ring mirrors the C side's pair plan at
    every depth (at d = 768: 6 query k-blocks resident, 4 stages,
    231,504 B)."""
    geom = ft.sm90_geometry("K1", b, d, N_SMS)
    n_qb = -(-b // ft.QUERY_BLOCK)
    pair = b >= ft.K1_PAIR_FROM == 65
    assert ft.sm90_queries("K1", b) == geom.queries == (128 if pair else 64)
    assert geom.wide is pair and ft.sm90_queries("K1-bf16", b) == 64
    if not pair:
        assert (geom.ks, geom.rows, geom.stages, geom.streamed, geom.resident) \
            == ft.sm90_plan("K1", d, b)
        return
    plan, smem = _pair_s8_plan(d)
    assert ft.sm90_plan("K1", d, b) == plan and geom.smem == smem <= SMEM_MAX
    assert geom.smem == ft.kernel_smem_bytes("K1", d, b)
    if d == 768:
        assert (plan, smem) == ((1, 256, 4, True, 6), 231504)
    assert geom.n_qp == -(-n_qb // 2) and geom.per_group == max(1, N_SMS // geom.n_qp)
    assert geom.n_ctas == geom.n_qp * geom.per_group <= max(N_SMS, geom.n_qp)
    if b == 256:
        assert (geom.n_qp, geom.per_group) == (2, 66)
    n_surv = 31
    seen = _walk(geom, n_surv)
    assert len(seen) == len(set(seen)) == geom.n_qp * n_surv
    rng = np.random.default_rng(b * 5 + d)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).bfloat16()
    qk, (qo, unscale, flags) = ft.sm90_pad_queries(q, (torch.ones(b),), geom,
                                                   ft.k1_query_perm(geom.dq))
    rows = geom.n_qp * 128
    assert qk.shape == (rows, geom.dq) and qo.shape == unscale.shape == (rows,)
    assert rows - b < 128 and flags.shape == (geom.n_qp,)
    if n_qb % 2:  # the odd block's pad: a whole block of zero lanes
        assert rows - n_qb * 64 == 64
    assert qo[:b].eq(1).all() and qo[b:].eq(0).all() and qk[b:].eq(0).all()
    assert unscale[b:].eq(1).all()  # zero queries: s = 0


def _f16_rule(q16, group):
    """``sm90::queries_to_f16``'s rule, element by element in numpy: per
    query the largest magnitude's bf16 bits m, s = 141 - (m >> 7) (0 for m
    = 0), ok = m < 0x7f80 and s <= 126; per element x (f32 of its bf16) the
    f16 h of x 2^s, and the group takes f16 if every query is ok and every
    h = x 2^s and h 2^-s = x in f32 -> (f16 bits, 2^-s (1 where not ok),
    flags)."""
    bits = q16.view(np.uint16)
    x = (bits.astype(np.uint32) << 16).view(np.float32)
    m = (bits & 0x7FFF).max(axis=1).astype(np.int64)
    s = np.where(m == 0, 0, 141 - (m >> 7))
    ok = (m < 0x7F80) & (s <= 126)
    s = np.where(ok, s, 0)
    up = np.ldexp(np.float32(1), s).astype(np.float32)[:, None]
    down = np.ldexp(np.float32(1), -s).astype(np.float32)
    y = (x * up).astype(np.float32)
    h = y.astype(np.float16)
    hf = h.astype(np.float32)
    good = (hf == y) & ((hf * down[:, None]).astype(np.float32) == x)
    n = q16.shape[0] // group
    flags = good.reshape(n, -1).all(1) & ok.reshape(n, group).all(1)
    return h.view(np.uint16), down, flags


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "wide", "zero", "nan", "subnormal"])
def test_k1_f16_queries_follow_the_rule(kind):
    """The caller-side f16 rewrite of the pair plan (``f16_queries``)
    against the rule of ``sm90::queries_to_f16`` written out in numpy:
    every query scaled by 1e-15 or 1e15 (f16 products at about 2^62 or
    2^-37), one query's even elements scaled by 2^-40 (its magnitudes span
    more than f16's range: its pair keeps bf16 products, the other pair
    f16), a zero query, a NaN element, a query near 1e-36 (s > 126). The
    scales, the f16 values of every pair that takes them and the pair
    flags are the rule's; a pair that does not keeps its bf16 queries."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(256, 128)).astype(np.float32)
    q *= {"tiny": 1e-15, "huge": 1e15}.get(kind, 1.0)
    if kind == "wide":
        q[3, ::2] *= 2.0 ** -40
    elif kind == "zero":
        q[200] = 0.0
    elif kind == "nan":
        q[130, 7] = np.nan
    elif kind == "subnormal":
        q[5] *= 1e-36
    qb = torch.from_numpy(q).bfloat16()
    got, unscale, flags = ft.f16_queries(qb.clone())
    bits, down, want_flags = _f16_rule(qb.view(torch.int16).numpy(), ft.PAIR_QUERIES)
    assert flags.tolist() == want_flags.astype(int).tolist()
    assert want_flags.tolist() == {"wide": [False, True], "nan": [True, False],
                                   "subnormal": [False, True]}.get(kind, [True, True])
    np.testing.assert_array_equal(unscale.numpy().view(np.uint32), down.view(np.uint32))
    for c, f16 in enumerate(want_flags):
        rows = slice(128 * c, 128 * (c + 1))
        want = bits[rows] if f16 else qb[rows].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got[rows].view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("d,row_bytes,b,plan", [
    (768, 1, 1, (2, 128, 8, False, 12)), (768, 2, 1, (1, 256, 4, False, 12)),
    (1392, 1, 1, (1, 128, 6, False, 22)), (1392, 2, 1, (1, 256, 4, True, 8)),
    (96, 2, 1, (1, 256, 6, False, 2)), (1536, 1, 1, (1, 128, 4, False, 24)),
    (1536, 2, 1, (1, 256, 4, True, 8)), (768, 1, 256, (1, 256, 4, True, 6)),
    (1392, 1, 65, (1, 256, 4, True, 6)), (96, 1, 600, (1, 256, 6, True, 2)),
    (768, 2, 256, (1, 256, 4, False, 12))])
def test_k1_stage_plan(d, row_bytes, b, plan):
    """int8 rows at one query block: two 64-deep k-blocks of 128 rows a
    stage; bf16 rows: one of 256 rows; one of 128 rows when fewer than 4
    stages would fit. Over bf16 rows at d = 1,392 and 1,536 one of 128 rows
    would leave 2 stages beside the query block (32 KB of rows in flight):
    the split plan keeps its first 8 k-blocks resident and 4 stages of 256
    rows with room for a query k-block each (128 KB of rows in flight).
    Over int8 rows at more than one query block the pair plan: one k-block
    of 256 rows and the pair's query k-block a stage (32 KB), 4 stages
    beside the first 6 query k-blocks of the pair (16 KB each), all of them
    at d = 96 (6 stages)."""
    mode = "K1" if row_bytes == 1 else "K1-bf16"
    assert ft.sm90_plan(mode, d, b) == plan


@pytest.mark.parametrize("dq", [64, 128, 768, 1408])
def test_k1_query_perm_matches_the_fragment_order(dq):
    """Replays how a consumer thread builds its int8 A fragment: lane
    t = lane % 4 loads row bytes 16 t .. 16 t + 15 of a 64-deep block; byte
    e of word kk goes to register a0 (e = 0, 1: depth 16 kk + 2 t + e) or
    a2 (e = 2, 3: depth 16 kk + 2 t + 8 + e - 2) of the m16n8k16 layout.
    The query element multiplying stored byte p must sit at that depth."""
    perm = ft.k1_query_perm(dq)
    assert sorted(perm.tolist()) == list(range(dq))
    for c in range(0, dq, 64):
        for t in range(4):
            for kk in range(4):
                for e in range(4):
                    p = 16 * t + 4 * kk + e
                    depth = 16 * kk + 2 * t + (e if e < 2 else 8 + e - 2)
                    assert perm[c + depth] == c + p
    # the product the kernel forms equals the plain dot
    rng = np.random.default_rng(dq)
    v = rng.integers(-127, 128, size=(5, dq)).astype(np.float64)
    q = rng.normal(size=(3, dq))
    a = v[:, perm.numpy()]  # A as wgmma sees it: depth j holds row byte perm[j]
    np.testing.assert_allclose(a @ q[:, perm.numpy()].T, v @ q.T, rtol=1e-12)


@pytest.mark.parametrize("d", [16, 112, 768, 832, 896])
@pytest.mark.parametrize("b", [1, 64, 70, 600])
def test_k4_bf16_planes_cover_the_batch(b, d):
    """K4 over bf16 rows: the f32 queries padded to whole query blocks and
    a depth multiple of 64, then split and stacked: rows [0, n_qb 64) hold
    qh, rows [n_qb 64, 2 n_qb 64) ql (the C side's plane p of query block c
    at rows p n_qb 64 + 64 c); padded lanes and columns are zero in both
    planes and carry q_ok = 0; qh + ql recovers each query to within a
    bf16 ulp of ql. The query blocks' planes share their CTAs (and ride in
    the ring stages at every depth)."""
    geom = ft.sm90_geometry("K4-bf16", b, d, N_SMS)
    assert geom.per_group == max(1, N_SMS // geom.n_qb)
    assert geom.streamed
    rng = np.random.default_rng(b * 1000 + d)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    assert geom.planes == 2
    qk, (qo,) = ft.sm90_pad_queries(q, (torch.ones(b),), geom)
    rows = geom.n_qb * ft.QUERY_BLOCK
    assert qk.dtype == torch.bfloat16 and qk.is_contiguous()
    assert qk.shape == (2 * rows, geom.dq)
    qh, ql = qk[:rows].float(), qk[rows:].float()
    assert qh[b:].eq(0).all() and ql[b:].eq(0).all()
    assert qh[:, d:].eq(0).all() and ql[:, d:].eq(0).all()
    assert qo[:b].eq(1).all() and qo[b:].eq(0).all()
    assert torch.equal(qh[:b, :d], q.bfloat16().float())
    assert torch.equal(ql[:b, :d], (q - q.bfloat16().float()).bfloat16().float())
    err = (qh[:b, :d] + ql[:b, :d] - q).abs()
    assert bool((err <= ql[:b, :d].abs() * 2.0**-8 + 1e-45).all())


@pytest.mark.parametrize("d", [16, 768, 2048])
@pytest.mark.parametrize("b", [1, 64, 65, 128, 192, 256, 600])
def test_k4_pair_geometry_covers_the_batch(b, d):
    """K4 over f32 rows at every batch size: the pair plan, each CTA
    holding a pair of query blocks (128 queries; the batch padded to whole
    pairs with zero lanes, q_ok = 0: at b <= 64 half the lanes, and a whole
    block where the count of blocks is odd), ``per_group`` = 132 // n_qp
    CTAs a pair (66 at b = 256), each (pair, live bin) computed once; the
    f32 queries padded to n_qp pairs, permuted to the fragment order and
    split into qh then ql (the C side's plane p of pair c at rows p n_qp
    128 + 128 c)."""
    geom = ft.sm90_geometry("K4", b, d, N_SMS)
    n_qb = -(-b // ft.QUERY_BLOCK)
    assert geom.n_qb == n_qb and geom.wide
    assert geom.queries == ft.PAIR_QUERIES == 128
    assert geom.n_qp == -(-n_qb // 2)
    assert geom.per_group == max(1, N_SMS // geom.n_qp)
    assert geom.n_ctas == geom.n_qp * geom.per_group <= max(N_SMS, geom.n_qp)
    assert (geom.stages, geom.smem) == (3, 198720)
    assert geom.smem == ft.sm90_smem_bytes(d, 4, geom.stages, 1, 128, True, 2,
                                           queries=geom.queries) <= SMEM_MAX
    if b == 256:
        assert (geom.n_qp, geom.per_group) == (2, 66)
    n_surv = 31
    seen = _walk(geom, n_surv)
    assert len(seen) == len(set(seen)) == geom.n_qp * n_surv
    rng = np.random.default_rng(b * 3 + d)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    perm = ft.f32_query_perm(geom.dq)
    qk, (qo,) = ft.sm90_pad_queries(q, (torch.ones(b),), geom, perm)
    rows = geom.n_qp * geom.queries
    assert rows - b < 128 and rows % 128 == 0
    if n_qb % 2:  # the odd block's pad: a whole block of zero lanes
        assert rows - -(-b // 64) * 64 == 64
    assert qk.shape == (2 * rows, geom.dq) and qk.dtype == torch.bfloat16
    assert qo[:b].eq(1).all() and qo[b:].eq(0).all() and qo.shape == (rows,)
    assert qk[b:rows].eq(0).all() and qk[rows + b:].eq(0).all()
    back = torch.argsort(perm)
    qh, ql = qk[:b, back][:, :d].float(), qk[rows : rows + b, back][:, :d].float()
    assert torch.equal(qh, q.bfloat16().float())
    assert torch.equal(ql, (q - qh).bfloat16().float())


@pytest.mark.parametrize("d", [112, 768, 3072, 8192])
@pytest.mark.parametrize("b", [1, 70, 256, 600])
def test_k2_geometry_covers_the_batch(b, d):
    """K2 on the Hopper scan: the query blocks and the persistent grid of
    K1, each (query block, live bin) pair computed once; the int8 queries
    padded to whole blocks and to a depth multiple of 128 (its k-block of
    128 int8 codes, 128 B a row) with zeros and no permutation (A and B are
    both read by descriptor from the same swizzled layout); the plan's
    shared memory within 232,448 B, resident up to d = 3,072 and streamed
    at 8,192."""
    geom = ft.sm90_geometry("K2", b, d, N_SMS)
    assert geom.smem == ft.sm90_smem_bytes(d, 1, geom.stages, geom.ks, geom.rows,
                                           geom.streamed, 1, 1) <= SMEM_MAX
    assert geom.stages >= 2 and geom.stages % 2 == 0
    assert geom.streamed is (d > 3072) and geom.planes == 1
    assert geom.n_qb == -(-b // ft.QUERY_BLOCK)
    assert geom.per_group == max(1, N_SMS // geom.n_qb)
    assert geom.dq % 128 == 0 and 0 <= geom.dq - d < 128
    n_surv = 29
    seen = _walk(geom, n_surv)
    assert len(seen) == len(set(seen)) == geom.n_qb * n_surv
    rng = np.random.default_rng(b * 7 + d)
    q = torch.from_numpy(rng.integers(-127, 128, size=(b, d)).astype(np.int8))
    qk, (qo,) = ft.sm90_pad_queries(q, (torch.ones(b),), geom)
    assert qk.dtype == torch.int8 and qk.is_contiguous()
    assert qk.shape == (geom.n_qb * 64, geom.dq)
    assert torch.equal(qk[:b, :d], q)
    assert qk[b:].eq(0).all() and qk[:, d:].eq(0).all()
    assert qo[:b].eq(1).all() and qo[b:].eq(0).all()
