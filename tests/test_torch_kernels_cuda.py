"""The Hopper kernels against their plain torch versions, on the card.

K1 (certified Cosine) over int8 and bfloat16 rows at b = 1 to 600 and d =
96 to 2048 (the deep-row plan), with its live-bin edge cases and queries
far from unit scale or too wide for f16, over int8 rows from b = 65 on the
pair plan (counted on ``wide_launches``; bit for bit the bin maxima of the
same queries launched one at a time, and its f16 rewrite on the card the
plain version's); K2 / K3 / K4 / K6 over int8 / f32
rows (K6 and K4 at b = 1 to 600, d = 100 to 2048 (K4 from d = 16), every
metric and filter; K4 with masked bins, NaN and inf rows, and rows small
enough that their low bf16 planes are subnormal; K2 at b = 1 to 600 and d
= 100 to 3072, every metric, Gt / Lte filters, its dots bit for bit past
2^24; K3 over f32 and bf16 rows at the same shapes against float64 and
with Eq filters); over bfloat16 rows K3,
K5 (the general certified fold, Dot and Euclid, at b = 1 to 600, d = 100
to 2048, with masked bins and NaN rows), and K4 and K6 on the Hopper scan
(b = 1 to 600, d = 16 to 2048; K4 streams its two query planes with the
rows; K4 over f32 rows on the pair plan, and 256 queries in one launch bit
for bit those of four launches of 64); K1-bf16, K5 and
K6-bf16 at d = 1,536 on the split plan (with
masked bins and NaN rows) and its launch counter; the shared-memory
figures of the depth route and the sm90 plans (the probes' too, the split
plan's depths too) against the C side, with K6 and K4 over f32 and bf16
rows and the probes launched at every depth there; the three profiling
probes (``profile_variants``) at b = 1 to 600 and d = 98 to 768, and every
dot of ``k_mm`` against float64. A depth that is not a multiple of 16 (d =
100) runs as the store pads it.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
torch: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``--noconftest`` skips ``tests/conftest.py``, which pins JAX to the CPU).

Tolerances: K2's int32 dots are exact in both versions, so the bin maxima
agree within 4 ulps (the epilogue multiplies are the same rounded ops, the
plain version's may be fused differently by torch); K3 sums in another
order than the plain f32 product, within d 2^-24 |q| |v|; K4 within
``high_precision_bound(d)`` |q| |v| (both are bf16x3 sums, of different
orders, each within the bound of the exact dot); K3 and K4 over bf16 rows
likewise. The certified scans sum exact bf16 products in f32 in another
order than the plain product: K1 within ``mixed_cert_eps(d)``, K5 within
``4 d 2^-24 |qh| max|v|`` (twice for Euclid) plus 4 ulps of the key. K6
sums the same exact bf16 products in another order than its plain
version: within ``d 2^-24 |qh| |vh|`` (Cosine: of the unit scores), as K3.
The probes: ``k_mm`` / ``k_mm_bins`` as K3, ``k_planes`` as K4.

Beside the kernels, torch paths are held on the card: the device Bloom
build against the host build bit for bit; the VPU metrics' programs
(direct, panel, scan_pruned) against the same store on the CPU (the same
indices; scores within rtol 1e-6, Hamming exactly); certified int8 queries
over string-filtered (hostmask), sorted, Z-ordered, tombstoned and appended
stores against the same stores on the CPU, and a store saved on the card
and loaded on the CPU (the same indices, scores within 1e-5); the
row-sharded stores over the card listed four times (``rows=4`` and ``rows=2,
batch=2``) against the same stores on a CPU mesh, each shard launching its
kernel (K1, K1-bf16, K2, K4, K5) once per query, and a sharded store saved
on the card and loaded on a CPU mesh; two processes sharing the card over
gloo (a ``rows=4`` mesh across them, ``parallel.init_distributed``) with K1
and K2 on each of their shards against a CPU mesh; and a cold / warm pair
of processes on a fresh ``OTTERS_AOT_CACHE`` (seven nvcc runs, then none).
"""

import ctypes

import numpy as np
import pytest
import torch

from otters_tpu_torch import profile_variants as pv
from otters_tpu_torch.ops import fused_topk as ft
from otters_tpu_torch.ops import scoring as sc
from otters_tpu_torch.types import Cmp, Metric


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _operands(mode, dev, *, n=40_000, d=128, b=70, seed=0, thr=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pad = sc.pad_rows(n)
    f32 = torch.randn((n_pad, d), generator=g, device=dev)
    f32[n:] = 0.0
    if mode == "K2":
        dv = sc.materialize_int8_slabs(lambda s, r: f32[s : s + r], n, d, 1 << 14, device=dev)
    else:
        dv = sc.materialize_f32_slabs(lambda s, r: f32[s : s + r], n, d, 1 << 14, device=dev)
    q = torch.randn((b, d), generator=g, device=dev)
    if mode == "K2":
        q, _, _ = sc._quantize_rows_int8(q)
    q_sq, q_inv = sc._query_norms(q.float())
    if mode == "K6":  # bf16-rounded queries, the f32 queries' norms
        q = q.bfloat16()
    n_bins = n_pad // ft.BIN
    alive = torch.rand(n_bins, generator=g, device=dev) < 0.6
    surv, n_surv = ft.survivor_bins(alive)
    rmask = (dv.valid & (torch.rand(n_pad, generator=g, device=dev) < 0.9)).float()
    return [q.contiguous(), dv.vectors, dv.inv_norms, dv.norms_sq, rmask, q_inv, q_sq,
            torch.ones(b, device=dev), torch.full((1,), thr, device=dev), surv, n_surv]


def _bf16_store(dev, g, n, d):
    n_pad = sc.pad_rows(n)
    f32 = torch.randn((n_pad, d), generator=g, device=dev)
    f32[n:] = 0.0
    return sc.materialize_from_device(f32, n_valid=n, dtype=torch.bfloat16)


def _bf16_operands(mode, dev, metric, *, n=40_000, d=128, b=70, seed=0, thr=0.0,
                   cmp=None):
    """Operands of a bf16-row mode over a bf16 store: the certified scans'
    (K1-bf16, K5) as the fused path sets them up, or K3 / K4's f32 queries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dv = _bf16_store(dev, g, n, d)
    q = torch.randn((b, d), generator=g, device=dev)
    n_pad = dv.vectors.shape[0]
    alive = torch.rand(n_pad // ft.BIN, generator=g, device=dev) < 0.6
    row_mask = torch.rand(n_pad, generator=g, device=dev) < 0.9
    thr_t = torch.tensor(thr, device=dev)
    if mode in ("K1-bf16", "K5"):
        return ft.cert_scan(mode, dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, q,
                            row_mask, thr_t, alive, metric=metric, cmp=cmp,
                            resid=dv.resid).ops
    q_sq, q_inv = sc._query_norms(q)
    if mode == "K6-bf16":
        q = q.bfloat16()
    surv, n_surv = ft.survivor_bins(alive)
    rmask = (dv.valid & row_mask).float()
    return [q, dv.vectors, dv.inv_norms, dv.norms_sq, rmask, q_inv, q_sq,
            torch.ones(b, device=dev), thr_t.reshape(1), surv, n_surv]


def _call(mode, args, metric, take_min, cmp, plain=False):
    if mode == "K1-bf16":
        fn = ft.cert_cos_binmax_plain if plain else ft.cert_cos_binmax_bf16
        return fn(*args, cmp)
    if mode == "K5":
        if plain:
            return ft.cert_fold_binmax_plain(*args, metric=metric, take_min=take_min, cmp=cmp)
        return ft.cert_fold_binmax(*args, metric, take_min, cmp)
    if plain:
        return ft.binmax_plain(mode, *args, metric=metric, take_min=take_min, cmp=cmp)
    return ft.KERNELS[mode](*args, metric, take_min, cmp)


def _tol(mode, args, metric):
    q, v = args[0].float(), args[1]
    d = q.shape[1]
    if mode == "K2":
        return 0.0
    if mode == "K1-bf16":
        return sc.mixed_cert_eps(d)
    if mode == "K5":
        base = 4 * d * 2.0**-24
    elif mode.startswith(("K3", "K6")):
        base = d * 2.0**-24
    else:
        base = sc.high_precision_bound(d)
    if metric is Metric.Cosine:
        return base
    # args[3]: nsq of the stored rows; K6's rounded rows are up to 2^-8
    # longer
    scale = float(q.norm(dim=1).max()) * float(args[3].max().sqrt()) * (1 + 2.0**-7)
    return base * scale * (2.0 if metric is Metric.Euclidean else 1.0)


CASES = [
    ("K2", Metric.Cosine, False, None, 0.0),
    ("K2", Metric.Cosine, False, Cmp.Gt, 0.05),
    ("K2", Metric.Cosine, True, Cmp.Lte, -0.05),
    ("K3", Metric.Cosine, False, Cmp.Gte, 0.05),
    ("K3", Metric.DotProduct, False, None, 0.0),
    ("K3", Metric.Euclidean, True, Cmp.Lt, 250.0),
    ("K4", Metric.Cosine, False, None, 0.0),
    ("K4", Metric.DotProduct, False, Cmp.Gt, 2.0),
    ("K4", Metric.Euclidean, True, None, 0.0),
    ("K6", Metric.Cosine, False, Cmp.Gt, 0.05),
    ("K6", Metric.DotProduct, False, None, 0.0),
    ("K6", Metric.Euclidean, True, Cmp.Lt, 250.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,metric,take_min,cmp,thr", CASES)
@pytest.mark.parametrize("d", [128, 100])
def test_kernel_matches_plain(mode, metric, take_min, cmp, thr, d):
    """At d = 100 the store pads its rows to 112 and the wrapper the
    queries."""
    dev = _device()
    args = _operands(mode, dev, d=d, thr=thr)
    fn = ft.KERNELS[mode]
    before = fn.launches
    got = fn(*args, metric, take_min, cmp)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ft.binmax_plain(mode, *args, metric=metric, take_min=take_min, cmp=cmp)
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w)
    assert bool(fin_w.any()) and not bool(fin_w.all())
    err = float((got[fin_w] - want[fin_w]).abs().max())
    if mode == "K2":
        scale = float(want[fin_w].abs().max())
        assert err <= 4 * float(np.spacing(np.float32(scale)))
    else:
        tol = _tol(mode, args, metric)
        if metric is Metric.Euclidean:
            tol += 4 * float(np.spacing(np.float32(float(want[fin_w].abs().max()))))
        assert err <= tol, (err, tol)


@pytest.mark.cuda
def test_k2_dots_are_bit_exact():
    """Unit norms, Dot metric, one unmasked row per bin: each bin max is
    that row's int32 dot, equal to an exact int64 product."""
    dev = _device()
    args = _operands("K2", dev, d=768, b=64, n=20_000)
    q8, v8 = args[0], args[1]
    n_pad = v8.shape[0]
    n_bins = n_pad // ft.BIN
    rows = torch.arange(n_bins, device=dev) * ft.BIN + 33
    rmask = torch.zeros(n_pad, device=dev)
    rmask[rows] = 1.0
    surv, n_surv = ft.survivor_bins(torch.ones(n_bins, dtype=torch.bool, device=dev))
    ones = torch.ones(n_pad, device=dev)
    out = ft.int8_binmax(q8, v8, ones, ones, rmask, torch.ones(64, device=dev),
                         torch.zeros(64, device=dev), torch.ones(64, device=dev),
                         torch.zeros(1, device=dev), surv, n_surv, Metric.DotProduct)
    exact = (q8.cpu().long() @ v8[rows].cpu().long().T).T
    assert torch.equal(out.cpu(), exact.float())


BF16_CASES = [
    ("K1-bf16", Metric.Cosine, False, None, 0.0),
    ("K1-bf16", Metric.Cosine, False, Cmp.Gt, 0.05),
    ("K5", Metric.DotProduct, False, None, 0.0),
    ("K5", Metric.DotProduct, False, Cmp.Gt, 2.0),
    ("K5", Metric.Euclidean, True, None, 0.0),
    ("K5", Metric.Euclidean, True, Cmp.Lt, 250.0),
    ("K3-bf16", Metric.Cosine, False, Cmp.Gte, 0.05),
    ("K3-bf16", Metric.Euclidean, True, Cmp.Lt, 250.0),
    ("K4-bf16", Metric.Cosine, False, None, 0.0),
    ("K4-bf16", Metric.DotProduct, False, Cmp.Gt, 2.0),
    ("K4-bf16", Metric.Euclidean, True, None, 0.0),
    ("K6-bf16", Metric.Cosine, False, None, 0.0),
    ("K6-bf16", Metric.DotProduct, False, Cmp.Gt, 2.0),
    ("K6-bf16", Metric.Euclidean, True, Cmp.Lt, 250.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,metric,take_min,cmp,thr", BF16_CASES)
@pytest.mark.parametrize("d", [128, 100])
def test_bf16_row_kernel_matches_plain(mode, metric, take_min, cmp, thr, d):
    """The bf16-row modes; at d = 100 the store pads its rows to 112 and the
    wrapper the queries."""
    dev = _device()
    args = _bf16_operands(mode, dev, metric, d=d, thr=thr, cmp=cmp)
    fn = ft.KERNELS[mode]
    before = fn.launches
    got = _call(mode, args, metric, take_min, cmp)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = _call(mode, args, metric, take_min, cmp, plain=True)
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w)
    assert bool(fin_w.any()) and not bool(fin_w.all())
    err = float((got[fin_w] - want[fin_w]).abs().max())
    tol = _tol(mode, args, metric)
    if metric is not Metric.Cosine or mode == "K5":
        tol += 4 * float(np.spacing(np.float32(float(want[fin_w].abs().max()))))
    assert err <= tol, (err, tol)


def _k1_operands(mode, dev, *, b, d, cmp, thr=0.05, live="some", n=20_000, seed=0,
                 q_scale=None):
    """K1's operands as the fused path sets them up (``cert_scan``) over an
    int8 ("K1") or bf16 ("K1-bf16") store; ``live``: "none", "one", "all"
    or "some" (60% of the bins) alive; ``q_scale`` [b, d] multiplies the
    queries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pad = sc.pad_rows(n)
    if mode == "K1":
        f32 = torch.randn((n_pad, d), generator=g, device=dev)
        f32[n:] = 0.0
        dv = sc.materialize_int8_slabs(lambda s, r: f32[s : s + r], n, d, 1 << 14, device=dev)
    else:
        dv = _bf16_store(dev, g, n, d)
    q = torch.randn((b, d), generator=g, device=dev)
    if q_scale is not None:
        q = q * q_scale.to(dev)
    n_bins = n_pad // ft.BIN
    alive = {
        "none": torch.zeros(n_bins, dtype=torch.bool, device=dev),
        "one": torch.arange(n_bins, device=dev) == n_bins // 2,
        "all": torch.ones(n_bins, dtype=torch.bool, device=dev),
        "some": torch.rand(n_bins, generator=g, device=dev) < 0.6,
    }[live]
    row_mask = torch.rand(n_pad, generator=g, device=dev) < 0.9
    return ft.cert_scan(mode, dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, q, row_mask,
                        torch.tensor(thr, device=dev), alive, metric=Metric.Cosine, cmp=cmp,
                        resid=dv.resid).ops


def _check_k1(mode, args, cmp, live):
    """One launch against the plain version; over int8 rows a batch of more
    than one query block is counted on ``wide_launches`` (the pair plan)."""
    fn = ft.KERNELS[mode]
    before, wide = fn.launches, fn.wide_launches
    got = fn(*args, cmp)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert fn.wide_launches == wide + (mode == "K1" and args[0].shape[0] > ft.QUERY_BLOCK)
    want = ft.cert_cos_binmax_plain(*args, cmp)
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w)
    if live == "none":
        assert bool(torch.isneginf(got).all())
        return
    assert bool(fin_w.any())
    err = float((got[fin_w] - want[fin_w]).abs().max())
    assert err <= sc.mixed_cert_eps(args[0].shape[1]), err


@pytest.mark.cuda
@pytest.mark.parametrize("cmp", [None, Cmp.Gt, Cmp.Gte])
@pytest.mark.parametrize("d", [96, 768, 1392, 2048])
@pytest.mark.parametrize("b", [1, 64, 65, 70, 128, 192, 256, 600])
@pytest.mark.parametrize("mode", ["K1", "K1-bf16"])
def test_k1_matches_plain(mode, b, d, cmp):
    """K1 over int8 and bf16 rows at batch sizes of one query, one full
    query block, two blocks (the second holding one or six queries), two,
    three (over int8 rows a pair padded by a block of q_ok = 0 lanes), four
    and ten blocks (over int8 rows from two blocks the pair plan), depths of
    one and a half, twelve, 21.75 and (the deep-row plan, the query block
    streamed through the ring) 32 64-deep blocks, each score filter; 60% of
    the bins alive: within ``mixed_cert_eps(d)`` of the plain version."""
    dev = _device()
    _check_k1(mode, _k1_operands(mode, dev, b=b, d=d, cmp=cmp), cmp, "some")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 600])
@pytest.mark.parametrize("live", ["none", "one", "all"])
@pytest.mark.parametrize("mode", ["K1", "K1-bf16"])
def test_k1_liveness(mode, live, b):
    """n_surv = 0 (every bin stays -inf), one live bin, every bin live."""
    dev = _device()
    _check_k1(mode, _k1_operands(mode, dev, b=b, d=768, cmp=None, live=live), None, live)


def _q_scale(kind, b, d):
    """[b, d] query multipliers: every query scaled by 1e-15 or 1e15 (int8
    rows: f16 products scaled by about 2^62 or 2^-37), or query 0's even
    elements by 2^-40 (its magnitudes span more than f16's range, so its
    block keeps bf16 products while the batch's other blocks take f16)."""
    if kind in ("tiny", "huge"):
        return torch.full((b, d), 1e-15 if kind == "tiny" else 1e15)
    scale = torch.ones(b, d)
    scale[0, ::2] = 2.0 ** -40
    return scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tiny", "huge", "wide"])
@pytest.mark.parametrize("b", [1, 70, 256])
@pytest.mark.parametrize("mode", ["K1", "K1-bf16"])
def test_k1_query_scales(mode, b, kind):
    """Queries far from unit scale, or spanning more than f16's range
    within one query: within ``mixed_cert_eps(d)`` of the plain version
    (over int8 rows the f16 products' scale is undone exactly, and a block
    that f16 cannot hold exactly keeps bf16 products; on the pair plan, b
    = 70 and 256, the pair holding that block keeps them for both of its
    blocks, whose flags differ, and the other pair takes f16)."""
    dev = _device()
    args = _k1_operands(mode, dev, b=b, d=768, cmp=None, q_scale=_q_scale(kind, b, 768))
    _check_k1(mode, args, None, "some")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,row_bytes,b,entry", [
    ("K1", 1, 1, "cert_cos_binmax"), ("K1-bf16", 2, 1, "cert_cos_binmax_bf16"),
    ("K1", 1, 256, "cert_cos_binmax_pair")])
@pytest.mark.parametrize("d", [16, 96, 384, 768, 1296, 1344, 1392, 1536, 4096])
def test_k1_smem_mirrors_the_kernel(mode, row_bytes, b, entry, d):
    """``sm90_plan`` / ``sm90_smem_bytes`` equal the C side's figures (over
    bf16 rows at d = 1,296-1,536 the split plan's; over int8 rows at more
    than one query block the pair plan's, its resident head included)."""
    _device()
    from otters_tpu_torch import kernels

    lib = kernels.load("cert_cos_binmax")
    smem, stages = getattr(lib, f"{entry}_smem_bytes"), getattr(lib, f"{entry}_stages")
    smem.argtypes = stages.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_size_t
    stages.restype = ctypes.c_int
    ks, rows, s, streamed, resident = ft.sm90_plan(mode, d, b)
    assert stages(d) == s
    assert smem(d) == ft.sm90_smem_bytes(d, row_bytes, s, ks, rows, streamed,
                                         resident=resident,
                                         queries=ft.sm90_queries(mode, b))
    assert smem(d) == ft.kernel_smem_bytes(mode, d, b) <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "wide"])
@pytest.mark.parametrize("d,b", [(96, 256), (768, 65), (768, 256), (1392, 192)])
def test_k1_pair_plan_equals_single_queries(d, b, kind):
    """Over int8 rows the bin maxima of b queries on the pair plan (128 a
    CTA, one launch counted on ``wide_launches``) are bit for bit those of
    the same queries launched one at a time on the 64-query plan (none of
    them wide): each query's dots are the same f16 products (scaled by the
    same 2^s, per pair or per block) in the same order, keyed alike. With
    ``kind`` "wide" query 0 spans more than f16's range: its pair keeps
    bf16 products for the other 127 queries too, which the single launches
    multiply in f16, and the sums still agree bit for bit (the same exact
    products, scaled by a power of two)."""
    dev = _device()
    scale = _q_scale(kind, b, d) if kind == "wide" else None
    args = _k1_operands("K1", dev, b=b, d=d, cmp=Cmp.Gte, thr=-0.5, q_scale=scale)
    fn = ft.cert_cos_binmax
    launches, wide = fn.launches, fn.wide_launches
    whole = fn(*args, Cmp.Gte)
    parts = [fn(*(t[s : s + 1] if i in (0, 5, 6) else t for i, t in enumerate(args)), Cmp.Gte)
             for s in range(b)]
    torch.cuda.synchronize()
    assert (fn.launches - launches, fn.wide_launches - wide) == (b + 1, 1)
    want = torch.cat(parts, dim=1)
    assert bool(torch.isfinite(want).any())
    assert torch.equal(whole.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "wide", "nan"])
def test_k1_f16_queries_on_the_card_equal_the_cpu(kind):
    """The pair plan's f16 rewrite on the card (one launch of
    ``cert_cos_binmax_f16_queries``) gives the plain version's queries,
    scales and flags bit for bit: three pairs of 768-deep queries, scaled
    by 1e-15 or 1e15, one query spanning more than f16's range (its pair
    keeps bf16), a NaN element."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((384, 768), generator=g, device=dev)
    q *= {"tiny": 1e-15, "huge": 1e15}.get(kind, 1.0)
    if kind == "wide":
        q[200, ::2] *= 2.0 ** -40
    if kind == "nan":
        q[5, 9] = float("nan")
    q = q.bfloat16()
    on_card = ft.f16_queries(q.clone())
    on_cpu = ft.f16_queries(q.cpu())
    flags = {"wide": [1, 0, 1], "nan": [0, 1, 1]}.get(kind, [1, 1, 1])
    assert on_card[2].tolist() == on_cpu[2].tolist() == flags
    for a, c in zip(on_card, on_cpu):
        assert torch.equal(a.cpu().view(torch.int32) if a.dtype == torch.float32 else
                           a.cpu().view(torch.int16) if a.dtype == torch.bfloat16 else a.cpu(),
                           c.view(torch.int32) if c.dtype == torch.float32 else
                           c.view(torch.int16) if c.dtype == torch.bfloat16 else c)


# K6 and K4 over bf16 rows, on the Hopper scan
BF16_SM90_CASES = [c for c in BF16_CASES if c[0] in ("K4-bf16", "K6-bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,metric,take_min,cmp,thr", BF16_SM90_CASES)
@pytest.mark.parametrize("d", [16, 112, 768, 832, 896, 2048])
@pytest.mark.parametrize("b", [1, 64, 256, 600])
def test_bf16_sm90_kernel_matches_plain(mode, metric, take_min, cmp, thr, b, d):
    """K6 and K4 over bf16 rows at one, one full, four and ten query
    blocks, every metric and filter of BF16_CASES, at a depth of one
    16-deep step, a stored 112, the main path's 768, 832 and 896 (where
    resident query planes of K4 would stop fitting) and deep rows (2,048,
    K6's streamed plan); a Euclid filter keeps about half the distances at
    every depth."""
    dev = _device()
    if metric is Metric.Euclidean and cmp is not None:
        thr = 2.0 * d  # about the median squared distance of the random rows
    args = _bf16_operands(mode, dev, metric, n=20_000, d=d, b=b, thr=thr, cmp=cmp)
    _check_plain(mode, args, metric, take_min, cmp)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode", ["K2", "K3", "K4", "K6", "K1-bf16", "K3-bf16", "K4-bf16", "K5", "K6-bf16"])
def test_no_live_bin_leaves_every_bin_neg_inf(mode):
    dev = _device()
    metric = Metric.DotProduct if mode == "K5" else Metric.Cosine
    if mode in ("K2", "K3", "K4", "K6"):
        args = _operands(mode, dev, n=5000)
    else:
        args = _bf16_operands(mode, dev, metric, n=5000)
    args[-2], args[-1] = ft.survivor_bins(
        torch.zeros(args[1].shape[0] // ft.BIN, dtype=torch.bool, device=dev)
    )
    out = _call(mode, args, metric, False, None)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(out).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 2048])
def test_k6_dots_equal_float64_of_the_rounded_operands(d):
    """Unit norms, Dot metric, one unmasked row per bin: each K6 bin max is
    that row's accumulated one-pass dot, within d 2^-24 |qh| |vh| of the
    float64 product of the bf16-rounded operands (the products are exact,
    only the f32 sums round); at a padded depth, the main path's and a
    streamed one."""
    dev = _device()
    args = _operands("K6", dev, d=d, b=64, n=20_000)
    qh, v = args[0], args[1]
    n_pad = v.shape[0]
    n_bins = n_pad // ft.BIN
    rows = torch.arange(n_bins, device=dev) * ft.BIN + 7  # a valid row in every bin
    rmask = torch.zeros(n_pad, device=dev)
    rmask[rows] = 1.0
    surv, n_surv = ft.survivor_bins(torch.ones(n_bins, dtype=torch.bool, device=dev))
    ones = torch.ones(n_pad, device=dev)
    out = ft.bf16_binmax(qh, v, ones, ones, rmask, torch.ones(64, device=dev),
                         torch.zeros(64, device=dev), torch.ones(64, device=dev),
                         torch.zeros(1, device=dev), surv, n_surv, Metric.DotProduct)
    vh = v[rows].bfloat16().double()
    ref = (qh.double() @ vh.T).T
    scale = vh.norm(dim=1)[:, None] * qh.double().norm(dim=1)[None, :]
    err = float(((out.double() - ref).abs() / scale).max())
    assert err <= d * 2.0**-24, err


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(pv.PROBES))
@pytest.mark.parametrize("d,b", [(768, 256), (100, 70), (98, 1), (98, 600), (768, 1),
                                 (768, 600)])
def test_probe_matches_plain(name, d, b):
    """Each probe against its plain version at 64 tiles of 1024 rows: the
    f32 probes within d 2^-24 |q| |v| (two f32 sums in other orders), the
    bf16x3 one within ``high_precision_bound(d)`` |q| |v|; at one, a
    partial and ten query blocks (600 queries: several blocks share the
    SMs), and at d = 98, whose rows the wrappers copy zero-padded to a
    16-byte stride."""
    dev = _device()
    ops = pv.make_inputs(dev, n_pad=64 * pv.T, d=d, b=b, seed=3)
    args = pv.probe_args(name, ops)
    fn = pv.PROBES[name]
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = pv.PLAIN[name](*args)
    assert got.shape == want.shape == (64, b, 2)
    base = sc.high_precision_bound(d) if name == "k_planes" else d * 2.0**-24
    scale = float(ops["q"].norm(dim=1).max()) * float(ops["v"].norm(dim=1).max())
    err = float((got - want).abs().max())
    assert err <= base * scale, (err, base * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("d,b", [(768, 256), (98, 70)])
def test_k_mm_all_dots_equal_float64(d, b):
    """probe_mm with a non-null ``all_dots`` at 64 tiles: every dot of the
    tile product (the FFMA scan's, one FMA per term) within d 2^-24 |q| |v|
    of the float64 product, padded query lanes included (zero queries, zero
    dots); the two columns it returns are those dots of each tile's rows 0
    and 1, bit for bit."""
    dev = _device()
    ops = pv.make_inputs(dev, n_pad=64 * pv.T, d=d, b=b, seed=11)
    q, v = ops["q"], ops["v"]
    bq = -(-b // ft.QUERY_BLOCK) * ft.QUERY_BLOCK
    all_dots = torch.full((bq, v.shape[0]), float("nan"), device=dev)
    before = pv.k_mm.launches
    first2 = pv.k_mm(q, v, all_dots=all_dots)
    torch.cuda.synchronize()
    assert pv.k_mm.launches == before + 1
    assert not bool(all_dots.isnan().any())
    assert not bool(all_dots[b:].any())
    ref = q.double() @ v.double().T
    scale = q.double().norm(dim=1)[:, None] * v.double().norm(dim=1)[None, :]
    err = float(((all_dots[:b].double() - ref).abs() / scale).max())
    assert err <= d * 2.0**-24, err
    cols = all_dots[:b].reshape(b, 64, pv.T)[:, :, :2].permute(1, 0, 2)
    assert torch.equal(first2, cols)


# ---------------------------------------------------------------------------
# K5 and K6 over f32 rows on the sm90 scan; the depth plans against C
# ---------------------------------------------------------------------------


def _check_plain(mode, args, metric, take_min, cmp, nan_ok=False):
    """Launch once, hold against the plain version: the same finite / -inf
    pattern, within ``_tol`` plus 4 ulps of the largest key."""
    fn = ft.KERNELS[mode]
    before = fn.launches
    got = _call(mode, args, metric, take_min, cmp)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = _call(mode, args, metric, take_min, cmp, plain=True)
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w)
    assert bool(fin_w.any()) and not bool(fin_w.all())
    err = float((got[fin_w] - want[fin_w]).abs().max())
    tol = _tol(mode, args, metric)
    tol += 4 * float(np.spacing(np.float32(float(want[fin_w].abs().max()))))
    assert err <= tol, (err, tol)


K5_FILTERS = [(Metric.DotProduct, False, None, 0.0), (Metric.DotProduct, False, Cmp.Gt, 2.0),
              (Metric.DotProduct, False, Cmp.Gte, 2.0),
              (Metric.Euclidean, True, None, 0.0), (Metric.Euclidean, True, Cmp.Lt, 250.0),
              (Metric.Euclidean, True, Cmp.Lte, 250.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric,take_min,cmp,thr", K5_FILTERS)
def test_k5_filters(metric, take_min, cmp, thr):
    """K5 with each score filter of Dot (take-max) and Euclid (take-min)."""
    dev = _device()
    args = _bf16_operands("K5", dev, metric, d=100, thr=thr, cmp=cmp)
    _check_plain("K5", args, metric, take_min, cmp)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 2048])
@pytest.mark.parametrize("b", [1, 64, 256, 600])
@pytest.mark.parametrize("metric", [Metric.DotProduct, Metric.Euclidean])
def test_k5_matches_plain(metric, b, d):
    """K5 at one, one full, four and ten (the last partial) query blocks,
    at a padded depth, the main path's and a depth past the resident query
    block (streamed)."""
    dev = _device()
    args = _bf16_operands("K5", dev, metric, d=d, b=b, n=20_000)
    _check_plain("K5", args, metric, metric is Metric.Euclidean, None)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.DotProduct, Metric.Euclidean])
def test_k5_masked_bins_and_nan_rows(metric):
    """Whole bins masked (every row's rmask 0) beside dead bins, and rows
    whose values are NaN (their side data finite, so their dots and scores
    are NaN): a NaN score fails the filter like a masked row, the bins stay
    equal to the plain version's."""
    dev = _device()
    take_min = metric is Metric.Euclidean
    args = _bf16_operands("K5", dev, metric, d=768, b=70, n=20_000)
    v, rmask, surv, n_surv = args[1], args[4], args[-2], args[-1]
    live = surv[: int(n_surv[0])].long()
    masked = live[::3]
    rmask.view(-1, ft.BIN)[masked] = 0.0
    nan_rows = live[1::3] * ft.BIN + 5
    v[nan_rows] = float("nan")
    _check_plain("K5", args, metric, take_min, None)
    out = ft.cert_fold_binmax(*args, metric, take_min, None)
    assert bool(torch.isneginf(out[masked]).all())


K6_FILTERS = [(m, tm, c, t) for m, tm, t in ((Metric.Cosine, False, 0.05),
                                             (Metric.DotProduct, False, 2.0),
                                             (Metric.Euclidean, True, 250.0))
              for c in (None, Cmp.Gt, Cmp.Gte, Cmp.Lt, Cmp.Lte)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric,take_min,cmp,thr", K6_FILTERS)
def test_k6_filters(metric, take_min, cmp, thr):
    """K6 over f32 rows with every metric and score filter (Eq:
    ``test_k6_eq_filter``)."""
    dev = _device()
    args = _operands("K6", dev, d=100, thr=thr)
    _check_plain("K6", args, metric, take_min, cmp)


@pytest.mark.cuda
def test_k6_eq_filter():
    """Eq needs scores both versions compute exactly: small-integer rows
    and queries (exact in bf16, exact sums), the Dot metric."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(4)
    n, d = 20_000, 100
    ints = torch.randint(-2, 3, (sc.pad_rows(n), d), generator=g, device=dev).float()
    ints[n:] = 0.0
    dv = sc.materialize_f32_slabs(lambda s_, r: ints[s_ : s_ + r], n, d, 1 << 14, device=dev)
    q = torch.randint(-2, 3, (70, d), generator=g, device=dev).float()
    thr = float(q[0] @ ints[777])
    q_sq, q_inv = sc._query_norms(q)
    alive = torch.ones(dv.vectors.shape[0] // ft.BIN, dtype=torch.bool, device=dev)
    surv, n_surv = ft.survivor_bins(alive)
    args = [q.bfloat16(), dv.vectors, dv.inv_norms, dv.norms_sq, dv.valid.float(), q_inv, q_sq,
            torch.ones(70, device=dev), torch.full((1,), thr, device=dev), surv, n_surv]
    _check_plain("K6", args, Metric.DotProduct, False, Cmp.Eq)


# ---------------------------------------------------------------------------
# K2 (s8 wgmma) and K3 (FFMA) on the sm90 scan
# ---------------------------------------------------------------------------

K2_FILTERS = [(Metric.Cosine, False, None), (Metric.Cosine, False, Cmp.Gt),
              (Metric.Cosine, True, Cmp.Lte), (Metric.DotProduct, False, None),
              (Metric.DotProduct, False, Cmp.Gt), (Metric.Euclidean, True, None),
              (Metric.Euclidean, True, Cmp.Lte)]


def _median_threshold(mode, args, metric, take_min):
    """A score threshold inside the bins' range: the median unfiltered bin
    key of the plain version (a score; negated back for take-min)."""
    keys = _call(mode, args, metric, take_min, None, plain=True)
    med = float(keys[torch.isfinite(keys)].median())
    return torch.full((1,), -med if take_min else med, device=keys.device)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,take_min,cmp", K2_FILTERS)
@pytest.mark.parametrize("d", [100, 768, 3072])
@pytest.mark.parametrize("b", [1, 70, 256, 600])
def test_k2_matches_plain(metric, take_min, cmp, b, d):
    """K2 at one query, one partial, four and ten (the last partial) query
    blocks; at a padded depth (112 stored, one 128-deep k-block), the main
    path's and 3,072 (two ring stages beside the resident block); every
    metric, Gt and take-min Lte filters at the median bin key. The int32
    dots are exact in both versions, so the keys agree within 4 ulps."""
    dev = _device()
    args = _operands("K2", dev, d=d, b=b, n=20_000)
    if cmp is not None:
        args[8] = _median_threshold("K2", args, metric, take_min)
    _check_plain("K2", args, metric, take_min, cmp)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 3072])
def test_k2_dots_round_like_astype_past_2_24(d):
    """One unmasked row per bin, each a copy of a query's codes (magnitudes
    100 - 127) with a tenth of its signs flipped, so its dot with that
    query passes 2^24 at d = 3,072; Dot metric, unit norms: each bin max
    is the row's int32 dot converted to f32, equal bit for bit to the exact
    int64 product rounded to nearest even (JAX's astype)."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(d)
    n, b = 20_000, 70
    n_pad = sc.pad_rows(n)
    dp = sc.pad_depth(d)
    mag = torch.randint(100, 128, (b, d), generator=g, device=dev)
    sign = torch.randint(0, 2, (b, d), generator=g, device=dev) * 2 - 1
    q8 = (mag * sign).to(torch.int8)
    buf = torch.randint(-127, 128, (n_pad, dp), generator=g, device=dev, dtype=torch.int8)
    buf[:, d:] = 0
    rows, rmask, surv, n_surv = _one_row_per_bin(None, dev, n_pad)
    flip = torch.where(torch.rand((rows.shape[0], d), generator=g, device=dev) < 0.1, -1, 1)
    buf[rows, :d] = (q8[torch.arange(rows.shape[0], device=dev) % b].long() * flip).to(
        torch.int8)
    v8 = buf[:, :d]
    ones_n, ones_b = torch.ones(n_pad, device=dev), torch.ones(b, device=dev)
    out = ft.int8_binmax(q8, v8, ones_n, ones_n, rmask, ones_b, torch.zeros(b, device=dev),
                         ones_b, torch.zeros(1, device=dev), surv, n_surv, Metric.DotProduct)
    exact = (q8.cpu().long() @ v8[rows].cpu().long().T).T  # [bins, b], exact
    if d == 3072:
        assert int(exact.abs().max()) > 1 << 24
    assert torch.equal(out.cpu(), exact.float())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 3072])
@pytest.mark.parametrize("b", [1, 70, 256, 600])
@pytest.mark.parametrize("metric", [Metric.Cosine, Metric.DotProduct, Metric.Euclidean])
@pytest.mark.parametrize("mode", ["K3", "K3-bf16"])
def test_k3_matches_plain(mode, metric, b, d):
    """K3 over f32 and bf16 rows at one, one partial, four and ten query
    blocks, a padded depth, the main path's and deep rows (the f32 query
    block streams at every depth)."""
    dev = _device()
    args = (_operands("K3", dev, d=d, b=b, n=20_000) if mode == "K3" else
            _bf16_operands("K3-bf16", dev, metric, n=20_000, d=d, b=b))
    _check_plain(mode, args, metric, metric is Metric.Euclidean, None)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 3072])
@pytest.mark.parametrize("b", [1, 70, 256, 600])
@pytest.mark.parametrize("mode", ["K3", "K3-bf16"])
def test_k3_dots_equal_float64(mode, b, d):
    """Unit norms, Dot metric, one unmasked row per bin: each bin max is
    that row's f32 dot (one FMA per term), within d 2^-24 |q| |v| of the
    float64 product of the stored values (bf16 rows upcast exactly)."""
    dev = _device()
    args = (_operands("K3", dev, d=d, b=b, n=20_000) if mode == "K3" else
            _bf16_operands("K3-bf16", dev, Metric.DotProduct, n=20_000, d=d, b=b))
    q, v = args[0], args[1]
    n_pad = v.shape[0]
    rows, rmask, surv, n_surv = _one_row_per_bin(args, dev, n_pad)
    ones_n, ones_b = torch.ones(n_pad, device=dev), torch.ones(b, device=dev)
    out = ft.KERNELS[mode](q, v, ones_n, ones_n, rmask, ones_b, torch.zeros(b, device=dev),
                           ones_b, torch.zeros(1, device=dev), surv, n_surv,
                           Metric.DotProduct)
    vr = v[rows].double()
    ref = (q.double() @ vr.T).T
    scale = vr.norm(dim=1)[:, None] * q.double().norm(dim=1)[None, :]
    err = float(((out.double() - ref).abs() / scale).max())
    assert err <= d * 2.0**-24, err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["K3", "K3-bf16"])
@pytest.mark.parametrize("b", [1, 70, 256])
def test_k3_eq_filter(mode, b):
    """Eq needs scores both versions compute exactly: small-integer rows
    and queries (exact in bf16 too, the sums exact), the Dot metric."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(7)
    n, d = 20_000, 100
    ints = torch.randint(-2, 3, (sc.pad_rows(n), d), generator=g, device=dev).float()
    ints[n:] = 0.0
    if mode == "K3":
        dv = sc.materialize_f32_slabs(lambda s_, r: ints[s_ : s_ + r], n, d, 1 << 14,
                                      device=dev)
    else:
        dv = sc.materialize_from_device(ints, n_valid=n, dtype=torch.bfloat16)
    q = torch.randint(-2, 3, (b, d), generator=g, device=dev).float()
    thr = float(q[0] @ ints[777])
    q_sq, q_inv = sc._query_norms(q)
    alive = torch.ones(dv.vectors.shape[0] // ft.BIN, dtype=torch.bool, device=dev)
    surv, n_surv = ft.survivor_bins(alive)
    args = [q, dv.vectors, dv.inv_norms, dv.norms_sq, dv.valid.float(), q_inv, q_sq,
            torch.ones(b, device=dev), torch.full((1,), thr, device=dev), surv, n_surv]
    _check_plain(mode, args, Metric.DotProduct, False, Cmp.Eq)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 2048])
@pytest.mark.parametrize("b", [1, 64, 256, 600])
@pytest.mark.parametrize("metric", [Metric.Cosine, Metric.DotProduct, Metric.Euclidean])
def test_k6_matches_plain(metric, b, d):
    """K6 over f32 rows at one, one full, four and ten query blocks, a
    padded depth, the main path's and a depth past the resident query
    block (streamed)."""
    dev = _device()
    args = _operands("K6", dev, d=d, b=b, n=20_000)
    _check_plain("K6", args, metric, metric is Metric.Euclidean, None)


def _one_row_per_bin(args, dev, n_pad):
    n_bins = n_pad // ft.BIN
    rows = torch.arange(n_bins, device=dev) * ft.BIN + 7  # a valid row in every bin
    rmask = torch.zeros(n_pad, device=dev)
    rmask[rows] = 1.0
    surv, n_surv = ft.survivor_bins(torch.ones(n_bins, dtype=torch.bool, device=dev))
    return rows, rmask, surv, n_surv


# ---------------------------------------------------------------------------
# K4 over f32 rows on the sm90 scan (two row planes split in the kernel)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 100, 768, 2048])
@pytest.mark.parametrize("b", [1, 64, 65, 128, 192, 256, 600])
@pytest.mark.parametrize("metric", [Metric.Cosine, Metric.DotProduct, Metric.Euclidean])
def test_k4_matches_plain(metric, b, d):
    """K4 over f32 rows on the pair plan at one query and one full query
    block (one pair, 127 and 64 of its lanes q_ok = 0), two blocks (the
    second holding one query), two full, three (a pair padded by a block
    of q_ok = 0 lanes), four and ten (the last partial), at one 16-deep
    step, a padded depth, the main path's and deep rows; each launch
    counted on ``wide_launches``."""
    dev = _device()
    args = _operands("K4", dev, d=d, b=b, n=20_000)
    wide = ft.bf16x3_binmax.wide_launches
    _check_plain("K4", args, metric, metric is Metric.Euclidean, None)
    assert ft.bf16x3_binmax.wide_launches == wide + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 768, 2048])
def test_k4_pair_plan_equals_four_query_blocks(d):
    """The bin maxima of 256 queries in one launch (two pairs of query
    blocks, 128 queries a CTA, 66 CTAs a pair) are bit for bit those of
    the same queries in four launches of 64 (one pair each, half its lanes
    padding, 132 CTAs), every metric: a query's dots do not depend on the
    batch around it, its CTA's share of the bins or its lane, since every
    CTA splits each row and query alike and issues the same three products
    per 16-deep step in the same order, into a partial per 64-deep k-block
    added with __fadd_rn."""
    dev = _device()
    args = _operands("K4", dev, d=d, b=256, n=20_000)
    fn = ft.bf16x3_binmax
    for metric in (Metric.Cosine, Metric.DotProduct, Metric.Euclidean):
        take_min = metric is Metric.Euclidean
        launches, wide = fn.launches, fn.wide_launches
        whole = fn(*args, metric, take_min, None)
        parts = [fn(*(t[s : s + 64] if i in (0, 5, 6, 7) else t for i, t in enumerate(args)),
                    metric, take_min, None) for s in range(0, 256, 64)]
        torch.cuda.synchronize()
        assert (fn.launches - launches, fn.wide_launches - wide) == (5, 5)
        got, want = whole.view(torch.int32), torch.cat(parts, dim=1).view(torch.int32)
        assert bool(torch.isfinite(whole).any())
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,take_min,cmp,thr", K6_FILTERS)
def test_k4_filters(metric, take_min, cmp, thr):
    """K4 over f32 rows with every metric and score filter (Eq:
    ``test_k4_eq_filter``)."""
    dev = _device()
    args = _operands("K4", dev, d=100, thr=thr)
    _check_plain("K4", args, metric, take_min, cmp)


@pytest.mark.cuda
def test_k4_eq_filter():
    """Eq needs scores both versions compute exactly: small-integer rows
    and queries (their low planes 0, the sums exact), the Dot metric."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(5)
    n, d = 20_000, 100
    ints = torch.randint(-2, 3, (sc.pad_rows(n), d), generator=g, device=dev).float()
    ints[n:] = 0.0
    dv = sc.materialize_f32_slabs(lambda s_, r: ints[s_ : s_ + r], n, d, 1 << 14, device=dev)
    q = torch.randint(-2, 3, (70, d), generator=g, device=dev).float()
    thr = float(q[0] @ ints[777])
    q_sq, q_inv = sc._query_norms(q)
    alive = torch.ones(dv.vectors.shape[0] // ft.BIN, dtype=torch.bool, device=dev)
    surv, n_surv = ft.survivor_bins(alive)
    args = [q, dv.vectors, dv.inv_norms, dv.norms_sq, dv.valid.float(), q_inv, q_sq,
            torch.ones(70, device=dev), torch.full((1,), thr, device=dev), surv, n_surv]
    _check_plain("K4", args, Metric.DotProduct, False, Cmp.Eq)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [70, 256])
@pytest.mark.parametrize("metric", [Metric.Cosine, Metric.DotProduct, Metric.Euclidean])
def test_k4_masked_bins_nan_and_inf_rows(metric, b):
    """Whole bins masked beside dead bins, NaN rows and rows with one inf
    element (their side data finite): an inf splits into an inf high plane
    and a NaN low plane, as JAX's split does, so the dot and score are NaN
    and the row fails the filter like a masked one; the bins stay equal to
    the plain version's (both on the pair plan: 70 queries, a pair padded
    by 58 lanes, and 256)."""
    dev = _device()
    take_min = metric is Metric.Euclidean
    args = _operands("K4", dev, d=768, b=b, n=20_000)
    v, rmask, surv, n_surv = args[1], args[4], args[-2], args[-1]
    live = surv[: int(n_surv[0])].long()
    masked = live[::3]
    rmask.view(-1, ft.BIN)[masked] = 0.0
    v[live[1::3] * ft.BIN + 5] = float("nan")
    v[live[2::3] * ft.BIN + 9, 7] = float("inf")
    _check_plain("K4", args, metric, take_min, None)
    out = ft.bf16x3_binmax(*args, metric, take_min, None)
    assert bool(torch.isneginf(out[masked]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 256])
@pytest.mark.parametrize("scale", [1e-30, 1e-36])
def test_k4_keeps_subnormal_low_planes(scale, b):
    """Rows scaled to 1e-30 and to 1e-36, where the low planes x - bf16(x)
    (about 2^-9 |x|) fall below 2^-126 and are subnormal: Dot metric, one
    unmasked row per bin, so each bin max is that row's bf16x3 dot, within
    the bound's 4 d 2^-24 |q| |v| share of the float64 sum of the split
    products (torch's casts keep subnormals). A flushed low plane would
    lose qh.vl, about 2^-9 |q| |v|. At 64 queries (one pair, half its lanes
    padding) and 256."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(6)
    n, d = 20_000, 768
    n_pad = sc.pad_rows(n)
    f32 = torch.randn((n_pad, d), generator=g, device=dev) * scale
    f32[n:] = 0.0
    dv = sc.materialize_f32_slabs(lambda s_, r: f32[s_ : s_ + r], n, d, 1 << 14, device=dev)
    q = torch.randn((b, d), generator=g, device=dev)
    rows, rmask, surv, n_surv = _one_row_per_bin(None, dev, n_pad)
    ones_n, ones_b = torch.ones(n_pad, device=dev), torch.ones(b, device=dev)
    out = ft.bf16x3_binmax(q, dv.vectors, ones_n, ones_n, rmask, ones_b,
                           torch.zeros(b, device=dev), ones_b, torch.zeros(1, device=dev),
                           surv, n_surv, Metric.DotProduct)
    v = dv.vectors[rows]
    vh = v.bfloat16()
    vl = (v - vh.float()).bfloat16()
    qh = q.bfloat16()
    ql = (q - qh.float()).bfloat16()
    if scale < 1e-35:
        low = vl.float().abs()
        assert float(((low > 0) & (low < 2.0**-126)).float().mean()) > 0.5
    vh, vl, qh, ql = (x.double() for x in (vh, vl, qh, ql))
    ref = vh @ qh.T + vl @ qh.T + vh @ ql.T
    norms = v.double().norm(dim=1)[:, None] * q.double().norm(dim=1)[None, :]
    err = float(((out.double() - ref).abs() / norms).max())
    assert err <= 4 * d * 2.0**-24, err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 768, 2048])
def test_k5_dots_equal_float64(d):
    """Dot metric, one unmasked row per bin, every certificate term 0: each
    K5 bin max is that row's accumulated dot, within d 2^-24 |qh| |v| of the
    float64 product of the bf16 operands (the products are exact)."""
    dev = _device()
    args = _bf16_operands("K5", dev, Metric.DotProduct, d=d, b=64, n=20_000)
    qh, v = args[0], args[1]
    n_pad = v.shape[0]
    rows, rmask, surv, n_surv = _one_row_per_bin(args, dev, n_pad)
    ones_n, zero_n = torch.ones(n_pad, device=dev), torch.zeros(n_pad, device=dev)
    ones_b, zero_b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    out = ft.cert_fold_binmax(qh, v, ones_n, ones_n, rmask, zero_n, zero_n, ones_b, zero_b,
                              ones_b, zero_b, zero_b, zero_b, torch.zeros(1, device=dev),
                              surv, n_surv, Metric.DotProduct, False, None)
    vh = v[rows].double()
    ref = (qh.double() @ vh.T).T
    scale = vh.norm(dim=1)[:, None] * qh.double().norm(dim=1)[None, :]
    err = float(((out.double() - ref).abs() / scale).max())
    assert err <= d * 2.0**-24, err


@pytest.mark.cuda
@pytest.mark.parametrize("mode,entry", [
    ("K1", "cert_cos_binmax"), ("K1-bf16", "cert_cos_binmax_bf16"), ("K5", "cert_fold_binmax"),
    ("K6", "bf16_binmax"), ("K6-bf16", "bf16_binmax_bf16"), ("K2", "int8_binmax"),
    ("K3", "f32_binmax"), ("K3-bf16", "f32_binmax_bf16"),
    ("K4", "bf16x3_binmax"), ("K4-bf16", "bf16x3_binmax_bf16"), ("k_planes", "probe_planes"),
    ("k_mm", "probe_mm"), ("k_mm_bins", "probe_mm_bins")])
@pytest.mark.parametrize(
    "d", [16, 112, 768, 832, 896, 1296, 1344, 1392, 1408, 1536, 1552, 2048, 2976, 2992, 3072,
          4096, 8192])
def test_smem_mirrors_the_kernel(mode, entry, d):
    """``kernel_smem_bytes`` (and the sm90 plans' stage counts) equal the C
    side's figures at every depth the shape check and the plans turn on;
    K2, K3 and K6 over bf16 rows and K4 over f32 and bf16 rows take every
    one of these depths and launch there (against the plain version at 70
    queries, and with no live bin), and so do the probes k_planes, k_mm
    and k_mm_bins (against their plain versions). K4 over f32 rows: the
    pair plan's figures at every depth, and both launches take it."""
    dev = _device()
    from otters_tpu_torch import kernels

    source = ft.kernel_source(mode) if mode in ft.KERNELS else "profile_probes"
    lib = kernels.load(source)
    smem = getattr(lib, f"{entry}_smem_bytes")
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_size_t
    assert smem(d) == ft.kernel_smem_bytes(mode, d, 1)
    if mode in ft.SM90_SHAPES:
        stages = getattr(lib, f"{entry}_stages")
        stages.argtypes = [ctypes.c_int]
        stages.restype = ctypes.c_int
        assert stages(d) == ft.sm90_plan(mode, d, 1).stages
    if mode == "K4":
        assert smem(d) == 198720 and ft.sm90_plan(mode, d, 1).stages == 3
        wide = ft.bf16x3_binmax.wide_launches
    if mode in pv.PROBES:
        ops = pv.make_inputs(dev, n_pad=4 * pv.T, d=d, b=70, seed=d)
        args = pv.probe_args(mode, ops)
        got = pv.PROBES[mode](*args)
        want = pv.PLAIN[mode](*args)
        base = sc.high_precision_bound(d) if mode == "k_planes" else d * 2.0**-24
        scale = float(ops["q"].norm(dim=1).max()) * float(ops["v"].norm(dim=1).max())
        assert float((got - want).abs().max()) <= base * scale
    if mode in ("K6-bf16", "K4-bf16", "K4", "K2", "K3", "K3-bf16"):
        assert ft.kernel_takes(mode, d)
        args = (_operands(mode, dev, n=20_000, d=d) if mode in ("K4", "K2", "K3") else
                _bf16_operands(mode, dev, Metric.Cosine, n=20_000, d=d))
        _check_plain(mode, args, Metric.Cosine, False, None)
        args[-2], args[-1] = ft.survivor_bins(
            torch.zeros(args[1].shape[0] // ft.BIN, dtype=torch.bool, device=dev))
        out = _call(mode, args, Metric.Cosine, False, None)
        torch.cuda.synchronize()
        assert bool(torch.isneginf(out).all())
    if mode == "K4":
        assert ft.bf16x3_binmax.wide_launches == wide + 2


# the split plan at d = 1,536 (the first 8 query k-blocks resident, K5's
# first 4, the rest riding in the stages)
SPLIT_CASES = [("K1-bf16", Metric.Cosine, False), ("K5", Metric.DotProduct, False),
               ("K5", Metric.Euclidean, True), ("K6-bf16", Metric.Cosine, False),
               ("K6-bf16", Metric.Euclidean, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 256, 600])
@pytest.mark.parametrize("mode,metric,take_min", SPLIT_CASES)
def test_split_plan_matches_plain(mode, metric, take_min, b):
    """K1-bf16, K5 and K6-bf16 at d = 1,536 on the split plan, at one, four
    and ten (the last partial) query blocks, with whole bins masked beside
    dead bins and NaN rows: the same bins as the plain version's, the
    masked ones -inf, each launch counted on ``split_launches``."""
    dev = _device()
    d = 1536
    assert ft.sm90_plan(mode, d, b).split
    args = _bf16_operands(mode, dev, metric, n=20_000, d=d, b=b)
    v, surv, n_surv = args[1], args[-2], args[-1]
    rmask = args[3 if mode == "K1-bf16" else 4]
    live = surv[: int(n_surv[0])].long()
    masked = live[::3]
    rmask.view(-1, ft.BIN)[masked] = 0.0
    v[live[1::3] * ft.BIN + 5] = float("nan")
    fn = ft.KERNELS[mode]
    before = fn.split_launches
    _check_plain(mode, args, metric, take_min, None)
    assert fn.split_launches == before + 1
    out = _call(mode, args, metric, take_min, None)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(out[masked]).all())


@pytest.mark.cuda
def test_split_launches_counts_the_split_plan():
    """``split_launches`` counts one a launch of K1-bf16 at d = 1,536 and
    none of K1 over int8 rows at d = 768 or 1,536, or of K1-bf16 at 768,
    whose plans keep the whole query block resident; ``reset_launches``
    zeroes it."""
    dev = _device()
    for mode, d, split in (("K1-bf16", 1536, 1), ("K1", 768, 0), ("K1", 1536, 0),
                           ("K1-bf16", 768, 0)):
        fn = ft.KERNELS[mode]
        args = _k1_operands(mode, dev, b=256, d=d, cmp=None)
        launches, splits = fn.launches, fn.split_launches
        fn(*args, None)
        fn(*args, None)
        torch.cuda.synchronize()
        assert (fn.launches - launches, fn.split_launches - splits) == (2, 2 * split)
    ft.reset_launches()
    assert not any(fn.launches or fn.split_launches for fn in ft.KERNELS.values())


@pytest.mark.cuda
def test_device_bloom_build_on_cuda_equals_host():
    """The device Bloom build on the card: the host build's bits, with
    hashes past 2^63, nulls, 16 hashes and per-chunk bits just under 2^24."""
    _device()
    from otters_tpu_torch.ops import bloom, hashing

    rng = np.random.default_rng(5)
    for n, chunk, bits, k in ((200_000, 1024, 9824, 7), (4_000, 100, (1 << 24) - 32, 16)):
        g1, g2 = hashing.hash_strings([f"s{int(x)}" for x in rng.integers(0, 5000, n)])
        g1[::3] |= np.uint64(1) << np.uint64(63)
        g2[::5] |= np.uint64(1) << np.uint64(63)
        nulls = rng.random(n) < 0.1
        n_chunks = -(-n // chunk)
        params = bloom.BloomParams(bits, k, bits // 32)
        host = bloom.build_matrix(g1, g2, nulls, np.arange(n) // chunk, n_chunks, params,
                                  chunk_size=chunk)
        dev = bloom.build_matrix_device(g1, g2, nulls, chunk, n_chunks, params, "cuda")
        np.testing.assert_array_equal(dev.cpu().numpy().view(np.uint32), host)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["direct", "panel", "scan_pruned"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", [Metric.Manhattan, Metric.Hamming, Metric.Jaccard])
def test_vpu_modes_on_cuda_equal_cpu(metric, storage, mode):
    """The VPU metrics' programs on the card give the CPU's answers: the
    same indices in the same order over integer rows (many ties), the
    scores within rtol 1e-6 (Hamming exactly), the same chunk counts."""
    dev = _device()
    import otters_tpu_torch as tx

    n, b = {"direct": (2_000, 2), "panel": (40_000, 128), "scan_pruned": (65_536, 64)}[mode]
    rng = np.random.default_rng(6)
    vecs = rng.integers(0, 4, size=(n, 64)).astype(np.float32)
    q = rng.integers(0, 4, size=(b, 64)).astype(np.float32)
    cat = [f"cat_{c % 16:02d}" for c in np.arange(n) // 1024]
    out = []
    for device in ("cpu", dev):
        store = (tx.MetaStore.from_columns([tx.Column("category", tx.DataType.String)
                                            .from_values(cat)])
                 .with_vectors(vecs).with_chunk_size(1024).with_storage_dtype(storage)
                 .with_device(device).build())
        plan = store.query_batch(q, metric)
        if mode != "panel":
            plan = plan.meta_filter(tx.col("category").eq("cat_03"))
        res = plan.take(10).collect()
        st = store.last_query_stats()
        out.append((res.indices, res.scores, st.evaluated_chunks))
    assert out[1][0] == out[0][0] and out[1][2] == out[0][2]
    if metric is Metric.Hamming:
        assert out[1][1] == out[0][1]
    else:
        np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The store's lifecycle on the card: string-filtered (hostmask), sorted,
# Z-ordered, tombstoned and appended stores, and persistence
# ---------------------------------------------------------------------------

# 128 queries x 40,448 padded rows: past the direct program's limit, so K1 runs
LIFECYCLE_N, LIFECYCLE_D, LIFECYCLE_B = 40_000, 64, 128


def _lifecycle_store(case, device, vecs):
    import otters_tpu_torch as tx

    n = len(vecs)
    idx = np.arange(n)
    cols = [tx.Column("price", tx.DataType.Float64).from_values((idx * 7919 % 100).astype(float)),
            tx.Column("category", tx.DataType.String).from_values(
                [f"cat_{c % 16:02d}" for c in idx // 1024])]
    b = (tx.MetaStore.from_columns(cols).with_vectors(vecs).with_chunk_size(1024)
         .with_storage_dtype("int8").with_rerank_source(keep_host_f32=True).with_device(device))
    if case == "sorted":
        b = b.with_sort_by("price")
    elif case == "zorder":
        b = b.with_z_order(["price", "category"])
    store = b.build()
    if case in ("deleted", "appended"):
        store.delete_rows(np.random.default_rng(3).choice(n, 2_000, replace=False))
    if case == "appended":
        new = np.random.default_rng(4).normal(size=(1_000, vecs.shape[1])).astype(np.float32)
        store = store.append(new, {"price": [float(i % 100) for i in range(1_000)],
                                   "category": ["cat_01"] * 1_000})
    return store


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hostmask", "sorted", "zorder", "deleted", "appended"])
def test_lifecycle_stores_on_cuda_equal_cpu(case):
    """Certified int8 queries (K1 on the card, its plain version on the
    CPU) over each kind of store: the same original row ids in order, the
    same ``certified`` flags and pruned counts, scores within 1e-5."""
    dev = _device()
    import otters_tpu_torch as tx

    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(LIFECYCLE_N, LIFECYCLE_D)).astype(np.float32)
    q = rng.normal(size=(LIFECYCLE_B, LIFECYCLE_D)).astype(np.float32)
    flt = (tx.col("category").contains("_1") & ~tx.col("category").ends_with("3")
           if case == "hostmask" else tx.col("price").lt(30.0))
    out = []
    for device in ("cpu", dev):
        store = _lifecycle_store(case, device, vecs)
        ft.reset_launches()
        res = (store.query_batch(q, tx.Metric.Cosine).meta_filter(flt)
               .take(10, rerank_from=100).collect())
        st = store.last_query_stats()
        out.append((res.indices, res.scores, st.certified, st.pruned_chunks, len(store)))
        if device is dev:
            assert ft.cert_cos_binmax.launches >= 1
    assert out[1][0] == out[0][0] and out[1][2:] == out[0][2:] and out[1][2] is True
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_save_on_cuda_load_on_cpu(tmp_path):
    """A sorted, tombstoned CUDA store saved and loaded on the CPU answers
    as the CUDA store; the load's default device is the card."""
    dev = _device()
    import otters_tpu_torch as tx

    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(LIFECYCLE_N, LIFECYCLE_D)).astype(np.float32)
    q = rng.normal(size=(LIFECYCLE_B, LIFECYCLE_D)).astype(np.float32)
    store = _lifecycle_store("deleted", dev, vecs)
    path = str(tmp_path / "store.npz")
    store.save(path)
    for loaded, where in ((tx.MetaStore.load(path, device="cpu"), "cpu"),
                          (tx.MetaStore.load(path), "cuda")):
        assert loaded._dv.vectors.device.type == where
        a = store.query_batch(q, tx.Metric.Cosine).take(10, rerank_from=100).collect()
        b = loaded.query_batch(q, tx.Metric.Cosine).take(10, rerank_from=100).collect()
        assert b.indices == a.indices and len(loaded) == len(store)
        np.testing.assert_allclose(b.scores, a.scores, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The row-sharded stores on the card: every shard launches its kernel
# ---------------------------------------------------------------------------

# 128 queries over four shards of 40,960 rows: past the direct program's
# limit on every shard (and 64 queries over two of 81,920 on rows=2 x batch=2)
SHARDED_N, SHARDED_D, SHARDED_B = 150_000, 64, 128
SHARDED_CASES = [  # (storage, metric, certify, the kernel each shard launches)
    ("int8", "Cosine", True, "K1"),
    ("int8", "Cosine", False, "K2"),
    ("bfloat16", "DotProduct", True, "K5"),
    ("bfloat16", "Cosine", True, "K1-bf16"),
    ("float32", "Euclidean", None, "K4"),
]


def _sharded_store(storage, mesh, vecs):
    import otters_tpu_torch as tx

    idx = np.arange(len(vecs))
    cols = [tx.Column("price", tx.DataType.Float64).from_values(
        np.where((idx // 1024) % 2 == 0, 80.0, 10.0) + idx % 20)]
    return (tx.MetaStore.from_columns(cols).with_vectors(vecs).with_chunk_size(1024)
            .with_storage_dtype(storage).with_rerank_source(keep_host_f32=True)
            .build_sharded(mesh))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(4, 1), (2, 2)], ids=["rows4", "rows2x2"])
@pytest.mark.parametrize("storage,metric,certify,mode", SHARDED_CASES)
def test_sharded_stores_on_cuda_equal_cpu(storage, metric, certify, mode, layout):
    """A sharded store on the card (the card listed four times) against the
    same store on the CPU (the plain versions): each shard launches its
    kernel once per query, and the answers agree: the same rows in order,
    ``certified`` flags and pruned counts, scores within 1e-5 relative."""
    dev = _device()
    import otters_tpu_torch as tx
    from otters_tpu_torch import parallel

    rows, batch = layout
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(SHARDED_N, SHARDED_D)).astype(np.float32)
    q = rng.normal(size=(SHARDED_B, SHARDED_D)).astype(np.float32)
    out = []
    for device in ("cpu", dev):
        mesh = parallel.make_mesh(rows=rows, batch=batch, devices=[device] * 4)
        store = _sharded_store(storage, mesh, vecs)
        ft.reset_launches()
        plan = (store.query_batch(q, getattr(tx.Metric, metric))
                .meta_filter(tx.col("price").lt(50.0)))
        res = (plan.take(10, rerank_from=100, certify=certify) if certify is not None
               else plan.take(10)).collect()
        st = store.last_query_stats()
        out.append((res.indices, res.scores, st.certified, st.pruned_chunks))
        if device is dev:
            assert ft.KERNELS[mode].launches == rows * batch, {
                m: f.launches for m, f in ft.KERNELS.items()}
    assert out[1][0] == out[0][0] and out[1][2:] == out[0][2:]
    assert out[1][2] is (True if certify else None)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_sharded_save_on_cuda_load_on_cpu(tmp_path):
    """A sharded int8 store on the card saved as ``sharded-v1`` and loaded
    onto a CPU mesh and onto the card without one answers as it does."""
    dev = _device()
    import otters_tpu_torch as tx
    from otters_tpu_torch import parallel

    rng = np.random.default_rng(13)
    vecs = rng.normal(size=(SHARDED_N, SHARDED_D)).astype(np.float32)
    q = rng.normal(size=(SHARDED_B, SHARDED_D)).astype(np.float32)
    store = _sharded_store("int8", parallel.make_mesh(rows=4, devices=[dev] * 4), vecs)
    store.delete_rows(np.arange(0, SHARDED_N, 97))
    path = str(tmp_path / "sharded")
    store.save(path)
    want = store.query_batch(q, tx.Metric.Cosine).take(10, rerank_from=100).collect()
    for loaded in (tx.MetaStore.load(path, mesh=parallel.make_mesh(rows=4, devices=["cpu"] * 4)),
                   tx.MetaStore.load(path)):
        got = loaded.query_batch(q, tx.Metric.Cosine).take(10, rerank_from=100).collect()
        assert got.indices == want.indices and len(loaded) == len(store)
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Meshes that span processes on the card, and the disk layer of aot
# ---------------------------------------------------------------------------

_TWO_PROCESS_WORKER = r"""
import json, sys
import numpy as np
import torch
from otters_tpu_torch.parallel import init_distributed, make_mesh
from otters_tpu_torch.ops import fused_topk as ft
from test_torch_kernels_cuda import SHARDED_B, SHARDED_D, SHARDED_N, _sharded_store
import otters_tpu_torch as tx

coord, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
init_distributed(coord, 2, pid, local_devices=["cuda:0", "cuda:0"])
mesh = make_mesh(rows=4)
rng = np.random.default_rng(12)
vecs = rng.normal(size=(SHARDED_N, SHARDED_D)).astype(np.float32)
q = rng.normal(size=(SHARDED_B, SHARDED_D)).astype(np.float32)
store = _sharded_store("int8", mesh, vecs)
got = {}
for certify, mode in ((True, "K1"), (False, "K2")):
    ft.reset_launches()
    res = (store.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("price").lt(50.0))
           .take(10, rerank_from=100, certify=certify).collect())
    st = store.last_query_stats()
    got[mode] = [res.indices, [float(s) for s in res.scores], st.certified, st.pruned_chunks,
                 ft.KERNELS[mode].launches]
with open(f"{out}_{pid}.json", "w") as f:
    json.dump(got, f)
"""


def _run_two(code, args, timeout=300):
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(tests), tests]))
    procs = [subprocess.Popen([sys.executable, "-c", code, coord, str(pid), *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for pid in (0, 1)]
    for pid, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            pytest.fail("two-process workers timed out")
        assert p.returncode == 0, f"proc {pid}: {err[-3000:]}"


@pytest.mark.cuda
def test_two_processes_on_the_card_equal_a_cpu_mesh(tmp_path):
    """Two processes sharing the card (gloo between them, two of four
    ``rows=4`` shards each) launch K1 (certified) and K2 (``certify=False``)
    on each of their shards, and answer as the same store on a CPU
    ``rows=4`` mesh: the same rows in order and flags, scores within 1e-5."""
    import json

    import otters_tpu_torch as tx
    from otters_tpu_torch import parallel

    _device()
    out = str(tmp_path / "out")
    _run_two(_TWO_PROCESS_WORKER, [out])
    got = []
    for pid in (0, 1):
        with open(f"{out}_{pid}.json") as f:
            got.append(json.load(f))
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(SHARDED_N, SHARDED_D)).astype(np.float32)
    q = rng.normal(size=(SHARDED_B, SHARDED_D)).astype(np.float32)
    cpu = _sharded_store("int8", parallel.make_mesh(rows=4, devices=["cpu"] * 4), vecs)
    for certify, mode in ((True, "K1"), (False, "K2")):
        res = (cpu.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("price").lt(50.0))
               .take(10, rerank_from=100, certify=certify).collect())
        st = cpu.last_query_stats()
        for rank in got:
            indices, scores, certified, pruned, launches = rank[mode]
            assert launches == 2, (mode, launches)  # two shards a process, one launch each
            assert indices == res.indices and [certified, pruned] == [st.certified,
                                                                      st.pruned_chunks]
            np.testing.assert_allclose(scores, res.scores, rtol=1e-5, atol=1e-5)
        assert got[0][mode][:4] == got[1][mode][:4]


_BUILD_PROG = r"""
from otters_tpu_torch import aot, kernels
kernels.build(kernels.SOURCES)
for name in kernels.SOURCES:
    kernels.load(name)
print("STATS", aot.stats["compiles"], aot.stats["disk_hits"], kernels.nvcc_runs)
"""


@pytest.mark.cuda
def test_a_warm_process_builds_no_kernel(tmp_path):
    """On a fresh ``OTTERS_AOT_CACHE`` the first process runs nvcc once per
    source (seven; loading what it built is no disk hit), the second none
    and loads all seven from the disk."""
    import os
    import subprocess
    import sys

    _device()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OTTERS_AOT_CACHE=str(tmp_path), PYTHONPATH=repo)
    env.pop("OTTERS_DISABLE_AOT", None)
    stats = []
    for _ in range(2):
        res = subprocess.run([sys.executable, "-c", _BUILD_PROG], capture_output=True, text=True,
                             env=env, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        line = next(x for x in res.stdout.splitlines() if x.startswith("STATS"))
        stats.append([int(v) for v in line.split()[1:]])
    assert stats == [[7, 0, 7], [0, 7, 0]], stats
