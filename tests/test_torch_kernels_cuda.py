"""The Hopper kernels against their plain torch versions, on the card.

K2 / K3 / K4 / K6 over int8 / f32 rows; over bfloat16 rows K1 (certified
Cosine), K3, K4, K5 (the general certified fold, Dot and Euclid) and K6;
the three profiling probes (``profile_variants``).

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
"""

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
    """K6 stages 16-element steps, so d = 100 runs it at 112."""
    dev = _device()
    if d % 16 and mode == "K6":
        d = 112
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
    """The bf16-row modes; the certified scan's (K1, K5, K6) need d % 16 ==
    0, so d = 100 runs them at 112."""
    dev = _device()
    if d % 16 and mode in ("K1-bf16", "K5", "K6-bf16"):
        d = 112
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
def test_k6_dots_equal_float64_of_the_rounded_operands():
    """Unit norms, Dot metric, one unmasked row per bin: each K6 bin max is
    that row's accumulated one-pass dot, within d 2^-24 |qh| |vh| of the
    float64 product of the bf16-rounded operands (the products are exact,
    only the f32 sums round)."""
    dev = _device()
    d = 768
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
@pytest.mark.parametrize("d,b", [(768, 256), (100, 70)])
def test_probe_matches_plain(name, d, b):
    """Each probe against its plain version at 64 tiles of 1024 rows: the
    f32 probes within d 2^-24 |q| |v| (two f32 sums in other orders), the
    bf16x3 one within ``high_precision_bound(d)`` |q| |v|."""
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
