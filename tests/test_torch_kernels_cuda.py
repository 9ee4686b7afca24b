"""K2 / K3 / K4 Hopper kernels against their plain torch versions, on the card.

These tests need a CUDA device and skip without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
torch: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``--noconftest`` skips ``tests/conftest.py``, which pins JAX to the CPU).

Tolerances: K2's int32 dots are exact in both versions, so the bin maxima
agree within 4 ulps (the epilogue multiplies are the same rounded ops, the
plain version's may be fused differently by torch); K3 sums in another
order than the plain f32 product, within d 2^-24 |q| |v|; K4 within
``high_precision_bound(d)`` |q| |v| (both are bf16x3 sums, of different
orders, each within the bound of the exact dot).
"""

import numpy as np
import pytest
import torch

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
    n_bins = n_pad // ft.BIN
    alive = torch.rand(n_bins, generator=g, device=dev) < 0.6
    surv, n_surv = ft.survivor_bins(alive)
    rmask = (dv.valid & (torch.rand(n_pad, generator=g, device=dev) < 0.9)).float()
    return [q.contiguous(), dv.vectors, dv.inv_norms, dv.norms_sq, rmask, q_inv, q_sq,
            torch.ones(b, device=dev), torch.full((1,), thr, device=dev), surv, n_surv]


def _tol(mode, args, metric):
    q, v = args[0].float(), args[1]
    d = q.shape[1]
    if mode == "K2":
        return 0.0
    base = d * 2.0**-24 if mode == "K3" else sc.high_precision_bound(d)
    if metric is Metric.Cosine:
        return base
    scale = float(q.norm(dim=1).max()) * float(args[3].max().sqrt())
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
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,metric,take_min,cmp,thr", CASES)
@pytest.mark.parametrize("d", [128, 100])
def test_kernel_matches_plain(mode, metric, take_min, cmp, thr, d):
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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["K2", "K3", "K4"])
def test_no_live_bin_leaves_every_bin_neg_inf(mode):
    dev = _device()
    args = _operands(mode, dev, n=5000)
    args[9], args[10] = ft.survivor_bins(
        torch.zeros(args[1].shape[0] // ft.BIN, dtype=torch.bool, device=dev)
    )
    out = ft.KERNELS[mode](*args)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(out).all())
