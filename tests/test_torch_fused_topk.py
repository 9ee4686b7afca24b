"""The fused kernels' plain versions and the fused top-k against the TPU kernel.

One store, built by the JAX package and carried across with
``state.device_vecs_from_numpy``, goes through the JAX Pallas kernel
(``interpret=True``) and the port's plain versions:

- K1 (certified cosine over int8 rows): the finite / -inf pattern of the bin
  maxima is equal and the values agree within ``mixed_cert_eps(d)`` (the
  scan's accumulation order differs); the fused top-k returns the same rows
  in the same order with a bound within the same tolerance.
- K2 (uncertified int8): the int32 dots are equal (both exact), the bin
  maxima within 4 ulps; K3 (exact f32) within d 2^-24 relative; K4 (bf16x3)
  within ``high_precision_bound(d)``. ``fused_topk`` in each mode returns
  the same rows in the same order as ``pallas_topk``, scores within 1e-6,
  and the same ``check``, including a check that fails on exact ties.

CUDA-only tests hold the Hopper kernels against their plain versions on the
card (``tests/test_torch_kernels_cuda.py`` for K2 - K5 and the bf16-row
modes); the bf16-row modes' parity with JAX is in ``tests/test_torch_bf16.py``.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from otters_tpu.ops import pallas_topk as pk
from otters_tpu.ops import scoring as js
from otters_tpu.types import Cmp as JCmp
from otters_tpu.types import Metric as JMetric
from otters_tpu_torch.ops import fused_topk as ft
from otters_tpu_torch.ops import scoring as ts
from otters_tpu_torch.state import device_vecs_from_numpy
from otters_tpu_torch.types import Cmp, Metric
import torch_parity  # noqa: F401  (sets the torch thread count)

N, D, B, TILE = 16384, 64, 5, 1024


def _store(seed=0, d=D):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N - 300, d)).astype(np.float32)  # padding rows too
    return js.materialize(v, dtype=jnp.int8)


def _queries(seed=1, b=B, d=D):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


def _tile_alive(n_tiles, seed=2):
    alive = np.random.default_rng(seed).random(n_tiles) < 0.6
    alive[0] = True
    alive[-1] = False
    return alive


def _row_mask(n_pad, alive, tile):
    """A row mask that every row of a dead tile fails (what zonemap pruning
    guarantees), with some rows of live tiles masked too."""
    rm = np.repeat(alive, tile)[:n_pad].copy()
    rm &= np.random.default_rng(3).random(n_pad) < 0.9
    return rm


def _jax_bins(dj, q, rm, alive, thr, cmp):
    """JAX's K1 bin maxima [n_tiles, nb, bo], set up as _pallas_topk_jit
    does it (certified cosine), through pallas_call in interpret mode."""
    n_pad, d = dj.vectors.shape
    b = q.shape[0]
    qh32, c0, c1, c2 = js.cert_query_coeffs(JMetric.Cosine, jnp.asarray(q), d)
    lane_a, lane_b = js.cert_row_lanes(
        JMetric.Cosine, dj.vectors.dtype, dj.resid, dj.inv_norms, dj.norms_sq, d
    )
    q_sq, q_inv = js._query_norms(qh32)
    slack_g = js.cert_global_slack(c0, c1, c2, lane_a, lane_b, dj.norms_sq)
    thr1 = jnp.float32(thr) - slack_g if cmp is not None else jnp.float32(thr)
    b_pad = pk._pad_b(b)
    bo = pk._round_up(b_pad, pk.LANE)
    n_tiles = alive.shape[0]
    t = n_pad // n_tiles
    nb = t // pk.BIN
    q_pad = jnp.zeros((b_pad, d), jnp.bfloat16).at[:b].set(qh32.astype(jnp.bfloat16))
    qaux = jnp.zeros((4, bo), jnp.float32)
    qaux = qaux.at[0, :b].set(q_inv).at[1, :b].set(q_sq).at[2, :b].set(1.0)
    rmask01 = dj.valid.astype(jnp.float32) * jnp.asarray(rm).astype(jnp.float32)
    aux = jnp.stack([dj.inv_norms, dj.norms_sq, rmask01, lane_a])
    alive_i = jnp.asarray(alive).astype(jnp.int32)
    n_surv = alive_i.sum()
    surv = jnp.asarray(np.concatenate([np.flatnonzero(alive),
                                       np.zeros(n_tiles - alive.sum(), np.int64)])).astype(jnp.int32)
    last = surv[jnp.maximum(n_surv - 1, 0)]
    g = jnp.arange(n_tiles)
    surv = jnp.where(g < n_surv, surv, last)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((b_pad, d), lambda g, s, n, th: (0, 0)),
            pl.BlockSpec((t, d), lambda g, s, n, th: (s[g], 0)),
            pl.BlockSpec((4, t), lambda g, s, n, th: (0, s[g])),
            pl.BlockSpec((4, bo), lambda g, s, n, th: (0, 0)),
        ],
        out_specs=pl.BlockSpec(
            (1, nb, bo), lambda g, s, n, th: (jnp.minimum(g, jnp.maximum(n[0] - 1, 0)), 0, 0)
        ),
    )
    bins = pl.pallas_call(
        partial(pk._kernel, metric=JMetric.Cosine, take_min=False, cmp=cmp,
                prec="highest", nb=nb, bo=bo, certify=True, cert_cos=True),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_tiles, nb, bo), jnp.float32),
        interpret=True,
    )(surv, n_surv.reshape(1), thr1.reshape(1), q_pad, dj.vectors, aux, qaux)
    bins = np.asarray(bins)
    out = np.full((n_pad // pk.BIN, b), -np.inf, np.float32)
    for gi, tile in enumerate(np.flatnonzero(alive)):
        out[tile * nb : (tile + 1) * nb] = bins[gi, :, :b]
    return out


def _port_inputs(dt, q, rm, alive, thr, cmp, tile):
    n_pad, d = dt.vectors.shape
    qt = torch.from_numpy(q)
    qh32, c0, c1, c2 = ts.cert_query_coeffs(Metric.Cosine, qt, d)
    lane_a, lane_b = ts.cert_row_lanes(
        Metric.Cosine, torch.int8, dt.resid, dt.inv_norms, dt.norms_sq, d
    )
    _, q_inv = ts._query_norms(qh32)
    slack = ts.cert_global_slack(c0, c1, c2, lane_a, lane_b, dt.norms_sq)
    thr1 = torch.tensor(thr) - slack if cmp is not None else torch.tensor(thr)
    rmask = dt.valid.float() * torch.from_numpy(rm).float()
    bin_alive = torch.from_numpy(np.repeat(alive, tile // ft.BIN))
    surv, n_surv = ft.survivor_bins(bin_alive)
    return (qh32.to(torch.bfloat16), dt.vectors, dt.inv_norms, rmask, lane_a,
            q_inv, torch.ones(q.shape[0]), thr1.reshape(1).float(), surv, n_surv)



def _numpy_fields(dj):
    """A JAX ``DeviceVecs``'s fields as numpy (absent fields stay None)."""
    return [None if x is None else np.asarray(x) for x in dj]

@pytest.mark.parametrize("cmp,thr", [(None, 0.0), ("Gt", 0.2), ("Gte", 0.15)])
def test_k1_plain_matches_tpu_kernel_bins(cmp, thr):
    dj = _store()
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = _queries()
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE)
    rm = _row_mask(n_pad, alive, TILE)
    want = _jax_bins(dj, q, rm, alive, thr, None if cmp is None else getattr(JCmp, cmp))
    args = _port_inputs(dt, q, rm, alive, thr, cmp, TILE)
    got = ft.cert_cos_binmax(*args, None if cmp is None else getattr(Cmp, cmp)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 50 and (~fin).sum() > 50
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ts.mixed_cert_eps(D))


@pytest.mark.parametrize("b,cmp,thr", [(1, None, 0.0), (300, "Gt", 0.2)])
def test_k1_plain_matches_tpu_kernel_bins_at_batch(b, cmp, thr):
    """One query (one padded 64-query block) and 300 (five blocks, the
    last one partial): the same agreement as above."""
    dj = _store(seed=11)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = _queries(seed=12, b=b)
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE, seed=13)
    rm = _row_mask(n_pad, alive, TILE)
    want = _jax_bins(dj, q, rm, alive, thr, None if cmp is None else getattr(JCmp, cmp))
    args = _port_inputs(dt, q, rm, alive, thr, cmp, TILE)
    got = ft.cert_cos_binmax(*args, None if cmp is None else getattr(Cmp, cmp)).numpy()
    assert got.shape == want.shape == (n_pad // ft.BIN, b)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 10 and (~fin).sum() > 10
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=ts.mixed_cert_eps(D))


@pytest.mark.parametrize("cmp,thr,k", [(None, 0.0, 10), ("Gt", 0.25, 40), (None, 0.0, 300)])
def test_fused_topk_matches_pallas_topk(cmp, thr, k):
    dj = _store(seed=4)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = _queries(seed=5)
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE, seed=6)
    rm = _row_mask(n_pad, alive, TILE)
    jc = None if cmp is None else getattr(JCmp, cmp)
    rows_j, sc_j, ok_j, _, bound_j = pk.pallas_topk(
        dj.vectors, dj.norms_sq, dj.inv_norms, dj.valid, jnp.asarray(q),
        jnp.asarray(rm), jnp.float32(thr), jnp.asarray(alive),
        metric=JMetric.Cosine, k=k, take_min=False, cmp=jc, interpret=True,
        certify=True, resid=dj.resid, resid_bin=dj.resid_bin,
    )
    rows_t, sc_t, ok_t, check, bound_t = ft.fused_topk(
        dt.vectors, dt.norms_sq, dt.inv_norms, dt.valid, torch.from_numpy(q),
        torch.from_numpy(rm), torch.tensor(thr),
        torch.from_numpy(np.repeat(alive, TILE // ft.BIN)),
        metric=Metric.Cosine, k=k, take_min=False,
        cmp=None if cmp is None else getattr(Cmp, cmp), certify=True, resid=dt.resid,
    )
    ok_j = np.asarray(ok_j)
    assert ok_t.tolist() == ok_j.tolist()
    assert rows_t[ok_t].tolist() == np.asarray(rows_j)[ok_j].tolist()
    np.testing.assert_allclose(sc_t[ok_t].numpy(), np.asarray(sc_j)[ok_j],
                               atol=ts.mixed_cert_eps(D))
    assert abs(float(bound_t) - float(bound_j)) <= ts.mixed_cert_eps(D)
    assert bool(check)


def test_survivor_list_and_bin_liveness():
    cm = torch.tensor([True, False, False, True, False])
    # chunk 700 rows over 512-row bins: bins straddle chunks
    alive = ft.bins_alive_from_chunk_mask(cm, 700, 7 * 512)
    rows_alive = np.repeat(cm.numpy(), 700)[: 7 * 512]
    want = np.zeros(7, bool)
    for i in range(7):
        want[i] = rows_alive[i * 512 : (i + 1) * 512].any() if i * 512 < len(rows_alive) else False
    assert alive.tolist() == want.tolist()
    surv, n = ft.survivor_bins(alive)
    assert int(n[0]) == want.sum()
    assert surv[: int(n[0])].tolist() == np.flatnonzero(want).tolist()
    empty, n0 = ft.survivor_bins(torch.zeros(4, dtype=torch.bool))
    assert int(n0[0]) == 0 and empty.tolist() == [0, 0, 0, 0]


def test_unported_kernel_modes_raise():
    """No mode raises any more: every one names its kernel, K1 .. K4 and K6
    over int8 / f32 rows, K1 / K3 / K4 / K6 over bfloat16 rows and K5 (the
    general certified fold) for bf16 Dot and Euclid; the one-pass
    precisions ("default" / "bf16") take K6, an unknown precision raises
    ValueError."""
    for prec in ("default", "bf16"):
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "-bf16")):
            for metric in (Metric.Cosine, Metric.DotProduct, Metric.Euclidean):
                assert ft.kernel_mode(dtype, metric, False, False, prec) == "K6" + sfx
    with pytest.raises(ValueError, match="unknown store precision"):
        ft.kernel_mode(torch.float32, Metric.Cosine, False, False, "half")
    with pytest.raises(ValueError, match="no certificate"):
        ft.kernel_mode(torch.float32, Metric.Cosine, False, True)
    with pytest.raises(ValueError, match="no certificate"):
        ft.kernel_mode(torch.bfloat16, Metric.Euclidean, False, True)
    assert ft.kernel_mode(torch.int8, Metric.Cosine, False, True) == "K1"
    assert ft.kernel_mode(torch.int8, Metric.Cosine, True, False) == "K2"
    assert ft.kernel_mode(torch.bfloat16, Metric.Cosine, False, True) == "K1-bf16"
    assert ft.kernel_mode(torch.bfloat16, Metric.DotProduct, False, True) == "K5"
    assert ft.kernel_mode(torch.bfloat16, Metric.Euclidean, True, True) == "K5"
    for metric in (Metric.Cosine, Metric.DotProduct, Metric.Euclidean):
        for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "-bf16")):
            assert ft.kernel_mode(dtype, metric, False, False) == "K3" + sfx
            assert ft.kernel_mode(dtype, metric, False, False, fast=True) == "K4" + sfx
            assert ft.kernel_mode(dtype, metric, False, False, "high") == "K4" + sfx


@pytest.mark.cuda
def test_k1_cuda_kernel_matches_plain():
    """On the card: the Hopper kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dj = _store(seed=8, d=128)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cuda")
    q = _queries(seed=9, b=70, d=128)
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE, seed=10)
    rm = _row_mask(n_pad, alive, TILE)
    args = [a.cuda() for a in _port_inputs(dt, q, rm, alive, 0.1, "Gt", TILE)]
    before = ft.cert_cos_binmax.launches
    got = ft.cert_cos_binmax(*args, Cmp.Gt)
    torch.cuda.synchronize()
    assert ft.cert_cos_binmax.launches == before + 1
    want = ft.cert_cos_binmax_plain(*args, Cmp.Gt)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    fin = np.isfinite(w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=ts.mixed_cert_eps(128))


# ---------------------------------------------------------------------------
# K2 / K3 / K4
# ---------------------------------------------------------------------------

MODE_PREC = {"K2": "highest", "K3": "highest", "K4": "high"}


def _f32_store(seed=0, d=D):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N - 300, d)).astype(np.float32)
    v[17] = 0.0  # a zero row
    v[40] *= 1e3  # a long one
    return js.materialize(v)


def _mode_store(mode, seed=0):
    return _store(seed) if mode == "K2" else _f32_store(seed)


def _jax_mode_bins(mode, dj, q, rm, alive, thr, cmp, metric, take_min):
    """JAX's uncertified _kernel bin maxima [n_bins, b] for one mode, set up
    as _pallas_topk_jit sets them up, through pallas_call in interpret
    mode; also the kernel's query operand."""
    n_pad, d = dj.vectors.shape
    b = q.shape[0]
    if mode == "K2":
        q_kern, _, _ = js._quantize_rows_int8(jnp.asarray(q))
        qf = q_kern.astype(jnp.float32)
    else:
        q_kern = qf = jnp.asarray(q)
    q_sq, q_inv = js._query_norms(qf)
    b_pad = pk._pad_b(b)
    bo = pk._round_up(b_pad, pk.LANE)
    n_tiles = alive.shape[0]
    t = n_pad // n_tiles
    nb = t // pk.BIN
    q_pad = jnp.zeros((b_pad, d), q_kern.dtype).at[:b].set(q_kern)
    qaux = jnp.zeros((4, bo), jnp.float32)
    qaux = qaux.at[0, :b].set(q_inv).at[1, :b].set(q_sq).at[2, :b].set(1.0)
    rmask01 = dj.valid.astype(jnp.float32) * jnp.asarray(rm).astype(jnp.float32)
    aux = jnp.stack([dj.inv_norms, dj.norms_sq, rmask01, jnp.zeros(n_pad, jnp.float32)])
    n_surv = int(alive.sum())
    surv = np.concatenate([np.flatnonzero(alive), np.zeros(n_tiles - n_surv, np.int64)])
    surv = jnp.asarray(np.where(np.arange(n_tiles) < n_surv, surv, surv[max(n_surv - 1, 0)]))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((b_pad, d), lambda g, s, n, th: (0, 0)),
            pl.BlockSpec((t, d), lambda g, s, n, th: (s[g], 0)),
            pl.BlockSpec((4, t), lambda g, s, n, th: (0, s[g])),
            pl.BlockSpec((4, bo), lambda g, s, n, th: (0, 0)),
        ],
        out_specs=pl.BlockSpec(
            (1, nb, bo), lambda g, s, n, th: (jnp.minimum(g, jnp.maximum(n[0] - 1, 0)), 0, 0)
        ),
    )
    bins = pl.pallas_call(
        partial(pk._kernel, metric=metric, take_min=take_min, cmp=cmp,
                prec=MODE_PREC[mode], nb=nb, bo=bo),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_tiles, nb, bo), jnp.float32),
        interpret=True,
    )(surv.astype(jnp.int32), jnp.int32(n_surv).reshape(1),
      jnp.float32(thr).reshape(1), q_pad, dj.vectors, aux, qaux)
    bins = np.asarray(bins)
    out = np.full((n_pad // pk.BIN, b), -np.inf, np.float32)
    for gi, tile in enumerate(np.flatnonzero(alive)):
        out[tile * nb : (tile + 1) * nb] = bins[gi, :, :b]
    return out, np.asarray(q_kern)


def _mode_args(mode, dt, q_kern, rm, alive, thr, tile=TILE):
    qk = torch.from_numpy(np.array(q_kern))
    q_sq, q_inv = ts._query_norms(qk.float())
    rmask = dt.valid.float() * torch.from_numpy(rm).float()
    surv, n_surv = ft.survivor_bins(torch.from_numpy(np.repeat(alive, tile // ft.BIN)))
    return (qk, dt.vectors, dt.inv_norms, dt.norms_sq, rmask, q_inv, q_sq,
            torch.ones(qk.shape[0]), torch.tensor([thr], dtype=torch.float32), surv, n_surv)


MODE_CASES = [
    ("K2", "Cosine", False, None, 0.0),
    ("K2", "Cosine", False, "Gt", 0.1),
    ("K2", "Cosine", True, "Lt", -0.1),
    ("K3", "Cosine", False, "Gte", 0.05),
    ("K3", "DotProduct", False, None, 0.0),
    ("K3", "Euclidean", True, "Lte", 130.0),
    ("K3", "DotProduct", False, "Eq", 0.0),
    ("K4", "Cosine", False, None, 0.0),
    ("K4", "DotProduct", False, "Gt", 1.0),
    ("K4", "Euclidean", True, "Lt", 125.0),
]


@pytest.mark.parametrize("mode,metric,take_min,cmp,thr", MODE_CASES)
def test_mode_plain_matches_tpu_kernel_bins(mode, metric, take_min, cmp, thr):
    dj = _mode_store(mode, seed=11)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = _queries(seed=12)
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE, seed=13)
    rm = _row_mask(n_pad, alive, TILE)
    want, q_kern = _jax_mode_bins(mode, dj, q, rm, alive, thr,
                                  None if cmp is None else getattr(JCmp, cmp),
                                  getattr(JMetric, metric), take_min)
    args = _mode_args(mode, dt, q_kern, rm, alive, thr)
    got = ft.KERNELS[mode](*args, getattr(Metric, metric), take_min,
                           None if cmp is None else getattr(Cmp, cmp)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert (~fin).sum() > 50
    if cmp == "Eq":  # only the zero row's bin scores exactly 0.0
        assert fin.sum() == q.shape[0] and fin[0].all()
    else:
        assert fin.sum() > 50
    if mode == "K2":
        _ulps_close(got[fin], want[fin])
        return
    # relative to |q| |v|: the bin's best row is not known here, so bound
    # by the largest norms of the store and the batch
    qn = np.linalg.norm(q, axis=1).max()
    vn = np.sqrt(np.asarray(dj.norms_sq).max())
    scale = 1.0 if metric == "Cosine" else qn * vn
    tol = (D * 2.0**-24 if mode == "K3" else ts.high_precision_bound(D)) * scale
    if metric == "Euclidean":
        tol = 2 * tol + 4 * np.spacing(np.float32(np.abs(want[fin]).max()))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol)


def _ulps_close(a, b, n=4):
    tol = n * np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    np.testing.assert_array_less(np.abs(a - b), tol + np.finfo(np.float32).tiny)


def test_k2_int32_dots_equal_exact_integer_product():
    """K2's plain dots are the exact integer product, equal to JAX's int32
    MXU dots (unit norms, no mask: the bin max of a one-row bin is its dot)."""
    dj = _store(seed=14)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q8, _, _ = js._quantize_rows_int8(jnp.asarray(_queries(seed=15)))
    q8 = np.asarray(q8)
    v8 = np.asarray(dj.vectors)
    n_pad = v8.shape[0]
    rows = np.arange(0, n_pad, ft.BIN) + 7
    rm = np.zeros(n_pad, np.float32)
    rm[rows] = 1.0
    b = q8.shape[0]
    surv, n_surv = ft.survivor_bins(torch.ones(n_pad // ft.BIN, dtype=torch.bool))
    got = ft.int8_binmax(
        torch.from_numpy(q8), dt.vectors, torch.ones(n_pad), torch.zeros(n_pad),
        torch.from_numpy(rm), torch.ones(b), torch.zeros(b), torch.ones(b),
        torch.zeros(1), surv, n_surv, Metric.DotProduct,
    ).numpy()
    exact = q8.astype(np.int64) @ v8[rows].astype(np.int64).T
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(q8), jnp.asarray(v8[rows]), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(want, exact)
    np.testing.assert_array_equal(got.T, exact.astype(np.float32))


def _fused_pair(mode, metric, take_min, cmp, thr, k, *, seed=21, dj=None, q=None,
                fast=None, alive=None, rm=None):
    dj = _mode_store(mode, seed) if dj is None else dj
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = _queries(seed=seed + 1) if q is None else q
    n_pad = dj.vectors.shape[0]
    if alive is None:
        alive = _tile_alive(n_pad // TILE, seed=seed + 2)
        rm = _row_mask(n_pad, alive, TILE)
    fast = (mode == "K4") if fast is None else fast
    jc = None if cmp is None else getattr(JCmp, cmp)
    prec = "high" if (mode == "K4" and not fast) else "highest"
    out_j = pk.pallas_topk(
        dj.vectors, dj.norms_sq, dj.inv_norms, dj.valid, jnp.asarray(q),
        None if rm is None else jnp.asarray(rm), jnp.float32(thr), jnp.asarray(alive),
        metric=getattr(JMetric, metric), k=k, take_min=take_min, cmp=jc, prec=prec,
        interpret=True, fast=fast,
    )
    out_t = ft.fused_topk(
        dt.vectors, dt.norms_sq, dt.inv_norms, dt.valid, torch.from_numpy(q),
        None if rm is None else torch.from_numpy(rm), torch.tensor(thr),
        torch.from_numpy(np.repeat(alive, n_pad // alive.shape[0] // ft.BIN)),
        metric=getattr(Metric, metric), k=k, take_min=take_min,
        cmp=None if cmp is None else getattr(Cmp, cmp), prec=prec, fast=fast,
    )
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]


FUSED_CASES = [
    ("K2", "Cosine", False, None, 0.0, 10),
    ("K2", "Cosine", False, "Gte", 0.15, 60),
    ("K3", "Cosine", False, "Eq", 0.0, 10),
    ("K3", "Euclidean", True, "Lt", 120.0, 300),
    ("K3", "DotProduct", False, None, 0.0, 200),
    ("K4", "Cosine", False, "Gt", 0.2, 10),
    ("K4", "DotProduct", False, None, 0.0, 40),
    ("K4", "Euclidean", True, None, 0.0, 12),
]


@pytest.mark.parametrize("mode,metric,take_min,cmp,thr,k", FUSED_CASES)
def test_fused_topk_mode_matches_pallas_topk(mode, metric, take_min, cmp, thr, k):
    (rows_j, sc_j, ok_j, check_j, _), (rows_t, sc_t, ok_t, check_t, _) = _fused_pair(
        mode, metric, take_min, cmp, thr, k
    )
    assert ok_t.tolist() == ok_j.tolist()
    assert rows_t[ok_t].tolist() == rows_j[ok_j].tolist()
    np.testing.assert_allclose(sc_t[ok_t], sc_j[ok_j], rtol=1e-6, atol=1e-6)
    assert bool(check_t) == bool(check_j)
    if cmp != "Eq":
        assert ok_t.sum() > 0
    if mode == "K4" and metric == "Cosine":
        assert bool(check_t)  # the long row voids the others' global slack


def test_fast_check_fails_on_exact_ties_like_jax():
    """The k-th row copied into more than 4k bins: the fast mode cannot
    examine them all, its check fails in both packages, and the strict K3
    rerun then gives both the same rows."""
    k = 5
    rng = np.random.default_rng(31)
    v = rng.normal(size=(N - 300, D)).astype(np.float32)
    q = rng.normal(size=(1, D)).astype(np.float32)
    v[: k - 1] = q + 0.1 * rng.normal(size=(k - 1, D))
    tie = q[0] + 0.5 * rng.normal(size=D)
    v[np.arange(4 * k + 3) * ft.BIN + 100] = tie
    dj = js.materialize(v.astype(np.float32))
    alive = np.ones(dj.vectors.shape[0] // TILE, bool)
    for metric, take_min in (("Cosine", False), ("DotProduct", False), ("Euclidean", True)):
        (rows_j, sc_j, ok_j, check_j, _), (rows_t, sc_t, ok_t, check_t, _) = _fused_pair(
            "K4", metric, take_min, None, 0.0, k, dj=dj, q=q, alive=alive
        )
        assert not bool(check_j) and not bool(check_t)
        (rows_j, sc_j, ok_j, _, _), (rows_t, sc_t, ok_t, check_t, _) = _fused_pair(
            "K3", metric, take_min, None, 0.0, k, dj=dj, q=q, alive=alive, fast=False
        )
        assert bool(check_t)
        assert rows_t.tolist() == rows_j.tolist()
        if metric == "Cosine":
            assert rows_t.tolist() == [1, 0, 2, 3, 100]  # the lowest copy last
        # Euclid's q^2 + v^2 - 2 q.v cancels: the two packages' dot orders
        # differ by ulps of q^2 + v^2, not of the small distance
        scale = float((q * q).sum() + (v[rows_t] ** 2).sum(axis=1).max())
        atol = 4 * np.spacing(np.float32(scale)) if metric == "Euclidean" else 1e-6
        np.testing.assert_allclose(sc_t, sc_j, rtol=1e-6, atol=atol)


def test_fast_ok_matches_jax():
    for metric in ("Cosine", "DotProduct", "Euclidean", "Manhattan"):
        for cmp in (None, "Gt", "Lt", "Eq"):
            for k, prec in ((10, "highest"), (129, "highest"), (10, "high")):
                want = pk.fast_ok(getattr(JMetric, metric), False,
                                  None if cmp is None else getattr(JCmp, cmp), k, prec)
                got = ft.fast_ok(getattr(Metric, metric), False,
                                 None if cmp is None else getattr(Cmp, cmp), k, prec)
                assert got == want
    assert ts.high_precision_bound(768) == js.high_precision_bound(768)
