"""K1 (certified-cosine bin maxima over int8 rows) against the TPU kernel.

One int8 store, built by the JAX package and carried across with
``state.device_vecs_from_numpy``, goes through the JAX Pallas kernel
(``interpret=True``) and the port's K1 plain version: the finite / -inf
pattern of the bin maxima is equal and the values agree within
``mixed_cert_eps(d)`` (the scan's accumulation order differs); the fused
top-k then returns the same rows in the same order with a bound within the
same tolerance. A CUDA-only test holds the Hopper kernel against the plain
version on the card.
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


@pytest.mark.parametrize("cmp,thr", [(None, 0.0), ("Gt", 0.2), ("Gte", 0.15)])
def test_k1_plain_matches_tpu_kernel_bins(cmp, thr):
    dj = _store()
    dt = device_vecs_from_numpy(*[np.asarray(x) for x in dj], device="cpu")
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


@pytest.mark.parametrize("cmp,thr,k", [(None, 0.0, 10), ("Gt", 0.25, 40), (None, 0.0, 300)])
def test_fused_topk_matches_pallas_topk(cmp, thr, k):
    dj = _store(seed=4)
    dt = device_vecs_from_numpy(*[np.asarray(x) for x in dj], device="cpu")
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
    for dtype, certify, name in ((torch.int8, False, "K2"), (torch.float32, False, "K3"),
                                 (torch.float32, True, "K5")):
        with pytest.raises(NotImplementedError, match=name):
            ft.kernel_mode(dtype, Metric.Cosine, False, certify)


@pytest.mark.cuda
def test_k1_cuda_kernel_matches_plain():
    """On the card: the Hopper kernel against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dj = _store(seed=8, d=128)
    dt = device_vecs_from_numpy(*[np.asarray(x) for x in dj], device="cuda")
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
