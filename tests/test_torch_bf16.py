"""bfloat16 storage in the port against the JAX package.

The same numpy inputs go through ``otters_tpu`` (JAX on the CPU, its Pallas
kernel in interpret mode) and ``otters_tpu_torch`` (CPU device, the kernels'
plain versions):

- storage: the stored bf16 codes are equal bit for bit (also when a JAX
  store is carried across with ``state.device_vecs_from_numpy``); norms and
  inverse norms within 4 ulps; the residuals and the certificate's c0 / c1 /
  c2 / lane_a / lane_b within a relative 2e-5 (cancellations that amplify
  the ulps of sums taken in another order);
- the kernel modes over bf16 rows (K1 certified Cosine, K5 the general
  certified fold for Dot and Euclid, K3 exact f32, K4 bf16x3): bin maxima
  within ``4 d 2^-24 |qh| max|v|`` (twice for Euclid; |qh| |v| = 1 for
  Cosine) plus 4 ulps of the key, and the same finite / -inf pattern;
- ``fused_topk`` against ``pallas_topk``: the same rows in the same order,
  and the certificate's bound within the same tolerance;
- ``MetaStore`` (twins of ``tests/test_cert_metrics.py``'s non-sharded
  tests, for all three metrics): the same indices in order, scores within
  1e-6 (relative for Dot, the ulps of q^2 + v^2 for Euclid), the same
  ``certified`` / ``scan_k_wide`` / pruned / evaluated counts, through
  ``collect()`` and ``collect_async`` + ``resolve``, on the direct program
  and on the fused path; uncertified ``take(k)`` through K4 and its strict
  K3 rerun.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.meta import resolve as jresolve
from otters_tpu.ops import pallas_topk as pk
from otters_tpu.ops import scoring as js
from otters_tpu_torch.ops import fused_topk as ft
from otters_tpu_torch.ops import scoring as ts
from otters_tpu_torch.state import device_vecs_from_numpy
from test_cert_metrics import _oracle
from torch_parity import stats_tuple, twin_stores, use_fused_path

METRICS = ["Cosine", "DotProduct", "Euclidean"]
PATHS = ["direct", "fused"]
N, D, B, TILE = 16384, 64, 5, 1024


def _ulps(a, b, n=4):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tol = n * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    np.testing.assert_array_less(np.abs(a - b), tol + np.finfo(np.float32).tiny)


def _rel(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=0)


def _codes(x):
    """bf16 values as their 16-bit codes (numpy has no bf16 of its own)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _data(n=3000, d=96, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    v[5] = 0.0  # zero row
    v[6] *= 1e-3
    v[7] = np.round(v[7] * 4) / 4  # exact in bf16: a true 0 residual
    v[8] *= 40.0
    return v


def _numpy_fields(dj):
    return [None if x is None else np.asarray(x) for x in dj]


# ---------------------------------------------------------------------------
# Storage and certificate terms
# ---------------------------------------------------------------------------


def test_bf16_materialize_bit_equal_codes_and_close_terms():
    v = _data()
    dj = js.materialize(v, dtype=jnp.bfloat16)
    dt = ts.materialize(v, dtype=torch.bfloat16, device="cpu")
    assert dt.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_codes(dt.vectors), _codes(dj.vectors))
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    for name in ("norms_sq", "inv_norms"):
        _ulps(getattr(dt, name).numpy(), getattr(dj, name))
    for name in ("resid", "resid_bin", "resid_max"):
        _rel(getattr(dt, name).numpy(), getattr(dj, name))
    assert float(dt.resid[7]) == 0.0 and float(dt.resid[8]) > 0.0


def test_bf16_slabs_and_device_ingest_equal_one_shot():
    v = _data(2500, 64, seed=1)
    whole = ts.materialize(v, dtype=torch.bfloat16, device="cpu")
    n_pad = ts.pad_rows(len(v))
    padded = torch.zeros((n_pad, 64))
    padded[: len(v)] = torch.from_numpy(v)
    slabs = ts._materialize_bf16(padded, len(v), slab_rows=700)
    from_dev = ts.materialize_from_device(torch.from_numpy(v), dtype=torch.bfloat16)
    for dv in (slabs, from_dev):
        for a, b in zip(dv, whole):
            np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    # rows already in bf16 are the storage as they are: no residuals
    again = ts.materialize_from_device(whole.vectors)
    assert again.vectors.dtype == torch.bfloat16 and again.resid is None


def test_bf16_state_carry_is_bit_for_bit():
    dj = js.materialize(_data(1000, 32, seed=2), dtype=jnp.bfloat16)
    assert np.asarray(dj.vectors).dtype.name == "bfloat16"
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    assert dt.vectors.dtype == torch.bfloat16
    np.testing.assert_array_equal(_codes(dt.vectors), _codes(dj.vectors))
    for a, b in zip(dt[1:], dj[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("metric", METRICS)
def test_cert_query_coeffs_close(metric):
    rng = np.random.default_rng(4)
    q = (rng.normal(size=(6, 96)) * 3.0).astype(np.float32)
    q[2] = 0.0
    q[3] = 1e-41  # nonzero in f32, zero in bf16
    jm, tm = getattr(jx.Metric, metric), getattr(tx.Metric, metric)
    qj, c0j, c1j, c2j = js.cert_query_coeffs(jm, jnp.asarray(q), 96)
    qt, c0t, c1t, c2t = ts.cert_query_coeffs(tm, torch.from_numpy(q), 96)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))  # bf16 rounding
    for a, b in ((c0t, c0j), (c1t, c1j), (c2t, c2j)):
        _rel(a.numpy(), b)


@pytest.mark.parametrize("metric", METRICS)
def test_cert_row_lanes_close(metric):
    dj = js.materialize(_data(2000, 64, seed=3), dtype=jnp.bfloat16)
    dt = ts.materialize(_data(2000, 64, seed=3), dtype=torch.bfloat16, device="cpu")
    jm, tm = getattr(jx.Metric, metric), getattr(tx.Metric, metric)
    la_j, lb_j = js.cert_row_lanes(jm, dj.vectors.dtype, dj.resid, dj.inv_norms,
                                   dj.norms_sq, 64)
    la_t, lb_t = ts.cert_row_lanes(tm, dt.vectors.dtype, dt.resid, dt.inv_norms,
                                   dt.norms_sq, 64)
    _rel(la_t.numpy(), la_j)
    _rel(lb_t.numpy(), lb_j)
    if metric == "Cosine":
        # lane_a = 2 resid inv (1 + 1e-5)
        want = 2.0 * dt.resid * dt.inv_norms * (1.0 + 1e-5)
        np.testing.assert_array_equal(la_t.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The kernel modes over bf16 rows: plain versions vs JAX's _kernel
# ---------------------------------------------------------------------------


def _store(seed=0, d=D):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N - 300, d)).astype(np.float32)  # padding rows too
    v[17] = 0.0
    v[40] *= 30.0
    return js.materialize(v, dtype=jnp.bfloat16)


def _tile_alive(n_tiles, seed=2):
    alive = np.random.default_rng(seed).random(n_tiles) < 0.6
    alive[0] = True
    alive[-1] = False
    return alive


def _row_mask(n_pad, alive, tile, seed=3):
    rm = np.repeat(alive, tile)[:n_pad].copy()
    rm &= np.random.default_rng(seed).random(n_pad) < 0.9
    return rm


def _jax_bins(mode, dj, q, rm, alive, thr, cmp, metric, take_min):
    """JAX's _kernel bin maxima [n_bins, b] for one mode over bf16 rows, set
    up as _pallas_topk_jit sets it up, through pallas_call in interpret
    mode. K1-bf16 / K5: certified (Cosine fold / general fold); K3-bf16:
    prec "highest"; K4-bf16: prec "high"."""
    n_pad, d = dj.vectors.shape
    b = q.shape[0]
    certify = mode in ("K1-bf16", "K5")
    queries = jnp.asarray(q)
    q_kern = queries
    thr1 = jnp.float32(thr)
    if certify:
        qh32, c0, c1, c2 = js.cert_query_coeffs(metric, queries, d)
        q_kern, queries = qh32.astype(jnp.bfloat16), qh32
        lane_a, lane_b = js.cert_row_lanes(metric, dj.vectors.dtype, dj.resid, dj.inv_norms,
                                           dj.norms_sq, d)
        slack_g = js.cert_global_slack(c0, c1, c2, lane_a, lane_b, dj.norms_sq)
        if cmp in (jx.Cmp.Gt, jx.Cmp.Gte):
            thr1 = thr1 - slack_g
        elif cmp in (jx.Cmp.Lt, jx.Cmp.Lte):
            thr1 = thr1 + slack_g
    q_sq, q_inv = js._query_norms(queries)
    cert_cos = certify and metric is jx.Metric.Cosine
    b_pad = pk._pad_b(b)
    bo = pk._round_up(b_pad, pk.LANE)
    n_tiles = alive.shape[0]
    t = n_pad // n_tiles
    nb = t // pk.BIN
    nqa = 6 if (certify and not cert_cos) else 4
    q_pad = jnp.zeros((b_pad, d), q_kern.dtype).at[:b].set(q_kern)
    qaux = jnp.zeros((nqa, bo), jnp.float32)
    qaux = qaux.at[0, :b].set(q_inv).at[1, :b].set(q_sq).at[2, :b].set(1.0)
    if nqa == 6:
        qaux = qaux.at[3, :b].set(c0).at[4, :b].set(c1).at[5, :b].set(c2)
    rmask01 = dj.valid.astype(jnp.float32) * jnp.asarray(rm).astype(jnp.float32)
    aux_rows = [dj.inv_norms, dj.norms_sq, rmask01]
    if cert_cos:
        aux_rows.append(lane_a)
    elif certify:
        aux_rows += [lane_a, lane_b]
    else:
        aux_rows.append(jnp.zeros(n_pad, jnp.float32))
    aux = jnp.stack(aux_rows)
    na = aux.shape[0]
    n_surv = int(alive.sum())
    surv = np.concatenate([np.flatnonzero(alive), np.zeros(n_tiles - n_surv, np.int64)])
    surv = jnp.asarray(np.where(np.arange(n_tiles) < n_surv, surv, surv[max(n_surv - 1, 0)]))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((b_pad, d), lambda g, s, n, th: (0, 0)),
            pl.BlockSpec((t, d), lambda g, s, n, th: (s[g], 0)),
            pl.BlockSpec((na, t), lambda g, s, n, th: (0, s[g])),
            pl.BlockSpec((nqa, bo), lambda g, s, n, th: (0, 0)),
        ],
        out_specs=pl.BlockSpec(
            (1, nb, bo), lambda g, s, n, th: (jnp.minimum(g, jnp.maximum(n[0] - 1, 0)), 0, 0)
        ),
    )
    prec = "high" if mode == "K4-bf16" else "highest"
    bins = pl.pallas_call(
        partial(pk._kernel, metric=metric, take_min=take_min, cmp=cmp, prec=prec, nb=nb,
                bo=bo, certify=certify, cert_cos=cert_cos),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_tiles, nb, bo), jnp.float32),
        interpret=True,
    )(surv.astype(jnp.int32), jnp.int32(n_surv).reshape(1), thr1.reshape(1), q_pad,
      dj.vectors, aux, qaux)
    bins = np.asarray(bins)
    out = np.full((n_pad // pk.BIN, b), -np.inf, np.float32)
    for gi, tile in enumerate(np.flatnonzero(alive)):
        out[tile * nb : (tile + 1) * nb] = bins[gi, :, :b]
    return out


def _port_bins(mode, dt, q, rm, alive, thr, cmp, metric, take_min):
    """The port's wrapper for the mode on CPU tensors (its plain version)."""
    qt = torch.from_numpy(q)
    row_mask = torch.from_numpy(rm)
    bin_alive = torch.from_numpy(np.repeat(alive, TILE // ft.BIN))
    thr_t = torch.tensor(thr, dtype=torch.float32)
    if mode in ("K1-bf16", "K5"):
        ops = ft.cert_scan(mode, dt.vectors, dt.norms_sq, dt.inv_norms, dt.valid, qt,
                           row_mask, thr_t, bin_alive, metric=metric, cmp=cmp,
                           resid=dt.resid).ops
        if mode == "K5":
            return ft.cert_fold_binmax(*ops, metric, take_min, cmp)
        return ft.cert_cos_binmax_bf16(*ops, cmp)
    q_sq, q_inv = ts._query_norms(qt)
    surv, n_surv = ft.survivor_bins(bin_alive)
    rmask = dt.valid.float() * row_mask.float()
    return ft.KERNELS[mode](qt, dt.vectors, dt.inv_norms, dt.norms_sq, rmask, q_inv, q_sq,
                            torch.ones(q.shape[0]), thr_t.reshape(1), surv, n_surv, metric,
                            take_min, cmp)


BF16_MODE_CASES = [
    ("K1-bf16", "Cosine", False, None, 0.0),
    ("K1-bf16", "Cosine", False, "Gt", 0.2),
    ("K5", "DotProduct", False, None, 0.0),
    ("K5", "DotProduct", False, "Gt", 4.0),
    ("K5", "Euclidean", True, None, 0.0),
    ("K5", "Euclidean", True, "Lt", 110.0),
    ("K5", "Euclidean", True, "Lte", 110.0),
    ("K3-bf16", "Cosine", False, "Gte", 0.05),
    ("K3-bf16", "Euclidean", True, "Lt", 125.0),
    ("K4-bf16", "DotProduct", False, None, 0.0),
    ("K4-bf16", "Euclidean", True, None, 0.0),
]


@pytest.mark.parametrize("mode,metric,take_min,cmp,thr", BF16_MODE_CASES)
def test_bf16_mode_plain_matches_tpu_kernel_bins(mode, metric, take_min, cmp, thr):
    dj = _store(seed=11)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = np.random.default_rng(12).normal(size=(B, D)).astype(np.float32)
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE, seed=13)
    rm = _row_mask(n_pad, alive, TILE)
    want = _jax_bins(mode, dj, q, rm, alive, thr, None if cmp is None else getattr(jx.Cmp, cmp),
                     getattr(jx.Metric, metric), take_min)
    got = _port_bins(mode, dt, q, rm, alive, thr, None if cmp is None else getattr(tx.Cmp, cmp),
                     getattr(tx.Metric, metric), take_min).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 50 and (~fin).sum() > 50
    scale = 1.0
    if metric != "Cosine":
        qh = q.astype(jnp.bfloat16).astype(np.float32)
        scale = np.linalg.norm(qh, axis=1).max() * np.sqrt(np.asarray(dj.norms_sq).max())
    tol = 4 * D * 2.0**-24 * scale * (2 if metric == "Euclidean" else 1)
    tol += 4 * np.spacing(np.float32(np.abs(want[fin]).max()))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# fused_topk vs pallas_topk
# ---------------------------------------------------------------------------


FUSED_CASES = [
    # (mode, metric, take_min, cmp, thr, k, certify, fast)
    ("K1-bf16", "Cosine", False, None, 0.0, 10, True, False),
    ("K1-bf16", "Cosine", False, "Gte", 0.2, 40, True, False),
    ("K5", "DotProduct", False, None, 0.0, 10, True, False),
    ("K5", "DotProduct", False, "Gt", 4.0, 300, True, False),
    ("K5", "Euclidean", True, None, 0.0, 12, True, False),
    ("K5", "Euclidean", True, "Lt", 110.0, 40, True, False),
    ("K4-bf16", "Cosine", False, "Gt", 0.2, 10, False, True),
    ("K4-bf16", "Euclidean", True, None, 0.0, 12, False, True),
    ("K3-bf16", "DotProduct", False, None, 0.0, 200, False, False),
]


@pytest.mark.parametrize("mode,metric,take_min,cmp,thr,k,certify,fast", FUSED_CASES)
def test_bf16_fused_topk_matches_pallas_topk(mode, metric, take_min, cmp, thr, k, certify,
                                             fast):
    dj = _store(seed=21)
    dt = device_vecs_from_numpy(*_numpy_fields(dj), device="cpu")
    q = np.random.default_rng(22).normal(size=(B, D)).astype(np.float32)
    n_pad = dj.vectors.shape[0]
    alive = _tile_alive(n_pad // TILE, seed=23)
    rm = _row_mask(n_pad, alive, TILE)
    jm, tm = getattr(jx.Metric, metric), getattr(tx.Metric, metric)
    cert = dict(resid=dj.resid, resid_bin=dj.resid_bin) if certify else {}
    rows_j, sc_j, ok_j, check_j, bound_j = (np.asarray(x) for x in pk.pallas_topk(
        dj.vectors, dj.norms_sq, dj.inv_norms, dj.valid, jnp.asarray(q), jnp.asarray(rm),
        jnp.float32(thr), jnp.asarray(alive), metric=jm, k=k, take_min=take_min,
        cmp=None if cmp is None else getattr(jx.Cmp, cmp), interpret=True, fast=fast,
        certify=certify, **cert,
    ))
    assert ft.kernel_mode(dt.vectors.dtype, tm, take_min, certify, fast=fast) == mode
    out = ft.fused_topk(
        dt.vectors, dt.norms_sq, dt.inv_norms, dt.valid, torch.from_numpy(q),
        torch.from_numpy(rm), torch.tensor(thr), torch.from_numpy(np.repeat(alive, TILE // ft.BIN)),
        metric=tm, k=k, take_min=take_min, cmp=None if cmp is None else getattr(tx.Cmp, cmp),
        certify=certify, fast=fast, resid=dt.resid if certify else None,
    )
    rows_t, sc_t, ok_t, check_t, bound_t = (x.numpy() for x in out)
    assert ok_t.tolist() == ok_j.tolist() and ok_t.sum() > 0
    assert rows_t[ok_t].tolist() == rows_j[ok_j].tolist()
    assert bool(check_t) == bool(check_j)
    scale = 1.0
    if metric != "Cosine":
        scale = np.linalg.norm(q, axis=1).max() * np.sqrt(np.asarray(dj.norms_sq).max())
    tol = 4 * D * 2.0**-24 * scale * (2 if metric == "Euclidean" else 1)
    tol += 4 * np.spacing(np.float32(np.abs(sc_j[ok_j]).max()))
    np.testing.assert_allclose(sc_t[ok_t], sc_j[ok_j], rtol=0, atol=tol)
    if certify:
        assert abs(float(bound_t) - float(bound_j)) <= tol
    else:
        assert float(bound_t) == float("-inf")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("trial", range(2))
def test_fused_bf16_cert_bound_is_sound(metric, trial):
    """The port's certified fused path (K1 / K5 through their plain
    versions): the bound covers the true key (negated distance for Euclid)
    of every row not returned, as the JAX package's kernel-level test
    asserts for its own."""
    rng = np.random.default_rng(300 + trial)
    n, d, b, k = 2048, 64, 3, 24
    vecs = (rng.normal(size=(n, d)) * rng.choice([0.01, 1.0, 30.0])).astype(np.float32)
    if trial == 1:
        vecs[7] = 0.0
    dv = ts.materialize(vecs, dtype=torch.bfloat16, device="cpu")
    qs = rng.normal(size=(b, d)).astype(np.float32)
    n_pad = dv.vectors.shape[0]
    take_min = metric == "Euclidean"
    rows, _, ok, _, bound = ft.fused_topk(
        dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, torch.from_numpy(qs), None,
        torch.tensor(0.0), torch.ones(n_pad // ft.BIN, dtype=torch.bool),
        metric=getattr(tx.Metric, metric), k=k, take_min=take_min, cmp=None, certify=True,
        resid=dv.resid,
    )
    rows = rows.numpy()[ok.numpy()]
    s_true = _oracle(qs, vecs, getattr(jx.Metric, metric))
    key_true = -s_true if take_min else s_true
    unret = np.setdiff1d(np.arange(n), rows)
    assert float(bound) >= float(key_true[:, unret].max()) - 1e-7


# ---------------------------------------------------------------------------
# MetaStore: twins of tests/test_cert_metrics.py
# ---------------------------------------------------------------------------


def _id_spec(n):
    return [("id", "Int64", list(range(n)))]


def _route(path, monkeypatch):
    """Put both packages on ``path`` and count the port's kernel calls
    (their plain versions serve the CPU tensors)."""
    calls = []
    if path == "fused":
        use_fused_path(monkeypatch)
        for name in ("cert_cos_binmax_plain", "cert_fold_binmax_plain", "binmax_plain"):
            f = getattr(ft, name)
            monkeypatch.setattr(ft, name,
                                lambda *a, _f=f, _n=name, **kw: calls.append(_n) or _f(*a, **kw))
    return calls


def _assert_twins(rj, rt, sj, st, metric):
    assert rt.indices == rj.indices
    atol = {"Cosine": 1e-6, "DotProduct": 1e-6, "Euclidean": 0.0}[metric]
    if metric == "Euclidean":  # the ulps of q^2 + v^2 that its formula cancels
        atol = 4 * float(np.spacing(np.float32(max(np.abs(rj.scores), default=1.0))))
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-6, atol=atol)
    assert stats_tuple(st) == stats_tuple(sj)


def _want_kernel(path, metric, calls):
    if path == "fused":
        want = "cert_cos_binmax_plain" if metric == "Cosine" else "cert_fold_binmax_plain"
        assert want in calls, calls


def _plan(store, pkg, q, metric, *, k, rerank_from=None, vf=None, batch=True):
    m = getattr(pkg.Metric, metric)
    plan = store.query_batch(q, m) if batch else store.query(q[0], m)
    if vf is not None:
        plan = plan.vec_filter(vf[0], getattr(pkg.Cmp, vf[1]))
    return plan.take(k, rerank_from=rerank_from)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("metric", METRICS)
def test_bf16_certificate_normal_data(metric, path, monkeypatch):
    calls = _route(path, monkeypatch)
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(8192, 48)).astype(np.float32)
    sj, st = twin_stores(vecs, _id_spec(8192), chunk=512, storage="bfloat16")
    qs = rng.normal(size=(3, 48)).astype(np.float32)
    rj = _plan(sj, jx, qs, metric, k=10, rerank_from=100).collect()
    rt = _plan(st, tx, qs, metric, k=10, rerank_from=100).collect()
    _want_kernel(path, metric, calls)
    _assert_twins(rj, rt, sj, st, metric)
    assert st.last_query_stats().certified is True
    s = _oracle(qs, vecs, getattr(jx.Metric, metric)).reshape(-1)
    sign = 1 if metric == "Euclidean" else -1
    assert sorted(rt.indices) == sorted((np.argsort(sign * s, kind="stable")[:10] % 8192).tolist())


def _near_ties(seed=17, n=4096, n_tie=192, d=64):
    """test_cert_metrics.py's near-ties: gaps far below bf16 rounding but
    far above the f32 rerank's resolution, for all three metrics."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    vecs = 0.05 * rng.normal(size=(n, d))
    scale = 1.0 + 3e-5 * rng.permutation(n_tie)
    w = rng.normal(size=(n_tie, d))
    w -= (w @ u)[:, None] * u[None, :]
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    vecs[:n_tie] = scale[:, None] * (u[None, :] + 0.2 * rng.random((n_tie, 1)) * w)
    return vecs.astype(np.float32), (2.0 * u).astype(np.float32)[None, :]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("metric", METRICS)
def test_bf16_adversarial_near_ties_widen_and_exact(metric, path, monkeypatch):
    calls = _route(path, monkeypatch)
    vecs, q = _near_ties()
    sj, st = twin_stores(vecs, _id_spec(len(vecs)), chunk=512, storage="bfloat16")
    rj = _plan(sj, jx, q, metric, k=10, rerank_from=16, batch=False).collect()
    rt = _plan(st, tx, q, metric, k=10, rerank_from=16, batch=False).collect()
    _want_kernel(path, metric, calls)
    _assert_twins(rj, rt, sj, st, metric)
    st_stats = st.last_query_stats()
    assert st_stats.certified is True and st_stats.scan_k_wide > 16  # it widened
    s = _oracle(q, vecs, getattr(jx.Metric, metric))[0]
    sign = 1 if metric == "Euclidean" else -1
    assert rt.indices == np.argsort(sign * s, kind="stable")[:10].tolist()
    assert list(st.cert_hints().values()) == list(sj.cert_hints().values())


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize(
    "metric,cmp,frac",
    [("DotProduct", "Gt", 0.9), ("Euclidean", "Lt", 1.1), ("Euclidean", "Lte", 1.1)],
)
def test_bf16_certificate_with_filter_loosened_threshold(metric, cmp, frac, path, monkeypatch):
    calls = _route(path, monkeypatch)
    rng = np.random.default_rng(23)
    vecs = rng.normal(size=(4096, 32)).astype(np.float32)
    sj, st = twin_stores(vecs, _id_spec(4096), chunk=512, storage="bfloat16")
    q = rng.normal(size=32).astype(np.float32)[None, :]
    s = _oracle(q, vecs, getattr(jx.Metric, metric))[0]
    sign = 1 if metric == "Euclidean" else -1
    order = np.argsort(sign * s, kind="stable")
    thr = float(s[order[20]]) * frac if frac != 1.1 else float(s[order[20]])
    rj = _plan(sj, jx, q, metric, k=10, rerank_from=64, vf=(thr, cmp), batch=False).collect()
    rt = _plan(st, tx, q, metric, k=10, rerank_from=64, vf=(thr, cmp), batch=False).collect()
    _want_kernel(path, metric, calls)
    _assert_twins(rj, rt, sj, st, metric)
    assert st.last_query_stats().certified is True
    ok = {"Gt": s > thr, "Lt": s < thr, "Lte": s <= thr}[cmp]
    want = [i for i in order if ok[i]][:10]
    np.testing.assert_allclose(np.sort(s[rt.indices]), np.sort(s[want]), rtol=1e-6, atol=1e-6)


def test_certify_true_rejects_f32_and_vpu():
    rng = np.random.default_rng(2)
    vecs = rng.normal(size=(1024, 16)).astype(np.float32)
    spec = _id_spec(1024)
    for storage, metric in (("float32", "Cosine"), ("bfloat16", "Manhattan")):
        stores = twin_stores(vecs, spec, chunk=256, storage=storage)
        msgs = []
        for store, pkg in zip(stores, (jx, tx)):
            with pytest.raises(pkg.OttersError, match="certify") as err:
                store.query(vecs[0], getattr(pkg.Metric, metric)).take(
                    5, rerank_from=50, certify=True).collect()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("trial", range(6))
def test_bf16_cert_soundness_fuzz(metric, trial):
    """certified=True implies the result equals the f32 oracle; the port
    also equals the JAX package (same rows, stats and widths)."""
    rng = np.random.default_rng(1000 + trial)
    n = int(rng.integers(600, 3000))
    d = int(rng.integers(8, 96))
    k = int(rng.integers(1, 16))
    kw = int(rng.integers(k, 4 * k + 8))
    vecs = (rng.normal(size=(n, d)) * rng.choice([1e-3, 1.0, 40.0])).astype(np.float32)
    if trial % 2:
        vecs[rng.integers(0, n)] = 0.0  # zero-norm row
    sj, st = twin_stores(vecs, _id_spec(n), chunk=256, storage="bfloat16")
    qs = rng.normal(size=(int(rng.integers(1, 5)), d)).astype(np.float32)
    if trial % 3 == 0:
        qs[0] = 0.0  # zero-norm query
    rj = _plan(sj, jx, qs, metric, k=k, rerank_from=kw).collect()
    rt = _plan(st, tx, qs, metric, k=k, rerank_from=kw).collect()
    assert st.last_query_stats().certified is True
    assert stats_tuple(st) == stats_tuple(sj)
    s = _oracle(qs, vecs, getattr(jx.Metric, metric)).reshape(-1)
    sign = 1 if metric == "Euclidean" else -1
    want_s = np.sort(sign * np.sort(sign * s)[: len(rt.scores)])
    tol = 2e-5 * (1.0 + float(np.abs(want_s).max(initial=0.0)))
    np.testing.assert_allclose(np.sort(rt.scores), want_s, rtol=2e-5, atol=tol)
    np.testing.assert_allclose(np.sort(rt.scores), np.sort(rj.scores), rtol=2e-5, atol=tol)


def _price_version_spec(n, chunk):
    idx = np.arange(n)
    even = (idx // chunk) % 2 == 0
    price = np.where(even, 80.0 + (idx % 20), 10.0 + (idx % 20))
    version = np.where(even, 1, 3).astype(np.int32)
    return [("price", "Float64", price), ("version", "Int32", version)]


def _bench_filter(pkg):
    return pkg.col("price").lt(50.0) & pkg.col("version").gte(2)


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_collect_async_resolve_three_batches_match_jax(metric, monkeypatch):
    """Three pipelined certified batches with the bench filter on the fused
    path: each equals JAX's and its own plain collect(); half the chunks
    pruned."""
    calls = _route("fused", monkeypatch)
    rng = np.random.default_rng(31)
    n = 16384
    vecs = rng.normal(size=(n, 64)).astype(np.float32)
    sj, st = twin_stores(vecs, _price_version_spec(n, 1024), chunk=1024, storage="bfloat16")
    batches = [rng.normal(size=(4, 64)).astype(np.float32) for _ in range(3)]

    def pend(store, pkg, q):
        return (store.query_batch(q, getattr(pkg.Metric, metric))
                .meta_filter(_bench_filter(pkg)).take(10, rerank_from=40).collect_async())

    res_j = jresolve([pend(sj, jx, q) for q in batches])
    res_t = tx.resolve([pend(st, tx, q) for q in batches])
    _want_kernel("fused", metric, calls)
    for rj, rt, q in zip(res_j, res_t, batches):
        assert rt.indices == rj.indices
        atol = 2e-5 if metric == "Euclidean" else 1e-6
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-6, atol=atol)
        again = pend(st, tx, q).result()
        assert again.indices == rt.indices
        stats = st.last_query_stats()
        assert stats.certified is True and stats.pruned_chunks == st.n_chunks() // 2


@pytest.mark.parametrize("case", ["fast", "failed_check", "eq", "wide_k"])
def test_bf16_uncertified_take_matches_jax(case, monkeypatch):
    """take(k) with no rerank over bf16 storage: the verified fast K4 over
    bf16 rows; exact ties over more than 4k bins fail its check and K3
    reruns; Eq filters and k > 128 run K3 directly. Exact over the stored
    values in both packages."""
    _route("fused", monkeypatch)
    rng = np.random.default_rng(37)
    n, d, k = 16384, 64, 10
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(2, d)).astype(np.float32)
    metric, vf = "Cosine", None
    if case == "failed_check":
        k = 5
        vecs[: k - 1] = q[0] + 0.1 * rng.normal(size=(k - 1, d))
        vecs[np.arange(4 * k + 3) * 512 + 300] = q[0] + 0.5 * rng.normal(size=d)
        q = q[:1]
    elif case == "eq":
        vecs = rng.integers(-2, 3, size=(n, d)).astype(np.float32)  # exact in bf16
        q = rng.integers(-2, 3, size=(2, d)).astype(np.float32)
        metric, vf, k = "DotProduct", (float(vecs[5000] @ q[0]), "Eq"), 50
    elif case == "wide_k":
        k = 200
    sj, st = twin_stores(vecs, _id_spec(n), chunk=512, storage="bfloat16", rerank=False)
    modes = []
    plain = ft.binmax_plain
    monkeypatch.setattr(ft, "binmax_plain",
                        lambda *a, **kw: modes.append(a[0]) or plain(*a, **kw))
    rj = _plan(sj, jx, q, metric, k=k, vf=vf).collect()
    rt = _plan(st, tx, q, metric, k=k, vf=vf).collect()
    assert modes == {"fast": ["K4-bf16"], "failed_check": ["K4-bf16", "K3-bf16"],
                     "eq": ["K3-bf16"], "wide_k": ["K3-bf16"]}[case]
    _assert_twins(rj, rt, sj, st, metric)
    assert len(rt) == k and st.last_query_stats().certified is None
    if case == "failed_check":
        assert rt.indices[-1] == 300  # the lowest tied copy
    if case == "eq":
        assert set(rt.scores) == {vf[0]}


def test_bf16_prebuilt_device_vecs_keep_their_storage():
    """A pre-built bf16 DeviceVecs is adopted as bfloat16 storage: with its
    residuals it certifies; rows handed over already in bf16 carry none, so
    certify=True is refused there and the default runs uncertified."""
    rng = np.random.default_rng(41)
    vecs = rng.normal(size=(3000, 32)).astype(np.float32)
    q = rng.normal(size=(2, 32)).astype(np.float32)
    cols = [tx.Column("id", tx.DataType.Int64).from_values(range(3000))]

    def build(dv):
        return (tx.MetaStore.from_columns(cols).with_vectors(dv, n_rows=3000)
                .with_rerank_source(fetch_vectors=lambda i: vecs[np.asarray(i)])
                .with_device("cpu").build())

    with_resid = build(ts.materialize_from_device(torch.from_numpy(vecs), dtype=torch.bfloat16))
    assert with_resid._storage_dtype == "bfloat16"
    res = with_resid.query_batch(q, tx.Metric.DotProduct).take(5, rerank_from=20).collect()
    assert with_resid.last_query_stats().certified is True
    s = _oracle(q, vecs, jx.Metric.DotProduct).reshape(-1)
    np.testing.assert_allclose(sorted(res.scores), np.sort(s)[-5:], rtol=1e-5)
    codes_only = build(ts.materialize_from_device(torch.from_numpy(vecs).bfloat16()))
    with pytest.raises(tx.OttersError, match="bfloat16: also DotProduct"):
        codes_only.query_batch(q, tx.Metric.Cosine).take(5, rerank_from=20, certify=True).collect()
    codes_only.query_batch(q, tx.Metric.Cosine).take(5, rerank_from=20).collect()
    assert codes_only.last_query_stats().certified is None
