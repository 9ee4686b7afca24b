"""Device storage, quantization and exact top-k of the port vs the JAX package.

int8 codes and bf16-rounded queries must be bit-equal; norms and inverse
norms agree within 4 f32 ulps (sums run in another order); the residual
bounds (per-row resid and the per-query c0) within a relative 2e-5, a fifth
of the (1 + 1e-4) inflation that makes each package's bound sound: they are
cancellations that amplify those ulps (see below); top-k selection is
stable on ties like ``lax.top_k``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from otters_tpu.ops import scoring as js
from otters_tpu.types import Metric as JMetric
from otters_tpu_torch.ops import scoring as ts
from otters_tpu_torch.types import Cmp, Metric
import torch_parity  # noqa: F401  (sets the torch thread count)


def _ulps(a, b, n=4):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    tol = n * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    np.testing.assert_array_less(np.abs(a - b), tol + np.finfo(np.float32).tiny)


def _resid_close(a, b):
    np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=0)


def _data(n=3000, d=96, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    v[5] = 0.0  # zero row
    v[6] *= 1e-3
    v[7] = np.round(v[7] * 4) / 4  # exact halves: round-half-even cases
    return v


def test_int8_materialize_bit_equal_codes_and_close_norms():
    v = _data()
    dj = js.materialize(v, dtype=jnp.int8)
    dt = ts.materialize(v, dtype=torch.int8, device="cpu")
    np.testing.assert_array_equal(dt.vectors.numpy(), np.asarray(dj.vectors))
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    for name in ("norms_sq", "inv_norms"):
        _ulps(getattr(dt, name).numpy(), getattr(dj, name))
    # the residual is a cancellation (||a/|a| - b/|b||| ~ 5e-3 formed from
    # unit-vector entries ~0.1): one ulp of the inverse norms, whose sums
    # run in another order, becomes tens of ulps here
    for name in ("resid", "resid_bin", "resid_max"):
        _resid_close(getattr(dt, name).numpy(), getattr(dj, name))


def test_int8_slabs_equal_one_shot_materialize():
    v = _data(2500, 64, seed=1)
    n_pad = ts.pad_rows(len(v))
    padded = np.zeros((n_pad, 64), np.float32)
    padded[: len(v)] = v
    slabs = ts.materialize_int8_slabs(
        lambda s, r: padded[s : s + r], len(v), 64, 700, device="cpu"
    )
    whole = ts.materialize(v, dtype=torch.int8, device="cpu")
    for a, b in zip(slabs, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_f32_materialize_norms_close():
    v = _data(500, 48, seed=2)
    dj = js.materialize(v)
    dt = ts.materialize(v, device="cpu")
    np.testing.assert_array_equal(dt.vectors.numpy(), np.asarray(dj.vectors))
    _ulps(dt.norms_sq.numpy(), dj.norms_sq)
    _ulps(dt.inv_norms.numpy(), dj.inv_norms)


def test_certificate_query_terms_close():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, 96)).astype(np.float32)
    q[2] = 0.0
    q[3] = 1e-41  # nonzero in f32, zero in bf16: the trivial bound 2.0
    qj, c0j, c1j, c2j = js.cert_query_coeffs(JMetric.Cosine, jnp.asarray(q), 96)
    qt, c0t, c1t, c2t = ts.cert_query_coeffs(Metric.Cosine, torch.from_numpy(q), 96)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))  # bf16 rounding
    # c0 is the query's bf16 rounding residual (a cancellation, like resid)
    _resid_close(c0t.numpy(), c0j)
    np.testing.assert_array_equal(c1t.numpy(), np.asarray(c1j))
    np.testing.assert_array_equal(c2t.numpy(), np.asarray(c2j))
    assert ts.mixed_cert_eps(768) == js.mixed_cert_eps(768)
    assert ts.pad_rows(10_000_000) == js.pad_rows(10_000_000)


@pytest.mark.parametrize("n", [5000, 1 << 16])  # plain / hierarchical
def test_topk_is_stable_on_ties(n):
    key = np.random.default_rng(0).normal(size=n).astype(np.float32) - 10.0
    for i in (7, 100, 3000, 4000):
        key[i] = 5.0
    _, want = jax.lax.top_k(jnp.asarray(key), 6)
    _, got = ts.exact_topk_flat(torch.from_numpy(key), 6)
    assert got.tolist()[:4] == [7, 100, 3000, 4000]
    assert got.tolist() == np.asarray(want).tolist()
    _, jgot = js.exact_topk_flat(jnp.asarray(key), 6)
    assert got.tolist() == np.asarray(jgot).tolist()


@pytest.mark.parametrize("n,k", [(1 << 16, 20), (1 << 16, 3), ((1 << 16) + 1, 20), (1 << 21, 40)])
def test_exact_ties_across_bins_match_jax_order(n, k):
    """Keys drawn from a few values tie across many 512-entry bins: the
    hierarchical form (n a multiple of 512) keeps JAX's candidate-bin order
    and breaks ties inside the candidates by bin rank; a length that is not
    a multiple of 512 takes the plain top-k. Both give JAX's indices."""
    key = np.random.default_rng(n).integers(0, 6, size=n).astype(np.float32)
    # a few distinct high keys in scattered bins: the k-th key is then a 5,
    # tied across candidate bins of different maxima
    hi = np.random.default_rng(1).choice(n, size=min(k - 2, 10), replace=False)
    key[hi] = 10.0 + np.arange(hi.size)
    _, want = js.exact_topk_flat(jnp.asarray(key), k)
    _, got = ts.exact_topk_flat(torch.from_numpy(key), k)
    assert got.tolist() == np.asarray(want).tolist()


def test_f32_slabs_equal_one_shot_materialize():
    v = _data(2500, 64, seed=8)
    n_pad = ts.pad_rows(len(v))
    padded = np.zeros((n_pad, 64), np.float32)
    padded[: len(v)] = v
    slabs = ts.materialize_f32_slabs(
        lambda s, r: padded[s : s + r], len(v), 64, 700, device="cpu"
    )
    whole = ts.materialize(v, device="cpu")
    for a, b in zip(slabs, whole):
        if a is None:
            assert b is None
            continue
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_topk_with_neg_inf_fill_matches_lax():
    key = np.full(40_000, -np.inf, np.float32)
    key[[30_000, 12, 39_999]] = [1.0, 1.0, 2.0]
    _, want = jax.lax.top_k(jnp.asarray(key), 9)
    _, got = ts.exact_topk_flat(torch.from_numpy(key), 9)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("storage,metric", [
    ("float32", "Cosine"), ("float32", "Euclidean"), ("float32", "DotProduct"),
    ("int8", "Cosine"),  # int8 storage is Cosine-only in both packages
])
def test_direct_and_scan_cores_match_jax(storage, metric):
    v = _data(2048, 32, seed=5)
    q = np.random.default_rng(6).normal(size=(3, 32)).astype(np.float32)
    dj = js.materialize(v, dtype=jnp.int8 if storage == "int8" else jnp.float32)
    dt = ts.materialize(v, dtype=torch.int8 if storage == "int8" else torch.float32, device="cpu")
    rm = np.random.default_rng(7).random(dt.vectors.shape[0]) < 0.7
    take_min = metric == "Euclidean"
    for cmp, thr in ((None, 0.0), ("Lt" if take_min else "Gt", 0.1)):
        kw_j = dict(metric=getattr(JMetric, metric), k=25, take_min=take_min,
                    cmp=None if cmp is None else getattr(js.Cmp, cmp), prec="highest")
        kw_t = dict(metric=getattr(Metric, metric), k=25, take_min=take_min,
                    cmp=None if cmp is None else getattr(Cmp, cmp))
        argj = (dj.vectors, dj.norms_sq, dj.inv_norms, dj.valid, jnp.asarray(q),
                jnp.asarray(rm), jnp.float32(thr))
        argt = (dt.vectors, dt.norms_sq, dt.inv_norms, dt.valid, torch.from_numpy(q),
                torch.from_numpy(rm), torch.tensor(thr, dtype=torch.float32))
        pairs = (
            (js.direct_topk_core(*argj, **kw_j), ts.direct_topk_core(*argt, **kw_t)),
            (js.scan_topk_core(*argj, tile=512, **kw_j),
             ts.scan_topk_core(*argt, tile=512, **kw_t)),
        )
        for rj, rt in pairs:
            assert rt[0].tolist() == np.asarray(rj[0]).tolist()
            np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj[1]), atol=2e-5)
            assert rt[2].tolist() == np.asarray(rj[2]).tolist()


def test_choose_mode_matches_jax():
    for n_pad, b, k in [(4096, 4, 10), (10_002_432, 256, 100), (10_002_432, 256, 4096),
                        (1 << 20, 1, 2000), (8192 * 3, 300, 1024)]:
        assert ts.choose_mode(n_pad, b, k) == js.choose_mode(n_pad, b, k)
        assert ts.needs_windowed(n_pad, b, k) == js.needs_windowed(n_pad, b, k)
