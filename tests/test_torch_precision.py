"""The one-pass store precisions ("default" / "bf16") in the port.

What they compute is what a TPU computes at ``Precision.DEFAULT`` for f32
operands: queries and rows each rounded to bfloat16 (round-to-nearest-
even), every product exact in f32, the products summed in f32, and the
metric over the unrounded f32 norms. The JAX package on the CPU computes
DEFAULT in full f32, which equals that one pass exactly when the inputs are
already bf16-representable, so:

- on bf16-representable inputs the port (plain K6 included, through
  ``fused_topk`` on the fused path) returns the same rows in the same order
  as the JAX package (``run_vec_topk``, ``MetaStore`` / ``VecStore``,
  ``pallas_topk`` and the TPU kernel in interpret mode), scores within
  1e-6 (Euclid: 4 ulps of q^2 + v^2, which its formula cancels); K6's bin
  maxima within d 2^-24 |q| |v| of the kernel's;
- on unrounded inputs the port matches a float64 numpy version of the
  one-pass function: the same rows in order, scores within 2 d 2^-24
  |qh| |vh| (two f32 sums of the same exact products);
- a store where bf16 rounding swaps the top two rows tells "default" from
  "highest" on every path, so a port that scores full f32 fails;
- int8 storage and certified plans do not read the precision.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu.meta import resolve as jresolve
from otters_tpu.ops import pallas_topk as pk
from otters_tpu.ops import scoring as js
from otters_tpu_torch.ops import fused_topk as ft
from otters_tpu_torch.ops import scoring as ts
from otters_tpu_torch.state import device_vecs_from_numpy, vec_store_from_numpy
import test_torch_fused_topk as tft
from torch_parity import columns, stats_tuple, twin_stores, use_fused_path

D = 64
STORAGES = ["float32", "bfloat16"]
METRICS = [("Cosine", False, "Gt", 0.05), ("DotProduct", False, "Gt", 1.0),
           ("Euclidean", True, "Lt", 120.0)]
PATHS = ["direct", "scan", "fused", "take_all"]
# k of each path (scan: wider than the fused kernel; take-all: every pair)
PATH_K = {"direct": 12, "scan": 1100, "fused": 12, "take_all": None}


def _bf16(x):
    """f32 numpy values rounded to bf16 (nearest even) and back."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _data(n, seed, d=D, representable=True):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, d)).astype(np.float32)
    v[3] = 0.0  # a zero row
    return _bf16(v) if representable else v


def _queries(b, seed, d=D, representable=True):
    q = np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)
    return _bf16(q) if representable else q


def _route(path, monkeypatch):
    """Put both packages on ``path`` (build the stores after this) and
    record the port's kernel modes (their plain versions serve the CPU
    tensors). Small limits make a small store take the scan and take-all
    routes."""
    modes = []
    if path != "direct":
        use_fused_path(monkeypatch)
    if path == "take_all":
        import otters_tpu.ops.scoring as jscoring

        monkeypatch.setattr(jscoring, "SCAN_K_MAX", 1024)
        monkeypatch.setattr(ts, "SCAN_K_MAX", 1024)
    plain = ft.binmax_plain
    monkeypatch.setattr(ft, "binmax_plain", lambda *a, **kw: modes.append(a[0]) or plain(*a, **kw))
    return modes


def _path_k(path, n_pad, b):
    return b * n_pad if path == "take_all" else PATH_K[path]


def _check_route(path, modes, storage, n_pad, b, k):
    if path == "fused":
        assert modes == ["K6" + ("-bf16" if storage == "bfloat16" else "")]
    else:
        assert modes == []
    if path == "take_all":
        assert ts.needs_windowed(n_pad, b, k)
    if path == "scan":
        assert ts.choose_mode(n_pad, b, k) == "scan"


def _assert_same(rows_t, sc_t, rows_j, sc_j, metric, swaps=False):
    """The same rows in the same order, scores within 1e-6 (Euclid: 4 ulps
    of q^2 + v^2, which its formula cancels). ``swaps``: thousands of
    results (take-all), where two f32 sum orders swap some near-tied
    neighbours; then the same rows as a multiset and the scores rank for
    rank within the tolerance, sorted in the take direction."""
    atol = 1e-6
    if metric == "Euclidean":
        atol = 4 * float(np.spacing(np.float32(max(np.abs(sc_j).max(), 1.0))))
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-6, atol=atol)
    if not swaps:
        assert list(rows_t) == list(rows_j)
        return
    assert sorted(rows_t) == sorted(rows_j)
    step = np.diff(np.asarray(sc_t))
    assert (step >= 0).all() if metric == "Euclidean" else (step <= 0).all()


# ---------------------------------------------------------------------------
# JAX against the port on bf16-representable inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("metric,take_min,cmp,thr", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_run_vec_topk_default_matches_jax(storage, metric, take_min, cmp, thr, path,
                                          monkeypatch):
    modes = _route(path, monkeypatch)
    n = 16384 if path == "fused" else 6000
    v, q = _data(n, 1), _queries(3, 2)
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[storage]
    dj = js.materialize(v, dtype=dtype)
    dt = device_vecs_from_numpy(*[None if x is None else np.asarray(x) for x in dj],
                                device="cpu")
    n_pad = dt.vectors.shape[0]
    k = _path_k(path, n_pad, 3)
    # unfiltered take-all keeps every pair; the others filter
    c = None if path == "take_all" else cmp
    out_j = js.run_vec_topk(dj, q, getattr(jx.Metric, metric), k, take_min,
                            None if c is None else getattr(jx.Cmp, c), thr, prec="default")
    out_t = ts.run_vec_topk(dt, torch.from_numpy(q), getattr(tx.Metric, metric), k, take_min,
                            None if c is None else getattr(tx.Cmp, c), thr, prec="default")
    _check_route(path, modes, storage, n_pad, 3, k)
    (rj, sj, okj), (rt, st_, okt) = [[np.asarray(x) for x in o] for o in (out_j, out_t)]
    assert okt.tolist() == okj.tolist() and okt.sum() > 0
    _assert_same(rt[okt], st_[okt], rj[okj], sj[okj], metric, swaps=path == "take_all")


@pytest.mark.parametrize("metric,take_min,cmp,thr", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_k6_plain_bins_match_tpu_kernel_at_default(storage, metric, take_min, cmp, thr,
                                                   monkeypatch):
    """The K6 plain bin maxima against ``_kernel`` at prec="default" in
    interpret mode, set up as ``_pallas_topk_jit`` sets it up (the helper of
    tests/test_torch_fused_topk.py)."""
    monkeypatch.setitem(tft.MODE_PREC, "K6", "default")
    v, q = _data(tft.N - 300, 11), _queries(tft.B, 12)
    dj = js.materialize(v, dtype={"float32": jnp.float32, "bfloat16": jnp.bfloat16}[storage])
    dt = device_vecs_from_numpy(*tft._numpy_fields(dj), device="cpu")
    n_pad = dj.vectors.shape[0]
    alive = tft._tile_alive(n_pad // tft.TILE, seed=13)
    rm = tft._row_mask(n_pad, alive, tft.TILE)
    jc, tc = getattr(jx.Cmp, cmp), getattr(tx.Cmp, cmp)
    want, _ = tft._jax_mode_bins("K6", dj, q, rm, alive, thr, jc, getattr(jx.Metric, metric),
                                 take_min)
    args = list(tft._mode_args("K6", dt, q, rm, alive, thr))
    args[0] = args[0].bfloat16()  # K6 takes the queries rounded, their f32 norms
    mode = "K6" + ("-bf16" if storage == "bfloat16" else "")
    got = ft.KERNELS[mode](*args, getattr(tx.Metric, metric), take_min, tc).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 50 and (~fin).sum() > 50
    scale = 1.0 if metric == "Cosine" else float(
        np.linalg.norm(q, axis=1).max() * np.sqrt(np.asarray(dj.norms_sq).max()))
    tol = D * 2.0**-24 * scale * (2 if metric == "Euclidean" else 1)
    tol += 4 * float(np.spacing(np.float32(np.abs(want[fin]).max())))
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol)


@pytest.mark.parametrize("metric,take_min,cmp,thr", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_fused_topk_default_matches_pallas_topk(storage, metric, take_min, cmp, thr):
    v, q = _data(tft.N - 300, 21), _queries(tft.B, 22)
    dj = js.materialize(v, dtype={"float32": jnp.float32, "bfloat16": jnp.bfloat16}[storage])
    dt = device_vecs_from_numpy(*tft._numpy_fields(dj), device="cpu")
    n_pad = dj.vectors.shape[0]
    alive = tft._tile_alive(n_pad // tft.TILE, seed=23)
    rm = tft._row_mask(n_pad, alive, tft.TILE)
    rows_j, sc_j, ok_j, check_j, _ = pk.pallas_topk(
        dj.vectors, dj.norms_sq, dj.inv_norms, dj.valid, jnp.asarray(q), jnp.asarray(rm),
        jnp.float32(thr), jnp.asarray(alive), metric=getattr(jx.Metric, metric), k=20,
        take_min=take_min, cmp=getattr(jx.Cmp, cmp), prec="default", interpret=True,
    )
    rows_t, sc_t, ok_t, check_t, _ = ft.fused_topk(
        dt.vectors, dt.norms_sq, dt.inv_norms, dt.valid, torch.from_numpy(q),
        torch.from_numpy(rm), torch.tensor(thr),
        torch.from_numpy(np.repeat(alive, tft.TILE // ft.BIN)),
        metric=getattr(tx.Metric, metric), k=20, take_min=take_min, cmp=getattr(tx.Cmp, cmp),
        prec="default",
    )
    ok_j, ok_t = np.asarray(ok_j), ok_t.numpy()
    assert ok_t.tolist() == ok_j.tolist() and ok_t.sum() > 0
    _assert_same(rows_t.numpy()[ok_t], sc_t.numpy()[ok_t], np.asarray(rows_j)[ok_j],
                 np.asarray(sc_j)[ok_j], metric)
    assert bool(check_t) and bool(check_j)


def _price_spec(n, chunk=1024):
    idx = np.arange(n)
    even = (idx // chunk) % 2 == 0
    price = np.where(even, 80.0 + (idx % 20), 10.0 + (idx % 20))
    return [("price", "Float64", price)]


@pytest.mark.parametrize("path", ["direct", "fused"])
@pytest.mark.parametrize("metric,take_min,cmp,thr", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_metastore_default_matches_jax(storage, metric, take_min, cmp, thr, path,
                                       monkeypatch):
    """MetaStore at precision "default" with a pruning filter and a score
    filter, ``collect_async`` + ``resolve`` for two batches: the same rows,
    scores and stats as JAX's."""
    modes = _route(path, monkeypatch)
    n = 16384
    v = _data(n, 31)
    sj, st = twin_stores(v, _price_spec(n), chunk=1024, storage=storage, rerank=False)
    sj.precision = st.precision = "default"
    batches = [_queries(3, 32 + i) for i in range(2)]

    def pend(store, pkg, q):
        return (store.query_batch(q, getattr(pkg.Metric, metric))
                .meta_filter(pkg.col("price").lt(50.0))
                .vec_filter(thr, getattr(pkg.Cmp, cmp)).take(15).collect_async())

    res_j = jresolve([pend(sj, jx, q) for q in batches])
    res_t = tx.resolve([pend(st, tx, q) for q in batches])
    for rj, rt in zip(res_j, res_t):
        assert len(rt) == 15
        _assert_same(rt.indices, rt.scores, rj.indices, rj.scores, metric)
    assert stats_tuple(st) == stats_tuple(sj)
    if path == "fused":
        assert set(modes) == {"K6" + ("-bf16" if storage == "bfloat16" else "")}


@pytest.mark.parametrize("prec", ["default", "bf16"])
@pytest.mark.parametrize("storage", STORAGES)
def test_vecstore_default_matches_jax(storage, prec, monkeypatch):
    modes = _route("fused", monkeypatch)
    rows, q = _data(6000, 41, d=32), _queries(3, 42, d=32)
    sj = jx.VecStore(32, storage)
    sj.add_vectors(rows)
    st = vec_store_from_numpy(sj._host_matrix(), 32, storage, device="cpu")
    sj.precision = st.precision = prec
    rj = sj.query(q, jx.Metric.DotProduct).filter(1.0, jx.Cmp.Gt).take(25).collect()
    rt = st.query(q, tx.Metric.DotProduct).filter(1.0, tx.Cmp.Gt).take(25).collect()
    assert modes == ["K6" + ("-bf16" if storage == "bfloat16" else "")]
    _assert_same([r.index for r in rt], [r.score for r in rt], [r.index for r in rj],
                 [r.score for r in rj], "DotProduct")


# ---------------------------------------------------------------------------
# A float64 numpy reference on unrounded inputs
# ---------------------------------------------------------------------------


def _one_pass_f64(q, v, stored, metric, take_min, cmp, thr, k):
    """The one-pass function in float64: bf16-rounded operands, exact
    products and sums, the metric over the f32 norms (of the f32 queries
    and of the stored rows) -> (flat order of the top k, scores [b, n],
    tolerance)."""
    qh, vh = _bf16(q).astype(np.float64), _bf16(v).astype(np.float64)
    dots = qh @ vh.T
    q_sq = (q.astype(np.float64) ** 2).sum(1)[:, None]
    v_sq = (stored.astype(np.float64) ** 2).sum(1)[None, :]
    if metric == "Cosine":
        with np.errstate(divide="ignore"):
            inv_q = np.where(q_sq > 0, 1 / np.sqrt(q_sq), 0.0)
            inv_v = np.where(v_sq > 0, 1 / np.sqrt(v_sq), 0.0)
        s = dots * inv_q * inv_v
        scale = 1.0
    elif metric == "Euclidean":
        s = q_sq + v_sq - 2 * dots
        scale = 2 * np.sqrt(q_sq.max() * v_sq.max())
    else:
        s = dots
        scale = np.sqrt(q_sq.max() * v_sq.max())
    ok = np.ones_like(s, bool) if cmp is None else {"Gt": s > thr, "Lt": s < thr}[cmp]
    key = np.where(ok, -s if take_min else s, -np.inf).reshape(-1)
    order = np.argsort(-key, kind="stable")[:k]
    tol = 2 * D * 2.0**-24 * scale * 1.01 + 4 * np.spacing(np.float32(np.abs(s).max()))
    return order[np.isfinite(key[order])], s.reshape(-1), tol


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("metric,take_min,cmp,thr", METRICS)
@pytest.mark.parametrize("storage", STORAGES)
def test_default_matches_float64_one_pass(storage, metric, take_min, cmp, thr, path,
                                          monkeypatch):
    modes = _route(path, monkeypatch)
    n = 16384 if path == "fused" else 6000
    v, q = _data(n, 51, representable=False), _queries(3, 52, representable=False)
    dt = ts.materialize(v, dtype=getattr(torch, storage), device="cpu")
    n_pad = dt.vectors.shape[0]
    k = _path_k(path, n_pad, 3)
    c = None if path == "take_all" else cmp
    rows, scores, ok = ts.run_vec_topk(dt, torch.from_numpy(q), getattr(tx.Metric, metric), k,
                                       take_min, None if c is None else getattr(tx.Cmp, c),
                                       thr, prec="default")
    _check_route(path, modes, storage, n_pad, 3, k)
    stored = dt.vectors[:n].float().numpy()
    order, s, tol = _one_pass_f64(q, v, stored, metric, take_min, c, thr, min(k, 3 * n))
    rows, scores = np.asarray(rows)[np.asarray(ok)], np.asarray(scores)[np.asarray(ok)]
    flat = order % n
    assert len(rows) == len(flat) > 0
    np.testing.assert_allclose(scores, s[order], rtol=0, atol=tol)
    # the same rows in order, up to swaps of near-tied neighbours: the same
    # multiset, sorted in the take direction, each row's score its own
    assert sorted(rows) == sorted(flat)
    step = np.diff(scores)
    assert (step >= 0).all() if take_min else (step <= 0).all()
    if path != "take_all":  # rows repeat across queries in take-all
        assert (rows == flat).mean() > 0.95


# ---------------------------------------------------------------------------
# A guard against a silent f32 port
# ---------------------------------------------------------------------------


def _swap_store(n=6000, d=D):
    """Rows 0 = e0 and 1 = 3 e1 (exact in bf16) and a query (a, b) with
    a = 3b + 2^-12, b = 1 + 2^-8 + 2^-12: in f32 the Dot score of row 0 (a)
    beats row 1's (3b); rounded to bf16, a -> 3 + 2^-6 and b -> 1 + 2^-7,
    so row 1 (3 + 3 2^-7) beats row 0. Every other row scores far below."""
    rng = np.random.default_rng(61)
    v = (0.01 * rng.normal(size=(n, d))).astype(np.float32)
    v[0], v[1] = 0.0, 0.0
    v[0, 0], v[1, 1] = 1.0, 3.0
    b = np.float32(1 + 2.0**-8 + 2.0**-12)
    q = np.zeros((1, d), np.float32)
    q[0, 0], q[0, 1] = np.float32(3 * b + 2.0**-12), b
    assert float(q[0, 0]) > 3 * float(b)
    assert _bf16(q)[0, 0] < 3 * _bf16(q)[0, 1]
    return v, q


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("storage", STORAGES)
def test_default_differs_from_highest_where_rounding_swaps(storage, path, monkeypatch):
    """The direct path included: "default" is the one pass, not full f32."""
    modes = _route(path, monkeypatch)
    v, q = _swap_store(16384 if path == "fused" else 6000)
    store = (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64)
                                        .from_values(range(len(v)))])
             .with_vectors(v).with_storage_dtype(storage).with_device("cpu").build())
    n_pad = store._dv.vectors.shape[0]
    k = _path_k(path, n_pad, 1)
    top = {}
    for prec in ("highest", "default", "bf16"):
        store.precision = prec
        res = store.query_batch(q, tx.Metric.DotProduct).take(k).collect()
        top[prec] = res.indices[:2]
    assert top["highest"] == [0, 1]
    assert top["default"] == top["bf16"] == [1, 0]
    if path == "fused":
        assert "K6" + ("-bf16" if storage == "bfloat16" else "") in modes


@pytest.mark.parametrize("path", PATHS)
def test_unknown_precision_raises_on_every_path(path, monkeypatch):
    _route(path, monkeypatch)
    v, q = _swap_store()
    store = (tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64)
                                        .from_values(range(len(v)))])
             .with_vectors(v).with_device("cpu").build())
    vs = tx.VecStore(D, device="cpu")
    vs.add_vectors(v)
    store.precision = vs.precision = "bogus"
    k = _path_k(path, store._dv.vectors.shape[0], 1)
    with pytest.raises(ValueError, match="unknown store precision"):
        store.query_batch(q, tx.Metric.DotProduct).take(k).collect()
    with pytest.raises(ValueError, match="unknown store precision"):
        vs.query(q, tx.Metric.DotProduct).take(k).collect()


# ---------------------------------------------------------------------------
# The hash-collision redo, int8 storage and certified plans
# ---------------------------------------------------------------------------


def test_collision_redo_keeps_the_precision(monkeypatch):
    """A (forced) failed String-Eq verification re-runs with the exact host
    mask through ``run_vec_topk`` at the store's precision: the swapped
    order of the one pass survives the redo."""
    v, q = _swap_store()
    n = len(v)
    tags = ["a" if i % 3 != 2 else "b" for i in range(n)]
    store = (tx.MetaStore.from_columns([tx.Column("tag", tx.DataType.String).from_values(tags)])
             .with_vectors(v).with_chunk_size(512).with_device("cpu").build())
    store.precision = "default"
    plan = store.query_batch(q, tx.Metric.DotProduct).meta_filter(tx.col("tag").eq("a"))
    first = plan.take(5).collect()
    from otters_tpu_torch.meta import MetaQueryPlan

    calls = []
    orig = ts.run_vec_topk
    monkeypatch.setattr(ts, "run_vec_topk", lambda *a, **kw: calls.append(kw["prec"]) or orig(*a, **kw))
    seen = []
    monkeypatch.setattr(MetaQueryPlan, "_row_satisfies",
                        lambda self, i: bool(seen) or seen.append(i) or False)
    redo = plan.take(5).collect()
    assert calls == ["default"]
    assert redo.indices == first.indices and first.indices[:2] == [1, 0]


@pytest.mark.parametrize("path", ["direct", "fused"])
@pytest.mark.parametrize("case", ["int8 certified", "int8 uncertified", "bf16 certified"])
def test_precision_does_not_touch_int8_or_certified_plans(case, path, monkeypatch):
    if path == "fused":
        use_fused_path(monkeypatch)
    storage = {"int8 certified": "int8", "int8 uncertified": "int8",
               "bf16 certified": "bfloat16"}[case]
    v, q = _data(16384, 71, representable=False), _queries(3, 72, representable=False)
    st = (tx.MetaStore.from_columns(columns(tx, _price_spec(len(v)))).with_vectors(v)
          .with_chunk_size(1024).with_storage_dtype(storage)
          .with_rerank_source(keep_host_f32=True).with_device("cpu").build())
    take = {"rerank_from": 40, "certify": False if case == "int8 uncertified" else None}
    out = {}
    for prec in ("highest", "default", "bf16"):
        st.precision = prec
        res = (st.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("price").lt(50.0))
               .take(10, **take).collect())
        out[prec] = (res.indices, res.scores, stats_tuple(st))
    assert out["default"] == out["highest"] == out["bf16"]
    assert out["highest"][2][0] is (None if case == "int8 uncertified" else True)
