"""``delete_rows`` and ``append`` in the port against the JAX package.

``delete_rows`` tombstones rows by original id (a sorted store maps them to
its positions): the validity mask every scoring path reads drops them, so
no kernel or program returns them. ``append`` rebuilds a new store over the
surviving rows in original order plus the new ones, with the old store's
configuration, on its device. The same seeded inputs go through
``otters_tpu`` (JAX on the CPU, Pallas in interpret mode) and
``otters_tpu_torch`` (CPU device):

- tombstoned plain, sorted and Z-ordered stores on the direct, scan, fused
  and take-all paths, with the certificate on and off (and the rerank): the
  same rows in order, the same ``certified`` flags, the same pruned /
  evaluated counts, and no deleted row returned; ``len`` and the range
  check as JAX's;
- three append generations: the int8 codes of every generation equal
  JAX's bit for bit, and a survivor's codes stay bit-identical across
  generations; quantized stores without ``keep_host_f32`` carry the
  survivors' original residuals; the configuration carries over; a
  ``fetch_vectors`` store raises JAX's message.
"""

import inspect

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
from otters_tpu.errors import OttersError as JOttersError
from otters_tpu_torch.errors import OttersError
from torch_parity import PATHS, assert_same_on_path, columns, query_on_path, route

N, D, CHUNK = 3000, 32, 128


def _spec(n, start=0):
    idx = np.arange(start, start + n)
    return [("price", "Float64", (idx % 100).astype(np.float64)),
            ("tag", "String", [f"t{(i // CHUNK) % 7}" for i in idx])]


def _values(n, start):
    return {name: list(vals) for name, _, vals in _spec(n, start)}


def _builder(pkg, vecs, layout=None, storage="int8", keep=True, fetch=None):
    b = (pkg.MetaStore.from_columns(columns(pkg, _spec(len(vecs)))).with_vectors(vecs)
         .with_chunk_size(CHUNK).with_storage_dtype(storage).with_bloom_bits(512))
    if keep:
        b = b.with_rerank_source(keep_host_f32=True)
    elif fetch is not None:
        b = b.with_rerank_source(fetch_vectors=fetch)
    if layout == "sort":
        b = b.with_sort_by("price", descending=True)
    elif layout == "z":
        b = b.with_z_order(["tag", "price"])
    return b.with_device("cpu") if pkg is tx else b


def _twins(layout=None, storage="int8", keep=True, seed=21):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    q = rng.normal(size=(3, D)).astype(np.float32)
    return (_builder(jx, vecs, layout, storage, keep).build(),
            _builder(tx, vecs, layout, storage, keep).build(), vecs, q)


def _filter(pkg):
    return pkg.col("price").lt(60.0) & pkg.col("tag").neq("t3")


@pytest.mark.parametrize("certify", [True, False], ids=["cert", "uncert"])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("layout", [None, "sort", "z"], ids=["plain", "sort", "z"])
def test_tombstoned_rows_reach_no_path(layout, path, certify, monkeypatch):
    route(path, monkeypatch)
    sj, st, vecs, q = _twins(layout)
    first = query_on_path(st, tx, q, path, certify, _filter)
    # every row of the first answer, a seeded tenth of the store, repeats
    dead = list(first.indices[:40]) + np.random.default_rng(1).choice(N, 300).tolist()
    dead += dead[:5]
    for s in (sj, st):
        s.delete_rows(dead)
    assert len(st) == len(sj) == N - len(set(dead)) and st.n_rows == N
    for flt in (None, _filter):
        rj = query_on_path(sj, jx, q, path, certify, flt)
        rt = query_on_path(st, tx, q, path, certify, flt)
        assert_same_on_path(rj, rt, sj, st, path)
        assert not set(rt.indices) & set(dead)
    if certify and path != "take_all":
        assert st.last_query_stats().certified is True


def test_delete_checks_match_jax():
    sj, st, _, _ = _twins("sort")
    for bad in ([N], [-1], [0, N + 5]):
        with pytest.raises(JOttersError) as ej:
            sj.delete_rows(bad)
        with pytest.raises(OttersError) as et:
            st.delete_rows(bad)
        assert str(et.value) == str(ej.value)
    for s in (sj, st):
        s.delete_rows([])
        s.delete_rows([3, 3, 7])
        s.delete_rows([7, 8])  # a row deleted twice counts once
    assert len(st) == len(sj) == N - 3 and st._n_deleted == 3
    # the sorted store tombstones the rows' positions: original 3, 7, 8
    inv = np.empty(N, np.int64)
    inv[st._index_map] = np.arange(N)
    assert np.flatnonzero(~st._dv.valid.numpy()[:N]).tolist() == sorted(inv[[3, 7, 8]])
    assert np.array_equal(st._dv.valid.numpy(), np.asarray(sj._dv.valid))


def _codes(store):
    v = store._dv.vectors[: store.n_rows]
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float32)


@pytest.mark.parametrize("layout", [None, "sort", "z"], ids=["plain", "sort", "z"])
@pytest.mark.parametrize("keep", [True, False], ids=["keep_host_f32", "codes"])
def test_append_generations_match_jax(keep, layout):
    """Three generations of delete + append: the same stores as JAX's (int8
    codes bit for bit, the same answers); without ``keep_host_f32`` the
    rebuild re-quantizes codes, which is idempotent."""
    rng = np.random.default_rng(8)
    sj, st, vecs, q = _twins(layout, keep=keep)
    start = N
    for gen in range(3):
        dead = rng.choice(sj.n_rows, 40, replace=False).tolist()
        for s in (sj, st):
            s.delete_rows(dead)
        m = 200
        new = rng.normal(size=(m, D)).astype(np.float32)
        vals = _values(m, start)
        start += m
        old_t = st
        sj, st = sj.append(new, vals), st.append(new, vals)
        assert st.n_rows == sj.n_rows == old_t.n_rows - 40 + m and len(st) == st.n_rows
        assert np.array_equal(_codes(st), _codes(sj))
        assert st._dv.vectors.dtype == torch.int8
        if not keep:
            # a survivor's codes are bit-identical across the generation
            keep_ids = np.setdiff1d(np.arange(old_t.n_rows), dead)
            old_pos = _orig_order(old_t)[keep_ids]
            new_pos = _orig_order(st)[np.arange(len(keep_ids))]
            assert torch.equal(old_t._dv.vectors[old_pos], st._dv.vectors[new_pos])
        wide = dict(rerank_from=40) if keep else {}  # no rerank source without it
        rj = sj.query_batch(q, jx.Metric.Cosine).meta_filter(_filter(jx)).take(
            10, **wide).collect()
        rt = st.query_batch(q, tx.Metric.Cosine).meta_filter(_filter(tx)).take(
            10, **wide).collect()
        assert rt.indices == rj.indices
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)
        assert st.last_query_stats().certified is sj.last_query_stats().certified


def _orig_order(store):
    """Original row id -> the store's position."""
    if store._index_map is None:
        return np.arange(store.n_rows)
    inv = np.empty(store.n_rows, np.int64)
    inv[store._index_map] = np.arange(store.n_rows)
    return inv


@pytest.mark.parametrize("storage", ["int8", "bfloat16"])
def test_append_carries_the_original_residuals(storage):
    """Without ``keep_host_f32`` the rebuild's residuals are sound against
    the codes only; the survivors keep their original ones (the appended
    rows keep the rebuild's), as in JAX: equal to JAX's within the
    residuals' few-ulp difference."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    sj = _builder(jx, vecs, "sort", storage, keep=False).build()
    st = _builder(tx, vecs, "sort", storage, keep=False).build()
    dead = rng.choice(N, 50, replace=False).tolist()
    for s in (sj, st):
        s.delete_rows(dead)
    new = rng.normal(size=(100, D)).astype(np.float32)
    aj, at = sj.append(new, _values(100, N)), st.append(new, _values(100, N))
    keep_ids = np.setdiff1d(np.arange(N), dead)
    old = st._dv.resid.numpy()[_orig_order(st)[keep_ids]]
    carried = at._dv.resid.numpy()[_orig_order(at)[np.arange(len(keep_ids))]]
    assert np.array_equal(carried, old) and (old > 0).all()
    np.testing.assert_allclose(at._dv.resid.numpy(), np.asarray(aj._dv.resid), rtol=2e-5,
                               atol=0)
    assert float(at._dv.resid_max) == float(at._dv.resid.max())
    assert torch.equal(at._dv.resid_bin, at._dv.resid.reshape(-1, 512).amax(dim=1))


def test_append_keeps_the_configuration_and_the_device():
    rng = np.random.default_rng(2)
    _, st, _, _ = _twins("z", storage="bfloat16")
    st.precision = "default"
    new = rng.normal(size=(10, D)).astype(np.float32)
    at = st.append(new, _values(10, N))
    assert at.device == st.device == torch.device("cpu")
    assert (at.chunk_size(), at._bloom_config, at._z_order, at._sort_by, at._storage_dtype,
            at.precision) == (CHUNK, ("bits", 512), ("tag", "price"), None, "bfloat16",
                              "default")
    assert at._rerank_config == (None, True)
    ids = np.arange(N + 10)
    np.testing.assert_array_equal(at._rerank_fetch(ids)[N:], new)


def test_append_checks_match_jax():
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    cases = [
        (dict(keep=False, fetch=lambda i: vecs[np.asarray(i)]),
         (rng.normal(size=(2, D)).astype(np.float32), _values(2, N))),
        (dict(), (rng.normal(size=(2, D + 1)).astype(np.float32), _values(2, N))),
        (dict(), (rng.normal(size=(2, D)).astype(np.float32), {"price": [1.0, 2.0]})),
    ]
    messages = []
    for kw, args in cases:
        sj = _builder(jx, vecs, **kw).build()
        st = _builder(tx, vecs, **kw).build()
        with pytest.raises(JOttersError) as ej:
            sj.append(*args)
        with pytest.raises(OttersError) as et:
            st.append(*args)
        assert str(et.value) == str(ej.value)
        messages.append(str(et.value))
    assert "fetch_vectors rerank source" in messages[0]
    assert messages[1:] == [f"appended vectors must be [m, {D}]", "column 'tag' needs 2 appended values"]


@pytest.mark.parametrize("method", ["delete_rows", "append"])
def test_mutation_methods_keep_jax_signatures(method):
    """Moved from the API-surface stubs: the ported methods keep JAX's
    parameters."""
    jsig = inspect.signature(getattr(jmeta.MetaStore, method))
    tsig = inspect.signature(getattr(tmeta.MetaStore, method))
    assert list(tsig.parameters) == list(jsig.parameters)
