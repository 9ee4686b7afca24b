"""Ingest from a device tensor and the device Bloom build, against the JAX
package.

``with_vectors(torch.Tensor)`` (the JAX package's ``with_vectors(jax.Array)``)
over f32, bf16 and int8 storage, with and without rows pre-padded to
``pad_rows(n)``: the stored codes are equal (norms within d 2^-24, the
bound on two f32 sums of d squares in other orders; residuals within 2e-5,
as for the host ingest), the query results are equal, the slab-wise
ingest gives the same bits as the port's whole-store ingest, and f32 rows
pre-padded at an aligned depth are adopted with no copy. The device Bloom
build (``OTTERS_BLOOM_DEVICE``) equals the host build and the JAX package's
device build bit for bit, on hashes with the top bit set, nulls, 16 hashes,
per-chunk bits just under 2^24 and ``n_chunks * bits`` near 2^31.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu.ops.bloom as jbloom
import otters_tpu_torch as tx
import otters_tpu_torch.ops.bloom as tbloom
import otters_tpu_torch.ops.scoring as ts
from otters_tpu_torch.ops import hashing
from torch_parity import columns

STORAGES = ["float32", "bfloat16", "int8"]


def _spec(n):
    return [("price", "Float64", (np.arange(n) % 100).astype(np.float64)),
            ("tag", "String", [f"t{i % 7}" for i in range(n)])]


def _builders(vecs_np, n_rows, storage):
    """(jax builder, torch builder) over the same rows handed as a device
    array / tensor (``n_rows`` rows valid)."""
    n = n_rows
    spec = _spec(n)
    bj = (jx.MetaStore.from_columns(columns(jx, spec))
          .with_vectors(jnp.asarray(vecs_np), n_rows=None if n == len(vecs_np) else n)
          .with_chunk_size(256).with_storage_dtype(storage))
    bt = (tx.MetaStore.from_columns(columns(tx, spec))
          .with_vectors(torch.from_numpy(vecs_np), n_rows=None if n == len(vecs_np) else n)
          .with_chunk_size(256).with_storage_dtype(storage).with_device("cpu"))
    return bj, bt


def _rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _assert_same_storage(dj, dt):
    np.testing.assert_array_equal(dt.vectors.float().numpy(),
                                  np.asarray(jnp.asarray(dj.vectors, jnp.float32)))
    np.testing.assert_array_equal(dt.valid.numpy(), np.asarray(dj.valid))
    acc = dt.vectors.shape[1] * 2.0**-24  # f32 sums of d terms in other orders
    np.testing.assert_allclose(dt.norms_sq.numpy(), np.asarray(dj.norms_sq), rtol=acc)
    np.testing.assert_allclose(dt.inv_norms.numpy(), np.asarray(dj.inv_norms), rtol=acc)
    assert (dt.resid is None) == (dj.resid is None)
    if dj.resid is not None:
        np.testing.assert_allclose(dt.resid.numpy(), np.asarray(dj.resid), rtol=2e-5,
                                   atol=1e-12)
        assert (dt.resid_bin is None) == (dj.resid_bin is None)
        np.testing.assert_allclose(dt.resid_max.numpy(), np.asarray(dj.resid_max),
                                   rtol=2e-5)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_tensor_ingest_matches_jax(storage, padded):
    n, d = 2900, 32
    vecs = _rows(n, d, 1)
    src = vecs
    if padded:
        src = np.zeros((ts.pad_rows(n), d), np.float32)
        src[:n] = vecs
    bj, bt = _builders(src, n, storage)
    rerank = dict(keep_host_f32=True)
    sj, st = bj.with_rerank_source(**rerank).build(), bt.with_rerank_source(**rerank).build()
    assert st.n_rows == sj.n_rows == n and st._storage_dtype == storage
    _assert_same_storage(sj._dv, st._dv)
    q = _rows(3, d, 2)
    for kw in (dict(), dict(rerank_from=30)):
        rj = sj.query_batch(q, jx.Metric.Cosine).meta_filter(jx.col("price").lt(40.0)) \
            .take(6, **kw).collect()
        rt = st.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("price").lt(40.0)) \
            .take(6, **kw).collect()
        assert rt.indices == rj.indices
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)
        assert st.last_query_stats().certified == sj.last_query_stats().certified


@pytest.mark.parametrize("storage", STORAGES)
def test_tensor_ingest_equals_the_whole_store_ingest(storage):
    """The slab walk (several slabs and a short last one) stores the same
    bits as the port's host ingest of the same rows, and int8 the same as
    materialize_int8_slabs."""
    n, d = 2900, 48
    vecs = _rows(n, d, 3)
    src = np.zeros((ts.pad_rows(n), d), np.float32)
    src[:n] = vecs
    dtype = getattr(torch, storage)
    whole = ts.materialize(vecs, dtype=dtype, device="cpu")
    old = ts.INGEST_SLAB_ROWS
    try:
        ts.INGEST_SLAB_ROWS = 700
        slabs = ts.materialize_from_device(torch.from_numpy(src), n_valid=n, dtype=dtype)
    finally:
        ts.INGEST_SLAB_ROWS = old
    built = [slabs]
    if storage == "int8":
        built.append(ts.materialize_int8_slabs(lambda s, r: src[s : s + r], n, d, 1000,
                                               device="cpu"))
    for dv in built:
        for a, b in zip(dv, whole):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("d", [32, 20])
def test_f32_prepadded_tensor_is_adopted_without_a_copy(d):
    n = 2900
    src = torch.zeros((ts.pad_rows(n), d))
    src[:n] = torch.from_numpy(_rows(n, d, 4))
    store = (tx.MetaStore.from_columns(columns(tx, _spec(n))).with_vectors(src, n_rows=n)
             .with_device("cpu").build())
    dv = store._dv
    if d % ts.DEPTH_ALIGN == 0:
        assert dv.vectors.data_ptr() == src.data_ptr()
    else:  # a depth that needs padding is copied once, into 32-deep rows
        assert dv.vectors.data_ptr() != src.data_ptr() and dv.vectors.stride(0) == 32
    assert torch.equal(dv.vectors, src) and int(dv.valid.sum()) == n


def test_tensor_on_another_device_raises():
    n, d = 300, 8
    builder = (tx.MetaStore.from_columns(columns(tx, _spec(n)))
               .with_vectors(torch.empty((n, d), device="meta")).with_device("cpu"))
    with pytest.raises(tx.OttersError, match="the vectors tensor lives on meta"):
        builder.build()


# ---------------------------------------------------------------------------
# The device Bloom build
# ---------------------------------------------------------------------------


def _hashes(n, seed, top_bits=True):
    rng = np.random.default_rng(seed)
    g1, g2 = hashing.hash_strings([f"s{int(x)}" for x in rng.integers(0, 700, n)])
    if top_bits:  # hashes >= 2^63, where a signed 64-bit `%` goes wrong
        g1[::3] |= np.uint64(1) << np.uint64(63)
        g2[::5] |= np.uint64(1) << np.uint64(63)
        g2[1::7] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return g1, g2


def test_mod64_pos_equals_uint64_arithmetic():
    g1, g2 = _hashes(4000, 5)
    g1[:4] = [0, 0xFFFFFFFFFFFFFFFF, 1 << 63, (1 << 64) - 2]
    hi1, lo1 = tbloom._halves(g1, "cpu")
    hi2, lo2 = tbloom._halves(g2, "cpu")
    for bits in (64, 640, 9824, (1 << 24) - 32):
        for j in range(16):
            want = (g1 + np.uint64(j) * g2) % np.uint64(bits)
            got = tbloom._mod64_pos(hi1, lo1, hi2, lo2, j, bits).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))


# (rows, chunk, bloom config, k_hashes or None, null share, compare with JAX)
BLOOM_CASES = {
    "fpr": (5000, 64, ("fpr", 0.01), None, 0.1, True),
    "k16": (3000, 100, ("bits", 5000), 16, 0.0, True),
    "all_null_chunk": (1000, 128, ("fpr", 0.05), None, 1.0, True),
    "bits_near_2^24": (2000, 1000, ("bits", (1 << 24) - 64), 16, 0.3, True),
    # n_chunks * bits = 2,130,702,368 of 2^31: the JAX build's dense bitmap
    # would take 10 GB on the host, so the port is held to the host build
    "flat_index_near_2^31": (127 * 4, 4, ("bits", (1 << 24) - 32), 16, 0.2, False),
}


@pytest.mark.parametrize("case", list(BLOOM_CASES))
def test_device_bloom_build_is_bit_equal(case):
    n, chunk, (kind, val), k, null_share, with_jax = BLOOM_CASES[case]
    g1, g2 = _hashes(n, 6)
    nulls = np.random.default_rng(7).random(n) < null_share
    n_chunks = -(-n // chunk)
    params = (tbloom.BloomParams.from_fpr if kind == "fpr" else tbloom.BloomParams.from_bits)(
        val, chunk)
    if k is not None:
        params = tbloom.BloomParams(params.bits, k, params.words)
    assert tbloom.device_build_ok(params, n_chunks)
    host = tbloom.build_matrix(g1, g2, nulls, np.arange(n) // chunk, n_chunks, params,
                               chunk_size=chunk)
    dev = tbloom.build_matrix_device(g1, g2, nulls, chunk, n_chunks, params, "cpu")
    assert dev.dtype == torch.int32 and dev.shape == (n_chunks, params.words)
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), host)
    if with_jax:
        jp = jbloom.BloomParams(params.bits, params.k_hashes, params.words)
        want = np.asarray(jbloom.build_matrix_device(g1, g2, nulls, chunk, n_chunks, jp))
        np.testing.assert_array_equal(dev.numpy().view(np.uint32), want)


@pytest.mark.parametrize("bits,n_chunks", [((1 << 24) - 32, 127), ((1 << 24) - 32, 128),
                                           (1 << 24, 1), (9824, 9766), (640, 0)])
def test_device_build_ok_is_jax_rule(bits, n_chunks):
    p = (tbloom.BloomParams(bits, 7, bits // 32), jbloom.BloomParams(bits, 7, bits // 32))
    assert tbloom.device_build_ok(p[0], n_chunks) == jbloom.device_build_ok(p[1], n_chunks)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_store_bloom_switch_matches_host_and_jax(storage, monkeypatch):
    """OTTERS_BLOOM_DEVICE=1 builds the store's Bloom matrix on the device:
    the same bits as the default host build and as the JAX package's
    device build, and a string_eq query prunes alike."""
    n, d = 3000, 16
    vecs = _rows(n, d, 8)
    cat = [None if i % 11 == 0 else f"cat_{(i // 256) % 16:02d}" for i in range(n)]
    spec = [("cat", "String", cat)]

    def build(pkg, env):
        if env is None:
            monkeypatch.delenv("OTTERS_BLOOM_DEVICE", raising=False)
        else:
            monkeypatch.setenv("OTTERS_BLOOM_DEVICE", env)
        b = (pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs)
             .with_chunk_size(256).with_storage_dtype(storage))
        return b.with_device("cpu").build() if pkg is tx else b.build()

    host = build(tx, None)
    off = build(tx, "false")
    dev = build(tx, "1")
    jdev = build(jx, "1")
    bits = lambda s: s._device_cols["cat"]["bloom"].numpy().view(np.uint32)  # noqa: E731
    np.testing.assert_array_equal(bits(dev), bits(host))
    np.testing.assert_array_equal(bits(off), bits(host))
    np.testing.assert_array_equal(bits(dev), np.asarray(jdev._device_cols["cat"]["bloom"]))
    q = _rows(2, d, 9)
    rt = dev.query_batch(q, tx.Metric.Cosine).meta_filter(tx.col("cat").eq("cat_03")) \
        .take(5).collect()
    rj = jdev.query_batch(q, jx.Metric.Cosine).meta_filter(jx.col("cat").eq("cat_03")) \
        .take(5).collect()
    assert rt.indices == rj.indices
    assert dev.last_query_stats().pruned_chunks == jdev.last_query_stats().pruned_chunks
