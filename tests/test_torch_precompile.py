"""``MetaStore.precompile`` and ``MetaStore.cache_stats`` of the port against
the JAX package.

``precompile`` returns the JAX package's count for the same store and
arguments (filters, batch sizes, ``rerank_from``, the certificate's widen
ladder, pipeline depths); ``cache_stats()`` returns the JAX package's dict
after the same precompile and query sequence, evictions included with both
stores' caps lowered alike. The JAX package's AOT disk cache is kept in a
temporary directory, as in tests/test_aot.py.
"""

import inspect

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu.meta as jmeta
import otters_tpu_torch as tx
import otters_tpu_torch.meta as tmeta
from torch_parity import columns

N, D = 3000, 16


@pytest.fixture(autouse=True)
def _aot_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("OTTERS_AOT_CACHE", str(tmp_path))
    monkeypatch.setenv("OTTERS_AOT_NO_WARM", "1")
    monkeypatch.delenv("OTTERS_DISABLE_AOT", raising=False)


def _twins(storage):
    rng = np.random.default_rng(61)
    vecs = rng.normal(size=(N, D)).astype(np.float32)
    spec = [("price", "Float64", (np.arange(N) % 100).astype(np.float64)),
            ("cat", "String", [f"c{i % 5}" for i in range(N)])]
    out = []
    for pkg in (jx, tx):
        b = (pkg.MetaStore.from_columns(columns(pkg, spec)).with_vectors(vecs)
             .with_chunk_size(256).with_storage_dtype(storage)
             .with_rerank_source(keep_host_f32=True))
        out.append(b.with_device("cpu").build() if pkg is tx else b.build())
    return out


GRID = {
    "plain": dict(filters=None, batch_sizes=(1, 4)),
    "filtered": dict(filters="both", batch_sizes=(2,), with_vec_filter=True),
    "rerank": dict(filters="both", batch_sizes=(1, 4), rerank_from=20),
    "rerank_depths": dict(filters=None, batch_sizes=(3,), rerank_from=20,
                          pipeline_depths=(1, 2)),
    "rerank_no_ladder": dict(filters="both", batch_sizes=(2,), rerank_from=20,
                             cert_widths=False, pipeline_depths=(1, 2)),
}


def _filters(pkg, which):
    if which is None:
        return None
    return [None, pkg.col("price").lt(50.0)]


@pytest.mark.parametrize("case", list(GRID))
@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_precompile_count_and_cache_stats_match_jax(storage, case):
    kw = dict(GRID[case])
    which = kw.pop("filters")
    sj, st = _twins(storage)
    nj = sj.precompile(filters=_filters(jx, which), k=5, **kw)
    nt = st.precompile(filters=_filters(tx, which), k=5, **kw)
    assert nt == nj
    assert st.cache_stats() == sj.cache_stats()
    # a served query whose program was readied misses no cache
    before = st.cache_stats()
    q = np.random.default_rng(62).normal(size=(kw["batch_sizes"][0], D)).astype(np.float32)
    for pkg, s in ((jx, sj), (tx, st)):
        plan = s.query_batch(q, pkg.Metric.Cosine)
        if which is not None:
            plan = plan.meta_filter(pkg.col("price").lt(50.0))
        plan.take(5).collect()
    assert st.cache_stats() == sj.cache_stats()
    for name in ("plan", "aot_key"):
        assert st.cache_stats()[name]["misses"] == before[name]["misses"]
    assert st.cache_stats()["hostmask"]["size"] == 0


def test_cache_stats_match_jax_with_evictions():
    """Both stores with caps lowered alike (plan 2, aot_key 3): the same
    query sequence over rotating filters, batch sizes and takes gives the
    same size / hit / miss / eviction counts after every query."""
    sj, st = _twins("int8")
    for s in (sj, st):
        s._plan_cache.cap = 2
        s._aot_key_cache.cap = 3
    rng = np.random.default_rng(63)
    seq = [(lim, b, k) for lim in (10.0, 50.0, 90.0, 10.0, 30.0, 90.0)
           for b, k in ((1, 5), (3, 5), (1, 7))]
    for i, (lim, b, k) in enumerate(seq):
        q = rng.normal(size=(b, D)).astype(np.float32)
        for pkg, s in ((jx, sj), (tx, st)):
            plan = s.query_batch(q, pkg.Metric.Cosine).meta_filter(pkg.col("price").lt(lim))
            if i % 4 == 3:
                plan = plan.meta_filter(pkg.col("cat").eq("c2") & pkg.col("price").lt(lim))
            plan.take(k, rerank_from=20 if i % 2 else None).collect()
        assert st.cache_stats() == sj.cache_stats(), i
    stats = st.cache_stats()
    assert stats["plan"]["evictions"] > 0 and stats["aot_key"]["evictions"] > 0
    assert stats["plan"]["capacity"] == 2 and stats["aot_key"]["capacity"] == 3


def test_cache_capacities_are_jax_defaults():
    sj, st = _twins("float32")
    assert {k: v["capacity"] for k, v in st.cache_stats().items()} == {
        k: v["capacity"] for k, v in sj.cache_stats().items()
    } == {"plan": 256, "aot_key": 512, "hostmask": 128}


def test_precompile_rerank_requires_a_rerank_source():
    rng = np.random.default_rng(64)
    vecs = rng.normal(size=(500, D)).astype(np.float32)
    st = tx.MetaStore.from_columns([]).with_vectors(vecs).with_device("cpu").build()
    with pytest.raises(tx.OttersError, match="requires with_rerank_source"):
        st.precompile(rerank_from=20)


@pytest.mark.parametrize("method", ["precompile", "cache_stats"])
def test_ported_methods_keep_jax_signatures(method):
    """precompile and cache_stats have the JAX package's signatures (they
    left the unported stubs' list in tests/test_torch_api_surface.py)."""
    jsig = inspect.signature(getattr(jmeta.MetaStore, method))
    tsig = inspect.signature(getattr(tmeta.MetaStore, method))
    assert list(tsig.parameters) == list(jsig.parameters)

    def defaults(sig):  # enum defaults by value: each package has its Metric
        return [getattr(p.default, "value", p.default) for p in sig.parameters.values()]

    assert defaults(tsig) == defaults(jsig)
