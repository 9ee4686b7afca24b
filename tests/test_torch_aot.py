"""The port's ``aot``: the per-signature programs and the disk layer of
compiled libraries.

Mirrors ``tests/test_aot.py``'s seven cases on the port: precompiled
signatures add nothing to ``aot._mem`` at query time (also with the
``vec_filter`` variant); the disk round trip in two subprocesses sharing an
``OTTERS_AOT_CACHE`` directory (the first builds the g++ host library, the
second loads it and compiles nothing; with ``OTTERS_AOT_CACHE=0`` both
build), on a single-device and on a sharded store; ``signature`` telling
shapes and statics apart; and the two rerank-warm cases. On the CPU the
programs load no kernel library (the kernels run through their plain
versions there); the card's nvcc libraries are held by the ``cuda``-marked
pair in ``test_torch_kernels_cuda.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from otters_tpu_torch import Cmp, Column, DataType, Metric, MetaStore, aot, col
from otters_tpu_torch.errors import OttersError
from otters_tpu_torch.meta import resolve

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def store():
    rng = np.random.default_rng(61)
    n = 2000
    cols = [
        Column("price", DataType.Float32).from_values((np.arange(n) % 100).astype(np.float32)),
    ]
    return (
        MetaStore.from_columns(cols)
        .with_vectors(rng.normal(size=(n, 16)).astype(np.float32))
        .with_chunk_size(256)
        .with_device("cpu")
        .build()
    )


def test_precompile_counts_and_reuse(store):
    aot.clear_memory_cache()
    n = store.precompile(filters=[None, col("price").lt(50.0)], batch_sizes=(1, 4), k=5)
    assert n == 4
    before = dict(aot._mem)
    assert len(before) == 4
    q = np.random.default_rng(62).normal(size=(4, 16)).astype(np.float32)
    r = store.query_batch(q, Metric.Cosine).meta_filter(col("price").lt(50.0)).take(5).collect()
    assert len(r) == 5
    assert all(i % 100 < 50 for i in r.indices)
    assert set(aot._mem) == set(before), "query made a program precompile had made"
    assert aot.jit_is_ready(next(iter(before))) and aot.wait_jit_ready() is True


def test_precompile_with_vec_filter_variant(store):
    aot.clear_memory_cache()
    n = store.precompile(filters=[None], batch_sizes=(2,), k=5, with_vec_filter=True)
    assert n == 2
    q = np.random.default_rng(63).normal(size=(2, 16)).astype(np.float32)
    before = dict(aot._mem)
    r = store.query_batch(q, Metric.Cosine).vec_filter(-1.0, Cmp.Gt).take(5).collect()
    assert len(r) == 5
    assert set(aot._mem) == set(before)


_DISK_PROG = r"""
import sys
import numpy as np
from otters_tpu_torch import Column, DataType, Metric, MetaStore, aot, col
from otters_tpu_torch.parallel import make_mesh

mode, layout = sys.argv[1], sys.argv[2]
rng = np.random.default_rng(61)
n = 4096
vecs = rng.normal(size=(n, 16)).astype(np.float32)
tags = [f"t{i % 7}" for i in range(n)]
b = (MetaStore.from_columns([Column("tag", DataType.String).from_values(tags)])
     .with_vectors(vecs).with_chunk_size(1024))
store = (b.build_sharded(make_mesh(rows=4, batch=2, devices=["cpu"] * 8)) if layout == "sharded"
         else b.with_device("cpu").build())
q = np.random.default_rng(64).normal(size=(2, 16)).astype(np.float32)
r = store.query_batch(q, Metric.Cosine).meta_filter(col("tag").eq("t3")).take(3).collect()
assert len(aot._mem) == 1, aot._mem
ok = np.array([t == "t3" for t in tags])
s = (q @ vecs.T) / np.linalg.norm(q, axis=1)[:, None] / np.linalg.norm(vecs, axis=1)[None, :]
s[:, ~ok] = -np.inf
want = np.sort(s.reshape(-1))[::-1][:3]
np.testing.assert_allclose(r.scores, want, rtol=1e-5, atol=1e-6)
print("STATS", aot.stats["compiles"], aot.stats["disk_hits"], aot.cache_dir())
"""


def _disk_pair(cache, layout):
    """Run the program twice, each time in a fresh process on the cache
    ``cache`` -> [(compiles, disk_hits, cache_dir)] of each."""
    env = {k: v for k, v in os.environ.items() if k not in ("OTTERS_DISABLE_AOT", "PYTHONPATH")}
    env.update(OTTERS_AOT_CACHE=cache, PYTHONPATH=_REPO)
    got = []
    for mode in ("first", "second"):
        res = subprocess.run([sys.executable, "-c", _DISK_PROG, mode, layout],
                             capture_output=True, text=True, env=env, timeout=240, cwd=_REPO)
        assert res.returncode == 0, (mode, res.stdout, res.stderr[-2000:])
        line = next(x for x in res.stdout.splitlines() if x.startswith("STATS"))
        compiles, hits, where = line.split()[1:]
        got.append((int(compiles), int(hits), where))
    return got


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_disk_round_trip_subprocess(tmp_path, layout):
    """A fresh process on the first one's ``OTTERS_AOT_CACHE`` finds the
    g++ library there and compiles nothing; ``OTTERS_AOT_CACHE=0`` builds
    it in each process's own temporary directory."""
    (c1, _, d1), (c2, h2, d2) = _disk_pair(str(tmp_path), layout)
    assert c1 >= 1 and (c2, d1, d2) == (0, str(tmp_path), str(tmp_path)) and h2 >= 1
    assert any(f.startswith("otters_native") for f in os.listdir(tmp_path))
    (c1, _, d1), (c2, _, d2) = _disk_pair("0", layout)
    assert c1 >= 1 and c2 >= 1 and d1 != d2
    assert not os.path.exists(d1) and not os.path.exists(d2)  # removed at exit


def test_the_port_has_jax_public_names():
    """``otters_tpu_torch.aot`` has every public name of ``otters_tpu.aot``
    (functions with JAX's parameters) and its ``stats`` keys."""
    import inspect

    import otters_tpu.aot as jaot

    names = [n for n, v in vars(jaot).items()
             if not n.startswith("_") and inspect.isfunction(v) and v.__module__ == jaot.__name__]
    assert len(names) == 8
    for n in names:
        assert list(inspect.signature(getattr(aot, n)).parameters) == \
            list(inspect.signature(getattr(jaot, n)).parameters), n
    assert set(aot.stats) == set(jaot.stats) == {"disk_hits", "compiles"}


def test_signature_distinguishes_shapes_and_statics():
    a = aot.signature("p", "s1", (torch.zeros((2, 3)),), {})
    b = aot.signature("p", "s1", (torch.zeros((2, 4)),), {})
    c = aot.signature("p", "s2", (torch.zeros((2, 3)),), {})
    e = aot.signature("p", "s1", (torch.zeros((2, 3), dtype=torch.int8),), {})
    assert len({a, b, c, e}) == 4
    assert aot.signature("p", "s1", (torch.ones((2, 3)),), {}) == a  # values do not count


def test_disable_aot_bypasses_the_table(store, monkeypatch):
    """``OTTERS_DISABLE_AOT`` (JAX's kill-switch) makes the launch decision
    afresh and leaves ``aot._mem`` and the ``aot_key`` memo alone."""
    monkeypatch.setenv("OTTERS_DISABLE_AOT", "1")
    aot.clear_memory_cache()
    q = np.random.default_rng(65).normal(size=(2, 16)).astype(np.float32)
    r = store.query_batch(q, Metric.Cosine).take(3).collect()
    assert len(r) == 3 and aot._mem == {}
    assert store.cache_stats()["aot_key"]["size"] == 0


def test_precompile_rerank_warms_device_program():
    """precompile(rerank_from=..., pipeline_depths=...) readies the widened
    scan and the batched rerank for each pipeline depth."""
    rng = np.random.default_rng(81)
    n, d = 3000, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store = (MetaStore.from_columns([]).with_vectors(vecs).with_storage_dtype("int8")
             .with_rerank_source(keep_host_f32=True).with_device("cpu").build())
    count = store.precompile(filters=[None], batch_sizes=(2,), k=3, rerank_from=32,
                             pipeline_depths=(1, 3))
    assert count >= 1 + 3 + 1  # rerank warms (1+3 pendings) + the base program
    bare = MetaStore.from_columns([]).with_vectors(vecs).with_device("cpu").build()
    with pytest.raises(OttersError, match="with_rerank_source"):
        bare.precompile(rerank_from=32)


def test_precompile_rerank_shapes_cover_pipelined_serving():
    """After precompile, a pipelined resolve() of fresh random pendings
    adds no program signature."""
    rng = np.random.default_rng(82)
    n, d, b, k, kw, depth = 3000, 16, 2, 3, 32, 3
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    store = (MetaStore.from_columns([]).with_vectors(vecs).with_storage_dtype("int8")
             .with_rerank_source(keep_host_f32=True).with_device("cpu").build())
    aot.clear_memory_cache()
    store.precompile(filters=[None], batch_sizes=(b,), k=k, rerank_from=kw,
                     pipeline_depths=(depth,))
    before = set(aot._mem)
    pend = [store.query_batch(rng.normal(size=(b, d)).astype(np.float32), Metric.Cosine)
            .take(k, rerank_from=kw).collect_async() for _ in range(depth)]
    results = resolve(pend)
    assert all(len(r) == k for r in results)
    assert all(p._device_rerank is not None for p in pend), "the batched rerank did not run"
    assert set(aot._mem) == before, f"serving made {set(aot._mem) - before}"
