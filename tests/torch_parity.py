"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each helper builds the same store in both packages from the same numpy
inputs: ``otters_tpu`` (JAX on the CPU, as conftest pins it) and
``otters_tpu_torch`` on the CPU device.
"""

import numpy as np
import torch

import otters_tpu as jx
import otters_tpu_torch as tx

torch.set_num_threads(1)


def columns(pkg, spec):
    """spec: list of (name, DataType name, values) -> that package's Columns."""
    return [
        pkg.Column(name, getattr(pkg.DataType, dt)).from_values(vals)
        for name, dt, vals in spec
    ]


def twin_stores(vecs, spec, *, chunk, storage="int8", rerank=True):
    """(jax store, torch store) over the same vectors and columns."""
    out = []
    for pkg in (jx, tx):
        b = (
            pkg.MetaStore.from_columns(columns(pkg, spec))
            .with_vectors(vecs)
            .with_chunk_size(chunk)
            .with_storage_dtype(storage)
        )
        if rerank:
            b = b.with_rerank_source(keep_host_f32=True)
        if pkg is tx:
            b = b.with_device("cpu")
        out.append(b.build())
    return tuple(out)


def stats_tuple(store):
    s = store.last_query_stats()
    return (s.certified, s.scan_k_wide, s.pruned_chunks, s.evaluated_chunks,
            s.total_chunks, s.vectors_compared)


def assert_same_results(rj, rt, sj, st):
    """Identical indices in order, scores within 1e-6, identical stats."""
    assert rt.indices == rj.indices
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)
    assert stats_tuple(st) == stats_tuple(sj)


def use_fused_path(monkeypatch, direct_limit=1 << 10):
    """Route both packages' big-store queries to the fused kernel path: the
    JAX kernel in interpret mode, the port's kernel through its plain
    version (CPU tensors)."""
    import otters_tpu.ops.scoring as jscoring
    import otters_tpu_torch.ops.scoring as tscoring

    monkeypatch.setenv("OTTERS_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jscoring, "DIRECT_LIMIT", direct_limit)
    monkeypatch.setattr(tscoring, "DIRECT_LIMIT", direct_limit)
