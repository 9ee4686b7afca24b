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


# ---------------------------------------------------------------------------
# The four query paths of a MetaStore (the lifecycle tests: strings, sorted
# and Z-ordered stores, deletes / appends, persistence)
# ---------------------------------------------------------------------------

PATHS = ["direct", "scan", "fused", "take_all"]
TAKE_ALL_K = 2500  # a rerank of every candidate on the take-all path


def route(path, monkeypatch):
    """Put both packages on ``path`` for a 3-query batch over a store of a
    few thousand rows (build the stores after this): "direct" as they are;
    "fused" and "scan" (a k past the fused kernel's) with the small direct
    limit of :func:`use_fused_path`; "take_all" with a small scan limit too,
    so no device top-k takes a k of thousands."""
    if path != "direct":
        use_fused_path(monkeypatch)
    if path == "take_all":
        import otters_tpu.ops.scoring as jscoring
        import otters_tpu_torch.ops.scoring as tscoring

        monkeypatch.setattr(jscoring, "SCAN_K_MAX", 1024)
        monkeypatch.setattr(tscoring, "SCAN_K_MAX", 1024)


def query_on_path(store, pkg, q, path, certify, flt=None, metric="Cosine"):
    """One query of a rerank store on ``path``: take(10) from a widened
    scan with the certificate on (auto) or off; the take-all path reranks
    every candidate (certify) or returns every row's stored score."""
    plan = store.query_batch(q, getattr(pkg.Metric, metric))
    if flt is not None:
        plan = plan.meta_filter(flt(pkg))
    if path == "take_all":
        return (plan.take(TAKE_ALL_K, rerank_from=TAKE_ALL_K) if certify else plan).collect()
    k_wide = 1100 if path == "scan" else 40
    return plan.take(10, rerank_from=k_wide, certify=None if certify else False).collect()


def assert_same_on_path(rj, rt, sj, st, path):
    """:func:`assert_same_results`; on the take-all path (thousands of
    results over f32 sums taken in other orders, so near-tied neighbours may
    swap) the same rows as a multiset, the scores rank for rank within
    2e-5 and sorted, and the same stats."""
    if path != "take_all":
        assert_same_results(rj, rt, sj, st)
        return
    assert sorted(rt.indices) == sorted(rj.indices)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=2e-5, atol=2e-5)
    assert (np.diff(np.asarray(rt.scores)) <= 0).all()
    assert stats_tuple(st) == stats_tuple(sj)


def assert_same_metric(rj, rt, sj, st, metric):
    """:func:`assert_same_results` with the tolerance of the metric's
    scores: 1e-6 relative (the dots summed in other orders), and for Euclid
    4 ulps of the largest score (``q^2 + v^2 - 2 q.v`` cancels)."""
    assert rt.indices == rj.indices
    atol = 1e-6
    if metric == "Euclidean":
        atol = 4 * float(np.spacing(np.float32(max(np.abs(rj.scores), default=1.0))))
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-6, atol=atol)
    assert stats_tuple(st) == stats_tuple(sj)


MESHES = {"4x2": (4, 2), "8": (8, 1)}


def twin_meshes(kind):
    """(JAX mesh over conftest's 8 virtual CPU devices, the port's mesh of
    the same shape over the CPU listed 8 times)."""
    from otters_tpu.parallel import make_mesh as jmesh
    from otters_tpu_torch.parallel import make_mesh as tmesh

    rows, batch = MESHES[kind]
    return jmesh(rows=rows, batch=batch), tmesh(rows=rows, batch=batch, devices=["cpu"] * 8)
