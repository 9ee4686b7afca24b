"""Differential fuzzing of the port: random stores and filters against a
numpy oracle and against the JAX package.

Both tests of ``tests/test_differential_fuzz.py`` with its seeds and trial
counts, on the port (CPU device): random stores over every column type with
nulls, random CNF filters over every leaf kind (negated at random), every
metric, a random vec_filter. Each trial is held against the numpy oracle of
``torch_fuzz_cases`` (the returned scores within 2e-4, every returned row
passing the filter, no chunk lost to pruning). Each single-store trial also
runs ``otters_tpu`` on the same inputs: the same indices in the same order,
the same pruned and evaluated chunk counts, scores within 1e-4. The sharded
trials (a ``rows=4, batch=2`` mesh over the CPU listed 8 times, with random
deletes, compacting appends and ``save`` -> ``load(mesh=)``) are compared
with ``otters_tpu`` on conftest's 8 virtual devices the same way.
"""

import os

import numpy as np
import pytest

import otters_tpu as jx
import otters_tpu_torch as tx
from torch_fuzz_cases import METRICS, columns, oracle, random_columns, random_expr, random_raw

PKGS = (jx, tx)


def _query(store, pkg, queries, metric, expr, k, thr, vcmp):
    plan = store.query_batch(queries, getattr(pkg.Metric, metric)).meta_filter(expr(pkg)).take(k)
    if thr is not None:
        plan = plan.vec_filter(thr, getattr(pkg.Cmp, vcmp))
    return plan.collect()


def _draw_query(rng, metric):
    k = int(rng.integers(1, 30))
    use_vf = rng.random() < 0.4
    thr = float(rng.normal(0, 5)) if use_vf else None
    vcmp = "Gt" if metric in ("Cosine", "DotProduct", "Jaccard") else "Lt"
    return k, thr, vcmp


def _check(trial, got, store, want_scores, row_mask):
    assert len(got) == len(want_scores), (
        f"trial {trial}: count {len(got)} vs oracle {len(want_scores)}"
    )
    np.testing.assert_allclose(got.scores, want_scores, rtol=2e-4, atol=2e-4,
                               err_msg=f"trial {trial}")
    for i in got.indices:
        assert row_mask[i], f"trial {trial}: row {i} fails the filter"
    stats = store.last_query_stats()
    assert stats.evaluated_chunks + stats.pruned_chunks == stats.total_chunks
    return stats


def _check_jax(trial, rt, st, rj, sj):
    assert rt.indices == rj.indices, f"trial {trial}"
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-4, atol=1e-4,
                               err_msg=f"trial {trial}")
    a, b = st.last_query_stats(), sj.last_query_stats()
    assert (a.pruned_chunks, a.evaluated_chunks, a.total_chunks) == (
        b.pruned_chunks, b.evaluated_chunks, b.total_chunks), f"trial {trial}"


def _binary_or_normal(rng, metric, vectors, b, d):
    if metric in ("Hamming", "Jaccard"):
        # binary data: the natural domain, where exact ties abound
        return (vectors > 0).astype(np.float32), (rng.normal(size=(b, d)) > 0).astype(np.float32)
    return vectors, rng.normal(size=(b, d)).astype(np.float32)


@pytest.mark.parametrize("trial", range(int(os.environ.get("OTTERS_FUZZ_TRIALS", "40"))))
def test_random_store_random_filter_matches_oracle_and_jax(trial):
    rng = np.random.default_rng(1000 + trial)
    n = int(rng.integers(50, 800))
    d = int(rng.integers(4, 48))
    chunk = int(rng.choice([16, 64, 256, 1024]))
    schema, raws = random_columns(n, rng)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    expr = random_expr(schema, raws, rng)
    metric = METRICS[rng.integers(0, 6)]
    b = int(rng.integers(1, 4))
    vectors, queries = _binary_or_normal(rng, metric, vectors, b, d)
    k, thr, vcmp = _draw_query(rng, metric)

    stores = {}
    for pkg in PKGS:
        bld = (pkg.MetaStore.from_columns(columns(pkg, schema, raws)).with_vectors(vectors)
               .with_chunk_size(chunk))
        stores[pkg] = (bld.with_device("cpu") if pkg is tx else bld).build()
    rt, rj = (_query(stores[pkg], pkg, queries, metric, expr, k, thr, vcmp) for pkg in (tx, jx))

    compiled = expr(tx).compile(stores[tx].schema())
    want, row_mask = oracle(vectors, queries, metric, compiled, raws, schema, k, thr, vcmp)
    _check(trial, rt, stores[tx], want, row_mask)
    _check_jax(trial, rt, stores[tx], rj, stores[jx])


@pytest.mark.parametrize("trial", range(int(os.environ.get("OTTERS_FUZZ_SHARDED_TRIALS", "12"))))
def test_random_sharded_store_matches_oracle_and_jax(trial, tmp_path):
    """The sharded stores under the same oracle: random stores built onto a
    ``rows=4, batch=2`` mesh, random filters over every dtype, every metric,
    a random vec_filter, and random mutations (tombstone deletes, a
    compacting append, a save -> load(mesh) round trip), the same in both
    packages."""
    from otters_tpu.parallel import make_mesh as jmesh
    from otters_tpu_torch.parallel import make_mesh as tmesh

    rng = np.random.default_rng(7000 + trial)
    n = int(rng.integers(50, 800))
    d = int(rng.choice([8, 16, 32]))
    chunk = int(rng.choice([256, 512]))
    schema, raws = random_columns(n, rng)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    metric = METRICS[rng.integers(0, 6)]
    b = int(rng.integers(1, 4))
    vectors, queries = _binary_or_normal(rng, metric, vectors, b, d)

    meshes = {jx: jmesh(rows=4, batch=2), tx: tmesh(rows=4, batch=2, devices=["cpu"] * 8)}
    stores = {pkg: pkg.MetaStore.from_columns(columns(pkg, schema, raws)).with_vectors(vectors)
              .with_chunk_size(chunk).build_sharded(meshes[pkg]) for pkg in PKGS}

    alive = np.ones(n, dtype=bool)
    if rng.random() < 0.5:
        dead = rng.choice(n, size=int(rng.integers(1, max(2, n // 10))), replace=False)
        for pkg in PKGS:
            stores[pkg].delete_rows(dead.tolist())
        alive[dead] = False

    if rng.random() < 0.35:
        # compacting append: the survivors and the new rows, fresh ids; the
        # oracle's view is rebuilt the same way
        m = int(rng.integers(1, 60))
        new_vecs = rng.normal(size=(m, d)).astype(np.float32)
        if metric in ("Hamming", "Jaccard"):
            new_vecs = (new_vecs > 0).astype(np.float32)
        new_raws = {name: random_raw(schema[name], m, rng) for name in schema}
        for pkg in PKGS:
            stores[pkg] = stores[pkg].append(new_vecs, dict(new_raws))
        keep = np.flatnonzero(alive)
        vectors = np.concatenate([vectors[keep], new_vecs], axis=0)
        raws = {name: [raws[name][i] for i in keep] + list(new_raws[name]) for name in schema}
        n = vectors.shape[0]
        alive = np.ones(n, dtype=bool)

    if rng.random() < 0.25:
        # persistence round trip straight back onto the mesh
        for pkg in PKGS:
            path = str(tmp_path / f"fuzz_{trial}_{pkg.__name__}.npz")
            stores[pkg].save(path)
            stores[pkg] = pkg.MetaStore.load(path, mesh=meshes[pkg])

    expr = random_expr(schema, raws, rng)
    k, thr, vcmp = _draw_query(rng, metric)
    rt, rj = (_query(stores[pkg], pkg, queries, metric, expr, k, thr, vcmp) for pkg in (tx, jx))

    compiled = expr(tx).compile(stores[tx].schema())
    want, row_mask = oracle(vectors, queries, metric, compiled, raws, schema, k, thr, vcmp,
                            alive=alive)
    _check(trial, rt, stores[tx], want, row_mask)
    _check_jax(trial, rt, stores[tx], rj, stores[jx])
