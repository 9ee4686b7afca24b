"""VecStore / VecQueryPlan of the port: the analytic cases of
``tests/test_vecstore.py`` (the reference's tests/vec_store_tests.rs), run
on the port's CPU device, and fused-size parity with the JAX package.

The analytic cases are those of the JAX package's file, case for case, with
``VecStore`` built on the CPU. The parity cases build the same store in
both packages above the direct path's size, so the JAX package runs its
Pallas kernel in interpret mode and the port its fused kernels' plain
versions: the same (index, score) lists, including a fast-exact check that
fails on exact ties and its strict rerun.
"""

import math

import numpy as np
import pytest
import torch

import otters_tpu as jx
import otters_tpu_torch as tx
from otters_tpu_torch import (
    Cmp,
    Metric,
    OttersError,
    VecQueryPlan,
    cosine_similarity,
    dot_product,
    euclidean_distance_squared,
)
from otters_tpu_torch.state import vec_store_from_numpy
from torch_parity import use_fused_path


def VecStore(dim, dtype="float32"):
    """The port's VecStore on the CPU device."""
    return tx.VecStore(dim, dtype, device="cpu")


def create_test_vectors():
    return [
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0],
        [1.0, 1.0, 0.0],
        [0.5, 0.5, 0.5],
    ]


# ---------------------------------------------------------------------------
# Basic store behavior
# ---------------------------------------------------------------------------


def test_vecstore_creation():
    store = VecStore(3)
    store.add_vector([1.0, 2.0, 3.0])
    with pytest.raises(OttersError):
        store.add_vector([1.0, 2.0])


def test_vecstore_add_vectors():
    store = VecStore(3)
    store.add_vectors(create_test_vectors())
    assert len(store) == 5
    assert not store.is_empty()


def test_query_plan_creation():
    store = VecStore(3)
    assert store.query([1.0, 0.0, 0.0], Metric.Cosine).collect() == []
    assert (
        store.query([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], Metric.Cosine).collect()
        == []
    )


# ---------------------------------------------------------------------------
# Error handling (deferred errors surface at collect)
# ---------------------------------------------------------------------------


def test_dimension_mismatch_error_handling():
    store = VecStore(3)
    store.add_vector([1.0, 0.0, 0.0])
    with pytest.raises(
        OttersError,
        match="Query vector length 2 does not match expected dimension 3",
    ):
        store.query([1.0, 0.0], Metric.Cosine).take(5).collect()


def test_empty_query_batch_error_handling():
    store = VecStore(3)
    with pytest.raises(OttersError, match="No queries provided"):
        store.query([], Metric.Cosine).take(5).collect()


def test_error_propagation_through_chain():
    store = VecStore(3)
    with pytest.raises(OttersError, match="does not match expected dimension 3"):
        (
            store.query([1.0, 0.0], Metric.Cosine)
            .filter(0.5, Cmp.Gt)
            .take(5)
            .take_min(3)
            .collect()
        )


def test_successful_chain_after_valid_query():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.8, 0.6])
    store.add_vector([0.0, 1.0])
    results = (
        store.query([1.0, 0.0], Metric.Cosine).filter(0.5, Cmp.Gt).take(5).collect()
    )
    for r in results:
        assert r.score > 0.5


def test_mixed_dimension_batch_error():
    store = VecStore(3)
    store.add_vector([1.0, 0.0, 0.0])
    queries = [[1.0, 0.0, 0.0], [1.0, 0.0], [1.0, 0.0, 0.0]]
    with pytest.raises(
        OttersError,
        match="Query vector length 2 does not match expected dimension 3",
    ):
        store.query(queries, Metric.Cosine).take(5).collect()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def test_cosine_similarity_basic():
    store = VecStore(3)
    store.add_vectors(create_test_vectors())
    results = store.query([1.0, 0.0, 0.0], Metric.Cosine).take(5).collect()
    assert len(results) == 5
    self_sim = next(r for r in results if r.index == 0)
    assert abs(self_sim.score - 1.0) < 1e-6


def test_cosine_orthogonal_vectors():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    results = store.query([1.0, 0.0], Metric.Cosine).take(2).collect()
    assert len(results) == 2
    parallel = next(r for r in results if r.index == 0)
    orthogonal = next(r for r in results if r.index == 1)
    assert abs(parallel.score - 1.0) < 1e-6
    assert abs(orthogonal.score) < 1e-6


def test_euclidean_distance_basic():
    store = VecStore(3)
    store.add_vectors(create_test_vectors())
    results = store.query([1.0, 0.0, 0.0], Metric.Euclidean).take_min(5).collect()
    self_dist = next(r for r in results if r.index == 0)
    assert abs(self_dist.score) < 1e-6


def test_dot_product_basic():
    store = VecStore(3)
    store.add_vectors(create_test_vectors())
    results = store.query([1.0, 0.0, 0.0], Metric.DotProduct).take(5).collect()
    self_dot = next(r for r in results if r.index == 0)
    assert abs(self_dot.score - 1.0) < 1e-6


def test_dot_product_orthogonal_vectors():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    store.add_vector([2.0, 0.0])
    store.add_vector([-1.0, 0.0])
    results = store.query([1.0, 0.0], Metric.DotProduct).take(4).collect()
    assert len(results) == 4
    by_idx = {r.index: r.score for r in results}
    assert abs(by_idx[0] - 1.0) < 1e-6
    assert abs(by_idx[1]) < 1e-6
    assert abs(by_idx[2] - 2.0) < 1e-6
    assert abs(by_idx[3] + 1.0) < 1e-6


def test_dot_product_ranking():
    store = VecStore(2)
    store.add_vector([3.0, 4.0])  # 25
    store.add_vector([1.0, 1.0])  # 7
    store.add_vector([0.0, 1.0])  # 4
    store.add_vector([-1.0, 0.0])  # -3
    results = store.query([3.0, 4.0], Metric.DotProduct).take(4).collect()
    assert len(results) == 4
    for i in range(1, len(results)):
        assert results[i - 1].score >= results[i].score
    assert abs(results[0].score - 25.0) < 1e-6
    assert abs(results[-1].score + 3.0) < 1e-6


def test_dot_product_filtering():
    store = VecStore(2)
    store.add_vector([2.0, 0.0])
    store.add_vector([1.0, 0.0])
    store.add_vector([0.5, 0.0])
    store.add_vector([-1.0, 0.0])
    results = (
        store.query([1.0, 0.0], Metric.DotProduct)
        .filter(1.0, Cmp.Gt)
        .take(10)
        .collect()
    )
    assert len(results) == 1
    assert abs(results[0].score - 2.0) < 1e-6


def test_dot_product_take_max():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([2.0, 0.0])
    store.add_vector([0.5, 0.0])
    store.add_vector([-1.0, 0.0])
    results = store.query([1.0, 0.0], Metric.DotProduct).take_max(2).collect()
    assert len(results) == 2
    assert abs(results[0].score - 2.0) < 1e-6
    assert abs(results[1].score - 1.0) < 1e-6


def test_dot_product_take_min():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([2.0, 0.0])
    store.add_vector([0.5, 0.0])
    store.add_vector([-1.0, 0.0])
    results = store.query([1.0, 0.0], Metric.DotProduct).take_min(2).collect()
    assert len(results) == 2
    assert abs(results[0].score + 1.0) < 1e-6
    assert abs(results[1].score - 0.5) < 1e-6


def test_dot_product_batch_queries():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    store.add_vector([1.0, 1.0])
    results = (
        store.query([[1.0, 0.0], [0.0, 1.0]], Metric.DotProduct).take(3).collect()
    )
    assert len(results) == 3


# ---------------------------------------------------------------------------
# Top-k selection
# ---------------------------------------------------------------------------


def test_top_k_cosine():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.8, 0.6])
    store.add_vector([0.0, 1.0])
    store.add_vector([-1.0, 0.0])
    results = store.query([1.0, 0.0], Metric.Cosine).take(2).collect()
    assert len(results) == 2
    assert results[0].score >= results[1].score


def test_top_k_euclidean():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([1.1, 0.0])
    store.add_vector([0.0, 1.0])
    store.add_vector([-1.0, 0.0])
    results = store.query([1.0, 0.0], Metric.Euclidean).take_min(2).collect()
    assert len(results) == 2
    assert results[0].score <= results[1].score


def test_take_more_than_available():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    results = store.query([1.0, 0.0], Metric.Cosine).take(10).collect()
    assert len(results) == 2


def test_take_zero_results():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    results = store.query([1.0, 0.0], Metric.Cosine).take(0).collect()
    assert len(results) == 0


def test_filtering():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.8, 0.6])
    store.add_vector([0.0, 1.0])
    store.add_vector([-1.0, 0.0])
    results = (
        store.query([1.0, 0.0], Metric.Cosine).filter(0.5, Cmp.Gt).take(10).collect()
    )
    for r in results:
        assert r.score > 0.5


def test_empty_store():
    store = VecStore(3)
    results = store.query([1.0, 0.0, 0.0], Metric.Cosine).take(5).collect()
    assert results == []


# ---------------------------------------------------------------------------
# Standalone kernel functions
# ---------------------------------------------------------------------------


def test_dot_product_fn():
    assert dot_product([1.0, 2.0, 3.0, 4.0], [2.0, 3.0, 4.0, 5.0]) == 40.0


def test_euclidean_distance_squared_fn():
    assert euclidean_distance_squared([1.0, 2.0], [4.0, 6.0]) == 25.0


def test_cosine_similarity_fn():
    assert abs(cosine_similarity([1.0, 0.0], [1.0, 0.0], 1.0, 1.0) - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# Mathematical correctness
# ---------------------------------------------------------------------------


def test_cosine_similarity_correctness():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([-1.0, 0.0])
    store.add_vector([0.0, 1.0])
    store.add_vector([1.0, 1.0])
    results = store.query([1.0, 0.0], Metric.Cosine).take(4).collect()
    assert len(results) == 4
    by_idx = {r.index: r.score for r in results}
    assert abs(by_idx[0] - 1.0) < 1e-6
    assert abs(by_idx[1] + 1.0) < 1e-6
    assert abs(by_idx[2]) < 1e-6
    assert abs(by_idx[3] - 1.0 / math.sqrt(2.0)) < 1e-5


def test_euclidean_distance_correctness():
    store = VecStore(2)
    store.add_vector([0.0, 0.0])
    store.add_vector([3.0, 4.0])
    store.add_vector([1.0, 1.0])
    store.add_vector([0.0, 5.0])
    store.add_vector([-3.0, -4.0])
    results = store.query([0.0, 0.0], Metric.Euclidean).take_min(5).collect()
    by_idx = {r.index: r.score for r in results}
    assert abs(by_idx[0]) < 1e-6
    assert abs(by_idx[1] - 25.0) < 1e-6
    assert abs(by_idx[2] - 2.0) < 1e-6
    assert abs(by_idx[3] - 25.0) < 1e-6
    assert abs(by_idx[4] - 25.0) < 1e-6


def test_dot_product_correctness():
    store = VecStore(3)
    store.add_vector([2.0, 3.0, 1.0])  # 14
    store.add_vector([1.0, 0.0, 0.0])  # 2
    store.add_vector([0.0, 1.0, 0.0])  # 3
    store.add_vector([0.0, 0.0, 1.0])  # 1
    store.add_vector([-1.0, 0.0, 0.0])  # -2
    store.add_vector([1.0, 1.0, 1.0])  # 6
    results = store.query([2.0, 3.0, 1.0], Metric.DotProduct).take(6).collect()
    by_idx = {r.index: r.score for r in results}
    expected = {0: 14.0, 1: 2.0, 2: 3.0, 3: 1.0, 4: -2.0, 5: 6.0}
    assert set(by_idx) == set(expected)
    for i, v in expected.items():
        assert abs(by_idx[i] - v) < 1e-6
    scores = [r.score for r in results]
    assert scores == sorted(scores, reverse=True)


def test_top_k_ranking_correctness():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.8, 0.6])
    store.add_vector([0.6, 0.8])
    store.add_vector([0.0, 1.0])
    results = store.query([1.0, 0.0], Metric.Cosine).take(4).collect()
    sims = [r.score for r in results]
    assert abs(sims[0] - 1.0) < 1e-6
    assert abs(sims[1] - 0.8) < 1e-6
    assert abs(sims[2] - 0.6) < 1e-6
    assert abs(sims[3]) < 1e-6
    assert sims == sorted(sims, reverse=True)


def test_euclidean_ranking_correctness():
    store = VecStore(2)
    store.add_vector([0.0, 0.0])
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    store.add_vector([1.0, 1.0])
    store.add_vector([2.0, 0.0])
    store.add_vector([3.0, 4.0])
    results = store.query([0.0, 0.0], Metric.Euclidean).take_min(6).collect()
    d = [r.score for r in results]
    assert abs(d[0]) < 1e-6
    assert abs(d[1] - 1.0) < 1e-6
    assert abs(d[2] - 1.0) < 1e-6
    assert abs(d[3] - 2.0) < 1e-6
    assert abs(d[4] - 4.0) < 1e-6
    assert abs(d[5] - 25.0) < 1e-6
    assert d == sorted(d)


def test_filter_threshold_correctness():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.8, 0.6])
    store.add_vector([0.6, 0.8])
    store.add_vector([0.0, 1.0])
    store.add_vector([-0.6, 0.8])
    q = [1.0, 0.0]
    above_07 = store.query(q, Metric.Cosine).filter(0.7, Cmp.Gt).take(10).collect()
    assert all(r.score > 0.7 for r in above_07)
    assert len(above_07) == 2
    above_eq_06 = (
        store.query(q, Metric.Cosine).filter(0.6, Cmp.Gte).take(10).collect()
    )
    assert all(r.score >= 0.6 for r in above_eq_06)
    below_05 = store.query(q, Metric.Cosine).filter(0.5, Cmp.Lt).take(10).collect()
    assert all(r.score < 0.5 for r in below_05)
    assert len(below_05) == 2


def test_batch_query_correctness():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.0, 1.0])
    store.add_vector([-1.0, 0.0])
    results = (
        store.query([[1.0, 0.0], [0.0, 1.0]], Metric.Cosine).take(2).collect()
    )
    ones = sum(1 for r in results if abs(r.score - 1.0) < 1e-6)
    assert ones == 2


# ---------------------------------------------------------------------------
# API design / plan-state tests
# ---------------------------------------------------------------------------


def test_api_design_showcase():
    store = VecStore(3)
    for i in range(100):
        store.add_vector([i / 100.0, (i * 2) / 100.0, (i * 3) / 100.0])
    results = (
        store.query([0.5, 0.5, 0.5], Metric.Cosine)
        .filter(0.8, Cmp.Gt)
        .take_min(10)
        .collect()
    )
    for r in results:
        assert r.score > 0.8


def test_error_in_chain_stops_execution():
    store = VecStore(3)
    plan = (
        store.query([1.0, 0.0], Metric.Cosine).filter(0.5, Cmp.Gt).take(10).take_min(5)
    )
    with pytest.raises(OttersError, match="does not match expected dimension 3"):
        plan.collect()


def test_vec_query_plan_new():
    with pytest.raises(
        OttersError, match="Query vectors or their norms are not set"
    ):
        VecQueryPlan().collect()


def test_error_propagation_in_take_methods():
    with pytest.raises(OttersError):
        VecQueryPlan().take(5).collect()
    with pytest.raises(OttersError):
        VecQueryPlan().take_min(5).collect()
    with pytest.raises(OttersError):
        VecQueryPlan().take_max(5).collect()


def test_filter_with_all_comparison_operators():
    store = VecStore(2)
    store.add_vectors([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.8, 0.6]])
    q = [1.0, 0.0]
    for thr, cmp in [(0.9, Cmp.Lt), (0.1, Cmp.Gt), (1.0, Cmp.Lte), (0.0, Cmp.Gte)]:
        results = store.query(q, Metric.Cosine).filter(thr, cmp).take(10).collect()
        assert results
    results = store.query(q, Metric.Cosine).filter(1.0, Cmp.Eq).take(10).collect()
    assert results


def test_add_vector_with_zero_norm():
    store = VecStore(3)
    store.add_vector([0.0, 0.0, 0.0])
    results = store.query([1.0, 0.0, 0.0], Metric.Cosine).take(1).collect()
    assert len(results) == 1
    assert results[0].score == 0.0  # zero-norm convention (vec.rs:365-367)


def test_query_with_zero_norm_query_vector():
    store = VecStore(3)
    store.add_vector([1.0, 0.0, 0.0])
    results = store.query([0.0, 0.0, 0.0], Metric.Cosine).take(1).collect()
    assert len(results) == 1


def test_row_mask():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([0.9, 0.1])
    store.add_vector([0.0, 1.0])
    mask = np.array([False, True, True])
    results = (
        store.query([1.0, 0.0], Metric.Cosine)
        .with_row_mask(mask)
        .take(3)
        .collect()
    )
    assert all(r.index != 0 for r in results)
    assert len(results) == 2


def test_filter_and_merge_with_no_filtering():
    store = VecStore(2)
    store.add_vectors([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
    results = store.query([1.0, 0.0], Metric.Cosine).take(2).collect()
    assert len(results) == 2


def test_dimension_mismatch_during_add_vectors():
    store = VecStore(3)
    with pytest.raises(
        OttersError,
        match="Input vector length 2 does not match expected dimension 3",
    ):
        store.add_vectors([[1.0, 0.0, 0.0], [1.0, 0.0]])


def test_take_closest_and_farthest_methods():
    store = VecStore(2)
    store.add_vectors([[1.0, 0.0], [0.0, 1.0], [0.9, 0.1]])
    q = [1.0, 0.0]
    assert len(store.query(q, Metric.Euclidean).take_min(2).collect()) == 2
    assert len(store.query(q, Metric.Euclidean).take_max(2).collect()) == 2
    queries = [q, [0.0, 1.0]]
    assert len(store.query(queries, Metric.Euclidean).take_min(1).collect()) == 1
    assert len(store.query(queries, Metric.Euclidean).take_max(1).collect()) == 1


def test_query_batch_conversions():
    store = VecStore(3)
    store.add_vector([1.0, 0.0, 0.0])
    assert len(store.query([1.0, 0.0, 0.0], Metric.Cosine).take(1).collect()) == 1
    results = (
        store.query([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], Metric.Cosine)
        .take(2)
        .collect()
    )
    assert len(results) <= 2


def test_numpy_query_inputs():
    store = VecStore(3)
    store.add_vectors(np.eye(3, dtype=np.float32))
    results = store.query(np.array([1.0, 0.0, 0.0]), Metric.Cosine).take(1).collect()
    assert results[0].index == 0
    batch = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=np.float32)
    assert len(store.query(batch, Metric.Cosine).take(2).collect()) == 2


def test_error_states_in_chained_operations():
    store = VecStore(3)
    store.add_vector([1.0, 0.0, 0.0])
    plan = (
        store.query([1.0, 0.0], Metric.Cosine)
        .filter(0.5, Cmp.Gt)
        .take(5)
        .take_min(2)
        .take_max(1)
    )
    with pytest.raises(OttersError, match="does not match expected dimension"):
        plan.collect()


def test_filtering_edge_cases():
    store = VecStore(2)
    store.add_vectors([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])
    q = [1.0, 0.0]
    results = store.query(q, Metric.Cosine).filter(1.5, Cmp.Gt).take(10).collect()
    assert results == []
    results = store.query(q, Metric.Cosine).filter(1.0, Cmp.Eq).take(10).collect()
    assert len(results) == 1


def test_nan_scores_dropped():
    store = VecStore(2)
    store.add_vector([1.0, 0.0])
    store.add_vector([float("nan"), 0.0])
    results = store.query([1.0, 0.0], Metric.DotProduct).take(2).collect()
    # NaN-score row is dropped (vec_compute.rs:237-239)
    assert [r.index for r in results] == [0]


def test_error_propagation_in_filter():
    """reference vec_store_tests.rs:999-1009: a filter on an uninitialized
    plan keeps the error state and collect() surfaces it."""
    with pytest.raises(OttersError):
        VecQueryPlan().filter(0.5, Cmp.Gt).collect()


def test_empty_query_vectors_in_batch():
    """reference vec_store_tests.rs:1022-1030: an empty batch errors with
    the reference's message."""
    store = VecStore(3)
    with pytest.raises(OttersError, match="No queries provided"):
        store.query([], Metric.Cosine).collect()


# ---------------------------------------------------------------------------
# The port's own surface
# ---------------------------------------------------------------------------


def test_unported_storage_and_persistence_raise():
    """Only persistence waits; bfloat16 storage is ported."""
    store = tx.VecStore(3, "bfloat16", device="cpu")
    store.add_vectors(np.eye(3, dtype=np.float32))
    assert store.device().vectors.dtype == torch.bfloat16
    assert [r.index for r in store.query([0.0, 1.0, 0.0], Metric.Cosine).take(1).collect()] == [1]
    with pytest.raises(OttersError, match="unsupported storage dtype"):
        tx.VecStore(3, "float16")
    store = VecStore(3)
    with pytest.raises(NotImplementedError, match="io.py"):
        store.save("x")
    with pytest.raises(NotImplementedError, match="io.py"):
        tx.VecStore.load("x")


def test_without_a_device_named_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tx.VecStore(2)
    store.add_vectors([[1.0, 0.0], [0.0, 1.0]])
    with pytest.raises(OttersError, match="device='cpu'"):
        store.query([1.0, 0.0], Metric.Cosine).take(1).collect()
    store = tx.VecStore(2, device="cpu")
    store.add_vectors([[1.0, 0.0], [0.0, 1.0]])
    res = store.query([1.0, 0.0], Metric.Cosine).take(1).collect()
    assert [r.index for r in res] == [0]


# ---------------------------------------------------------------------------
# Fused-size parity with the JAX package
# ---------------------------------------------------------------------------


def _twin_vecstores(rows, dtype="float32"):
    sj = jx.VecStore(rows.shape[1], dtype)
    sj.add_vectors(rows)
    st = vec_store_from_numpy(sj._host_matrix(), rows.shape[1], dtype, device="cpu")
    return sj, st


def _same(rj, rt, atol=1e-6):
    assert [r.index for r in rt] == [r.index for r in rj]
    np.testing.assert_allclose([r.score for r in rt], [r.score for r in rj],
                               rtol=1e-6, atol=atol)


FUSED_VEC_CASES = [
    ("float32", "Cosine", None, None, 10),
    ("float32", "DotProduct", 2.0, "Gt", 25),
    ("float32", "Euclidean", None, None, 7),
    ("float32", "Cosine", 0.2, "Eq", 10),
    ("float32", "Cosine", None, None, 200),
    ("int8", "Cosine", 0.1, "Gte", 10),
    ("bfloat16", "Cosine", None, None, 10),
    ("bfloat16", "DotProduct", 2.0, "Gt", 25),
    ("bfloat16", "Euclidean", 40.0, "Lt", 7),
    ("bfloat16", "Cosine", None, None, 200),
]


@pytest.mark.parametrize("dtype,metric,thr,cmp,k", FUSED_VEC_CASES)
def test_fused_size_vecstore_matches_jax(monkeypatch, dtype, metric, thr, cmp, k):
    use_fused_path(monkeypatch)
    from otters_tpu_torch.ops import fused_topk as ft

    rng = np.random.default_rng(41)
    rows = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    sj, st = _twin_vecstores(rows, dtype)
    calls = []
    monkeypatch.setattr(ft, "binmax_plain",
                        lambda *a, _f=ft.binmax_plain, **kw: calls.append(a[0]) or _f(*a, **kw))

    def run(store, pkg):
        plan = store.query(q, getattr(pkg.Metric, metric))
        if thr is not None:
            plan = plan.filter(thr, getattr(pkg.Cmp, cmp))
        return plan.take(k).collect()

    rj, rt = run(sj, jx), run(st, tx)
    want_mode = "K2" if dtype == "int8" else ("K4" if k <= 128 and cmp != "Eq" else "K3")
    assert calls == [want_mode + ("-bf16" if dtype == "bfloat16" else "")]
    # Euclid's q^2 + v^2 - 2 q.v cancels: ulps of q^2 + v^2 (~64 here)
    _same(rj, rt, atol=2e-5 if metric == "Euclidean" else 1e-6)
    if cmp != "Eq":
        assert len(rt) == k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_failed_check_reruns_strictly_like_jax(monkeypatch, dtype):
    """Exact ties across more than 4k bins: the fast check fails and both
    packages re-run strictly, with the same results (f32 and bf16 rows)."""
    use_fused_path(monkeypatch)
    from otters_tpu_torch.ops import fused_topk as ft

    k = 4
    rng = np.random.default_rng(43)
    rows = rng.normal(size=(16000, 32)).astype(np.float32)
    q = rng.normal(size=(1, 32)).astype(np.float32)
    rows[: k - 1] = q + 0.1 * rng.normal(size=(k - 1, 32))
    rows[np.arange(4 * k + 2) * ft.BIN + 9] = q[0] + 0.4 * rng.normal(size=32)
    sj, st = _twin_vecstores(rows, dtype)
    calls = []
    monkeypatch.setattr(ft, "binmax_plain",
                        lambda *a, _f=ft.binmax_plain, **kw: calls.append(a[0]) or _f(*a, **kw))
    rj = sj.query(q, jx.Metric.Cosine).take(k).collect()
    rt = st.query(q, tx.Metric.Cosine).take(k).collect()
    sfx = "-bf16" if dtype == "bfloat16" else ""
    assert calls == ["K4" + sfx, "K3" + sfx]
    _same(rj, rt)
    assert len(rt) == k and rt[-1].index == 9  # the lowest tied copy


@pytest.mark.parametrize("metric", ["Cosine", "DotProduct", "Euclidean"])
def test_small_bf16_vecstore_matches_jax(metric):
    """A small bf16 store takes the direct program in both packages: the
    exact top-k of the stored values."""
    rng = np.random.default_rng(47)
    rows = rng.normal(size=(3000, 24)).astype(np.float32)
    q = rng.normal(size=(2, 24)).astype(np.float32)
    sj, st = _twin_vecstores(rows, "bfloat16")
    rj = sj.query(q, getattr(jx.Metric, metric)).take(9).collect()
    rt = st.query(q, getattr(tx.Metric, metric)).take(9).collect()
    _same(rj, rt, atol=2e-5 if metric == "Euclidean" else 1e-6)
    assert len(rt) == 9
