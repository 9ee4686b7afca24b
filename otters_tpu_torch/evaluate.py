"""Exact re-ranking and recall.

``exact_rerank`` is the exact-f32 step of ``take(k, rerank_from=...)``: the
quantized scan hands over a widened candidate set, and the final top-k is
re-scored against the true f32 rows (the reference's exactness contract,
vec_compute.rs:77-294, over int8 storage). The VPU metrics rerank here
too, one pending at a time, as in the JAX package. ``recall_at_k`` and
``mean_recall_at_k`` measure an approximate answer against an exact one.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def exact_rerank(
    queries,
    cand_indices: Sequence[int],
    fetch_vectors: Callable,
    metric,
    k: int,
    take_min=None,
):
    """Re-rank a candidate set with exact f32 scores.

    ``fetch_vectors(indices) -> [m, d] f32`` (numpy or a torch tensor)
    supplies the true rows; the scores are computed on the device of
    ``queries`` when it is a tensor, with the JAX package's formulas:
    Cosine, Dot and squared Euclid in full f32, and the VPU metrics
    elementwise in f32 (Manhattan sum |q - v|, Hamming the count of unequal
    components, Jaccard sum min / sum max, 0 where both rows are all zero). Batch queries merge into ONE global
    top-k (vec.rs:217-219), ties toward the lower (query, candidate) flat
    index like ``lax.top_k``. Returns (indices[k], scores[k]) in take order.

    >>> q = np.array([[1.0, 0.0]], np.float32)
    >>> rows = np.array([[0.0, 1.0], [1.0, 0.1], [1.0, 0.0]], np.float32)
    >>> from otters_tpu_torch import Metric
    >>> exact_rerank(q, [0, 1, 2], lambda ids: rows[ids], Metric.Cosine, 2)[0]
    [2, 1]
    """
    from .meta import _rerank_scores
    from .ops.scoring import _stable_topk
    from .types import TakeType, default_take_type

    if take_min is None:
        take_min = default_take_type(metric) is TakeType.Min
    cand = np.asarray(list(dict.fromkeys(int(i) for i in cand_indices)), dtype=np.int64)
    if cand.size == 0:
        return [], []
    q = torch.as_tensor(queries, dtype=torch.float32)
    if q.ndim == 1:
        q = q[None, :]
    v = torch.as_tensor(fetch_vectors(cand), dtype=torch.float32).to(q.device)
    flat = _rerank_scores(q, v, metric).reshape(-1)
    _, order = _stable_topk(-flat if take_min else flat, min(k, flat.shape[0]))
    order = order.cpu().numpy()
    rows = cand[order % len(cand)]
    return rows.tolist(), flat.cpu().numpy()[order].tolist()


def recall_at_k(exact_indices: Sequence[int], approx_indices: Sequence[int]) -> float:
    """|approx ∩ exact| / |exact| for one query's top-k lists.

    >>> recall_at_k([1, 2, 3, 4], [4, 2, 9, 1])
    0.75
    >>> recall_at_k([], [])
    1.0
    """
    if not exact_indices:
        return 1.0
    exact = set(exact_indices)
    return len(exact & set(approx_indices)) / len(exact)


def mean_recall_at_k(exact_lists, approx_lists) -> float:
    """Average recall over many queries' top-k lists."""
    pairs = list(zip(exact_lists, approx_lists, strict=True))
    if not pairs:
        return 1.0
    return sum(recall_at_k(e, a) for e, a in pairs) / len(pairs)
