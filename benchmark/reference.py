"""The plain reference: exact filtered top-k in float32, TF32 off, by the
configuration's metric.

It evaluates the filter itself from the column's values, scores every
(query, row) pair of a group of queries in blocks of rows, and keeps the
group's best ``k`` pairs: a batch of queries answers with one top-k over all
its pairs, as a store's ``query_batch`` does. It is handed only the rows and
queries that the benchmark made, and imports nothing of the program.

The rows are a ``[n, d]`` float32 tensor, or a source that makes them by id
(``slab(start, count, device)``, ``take(ids, device)``; see ``data.py``).
Given several devices, the row range is split into as many contiguous
parts, and each device makes and scores its part's blocks; the parts' best
pairs meet on the first device.

Metrics (``METRICS``): ``cosine`` (the products of the normalised query and
row), ``dot`` (the products) and ``l2`` (the squared Euclidean distance,
where less is better). Every answer is held as a key where higher is better
(``key``): the score, or the negated distance for a take-min metric.

Squared L2 is computed as ``||q||^2 + ||v||^2 - 2 q.v``: the two sums of
squares and one f32 product. With u = 2^-24 and g(n) = n u / (1 - n u), each
of the three terms is within g(d) of its size (the product's of
``||q|| ||v||``) and the two additions round once each, so the computed
distance lies within g(d + 2) (||q|| + ||v||)^2 of the exact one: at d = 768
and Gaussian rows about 0.14 at worst against distances near 1,536, and in
practice some 1e-4. A sum of squared differences would hold a
``[queries, rows, d]`` block and cost d times the memory traffic of the
product.

``tf32=True`` is the control: the same computation with both operands
rounded to TF32 (10 mantissa bits) before an f32-accumulated product, which
is what a TF32 tensor core does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

BLOCK_ELEMENTS = 1 << 27  # scores held at once: 512 MB of float32
OPS = {"gte": np.greater_equal}  # the filters the cells use
METRICS = ("cosine", "dot", "l2")
TAKE_MIN = ("l2",)  # metrics where the least score is the best


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def keep_mask(values: np.ndarray, op: str, value: int) -> np.ndarray:
    """The rows the filter ``<column> <op> value`` keeps."""
    return OPS[op](values, value)


def key(scores, metric: str = "cosine"):
    """Scores as keys where higher is better (a tensor, or a list of floats)."""
    if metric not in TAKE_MIN:
        return scores
    if isinstance(scores, torch.Tensor):
        return -scores
    return [-s for s in scores]


def _normalized(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def pair_scores(q: torch.Tensor, v: torch.Tensor, tf32: bool = False,
                metric: str = "cosine") -> torch.Tensor:
    """[b, d] x [m, d] -> [b, m] scores of ``metric``."""
    if metric == "cosine":
        q, v = _normalized(q), _normalized(v)
    else:
        q, v = q.float(), v.float()
    if tf32:
        q, v = round_tf32(q), round_tf32(v)
    if metric != "l2":
        return q @ v.T
    return (q * q).sum(-1)[:, None] + (v * v).sum(-1)[None, :] - 2.0 * (q @ v.T)


def _slab(rows, start: int, end: int, device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows[start:end].to(device)
    return rows.slab(start, end - start, device)


def _take(rows, ids: List[int], device) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows[torch.as_tensor(ids, device=rows.device)]
    return rows.take(ids, device)


@dataclass
class TopK:
    rows: List[List[int]]  # per group, best first
    keys: List[List[float]]  # higher is better (``key``)


def _check(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"the reference scores {', '.join(METRICS)}, not {metric}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the reference runs with TF32 off")


def topk(rows, keep: np.ndarray, queries: torch.Tensor, k: int, metric: str = "cosine",
         tf32: bool = False, devices: Sequence = ()) -> TopK:
    """The best ``k`` (query, row) pairs of each group over the kept rows.

    rows: [n_rows, d] or a row source (only the first ``len(keep)`` rows are
    the store's); keep: [n] bool; queries: [groups, group_size, d];
    devices: where to score (default: the queries' device)."""
    _check(metric)
    groups, gsize, _ = queries.shape
    n = len(keep)
    kept_at = np.flatnonzero(keep)
    if len(kept_at) == 0:
        return TopK([[] for _ in range(groups)], [[] for _ in range(groups)])
    devices = [torch.device(d) for d in devices] or [queries.device]
    lead = devices[0]
    q_all = queries.reshape(groups * gsize, -1)
    block = max(1, BLOCK_ELEMENTS // q_all.shape[0])
    part = -(-n // len(devices))
    state, work = [], []
    for j, dev in enumerate(devices):
        lo, hi = j * part, min(n, (j + 1) * part)
        kept = kept_at[(kept_at >= lo) & (kept_at < hi)]
        state.append([q_all.to(dev), torch.as_tensor(keep, device=dev),
                      torch.full((groups, k), float("-inf"), device=dev),
                      torch.full((groups, k), -1, dtype=torch.int64, device=dev)])
        # skip blocks with no kept row (a narrow filter scores only its rows)
        if len(kept):
            first = lo + (int(kept[0]) - lo) // block * block
            work.append([(j, s, min(hi, s + block))
                         for s in range(first, int(kept[-1]) + 1, block)])
    # the devices' blocks in turns, so that the devices work at once
    for j, s, e in (b for turn in _interleave(work) for b in turn):
        q, keep_t, best_v, best_r = state[j]
        sc = key(pair_scores(q, _slab(rows, s, e, devices[j]), tf32, metric), metric)
        sc = torch.where(keep_t[s:e][None, :], sc, float("-inf"))
        flat = sc.reshape(groups, gsize * (e - s))
        kk = min(k, flat.shape[1])
        v, i = torch.topk(flat, kk, dim=1)
        r = i % (e - s) + s
        cat_v, cat_r = torch.cat([best_v, v], 1), torch.cat([best_r, r], 1)
        top_v, top_i = torch.topk(cat_v, k, dim=1)
        state[j][2], state[j][3] = top_v, torch.gather(cat_r, 1, top_i)
    if len(devices) == 1:
        best_v, best_r = state[0][2], state[0][3]
    else:
        cat_v = torch.cat([st[2].to(lead) for st in state], 1)
        cat_r = torch.cat([st[3].to(lead) for st in state], 1)
        best_v, top_i = torch.topk(cat_v, k, dim=1)
        best_r = torch.gather(cat_r, 1, top_i)
    out_r, out_v = best_r.cpu().tolist(), best_v.cpu().tolist()
    rows_l, keys_l = [], []
    for rr, vv in zip(out_r, out_v):
        pairs = [(r, s) for r, s in zip(rr, vv) if r >= 0 and s != float("-inf")]
        rows_l.append([r for r, _ in pairs])
        keys_l.append([s for _, s in pairs])
    return TopK(rows_l, keys_l)


def _interleave(work):
    """[[a0, a1, ...], [b0, ...]] -> [(a0, b0), (a1, b1), ...], ragged."""
    longest = max((len(w) for w in work), default=0)
    return [[w[i] for w in work if i < len(w)] for i in range(longest)]


def best_of_rows(rows, queries: torch.Tensor, answer: List[int],
                 metric: str = "cosine") -> List[float]:
    """The true keys of an answer's rows for one group of queries ([g, d]):
    a row named m times takes its m best pairs. -> sorted, best first."""
    if not answer:
        return []
    uniq = sorted(set(answer))
    sc = key(pair_scores(queries, _take(rows, uniq, queries.device), metric=metric), metric)
    out = []
    for j, r in enumerate(uniq):
        m = answer.count(r)
        out.extend(torch.topk(sc[:, j], min(m, sc.shape[0])).values.tolist())
        out.extend([float("-inf")] * (m - min(m, sc.shape[0])))
    return sorted(out, reverse=True)
