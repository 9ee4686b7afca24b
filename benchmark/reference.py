"""The plain reference: exact filtered Cosine top-k in float32, TF32 off.

It evaluates the filter itself from the column's values, scores every
(query, row) pair of a group of queries in blocks of rows, and keeps the
group's best ``k`` pairs: a batch of queries answers with one top-k over all
its pairs, as a store's ``query_batch`` does. It is handed only the rows and
queries that the benchmark made, and imports nothing of the program.

``tf32=True`` is the control: the same computation with both operands
rounded to TF32 (10 mantissa bits) before an f32-accumulated product, which
is what a TF32 tensor core does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

BLOCK_ELEMENTS = 1 << 27  # scores held at once: 512 MB of float32
OPS = {"gte": np.greater_equal}  # the filters the cells use


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def keep_mask(values: np.ndarray, op: str, value: int) -> np.ndarray:
    """The rows the filter ``<column> <op> value`` keeps."""
    return OPS[op](values, value)


def _normalized(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def pair_scores(q: torch.Tensor, v: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[b, d] x [m, d] -> [b, m] Cosine scores."""
    qn, vn = _normalized(q), _normalized(v)
    if tf32:
        qn, vn = round_tf32(qn), round_tf32(vn)
    return qn @ vn.T


@dataclass
class TopK:
    rows: List[List[int]]  # per group, best first
    keys: List[List[float]]


def topk(rows: torch.Tensor, keep: np.ndarray, queries: torch.Tensor, k: int,
         metric: str = "cosine", tf32: bool = False) -> TopK:
    """The best ``k`` (query, row) pairs of each group over the kept rows.

    rows: [n_rows, d] (only the first ``len(keep)`` are the store's);
    keep: [n] bool; queries: [groups, group_size, d]."""
    if metric != "cosine":
        raise ValueError(f"the reference scores Cosine, not {metric}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the reference runs with TF32 off")
    groups, gsize, _ = queries.shape
    q = queries.reshape(groups * gsize, -1)
    n = len(keep)
    keep_t = torch.as_tensor(keep, device=rows.device)
    block = max(1, BLOCK_ELEMENTS // q.shape[0])
    best_v = torch.full((groups, k), float("-inf"), device=rows.device)
    best_r = torch.full((groups, k), -1, dtype=torch.int64, device=rows.device)
    # skip blocks with no kept row (a narrow filter scores only its rows)
    kept_at = np.flatnonzero(keep)
    if len(kept_at) == 0:
        return TopK([[] for _ in range(groups)], [[] for _ in range(groups)])
    for s in range(int(kept_at[0]) // block * block, int(kept_at[-1]) + 1, block):
        e = min(n, s + block)
        sc = pair_scores(q, rows[s:e], tf32)
        sc = torch.where(keep_t[s:e][None, :], sc, float("-inf"))
        flat = sc.reshape(groups, gsize * (e - s))
        kk = min(k, flat.shape[1])
        v, i = torch.topk(flat, kk, dim=1)
        r = i % (e - s) + s
        cat_v, cat_r = torch.cat([best_v, v], 1), torch.cat([best_r, r], 1)
        top_v, top_i = torch.topk(cat_v, k, dim=1)
        best_v, best_r = top_v, torch.gather(cat_r, 1, top_i)
    out_r, out_v = best_r.cpu().tolist(), best_v.cpu().tolist()
    rows_l, scores_l = [], []
    for rr, vv in zip(out_r, out_v):
        pairs = [(r, s) for r, s in zip(rr, vv) if r >= 0 and s != float("-inf")]
        rows_l.append([r for r, _ in pairs])
        scores_l.append([s for _, s in pairs])
    return TopK(rows_l, scores_l)


def best_of_rows(rows: torch.Tensor, queries: torch.Tensor, answer: List[int]) -> List[float]:
    """The true scores of an answer's rows for one group of queries ([g, d]):
    a row named m times takes its m best pairs. -> sorted, best first."""
    if not answer:
        return []
    uniq = sorted(set(answer))
    sc = pair_scores(queries, rows[torch.as_tensor(uniq, device=rows.device)])
    out = []
    for j, r in enumerate(uniq):
        m = answer.count(r)
        out.extend(torch.topk(sc[:, j], min(m, sc.shape[0])).values.tolist())
        out.extend([float("-inf")] * (m - min(m, sc.shape[0])))
    return sorted(out, reverse=True)
