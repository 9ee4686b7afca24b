"""Device-side predicate evaluation: chunk masks and row masks.

Replaces the reference's pruning kernels:
- chunk-mask-over-zonemaps loops (``type_utils.rs:446-584,739-889`` +
  orchestration ``meta.rs:405-544``) become one vectorized pass over
  ``[n_chunks]`` zonemap tensors on the device;
- row-mask loops (``type_utils.rs:306-444,587-736`` +
  ``meta_compute.rs:194-318``) become elementwise predicates over ``[N_pad]``
  column tensors, consumed by the scoring program as a row mask.

Semantics mirror the reference (and the JAX package) exactly:
- chunk rules: Eq -> min<=t<=max, Lt -> min<t, Lte -> min<=t, Gt -> max>t,
  Gte -> max>=t, Neq -> keep; a chunk with zero non-null values never
  survives (type_utils.rs:446-584);
- string chunks: Eq -> Bloom "maybe contains", Neq -> keep (meta.rs:523-544);
- row rules: value cmp threshold with null rows always excluded; string rows
  compare by 64-bit identity hash (Eq verified host-side afterwards); NaN
  values follow IEEE (only Neq is true).

A compiled plan is an AND of OR-clauses; leaves carry a static descriptor
``(repr, column, cmp)`` where repr in {'i32', 'f32', 'i64', 'f64', 'str',
'null', 'nanthr', 'hostmask'} selects the compare, and a parameter tuple of
device tensors (thresholds / hash + Bloom probe coordinates / the host-made
masks of an extended string predicate).
"""

from __future__ import annotations

import torch

from ..types import CmpOp
from . import bloom as bloom_ops

# Leaf params:
#   'i32' / 'f32' / 'i64' / 'f64' : (thr,)
#   'str'                         : (rh, bloom_words, bloom_masks)
#   'null'                        : (chunk_lens[n_chunks],)
#   'nanthr'                      : ()
#   'hostmask'                    : (row_mask[n_pad], chunk_any[n_chunks])


def _cmp(v, thr, cmp: CmpOp):
    if cmp is CmpOp.Eq:
        return v == thr
    if cmp is CmpOp.Neq:
        return v != thr
    if cmp is CmpOp.Lt:
        return v < thr
    if cmp is CmpOp.Lte:
        return v <= thr
    if cmp is CmpOp.Gt:
        return v > thr
    return v >= thr


def _leaf_row_mask(leaf, params, cols):
    rep, name, cmp = leaf
    if rep == "hostmask":
        # an extended string predicate, evaluated on the host: no column
        # tensor is read
        return params[0]
    c = cols[name]
    not_null = ~c["null"]
    if rep == "null":
        # is_null / is_not_null: the only predicates that can select nulls.
        # Padding rows read as null but the scoring core's validity mask
        # excludes them regardless.
        return c["null"] if cmp is CmpOp.IsNull else not_null
    if rep in ("i32", "f32", "i64", "f64"):
        (thr,) = params
        return _cmp(c["vals"], thr, cmp) & not_null
    if rep == "nanthr":
        # predicate against a NaN literal: IEEE-false for all ops except Neq
        if cmp is CmpOp.Neq:
            return not_null
        return torch.zeros_like(not_null)
    # string: identity-hash compare
    rh, _, _ = params
    eq = c["rh"] == rh
    if cmp is CmpOp.Eq:
        return eq & not_null
    if cmp is CmpOp.Neq:
        return (~eq) & not_null
    # other comparators are rejected at compile time (UnsupportedStringOp);
    # reference row kernels treat them as never-satisfied (meta_compute.rs:308-312)
    return torch.zeros_like(not_null)


def _leaf_chunk_mask(leaf, params, cols):
    rep, name, cmp = leaf
    if rep == "hostmask":
        return params[1]  # the exact per-chunk any(), made on the host
    c = cols[name]
    has_values = c["non_null"] > 0
    if rep == "null":
        # params = (chunk_lens,): a chunk with no null rows is pruned for
        # is_null; one with no values is pruned for is_not_null.
        if cmp is CmpOp.IsNull:
            (clens,) = params
            return clens > c["non_null"]
        return has_values
    if rep == "nanthr":
        if cmp is CmpOp.Neq:
            return has_values
        return torch.zeros_like(has_values)
    if rep == "str":
        if cmp is CmpOp.Eq:
            _, words, masks = params
            return bloom_ops.probe(c["bloom"], words, masks) & has_values
        return has_values  # Neq conservatively keeps non-empty chunks
    (thr,) = params
    zmin, zmax = c["zmin"], c["zmax"]
    if cmp is CmpOp.Eq:
        ok = (zmin <= thr) & (zmax >= thr)
    elif cmp is CmpOp.Lt:
        ok = zmin < thr
    elif cmp is CmpOp.Lte:
        ok = zmin <= thr
    elif cmp is CmpOp.Gt:
        ok = zmax > thr
    elif cmp is CmpOp.Gte:
        ok = zmax >= thr
    else:  # Neq keeps every non-empty chunk
        return has_values
    return ok & has_values


def _fold_plan(plan_static, plan_params, cols, leaf_fn, ones):
    """AND over clauses of (OR over leaves). Empty plan keeps everything."""
    acc = ones
    for clause, clause_params in zip(plan_static, plan_params):
        clause_mask = None
        for leaf, params in zip(clause, clause_params):
            m = leaf_fn(leaf, params, cols)
            clause_mask = m if clause_mask is None else (clause_mask | m)
        if clause_mask is not None:
            acc = acc & clause_mask
    return acc


def row_mask(plan_static, plan_params, cols, n_pad: int, device):
    ones = torch.ones((n_pad,), dtype=torch.bool, device=device)
    return _fold_plan(plan_static, plan_params, cols, _leaf_row_mask, ones)


def chunk_mask(plan_static, plan_params, cols, n_chunks: int, device):
    ones = torch.ones((n_chunks,), dtype=torch.bool, device=device)
    return _fold_plan(plan_static, plan_params, cols, _leaf_chunk_mask, ones)
