"""The plain reference against a brute-force numpy top-k for each metric, on
one device or several and on rows made by id, and its TF32 control."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def brute(rows, keep, queries, k, metric="cosine"):
    """Every (query, row) pair of each group in float64, best k by ``metric``
    (keys where higher is better: a distance negated)."""
    out_rows, out_keys = [], []
    v = rows.astype(np.float64)
    if metric == "cosine":
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    for g in queries:
        q = g.astype(np.float64)
        if metric == "cosine":
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
        if metric == "l2":
            scores = -((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
        else:
            scores = q @ v.T
        keys = np.where(keep[None, :], scores, -np.inf).reshape(-1)
        order = np.argsort(-keys, kind="stable")[:k]
        order = [o for o in order if np.isfinite(keys[o])]
        out_rows.append([int(o % rows.shape[0]) for o in order])
        out_keys.append([float(keys[o]) for o in order])
    return out_rows, out_keys


@pytest.mark.parametrize("block", [64 * 16, 1 << 27])
@pytest.mark.parametrize("groups,gsize", [(3, 5), (7, 1)])
@pytest.mark.parametrize("share_out", [0.0, 0.4, 0.97])
def test_reference_matches_brute_force(block, groups, gsize, share_out, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", block)  # many blocks, or one
    g = torch.Generator().manual_seed(3)
    n, d, k = 300, 24, 10
    rows = torch.randn((n, d), generator=g)
    queries = torch.randn((groups, gsize, d), generator=g)
    ids = np.arange(n, dtype=np.int64)
    keep = reference.keep_mask(ids, "gte", int(round(share_out * n)))
    got = reference.topk(rows, keep, queries, k)
    want_rows, want_keys = brute(rows.numpy(), keep, queries.numpy(), k)
    for gr, gk, wr, wk in zip(got.rows, got.keys, want_rows, want_keys):
        assert len(gr) == len(wr) == min(k, int(keep.sum()) * gsize)
        np.testing.assert_allclose(gk, wk, atol=1e-5)
        assert sorted(gr) == sorted(wr)


@pytest.mark.parametrize("metric", ["l2", "dot"])
@pytest.mark.parametrize("share_out", [0.0, 0.4])
def test_reference_matches_brute_force_in_order(metric, share_out, monkeypatch):
    """Squared L2 (take-min: nearest first) and Dot, best first, in order."""
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 64 * 15)  # many blocks
    g = torch.Generator().manual_seed(7)
    n, d, k = 300, 24, 10
    rows = torch.randn((n, d), generator=g)
    queries = torch.randn((4, 3, d), generator=g)
    keep = reference.keep_mask(np.arange(n), "gte", int(round(share_out * n)))
    got = reference.topk(rows, keep, queries, k, metric)
    want_rows, want_keys = brute(rows.numpy(), keep, queries.numpy(), k, metric)
    for gr, gk, wr, wk in zip(got.rows, got.keys, want_rows, want_keys):
        assert gr == wr
        np.testing.assert_allclose(gk, wk, rtol=1e-5, atol=1e-4)
        assert gk == sorted(gk, reverse=True)
    if metric == "l2":  # the keys are the negated distances: nearest first
        assert all(x <= 0 for ks in got.keys for x in ks)


def test_reference_scores_cosine_alone():
    """The reference scores the metrics it names (Cosine, Dot, squared L2)
    and refuses any other."""
    for metric in ("euclidean", "manhattan"):
        with pytest.raises(ValueError, match="cosine, dot, l2"):
            reference.topk(torch.ones((4, 2)), np.ones(4, bool), torch.ones((1, 1, 2)), 2,
                           metric=metric)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_reference_on_several_devices_and_by_id_is_the_same(metric, monkeypatch):
    """The row range split over devices, and rows made by id in blocks, give
    the answers of one device over the whole tensor."""
    from benchmark import spec

    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", 6 * 37)
    source = spec.part("inputs", "gaussian_by_id").RowsById(2**40 + 3, 500, 16)
    rows = source.slab(0, 500, "cpu")
    queries = torch.randn((3, 2, 16), generator=torch.Generator().manual_seed(9))
    keep = reference.keep_mask(np.arange(500), "gte", 120)
    one = reference.topk(rows, keep, queries, 10, metric)
    for got in (reference.topk(rows, keep, queries, 10, metric, devices=["cpu"] * 3),
                reference.topk(source, keep, queries, 10, metric),
                reference.topk(source, keep, queries, 10, metric, devices=["cpu"] * 4)):
        assert got.rows == one.rows
        np.testing.assert_allclose(got.keys, one.keys, rtol=0, atol=1e-5)
    want = reference.best_of_rows(rows, queries[1], one.rows[1], metric)
    assert reference.best_of_rows(source, queries[1], one.rows[1], metric) == want


def test_reference_short_when_few_rows_pass():
    g = torch.Generator().manual_seed(4)
    rows, queries = torch.randn((50, 8), generator=g), torch.randn((2, 1, 8), generator=g)
    keep = reference.keep_mask(np.arange(50), "gte", 47)
    got = reference.topk(rows, keep, queries, 10)
    assert [sorted(r) for r in got.rows] == [[47, 48, 49]] * 2


def test_reference_refuses_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32 off"):
        reference.topk(torch.ones((4, 2)), np.ones(4, bool), torch.ones((1, 1, 2)), 2)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, -1.5 - 2.0**-12,
                      3.0e-30])
    got = reference.round_tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-9, -1.5]
    assert abs(got[5].item() - 3.0e-30) <= 3.0e-30 * 2.0**-11
    r = torch.randn(10_000, generator=torch.Generator().manual_seed(1))
    rel = ((reference.round_tf32(r) - r).abs() / r.abs()).max().item()
    assert 2.0**-13 < rel <= 2.0**-11


def test_best_of_rows_takes_a_rows_best_pairs():
    rows = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    queries = torch.tensor([[1.0, 0.0], [0.6, 0.8]])
    got = reference.best_of_rows(rows, queries, [0, 0, 1])
    np.testing.assert_allclose(got, [1.0, 0.8, 0.6], atol=1e-6)
    # squared L2, take-min: the nearest pairs, as negated distances
    got = reference.best_of_rows(rows, queries, [0, 0, 1], "l2")
    np.testing.assert_allclose(got, [0.0, -0.4, -0.8], atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    with open(os.path.join(ROOT, "benchmark", "reference.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names <= {"__future__", "dataclasses", "typing", "numpy", "torch"}, names
    code = ("import sys; import benchmark.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'otters_tpu_torch', 'otters_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
