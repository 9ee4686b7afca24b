"""``correct`` comes out false when the timed path is broken underneath, and
the TF32 control fails the limit that the program meets.

Each fault is planted in the program for one run on the CPU at a small size
(the harness's look for a chip skipped): an answer altered where the
results are made, half of each batch's queries left out, and the previous
request's answer handed back (a step that returns its state unchanged).
One chip holds each cell, so no exchange between chips can be left out.
"""

import time

import numpy as np
import pytest
import torch

import otters_tpu_torch as tx
from otters_tpu_torch import meta

from benchmark import control, harness, spec

SMALL = {"rows": 30_000, "dim": 64, "batch": 32}


def run(name, **extra):
    cell = spec.cell(name)
    sizes = dict(SMALL, batch=min(SMALL["batch"], int(cell.mix["batch"])), **extra)
    return harness.run_cell(cell, 2**36 + 9, 0.4, False, "cpu", time.perf_counter(),
                            overrides=sizes)


def altered_answer(monkeypatch):
    init = meta.MetaQueryResults.__init__

    def wrong(self, columns, data, indices, scores):
        indices = list(indices)
        if indices:
            indices[-1] = (indices[-1] + 1) % 30_000
        init(self, columns, data, indices, scores)

    monkeypatch.setattr(meta.MetaQueryResults, "__init__", wrong)


def half_batch(monkeypatch):
    query_batch = meta.MetaStore.query_batch

    def half(self, queries, metric):
        return query_batch(self, queries[: max(1, queries.shape[0] // 2)], metric)

    monkeypatch.setattr(meta.MetaStore, "query_batch", half)


def stale_resolve(monkeypatch):
    resolve, last = tx.resolve, []

    def stale(pendings):
        fresh = resolve(pendings)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    monkeypatch.setattr(tx, "resolve", stale)


def stale_result(monkeypatch):
    result, last = meta.PendingMetaQuery.result, []

    def stale(self):
        fresh = result(self)
        out = last[0] if last else fresh
        last[:] = [fresh]
        return out

    monkeypatch.setattr(meta.PendingMetaQuery, "result", stale)


@pytest.mark.parametrize("name,fault", [
    ("cohere10m.f1p", altered_answer),
    ("cohere10m.f1p.serial", altered_answer),
    ("cohere10m.f1p", half_batch),
    ("cohere10m.f1p", stale_resolve),
    ("cohere10m.f1p.serial", stale_result),
])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(name)
    assert out["correct"] is False and out["failed"] > 0
    assert out["checks"]["worst_gap"]["value"] > out["checks"]["worst_gap"]["limit"] or (
        out["checks"]["filter_violations"]["value"] > 0)


@pytest.mark.parametrize("name", ["cohere10m.f1p", "openai5m.f1p", "cohere10m.f1p.serial"])
def test_the_tf32_control_fails_where_the_program_passes(name):
    cell = spec.cell(name)
    sizes = {"rows": 20_000, "dim": int(cell.config["dim"]),
             "batch": min(32, int(cell.mix["batch"])), "pool": 8}
    limit = float(cell.config["limits"]["worst_gap"])
    for seed in (1, 2, 3):
        verdict = control.control_verdict(cell, seed, "cpu", overrides=sizes)
        assert not verdict.correct
        assert verdict.numbers["worst_gap"] > limit
        assert verdict.numbers["filter_violations"] == 0
    program = harness.run_cell(cell, 1, 0.3, False, "cpu", time.perf_counter(),
                               overrides=sizes)
    assert program["correct"] is True
    assert program["checks"]["worst_gap"]["value"] < limit / 3


def test_a_missing_answer_counts_short():
    from benchmark import judge, reference

    rows = torch.randn((64, 8), generator=torch.Generator().manual_seed(2))
    queries = rows[:2].reshape(2, 1, 8).clone()
    keep = np.ones(64, bool)
    ref = reference.topk(rows, keep, queries, 5)
    answers = [judge.Answer(0, ref.rows[0][:4], ref.keys[0][:4]),
               judge.Answer(1, ref.rows[1], ref.keys[1], certified=False)]
    v = judge.judge(answers, ref, rows, queries, keep, 1e-6, certified=True)
    assert v.numbers["short_answers"] == 1 and v.numbers["uncertified"] == 1
    assert v.failed == 2 and not v.correct
