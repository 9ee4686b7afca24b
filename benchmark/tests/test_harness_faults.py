"""``correct`` comes out false when the timed path is broken underneath, and
the TF32 control fails the limit that the program meets.

Each fault is planted in the program for one run on the CPU at a small size
(the harness's look for a chip skipped): an answer altered where the
results are made, half of each batch's queries left out, and the previous
request's answer handed back (a step that returns its state unchanged).
One chip holds each cell, so no exchange between chips can be left out
(``test_harness_by_id.py`` leaves it out of a store over four shards).

For a take-min metric (squared L2) the comparison itself catches a wrong
row, a short answer and the order of the other direction (the farthest
pairs, as a take-max metric would take them).
"""

import time

import numpy as np
import pytest
import torch

import otters_tpu_torch as tx
from otters_tpu_torch import meta

from benchmark import control, harness, judge, reference, spec

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
    """Each request of a round gets the answer of the request before it (the
    first, the previous round's last): the window's first round repeats the
    warm-up's pool entries, so a whole previous round would go unseen in a
    window of one round."""
    resolve, last = tx.resolve, []

    def stale(pendings):
        fresh = list(resolve(pendings))
        out = (last or fresh[:1]) + fresh[:-1]
        last[:] = fresh[-1:]
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
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, one_thread):
    """A stale answer shows from the window's second request on (the first
    repeats the warm-up's pool entry): one thread keeps the short window
    long enough for several."""
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


def _l2_case():
    g = torch.Generator().manual_seed(5)
    rows = torch.randn((200, 16), generator=g)
    queries = torch.randn((2, 3, 16), generator=g)
    keep = np.arange(200) >= 20
    return rows, queries, keep, reference.topk(rows, keep, queries, 10, "l2")


def _l2_verdict(rows, queries, keep, ref, answers):
    return judge.judge([judge.Answer(p, r, s) for p, (r, s) in enumerate(answers)], ref, rows,
                       queries, keep, 1e-4, certified=True, metric="l2")


def test_take_min_faults_are_caught():
    rows, queries, keep, ref = _l2_case()
    # the program's answer: rows and their squared distances, nearest first
    sound = [(r, [-x for x in k]) for r, k in zip(ref.rows, ref.keys)]
    v = _l2_verdict(rows, queries, keep, ref, sound)
    assert v.correct and v.numbers["worst_gap"] == 0.0

    # a wrong row: the last one swapped for a kept row outside the answer
    d = reference.pair_scores(queries[0].reshape(-1, 16), rows, metric="l2").min(0).values
    other = next(i for i in torch.argsort(d).tolist() if keep[i] and i not in ref.rows[0])
    wrong = [(sound[0][0][:-1] + [other], sound[0][1][:-1] + [float(d[other])]), sound[1]]
    v = _l2_verdict(rows, queries, keep, ref, wrong)
    assert not v.correct and v.failed == 1 and v.numbers["worst_gap"] > 1e-4

    # a short answer
    short = [(sound[0][0][:-1], sound[0][1][:-1]), sound[1]]
    v = _l2_verdict(rows, queries, keep, ref, short)
    assert not v.correct and v.numbers["short_answers"] == 1

    # the order of the other direction: the ten farthest pairs, farthest first
    keys = reference.key(reference.pair_scores(queries[0], rows, metric="l2"), "l2")
    flat = torch.where(torch.as_tensor(keep)[None, :], -keys, float("-inf")).reshape(-1)
    top = torch.topk(flat, 10).indices
    swapped = [((top % 200).tolist(), flat[top].tolist()), sound[1]]
    v = _l2_verdict(rows, queries, keep, ref, swapped)
    assert not v.correct and v.numbers["worst_gap"] > 10.0


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
