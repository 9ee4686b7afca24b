"""The comparison that decides ``correct``.

Every request of the window is held against the reference's answer for its
pool entry. Numbers, each with its limit:

- ``worst_gap``: over every rank of every answer, the larger of how far the
  answer's reported score lies from the reference's score at that rank and
  how far the true score of the row it returned there lies below the
  reference's. Scores are compared as keys where higher is better
  (``reference.key``: a take-min metric's distances negated), so the gap
  means the same for every metric. Its limit is the configuration's
  (``limits``), set from the program's readings and the TF32 control's.
- ``short_answers``: answers with fewer results than the reference finds
  (limit 0).
- ``filter_violations``: returned rows that the filter drops, or that are no
  row of the store (limit 0).
- ``uncertified``: where the configuration states the certificate, answers
  whose certificate did not pass (limit 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from . import reference


@dataclass
class Answer:
    pool: int
    indices: List[int]
    scores: List[float]
    certified: Optional[bool] = True


@dataclass
class Verdict:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    failed: int  # answers that break a limit

    @property
    def correct(self) -> bool:
        return all(self.numbers[name] <= self.limits[name] for name in self.numbers)

    def checks(self) -> Dict[str, Dict[str, float]]:
        return {name: {"value": self.numbers[name], "limit": self.limits[name]}
                for name in self.numbers}


def _gap(ref_keys: List[float], got_keys: List[float], true_keys: List[float]) -> float:
    gap = 0.0
    for r in range(min(len(ref_keys), len(got_keys))):
        gap = max(gap, abs(got_keys[r] - ref_keys[r]), ref_keys[r] - true_keys[r])
    return gap


def judge(answers: List[Answer], ref: reference.TopK, rows, queries, keep: np.ndarray,
          gap_limit: float, certified: bool, metric: str = "cosine") -> Verdict:
    """``queries``: [pool, batch, d], the pool entry of each answer's group;
    ``rows``: the store's rows, a tensor or a row source (``data.py``)."""
    n = len(keep)
    numbers = {"worst_gap": 0.0, "short_answers": 0, "filter_violations": 0}
    if certified:
        numbers["uncertified"] = 0
    failed = 0
    seen: Dict[tuple, tuple] = {}
    for a in answers:
        key = (a.pool, tuple(a.indices), tuple(a.scores))
        if key not in seen:
            inside = [i for i in a.indices if 0 <= i < n]
            bad = len(a.indices) - len(inside) + int(np.count_nonzero(~keep[inside]))
            got = sorted(reference.key(list(a.scores), metric), reverse=True)
            true = reference.best_of_rows(rows, queries[a.pool], inside, metric)
            true += [float("-inf")] * (len(got) - len(true))
            seen[key] = (_gap(ref.keys[a.pool], got, true), bad,
                         len(a.indices) < len(ref.rows[a.pool]))
        gap, bad, short = seen[key]
        uncert = certified and a.certified is not True
        numbers["worst_gap"] = max(numbers["worst_gap"], gap)
        numbers["short_answers"] += int(short)
        numbers["filter_violations"] += bad
        if certified:
            numbers["uncertified"] += int(uncert)
        failed += int(gap > gap_limit or bad > 0 or short or uncert)
    limits = {name: 0 for name in numbers}
    limits["worst_gap"] = gap_limit
    return Verdict(numbers=numbers, limits=limits, failed=failed)
