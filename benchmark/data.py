"""A cell's inputs, made from ``--seed``: the rows, the columns and the pool
of query batches that the traffic cycles through.

The configuration names how each is made: ``inputs`` the file
``inputs/<name>.py`` whose ``make`` gives the rows and draws the queries on
the device from one ``torch.Generator``, and each column's ``values`` the
file ``columns/<values>.py`` whose ``make`` gives its values. The same seed
gives the same inputs. Both the program and the reference are handed these.

The rows are either one ``[n, d]`` float32 tensor on the device
(``inputs/gaussian.py``) or a source that makes them on demand: an object
with ``n``, ``d``, ``slab(start, count, device)`` and ``take(ids, device)``,
each giving float32 rows on the device named (``inputs/gaussian_by_id.py``).
Where the rows are such a source, no tensor of them all exists: the build,
the rerank source and the reference remake the rows they need.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from . import spec


@dataclass
class Inputs:
    rows: Any  # [n, d] float32 tensor, or a source that makes rows by id
    n: int
    columns: Dict[str, np.ndarray]  # name -> [n] values
    queries: torch.Tensor  # [pool, batch, d] float32


def make(config: dict, n: int, d: int, pool: int, batch: int, seed: int, device) -> Inputs:
    """``n`` rows of depth ``d``, their columns and ``pool`` batches of
    ``batch`` queries, as the configuration states."""
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**64)  # seeds pass 32 bits
    rows, queries = spec.part("inputs", config["inputs"]).make(n, d, pool, batch, g, device)
    columns = {c["name"]: spec.part("columns", c["values"]).make(n, seed)
               for c in config["columns"]}
    return Inputs(rows=rows, n=n, columns=columns, queries=queries)
