"""A cell's inputs, made from ``--seed``: the rows, the columns and the pool
of query batches that the traffic cycles through.

The configuration names how each is made: ``inputs`` the file
``inputs/<name>.py`` whose ``make`` draws the rows and queries on the device
from one ``torch.Generator``, and each column's ``values`` the file
``columns/<values>.py`` whose ``make`` gives its values. The same seed gives
the same inputs. Both the program and the reference are handed these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import spec


@dataclass
class Inputs:
    rows: torch.Tensor  # [n, d] float32
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
