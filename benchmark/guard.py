"""The import guard: no module of JAX or of the JAX package in the process.

Names are compared by their top-level part (before the first dot) whole, so
``otters_tpu_torch`` passes and ``otters_tpu.ops`` does not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "otters_tpu")


def offenders(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)
