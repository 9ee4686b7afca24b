"""Standalone distance functions (public API parity).

The reference re-exports its scalar kernels as library functions
(``src/vec.rs:7``, ``src/prelude.rs:13``): ``dot_product``,
``cosine_similarity``, ``euclidean_distance_squared``. These host helpers
keep that surface for small one-off computations; the batched device
versions used by queries live in ``otters_tpu_torch.ops.scoring``.
"""

from __future__ import annotations

import numpy as np


def dot_product(vec1, vec2) -> float:
    """f32 dot product (reference vec_compute.rs:9-22)."""
    a = np.asarray(vec1, dtype=np.float32)
    b = np.asarray(vec2, dtype=np.float32)
    return float(np.dot(a, b))


def cosine_similarity(vec1, vec2, vec1_inv_norm: float, vec2_inv_norm: float) -> float:
    """dot * inv-norms, with norms supplied by the caller (vec_compute.rs:25-32)."""
    return dot_product(vec1, vec2) * float(vec1_inv_norm) * float(vec2_inv_norm)


def euclidean_distance_squared(vec1, vec2) -> float:
    """Squared L2 distance (vec_compute.rs:35-54)."""
    a = np.asarray(vec1, dtype=np.float32)
    b = np.asarray(vec2, dtype=np.float32)
    d = a - b
    return float(np.dot(d, d))
