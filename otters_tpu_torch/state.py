"""Carry device state across from the JAX package.

The parity tests hand the port the very arrays the JAX package built (as
numpy), so both packages' kernels see the same store bit for bit: a
``DeviceVecs`` (int8 with its residuals, or f32 without them) and a
``VecStore``'s staged rows.

numpy has no bfloat16: JAX hands out ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses. Such arrays cross as their 16-bit codes
(``view(np.int16)``), reinterpreted as ``torch.bfloat16`` on the torch side,
so the stored values arrive bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.scoring import DeviceVecs, _depth_padded


def device_vecs_from_numpy(
    vectors, norms_sq, inv_norms, valid, resid=None, resid_bin=None,
    resid_max=None, *, device,
) -> DeviceVecs:
    """Adopt a JAX ``DeviceVecs``'s arrays (as numpy) into the port's
    ``DeviceVecs`` on ``device``, the rows' depth padded as every ingest of
    the port pads it. The residual fields may be absent (an f32 store has
    none); bfloat16 vectors keep their codes."""

    def t(x):
        if x is None:
            return None
        x = np.array(x, copy=True)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(x).to(device)

    return DeviceVecs(
        _depth_padded(t(vectors)), t(norms_sq), t(inv_norms), t(valid), t(resid),
        t(resid_bin), t(resid_max),
    )


def vec_store_from_numpy(rows, dim: int, dtype: str = "float32", *, device):
    """A port ``VecStore`` holding the same staged rows as a JAX one (pass
    its ``_host_matrix()``), so both materialize the same store."""
    from .vec import VecStore

    store = VecStore(dim, dtype=dtype, device=device)
    rows = np.asarray(rows, dtype=np.float32)
    if rows.shape[0]:
        store.add_vectors(rows)
    return store
