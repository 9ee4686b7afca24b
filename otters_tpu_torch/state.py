"""Carry device state across from the JAX package.

The parity tests hand the port the very arrays the JAX package built (as
numpy), so both packages' kernels see the same quantized store bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.scoring import DeviceVecs


def device_vecs_from_numpy(
    vectors, norms_sq, inv_norms, valid, resid=None, resid_bin=None,
    resid_max=None, *, device,
) -> DeviceVecs:
    """Adopt a JAX ``DeviceVecs``'s arrays (as numpy) into the port's
    ``DeviceVecs`` on ``device``."""

    def t(x):
        if x is None:
            return None
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return DeviceVecs(
        t(vectors), t(norms_sq), t(inv_norms), t(valid), t(resid),
        t(resid_bin), t(resid_max),
    )
