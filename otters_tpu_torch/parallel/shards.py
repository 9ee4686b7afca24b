"""Row-sharded tensors over a :class:`~.mesh.Mesh`.

A :class:`ShardedTensor` is the port's counterpart of a ``jax.Array``
sharded along the mesh's "rows" axis (``PartitionSpec("rows", ...)``): one
tensor per row shard, shard ``r`` on ``mesh.devices[r, 0]``. A batch column
``c`` whose device differs from column 0's reads a copy of the shard on its
own device (JAX's replication along "batch"), made on first use. Nothing
here gathers a whole array onto one device except :meth:`numpy`, the host
copy that mutation and persistence read.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .mesh import Mesh


def on_device(device: torch.device):
    """The context a shard's work runs in: its CUDA device made current (a
    kernel launch takes its device, stream and geometry from it), nothing
    for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedTensor:
    """``[n, ...]`` split along axis 0 into one tensor per row shard."""

    def __init__(self, mesh: Mesh, shards: List[torch.Tensor]):
        if len(shards) != mesh.shape["rows"]:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.shape['rows']} rows")
        self.mesh = mesh
        self.shards = list(shards)
        self._replicas: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(int(s.shape[0]) for s in self.shards),) + tuple(self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        """The lead device (row shard 0's)."""
        return self.shards[0].device

    def local(self, r: int, c: int = 0) -> torch.Tensor:
        """Row shard ``r`` on ``mesh.devices[r, c]``."""
        dev = self.mesh.devices[r, c]
        shard = self.shards[r]
        if shard.device == dev:
            return shard
        rep = self._replicas.get((r, dev))
        if rep is None:
            rep = _copy_to(shard, dev)
            self._replicas[(r, dev)] = rep
        return rep

    def __getitem__(self, sl):
        """Rows ``sl`` (a slice along axis 0 with step 1), still sharded."""
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise TypeError("a ShardedTensor takes a slice of rows")
        start, stop, _ = sl.indices(self.shape[0])
        out, lo = [], 0
        for s in self.shards:
            hi = lo + int(s.shape[0])
            a, b = min(max(start - lo, 0), hi - lo), min(max(stop - lo, 0), hi - lo)
            out.append(s[a:max(a, b)])
            lo = hi
        return ShardedTensor(self.mesh, out)

    def numpy(self) -> np.ndarray:
        """The whole array on the host (bfloat16 upcast exactly to f32)."""
        parts = [(s.float() if s.dtype == torch.bfloat16 else s).cpu().numpy()
                 for s in self.shards]
        return np.concatenate(parts)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"shards={len(self.shards)})")


def _copy_to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, keeping a store row view's padded row stride (the
    kernels read the stored depth from it)."""
    if t.ndim == 2 and t.shape[0] > 1 and t.stride(0) != t.shape[1]:
        base = torch.zeros((t.shape[0], t.stride(0)), dtype=t.dtype, device=dev)
        base[:, : t.shape[1]] = t.to(dev)
        return base[:, : t.shape[1]]
    return t.to(dev)


def shard_bounds(n: int, n_shards: int) -> List[Tuple[int, int]]:
    """The row range ``[lo, hi)`` of each of ``n_shards`` equal shards of
    ``n`` rows (``n`` a multiple of ``n_shards``)."""
    step = n // n_shards
    return [(r * step, (r + 1) * step) for r in range(n_shards)]


def put_rows(mesh: Mesh, arr, n_target: int, fill) -> ShardedTensor:
    """Place an ``[n, ...]`` array (host numpy or a tensor on one device) as
    a padded ``[n_target, ...]`` array sharded along rows, without forming
    the padded whole anywhere: each shard pads only its own block (rows past
    ``n`` hold ``fill``)."""
    t = torch.as_tensor(arr)
    shards = []
    for r, (lo, hi) in enumerate(shard_bounds(n_target, mesh.shape["rows"])):
        dev = mesh.devices[r, 0]
        block = torch.full((hi - lo,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=dev)
        avail = min(max(t.shape[0] - lo, 0), hi - lo)
        if avail > 0:
            block[:avail] = t[lo : lo + avail].to(dev)
        shards.append(block)
    return ShardedTensor(mesh, shards)
