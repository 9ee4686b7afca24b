"""Row-sharded tensors over a :class:`~.mesh.Mesh`.

A :class:`ShardedTensor` is the port's counterpart of a ``jax.Array``
sharded along the mesh's "rows" axis (``PartitionSpec("rows", ...)``): one
tensor per row shard, shard ``r`` on ``mesh.home(r)`` (``devices[r, 0]`` in
one process; across processes, only the shards a process owns). A batch column
``c`` whose device differs from column 0's reads a copy of the shard on its
own device (JAX's replication along "batch"), made on first use. Nothing
here gathers a whole array onto one device except :meth:`numpy`, the host
copy that mutation and persistence read (a collective across processes).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

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
    """``[n, ...]`` split along axis 0 into one tensor per row shard.

    On a mesh that spans processes a process holds only the shards of the
    rows it owns an entry in (``None`` in the others' places), and still
    knows every shard's row count: ``rows``, by default each present
    shard's own and, for an absent one, that of the present ones (every
    placement splits the rows evenly; only a slice passes ``rows``)."""

    def __init__(self, mesh: Mesh, shards: List[Optional[torch.Tensor]],
                 rows: Optional[List[int]] = None):
        if len(shards) != mesh.shape["rows"]:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.shape['rows']} rows")
        self.mesh = mesh
        self.shards = list(shards)
        self._first = next(s for s in self.shards if s is not None)
        if rows is None:
            rows = [int((self._first if s is None else s).shape[0]) for s in self.shards]
        self.rows = list(rows)
        self._replicas: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(self.rows),) + tuple(self._first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._first.dtype

    @property
    def device(self) -> torch.device:
        """The device of this process's first shard."""
        return self._first.device

    def local(self, r: int, c: int = 0) -> torch.Tensor:
        """Row shard ``r`` on ``mesh.devices[r, c]``, an entry this process
        owns."""
        if not self.mesh.is_local(r, c):
            raise ValueError(f"mesh entry ({r}, {c}) belongs to process {self.mesh.owners[r, c]}")
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
        out, sizes, lo = [], [], 0
        for s, n in zip(self.shards, self.rows):
            hi = lo + n
            a, b = min(max(start - lo, 0), hi - lo), min(max(stop - lo, 0), hi - lo)
            out.append(None if s is None else s[a:max(a, b)])
            sizes.append(max(a, b) - a)
            lo = hi
        return ShardedTensor(self.mesh, out, sizes)

    def numpy(self) -> np.ndarray:
        """The whole array on the host (bfloat16 upcast exactly to f32). On
        a mesh that spans processes this is the replicating gather (JAX's
        ``_host_gather``), a collective: every process calls it."""
        mesh = self.mesh
        mine = {r: (s.float() if s.dtype == torch.bfloat16 else s).cpu().numpy()
                for r, s in enumerate(self.shards)
                if s is not None and mesh.writer(r) == mesh.rank}
        if mesh.spans_processes:
            from . import exchange

            for part in exchange.all_gather_object(mine):
                mine.update(part)
        return np.concatenate([mine[r] for r in range(len(self.shards))])

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
        dev = mesh.home(r)
        if dev is None:
            shards.append(None)
            continue
        block = torch.full((hi - lo,) + tuple(t.shape[1:]), fill, dtype=t.dtype, device=dev)
        avail = min(max(t.shape[0] - lo, 0), hi - lo)
        if avail > 0:
            block[:avail] = t[lo : lo + avail].to(dev)
        shards.append(block)
    return ShardedTensor(mesh, shards)
