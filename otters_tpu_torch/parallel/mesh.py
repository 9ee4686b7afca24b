"""Mesh construction: a ``[rows, batch]`` grid of torch devices.

The JAX package shards over a ``jax.sharding.Mesh`` with the axes
``("rows", "batch")``. The port's :class:`Mesh` is the same grid held as a
numpy object array of ``torch.device``: the sharded stores place row shard
``r`` on ``devices[r, c]`` for every batch column ``c``, and the query batch
is split over the columns. A device may appear more than once (four row
shards on one card, or eight on the CPU): each entry is then a shard of its
own that shares the device's memory and stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

_ROADMAP = "ROADMAP.md, Queue 1: meshes that span processes"


class Mesh:
    """A ``[rows, batch]`` grid of devices with JAX's axis names."""

    axis_names = ("rows", "batch")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a [rows, batch] grid, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        """``{"rows": rows, "batch": batch}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """``devices[0, 0]``: where the merge and the results live."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join a mesh that spans processes (the JAX package's multi-host
    ``jax.distributed.initialize``). Not ported yet: a mesh of the port
    lives in one process."""
    raise NotImplementedError(
        f"parallel.init_distributed: meshes that span processes are not ported yet ({_ROADMAP})"
    )


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device named without an index is the current one."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(
    rows: Optional[int] = None,
    batch: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('rows', 'batch') mesh.

    'rows'  : shards the vector/metadata row axis.
    'batch' : shards the query batch (data parallel over queries).

    ``devices`` (names or ``torch.device``) defaults to every visible CUDA
    device; a device listed more than once holds several shards. All rows
    by default: ``rows = len(devices) // batch``."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if rows is None:
        rows = n // batch
    if rows * batch != n or n == 0:
        raise ValueError(
            f"rows ({rows}) x batch ({batch}) must equal device count ({n})"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(rows, batch))
