"""Mesh construction: a ``[rows, batch]`` grid of torch devices, in one
process or across processes.

The JAX package shards over a ``jax.sharding.Mesh`` with the axes
``("rows", "batch")``. The port's :class:`Mesh` is the same grid held as a
numpy object array of ``torch.device`` beside an array of owner ranks: the
sharded stores place row shard ``r`` on ``devices[r, c]`` for every batch
column ``c``, and the query batch is split over the columns. A device may
appear more than once (four row shards on one card, or eight on the CPU):
each entry is then a shard of its own that shares the device's memory and
stream.

A mesh that spans processes (after :func:`init_distributed`, JAX's
``jax.distributed.initialize``) lists every process's devices in rank
order, as ``jax.devices()`` does. Each process holds and runs only the
entries it owns; the k-sized partials of a query meet in one gloo
``all_gather`` of a host buffer (``parallel/exchange.py``), after which
every process merges them alike on its local lead.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# the process group of init_distributed and what each process brought to it
_group = None
_devices: Optional[List[torch.device]] = None  # every process's, in rank order
_owners: Optional[List[int]] = None  # the rank owning each of them


class Mesh:
    """A ``[rows, batch]`` grid of devices with JAX's axis names; ``owners``
    holds the rank of the process that owns each entry (all this process's
    in a mesh of one process)."""

    axis_names = ("rows", "batch")

    def __init__(self, devices: np.ndarray, owners: Optional[np.ndarray] = None):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a [rows, batch] grid, got shape {devices.shape}")
        self.devices = devices
        if owners is None:
            owners = np.full(devices.shape, process_index(), dtype=np.int64)
        self.owners = owners
        self.rank = process_index()
        self.spans_processes = bool((owners != self.rank).any())

    @property
    def shape(self) -> Dict[str, int]:
        """``{"rows": rows, "batch": batch}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def is_local(self, r: int, c: int = 0) -> bool:
        """Does this process own entry ``(r, c)``?"""
        return int(self.owners[r, c]) == self.rank

    def programs(self) -> List[tuple]:
        """The entries ``(r, c)`` this process runs, rows-major."""
        rows, batch = self.devices.shape
        return [(r, c) for r in range(rows) for c in range(batch) if self.is_local(r, c)]

    def home(self, r: int) -> Optional[torch.device]:
        """Where this process holds row shard ``r``: its first entry of row
        ``r`` (``devices[r, 0]`` in one process), None if it owns none."""
        for c in range(self.devices.shape[1]):
            if self.is_local(r, c):
                return self.devices[r, c]
        return None

    def writer(self, r: int) -> int:
        """The one process that reports row shard ``r`` (replica 0 in JAX's
        terms): the owner of ``devices[r, 0]``. Saves and gathers read each
        row shard from its writer only."""
        return int(self.owners[r, 0])

    def local_rows(self) -> List[int]:
        """The row shards this process holds."""
        return [r for r in range(self.devices.shape[0]) if self.home(r) is not None]

    @property
    def lead(self) -> torch.device:
        """The local lead: the first entry this process owns, where its merge
        runs and its results live (``devices[0, 0]`` in one process)."""
        r, c = self.programs()[0]
        return self.devices[r, c]

    def __repr__(self) -> str:
        names = [str(d) for d in self.devices.flat]
        if self.spans_processes:  # each entry with its owner's rank
            names = [f"{d}@{o}" for d, o in zip(names, self.owners.flat)]
        return f"Mesh({self.shape}, devices={names})"


def process_index() -> int:
    """This process's rank after :func:`init_distributed`, else 0
    (``jax.process_index``)."""
    return 0 if _group is None else torch.distributed.get_rank(_group)


def process_count() -> int:
    """The number of processes after :func:`init_distributed`, else 1
    (``jax.process_count``)."""
    return 1 if _group is None else torch.distributed.get_world_size(_group)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    local_devices: Optional[Sequence] = None,
) -> None:
    """Join a mesh that spans processes (the JAX package's multi-host
    ``jax.distributed.initialize``; call once in every process, before any
    store is built).

    Starts one gloo process group at ``tcp://{coordinator_address}``
    (``"host:port"``, process 0 listening there) with ``num_processes``
    ranks, this one ``process_id``. With no address, the ``env://``
    variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) take their place, the counterpart of JAX's
    auto-detection. ``local_devices`` is what this process brings to the
    mesh, every visible CUDA device by default (the CPU tests pass
    ``["cpu", "cpu"]``, a device listed twice being two entries). The
    devices of every process are gathered once, in rank order: afterwards
    ``make_mesh()`` spans them all.

    The exchange between processes is gloo over host buffers, so two
    processes may share one card (NCCL refuses two ranks on one device).
    Collective: every process calls it; a second call raises, as JAX's."""
    global _group, _devices, _owners
    import torch.distributed as dist

    if _group is not None or dist.is_initialized():
        raise RuntimeError("distributed.initialize should only be called once.")
    if coordinator_address is None:
        init_method = "env://"
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    else:
        init_method = f"tcp://{coordinator_address}"
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and process_id with an address")
    dist.init_process_group("gloo", init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id))
    if local_devices is None:
        local_devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mine = [str(_indexed(torch.device(d))) for d in local_devices]
    every: List = [None] * int(num_processes)
    dist.all_gather_object(every, mine)
    _group = dist.group.WORLD
    _devices = [torch.device(d) for names in every for d in names]
    _owners = [rank for rank, names in enumerate(every) for _ in names]


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

    ``devices`` (names or ``torch.device``, all this process's) defaults to
    every visible CUDA device, or after :func:`init_distributed` to every
    process's devices in rank order; a device listed more than once holds
    several shards. All rows by default: ``rows = len(devices) // batch``."""
    owners = None
    if devices is None and _devices is not None:
        devices, owners = _devices, _owners
    elif devices is None:
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
    if owners is not None:
        owners = np.asarray(owners, dtype=np.int64).reshape(rows, batch)
    return Mesh(grid.reshape(rows, batch), owners)
