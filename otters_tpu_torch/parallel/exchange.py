"""The collectives of a mesh that spans processes.

Each is one gloo call over host memory on the process group of
``mesh.init_distributed``. Every function here is collective: every process
of the group calls it, with the same arguments' shapes, in the same order
(the contract JAX states for multi-process meshes), or all of them wait.
``calls`` counts the calls this process made, so a test can hold a query
to its budget (at most two a batch), and ``seconds`` their wall time.

A query's per-program results travel as records: each program's tensors
as raw bytes, one fixed-length record per program (``to_bytes`` /
``from_bytes``), every process's records in one buffer, one buffer a
process in one ``all_gather`` (:class:`Pending`).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.scoring import HostCopy
from . import mesh as _mesh

calls = 0
seconds = 0.0


def _dist():
    global calls
    if _mesh._group is None:
        raise RuntimeError("a mesh across processes needs parallel.init_distributed first")
    calls += 1
    return torch.distributed


class _Clock:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        global seconds
        seconds += time.perf_counter() - self.t0


def all_gather_bytes(buf: np.ndarray) -> List[np.ndarray]:
    """Every process's ``uint8`` buffer (of one length on every process),
    in rank order: one ``all_gather``."""
    dist = _dist()
    t = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(_mesh._group))]
    with _Clock():
        dist.all_gather(out, t, group=_mesh._group)
    return [o.numpy() for o in out]


def all_reduce_max(x: np.ndarray) -> np.ndarray:
    """The elementwise maximum of ``x`` (f32) over the processes: one
    ``all_reduce``. A maximum is exact, so every process holds the same
    bits."""
    dist = _dist()
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    with _Clock():
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_mesh._group)
    return t.numpy()


def all_gather_object(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, in rank order (the replicating
    gathers of mutation and persistence; never on the query path)."""
    dist = _dist()
    out: List[Any] = [None] * dist.get_world_size(_mesh._group)
    dist.all_gather_object(out, obj, group=_mesh._group)
    return out


def barrier() -> None:
    """Wait until every process gets here."""
    _dist().barrier(group=_mesh._group)


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def to_bytes(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """One record: the tensors' raw bytes, flattened and concatenated on
    ``device`` (no host wait)."""
    parts = [t.contiguous().reshape(-1) for t in tensors]
    parts = [(p.to(torch.uint8) if p.dtype == torch.bool else p).view(torch.uint8).to(device)
             for p in parts]
    return torch.cat(parts)


def from_bytes(rec: np.ndarray, spec: Sequence[Tuple[torch.dtype, int]]) -> List[torch.Tensor]:
    """The tensors of a record laid out by ``spec`` ((dtype, numel) in
    order), on the host, bit for bit as they were packed."""
    out, off = [], 0
    for dtype, numel in spec:
        raw = torch.from_numpy(rec[off : off + numel * _itemsize(dtype)].copy())
        out.append(raw.bool() if dtype == torch.bool else raw.view(dtype))
        off += numel * _itemsize(dtype)
    return out


def record_bytes(spec: Sequence[Tuple[torch.dtype, int]]) -> int:
    return sum(numel * _itemsize(dtype) for dtype, numel in spec)


def _itemsize(dtype: torch.dtype) -> int:
    return 1 if dtype == torch.bool else torch.empty((), dtype=dtype).element_size()


def gather_records(mesh, mine: np.ndarray, size: int) -> Dict[tuple, np.ndarray]:
    """Every program's record: ``mine`` holds this process's, one of
    ``size`` bytes per entry of ``mesh.programs()`` in order -> {(r, c):
    record} over the whole mesh, from one ``all_gather``. Buffers are
    padded to the longest process's."""
    per_rank: Dict[int, List[tuple]] = {}
    rows, batch = mesh.devices.shape
    for r in range(rows):
        for c in range(batch):
            per_rank.setdefault(int(mesh.owners[r, c]), []).append((r, c))
    longest = max(len(v) for v in per_rank.values()) * size
    buf = np.zeros(longest, np.uint8)
    buf[: mine.size] = mine
    out = {}
    for rank, got in enumerate(all_gather_bytes(buf)):
        for i, rc in enumerate(per_rank.get(rank, [])):
            out[rc] = got[i * size : (i + 1) * size]
    return out


class Pending:
    """A query's local records on their way to the host: ``wait()`` (where
    a single process waits on its device) finishes the copy, exchanges the
    records and returns ``finish({(r, c): record})``. Collective: every
    process waits on its pendings in the same order."""

    def __init__(self, mesh, records: torch.Tensor, size: int,
                 finish: Callable[[Dict[tuple, np.ndarray]], tuple]):
        self._mesh = mesh
        self._copy = HostCopy([records])
        self._size = size
        self._finish = finish
        self._out = None

    def wait(self) -> tuple:
        if self._out is None:
            mine = self._copy.wait()[0]
            self._out = self._finish(gather_records(self._mesh, mine, self._size))
        return self._out
