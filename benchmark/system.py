"""The system under test: ``otters_tpu_torch``, driven through its public API.

A store is built from the benchmark's f32 rows as the configuration states:
its columns, storage dtype, chunk size and rerank source (the file
``rerank/<rerank_source>.py``). On one device, rows made as one tensor go to
``build()``; on several (the cell's ``chips`` cards), the store is built
across them by the port's own path, ``make_mesh(rows=<devices>)`` and
``build_sharded``. Rows made by id (a row source, ``data.py``) are fed to a
mesh of the run's devices slab by slab, each slab made on the device of the
shard that holds it (``materialize_*_slabs_sharded`` into
``with_vectors(DeviceVecs, n_rows=n)``; one device is a one-shard mesh, since
the port's single-device slab ingest has no bfloat16 form). A request is
``query_batch(q, metric).meta_filter(<column> <op> value).take(k, rerank_from)``
sent with ``collect_async``.
"""

from __future__ import annotations

import math
import time
from typing import List

import torch

from . import spec

METRICS = {"cosine": "Cosine", "l2": "Euclidean", "dot": "DotProduct"}
SLAB_ROWS = 1 << 16  # rows made at once where rows are made by id


def devices(devs) -> List[torch.device]:
    """A device or a list of them -> the list, a CUDA device named without
    an index taken as the current one."""
    devs = devs if isinstance(devs, (list, tuple)) else [devs]
    out = []
    for d in devs:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def cards(devs) -> List[torch.device]:
    """The distinct CUDA devices among ``devs``, in order."""
    out = []
    for d in devices(devs):
        if d.type == "cuda" and d not in out:
            out.append(d)
    return out


def sync(devs) -> None:
    for d in cards(devs):
        torch.cuda.synchronize(d)


def filter_expr(tx, mix: dict, value: int):
    return getattr(tx.col(mix["filter"]["column"]), mix["filter"]["op"])(value)


def _slabs_by_id(config: dict, rows, n: int, mesh):
    """The store's rows made by id straight into each shard's memory."""
    from otters_tpu_torch.parallel import meta_sharded

    shards, chunk = mesh.shape["rows"], int(config["chunk_size"])
    n_loc = meta_sharded.sharded_geometry(n, chunk, shards)[0] // shards
    slab_rows = math.gcd(n_loc, SLAB_ROWS)  # a slab lies in one shard

    def slab(start, count):
        out = rows.slab(start, count, mesh.home(start // n_loc))
        if start + count > n:
            out[max(0, n - start):] = 0.0  # the padding rows, zero as the program's own
        return out

    if config["storage_dtype"] == "int8":
        return meta_sharded.materialize_int8_slabs_sharded(slab, n, rows.d, slab_rows, mesh,
                                                           chunk_size=chunk)
    return meta_sharded.materialize_f32_slabs_sharded(
        slab, n, rows.d, slab_rows, mesh, chunk_size=chunk,
        dtype=getattr(torch, config["storage_dtype"]))


def build(tx, config: dict, inputs, devs):
    """-> (the store, the synchronised seconds of its build)."""
    devs = devices(devs)
    columns = [tx.Column(c["name"], getattr(tx.DataType, c["dtype"]))
               .from_values(inputs.columns[c["name"]]) for c in config["columns"]]
    rerank = spec.part("rerank", config["rerank_source"])
    whole = isinstance(inputs.rows, torch.Tensor)
    sync(devs)
    t0 = time.perf_counter()
    builder = (
        tx.MetaStore.from_columns(columns)
        .with_storage_dtype(config["storage_dtype"])
        .with_chunk_size(int(config["chunk_size"]))
    )
    if whole and len(devs) == 1:
        builder = builder.with_vectors(inputs.rows, n_rows=inputs.n)
        store = rerank.apply(builder, inputs).with_device(devs[0]).build()
    else:
        mesh = tx.parallel.make_mesh(rows=len(devs), devices=devs)
        vectors = inputs.rows if whole else _slabs_by_id(config, inputs.rows, inputs.n, mesh)
        builder = builder.with_vectors(vectors, n_rows=inputs.n)
        store = rerank.apply(builder, inputs).build_sharded(mesh)
    sync(devs)
    return store, time.perf_counter() - t0


class Requests:
    """Send and finish the requests of one mix on one store."""

    def __init__(self, tx, store, config: dict, mix: dict, keep_from: int):
        self.tx = tx
        self.store = store
        self.metric = getattr(tx.Metric, METRICS[config["metric"]])
        self.expr = filter_expr(tx, mix, keep_from)
        self.k = int(mix["k"])
        self.rerank_from = mix.get("rerank_from")
        self.finish_by = mix["finish"]

    def submit(self, q):
        return (self.store.query_batch(q, self.metric).meta_filter(self.expr)
                .take(self.k, rerank_from=self.rerank_from).collect_async())

    def finish(self, pendings):
        if self.finish_by == "resolve":
            return self.tx.resolve(pendings)
        return [p.result() for p in pendings]

    def precompile(self, batch: int, depth: int) -> int:
        return self.store.precompile(filters=[self.expr], batch_sizes=(batch,), k=self.k,
                                     metric=self.metric, rerank_from=self.rerank_from,
                                     pipeline_depths=(depth,))


def counters(tx) -> dict:
    """The program's build and launch counters, for the log."""
    from otters_tpu_torch import aot, kernels
    from otters_tpu_torch.ops import fused_topk as ft

    return {"nvcc_runs": kernels.nvcc_runs, "aot": dict(aot.stats),
            "launches": {m: fn.launches for m, fn in ft.KERNELS.items() if fn.launches},
            "routed": ft.kernel_takes.routed}


def reset_launches() -> None:
    from otters_tpu_torch.ops import fused_topk as ft

    ft.reset_launches()
