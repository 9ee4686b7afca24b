"""The system under test: ``otters_tpu_torch``, driven through its public API.

A store is built from the benchmark's f32 rows as the configuration states:
its columns, storage dtype, chunk size and rerank source (the file
``rerank/<rerank_source>.py``). A request is
``query_batch(q, metric).meta_filter(<column> <op> value).take(k, rerank_from)``
sent with ``collect_async``.
"""

from __future__ import annotations

import time

import torch

from . import spec

METRICS = {"cosine": "Cosine"}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def filter_expr(tx, mix: dict, value: int):
    return getattr(tx.col(mix["filter"]["column"]), mix["filter"]["op"])(value)


def build(tx, config: dict, inputs, device):
    """-> (the store, the synchronised seconds of its build)."""
    columns = [tx.Column(c["name"], getattr(tx.DataType, c["dtype"]))
               .from_values(inputs.columns[c["name"]]) for c in config["columns"]]
    rerank = spec.part("rerank", config["rerank_source"])
    sync(device)
    t0 = time.perf_counter()
    builder = (
        tx.MetaStore.from_columns(columns)
        .with_vectors(inputs.rows, n_rows=inputs.n)
        .with_storage_dtype(config["storage_dtype"])
        .with_chunk_size(int(config["chunk_size"]))
    )
    store = rerank.apply(builder, inputs).with_device(device).build()
    sync(device)
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
