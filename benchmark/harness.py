"""One run of one cell: inputs from the seed, the store, the warm-up, the
window, the comparison with the reference, and the metrics by name.

``run.py`` is the command; the tests call ``run_cell`` on the CPU at small
sizes (``overrides``). A run takes one device or a list of them: with more
than one, the store spans them (``system.build``), the reference scores on
all of them, and the result's ``device`` gives the number of cards and the
fullest card's memory peak.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from . import data, guard, judge, reference, spec, system, trace
from .spec import BENCH_DIR, Cell
from .window import Window

TRACE_DIR = os.path.join(BENCH_DIR, "traces")
TRACE_SECONDS = 10.0  # the longest traced window: the trace's reduction grows with it


_T0 = [time.perf_counter()]


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0[0]:8.3f}] {msg}", file=sys.stderr, flush=True)


@dataclass
class Record:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: Cell
    batch: int
    live_rows: int  # rows the filter keeps
    setup_s: float
    build_s: float
    window: Window
    trace: Optional[trace.DeviceTrace] = None


def reader(name: str):
    """The ``read(record)`` of ``metrics/<name>.py``, where a name split by
    the cells it is reported in (``qps.serial``) takes its part before the
    first dot."""
    return spec.part("metrics", name.split(".")[0]).read


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def sizes(cell: Cell, overrides: Optional[Dict] = None) -> Dict:
    s = {"rows": cell.rows, "dim": int(cell.config["dim"]), "batch": int(cell.mix["batch"]),
         "pool": int(cell.mix["pool_requests"])}
    s.update(overrides or {})
    return s


def _values(readers, rec: Record) -> Dict[str, Dict]:
    out = {}
    for m in readers:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, devices,
             t_process: float, overrides: Optional[Dict] = None) -> Dict:
    """-> the result line's fields (``correct`` ... ``checks``). ``devices``:
    one device, or a list (the first leads: the inputs' queries, the
    program's merge and the reference's are there)."""
    _T0[0] = t_process
    import otters_tpu_torch as tx

    devs = system.devices(devices)
    dev = devs[0]
    cards = system.cards(devs)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    sz = sizes(cell, overrides)
    n, d, batch = sz["rows"], sz["dim"], sz["batch"]
    kind = spec.part("traffic", cell.mix["kind"])
    filt = cell.mix["filter"]
    keep_from = spec.keep_from(cell.mix, n)
    log(f"cell {cell.name}: {n} x {d} {cell.config['storage_dtype']} "
        f"{cell.config['metric']}, batch {batch}, mix {json.dumps(cell.mix)}, "
        f"{filt['column']} {filt['op']} {keep_from}, seed {seed}, devices "
        f"{[str(x) for x in devs]}")

    t0 = time.perf_counter()
    inputs = data.make(cell.config, n, d, sz["pool"], batch, seed, dev)
    system.sync(devs)
    log(f"inputs made on {dev}: {time.perf_counter() - t0:.3f} s")
    store, build_s = system.build(tx, cell.config, inputs, devs)
    log(f"build: {build_s:.3f} s, {store.n_chunks()} chunks")
    api = system.Requests(tx, store, cell.config, cell.mix, keep_from)
    t0 = time.perf_counter()
    n_programs, warm = kind.warm(api, inputs.queries, cell.mix)
    system.sync(devs)
    log(f"precompile ({n_programs} programs) and warm-up: {time.perf_counter() - t0:.3f} s, "
        f"certified {sum(r.certified is True for r in warm)} of {len(warm)}")
    log(f"counters after set-up: {json.dumps(system.counters(tx))}")
    system.reset_launches()
    gc.collect()
    system.sync(devs)
    setup_s = time.perf_counter() - t_process

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW_SPAN):
                window = kind.run(api, inputs.queries, cell.mix, min(seconds, TRACE_SECONDS),
                                  record_function)
                system.sync(devs)
    else:
        window = kind.run(api, inputs.queries, cell.mix, seconds)
    found = guard.offenders()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {found}")
    peaks = {str(c): torch.cuda.max_memory_allocated(c) for c in cards}
    memory_peak = max(peaks.values(), default=0)
    counts = system.counters(tx)
    log(f"window: {len(window.requests)} requests, {window.queries} queries in "
        f"{window.seconds:.3f} s, {window.gc}; counters {json.dumps(counts)}; "
        f"certified {sum(r.certified is True for r in window.requests)} of "
        f"{len(window.requests)}; memory peak {memory_peak / 1e9:.3f} GB")
    if len(cards) > 1:
        log(f"memory peak by card: {json.dumps(peaks)}")
    log(f"queries sent in each second: {window.qps_by_second(batch)}")
    if on_card:
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    dtrace = None
    if prof is not None:
        t0 = time.perf_counter()
        dtrace = trace.reduce(prof, [c.index for c in cards])
        del prof
        log(f"trace reduced in {time.perf_counter() - t0:.3f} s: busy {dtrace.busy_s:.6f} s "
            f"of {dtrace.window_s:.6f} s")
        if dtrace.card_busy_s:
            log("idle share by card: " + json.dumps(
                {c: 1.0 - b / dtrace.window_s for c, b in dtrace.card_busy_s.items()}))

    # the program's state goes before the reference runs
    del api, store, warm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    metric = cell.config["metric"]
    keep = reference.keep_mask(inputs.columns[filt["column"]], filt["op"], keep_from)
    ref = reference.topk(inputs.rows, keep, inputs.queries, int(cell.mix["k"]), metric,
                         devices=cards or [dev])
    answers = [judge.Answer(r.pool, r.indices, r.scores, r.certified) for r in window.requests]
    verdict = judge.judge(answers, ref, inputs.rows, inputs.queries, keep,
                          float(cell.config["limits"]["worst_gap"]),
                          bool(cell.config.get("certified", False)), metric)
    log(f"reference and comparison: {time.perf_counter() - t0:.3f} s")

    rec = Record(cell=cell, batch=batch, live_rows=int(np.count_nonzero(keep)),
                 setup_s=setup_s, build_s=build_s, window=window, trace=dtrace)
    e2e, layers = _values(cell.end_to_end, rec), _values(cell.per_layer, rec)
    out = {"correct": verdict.correct, "attempted": len(window.requests),
           "failed": verdict.failed, "metrics": layers if traced else e2e}
    log(f"end-to-end: {json.dumps(e2e)}")
    log(f"per-layer: {json.dumps(layers)}")
    out["device"] = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": max(1, len(cards)),
        "memory_peak_bytes": int(memory_peak),
    }
    if dtrace is not None:
        out["device"].update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
        out["breakdown"] = dtrace.breakdown()
        os.makedirs(TRACE_DIR, exist_ok=True)
        with open(os.path.join(TRACE_DIR, f"{cell.name}.{seed}.json"), "w") as f:
            json.dump({"metrics": out["metrics"], "end_to_end": e2e,
                       "breakdown": out["breakdown"], "counters": counts}, f, indent=1)
    out["checks"] = verdict.checks()
    return out
