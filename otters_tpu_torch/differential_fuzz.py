"""On-card differential fuzz: the fused kernels against the scan programs.

The port of the JAX package's ``scripts/tpu_differential_fuzz.py``, with its
random space: N in {600k, 1M} rows (padded by ``scoring.pad_rows``), D in
{64, 128, 256, 768}, B in {1, 4, 8, 32, 64, 256} queries, K in {5, 10, 50,
100}, chunks of {512, 1000, 1024, 4096} rows (1000 aligns with no tile),
int8 storage one time in four (Cosine), else float32 (Cosine, Dot or
Euclid), and the filter ``price < sel``. Each trial builds a store on the
device from rows drawn by a ``torch.Generator`` there and runs one query
twice: through the kernels (K2 over int8 rows; K4 over f32 rows, and K3
where its fast check fails), then with ``OTTERS_DISABLE_PALLAS`` set, which
sends the same shape to the scan program (``scoring.scan_topk_core``).

A trial passes when the two runs return the same indices (int8: equal but
where the rank-wise scores tie within 1e-6), scores within rtol = atol =
1e-5, only rows that satisfy the filter, and, on a shape the fused path
takes (``scoring.choose_mode`` "panel": more than ``DIRECT_LIMIT`` query x
row pairs), a kernel launch in the first run on a CUDA device, none in the
second and the batch counted in ``fused_topk.kernel_takes.routed``. A
smaller shape runs the direct program in both runs (as in the JAX
package): such trials are run and checked, but only fused-size trials
count, and ``run`` draws until enough of them ran, a batch of 8 and chunks
of 1000 rows among them.

Gaussian rows never tie across the 4k bins the fast check examines, so K3
never re-runs on a drawn trial. One more trial, a tie trial, takes its
shape from the same space (float32, a fused size) and makes its rows copies
of ``TIE_POOL`` drawn vectors: every bin holds a copy of the best pair's
vector, the fast check fails and K3 re-runs; its indices are held equal
too (both routes keep the lowest-indexed copies).

Usage: ``python -m otters_tpu_torch.differential_fuzz [trials] [seed] [device]``
(the device defaults to the current CUDA device).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import Column, DataType, MetaStore, Metric, col
from ._device import resolve_device
from .ops import fused_topk as ft
from .ops import scoring

N_CHOICES = (600_000, 1_000_000)
D_CHOICES = (64, 128, 256, 768)
B_CHOICES = (1, 4, 8, 32, 64, 256)  # narrow batches, b = 1 included
K_CHOICES = (5, 10, 50, 100)
CHUNK_CHOICES = (512, 1000, 1024, 4096)  # 1000: chunks that align with no tile
COVER_B, COVER_CHUNK = 8, 1000  # a fused-size trial of each must run
TIE_POOL = 16  # the tie trial's distinct vectors
MAX_DRAWS = 64
SCORE_TOL = 1e-5
TIE_TOL = 1e-6


def _launches() -> dict:
    return {m: fn.launches for m, fn in ft.KERNELS.items()}


def _delta(before: dict) -> dict:
    return {m: n - before[m] for m, n in _launches().items() if n != before[m]}


def _fused(n_pad: int, b: int, k: int) -> bool:
    return scoring.choose_mode(n_pad, b, min(k, b * n_pad)) == "panel"


def trial(index: int, rng: np.random.Generator, seed: int, device: torch.device,
          n_choices=N_CHOICES, ties: bool = False) -> dict:
    """One trial: draws its configuration from ``rng`` in the script's
    order, runs both routes and returns its record (raises
    ``AssertionError`` on a mismatch). ``ties``: the tie trial, float32 rows
    copied from ``TIE_POOL`` vectors, its shape redrawn until it is of
    fused size; a K3 re-run must follow K4 in its first run."""
    while True:
        n = int(rng.choice(n_choices))
        d = int(rng.choice(D_CHOICES))
        b = int(rng.choice(B_CHOICES))
        k = int(rng.choice(K_CHOICES))
        chunk = int(rng.choice(CHUNK_CHOICES))
        dtype = "int8" if rng.random() < 0.25 else "float32"
        n_pad = scoring.pad_rows(n)
        if not ties or _fused(n_pad, b, k):
            break
    g = torch.Generator(device=device).manual_seed(seed * 1000 + index)
    if ties:
        dtype = "float32"
        pool = torch.randn((TIE_POOL, d), generator=g, device=device)
        rows = pool[torch.arange(n_pad, device=device) % TIE_POOL]
    else:
        rows = torch.randn((n_pad, d), generator=g, device=device)
    price = rng.uniform(0, 100, n)
    sel = float(rng.uniform(10, 90))
    cols = [Column("price", DataType.Float64).from_values(price)]
    t0 = time.perf_counter()
    store = (MetaStore.from_columns(cols).with_vectors(rows, n_rows=n).with_chunk_size(chunk)
             .with_storage_dtype(dtype).with_device(device).build())
    del rows
    q = rng.normal(size=(b, d)).astype(np.float32)
    if dtype == "int8":
        metric = Metric.Cosine
    else:
        metric = [Metric.Cosine, Metric.DotProduct, Metric.Euclidean][int(rng.integers(0, 3))]
    fused = _fused(n_pad, b, k)

    def run():
        before, routed = _launches(), ft.kernel_takes.routed
        res = store.query_batch(q, metric).meta_filter(col("price").lt(sel)).take(k).collect()
        return res, _delta(before), ft.kernel_takes.routed - routed

    r1, launched, routed1 = run()
    os.environ["OTTERS_DISABLE_PALLAS"] = "1"
    try:
        r2, launched2, routed2 = run()
    finally:
        del os.environ["OTTERS_DISABLE_PALLAS"]
    seconds = time.perf_counter() - t0
    s1, s2 = np.asarray(r1.scores), np.asarray(r2.scores)
    close = s1.shape == s2.shape and bool(np.allclose(s1, s2, rtol=SCORE_TOL, atol=SCORE_TOL))
    if dtype == "int8":
        # quantized scores tie often, and the two routes may order tied rows
        # differently: indices agree except where the rank-wise scores tie
        same_idx = len(r1.indices) == len(r2.indices) and all(
            i == j or abs(a - c) <= TIE_TOL
            for i, j, a, c in zip(r1.indices, r2.indices, r1.scores, r2.scores)
        )
    else:
        same_idx = r1.indices == r2.indices
    filter_ok = all(price[i] < sel for i in r1.indices + r2.indices)
    record = {
        "trial": index, "n": n, "d": d, "b": b, "k": k, "chunk": chunk, "dtype": dtype,
        "metric": metric.value, "route": "fused" if fused else "direct", "ties": ties,
        "kernel_launches": launched, "switch_launches": launched2,
        "routed": routed2, "results": len(r1.indices),
        "max_abs_diff": float(np.abs(s1 - s2).max()) if s1.shape == s2.shape and s1.size
        else None,
        "idx_match": same_idx, "scores_close": close, "filter_ok": filter_ok,
        "seconds": seconds,
    }
    checks = [same_idx, close, filter_ok, not launched2, routed1 == 0,
              routed2 == (b if fused else 0)]
    if fused and device.type == "cuda":
        checks.append(bool(launched))
        if ties:
            checks.append(launched.get("K4") == 1 and launched.get("K3") == 1)
    if not all(checks):
        raise AssertionError(f"mismatch in trial {index}: {record}")
    return record


def run(trials: int = 8, seed: int = 7, device=None, n_choices=N_CHOICES, log=None) -> list:
    """Draw trials from ``np.random.default_rng(seed)`` on ``device``
    (default: the current CUDA device) until ``trials`` of them are of
    fused size, a batch of ``COVER_B`` and chunks of ``COVER_CHUNK`` among
    those, then run the tie trial -> one record a trial, in order (the
    direct-size ones included, the tie trial last); ``log(record)`` sees
    each as it ends. Raises ``RuntimeError`` when ``MAX_DRAWS`` draws do not
    get there. ``OTTERS_DISABLE_PALLAS`` must be unset (each trial sets it
    for its second run only)."""
    if os.environ.get("OTTERS_DISABLE_PALLAS"):
        raise RuntimeError("OTTERS_DISABLE_PALLAS is set: both runs would take the scan program")
    dev = resolve_device(device, "differential_fuzz.run(device='cpu')")
    rng = np.random.default_rng(seed)
    out = []

    def step(ties=False):
        out.append(trial(len(out), rng, seed, dev, n_choices, ties))
        if log is not None:
            log(out[-1])
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def done():
        fused = [r for r in out if r["route"] == "fused"]
        return (len(fused) >= trials and any(r["b"] == COVER_B for r in fused)
                and any(r["chunk"] == COVER_CHUNK for r in fused))

    while not done():
        if len(out) == MAX_DRAWS:
            raise RuntimeError(f"{MAX_DRAWS} draws gave {trials} fused-size trials with b = "
                               f"{COVER_B} and chunks of {COVER_CHUNK} not yet")
        step()
    step(ties=True)
    return out


def describe(r: dict) -> str:
    return (f"trial {r['trial']}: N={r['n']} D={r['d']} B={r['b']} K={r['k']} "
            f"chunk={r['chunk']} dtype={r['dtype']} metric={r['metric']} route={r['route']}"
            f"{' ties' if r['ties'] else ''} "
            f"({r['seconds']:.1f}s) kernels={r['kernel_launches']} routed={r['routed']} "
            f"-> idx_match={r['idx_match']} scores_close={r['scores_close']} "
            f"filter_ok={r['filter_ok']}")


if __name__ == "__main__":
    recs = run(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
               int(sys.argv[2]) if len(sys.argv) > 2 else 7,
               sys.argv[3] if len(sys.argv) > 3 else None,
               log=lambda r: print(describe(r), flush=True))
    fused = sum(r["route"] == "fused" and not r["ties"] for r in recs)
    print(f"ALL FUZZ TRIALS PASSED: {fused} of fused size, {len(recs) - fused - 1} of direct "
          "size, and the tie trial", flush=True)
