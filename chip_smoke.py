#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (otters_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. the card: name and power limit (nvidia-smi);
2. the build: every Hopper kernel from ``csrc/`` with nvcc (one process
   per source, started together);
3. the kernel phase: K1 (csrc/cert_cos_binmax.cu), K2 (int8_binmax.cu), K3
   (f32_binmax.cu), K4 (bf16x3_binmax.cu), K5 (cert_fold_binmax.cu) and K6
   (bf16_binmax.cu) against their plain torch versions at d = 768, b = 256
   and 70 (the sm90 kernels also 1 and 600), 2M rows in 1024-row chunks with
   half of them pruned, every metric
   and Gt / Lt / Eq filters, over int8 / f32 rows and (K1, K3, K4, K5, K6)
   bfloat16 rows; K2's int32 dots bit for bit; the others against float64
   dots (K4 within the ``4 d 2^-24`` accumulation share of
   ``high_precision_bound``, K6 against the product of its bf16-rounded
   operands);
4. the main path at the bench's size: a 10M x 768 int8 store quantized on
   the device from seeded f32 rows, bench.py's price/version columns, the
   filter ``price < 50 & version >= 2`` (prunes half the chunks), pipelined
   ``collect_async`` batches of 256 Cosine queries with
   ``take(10, rerank_from=100)`` and ``resolve``, timed in PATH_ROUNDS
   rounds (median q/s, as are the bf16 paths of 4f and the f32 path of 6);
   every query certified and equal to an exact f32 filtered top-10; one
   round traced (K1's time per
   batch, the rest of the device time, the idle share); then K1 timed at
   these shapes against its plain version, a library yardstick and its
   bound, and again at b = 1, 64 and 512 (as K2 in 4u, K1, K6 and K4 over
   bf16 rows and K5 in 4f, K6 and K4 in 6); each kernel (all of them run on
   csrc/cert_scan_sm90.cuh: K1, K2, K3, K5, K6 and K4 over their row types)
   and its library call timed in K1_ROUNDS interleaved rounds (median and
   range);
   4u. bench.py's ``filtered_uncert`` on the same store
   (``certify=False``): K2 (s8 wgmma), recall@10 against the f32 truth,
   PATH_ROUNDS timed rounds (median q/s) and one traced round (K2's ms per
   batch, the rest of the device time, the idle share), K2 timed;
   4p. the row-sharded stores (``otters_tpu_torch.parallel``) on the card:
   (a) a ``rows=4`` mesh (the card listed four times; the real devices when
   there are several) and phase 4's f32 rows quantized slab by slab into
   four int8 shards (``materialize_int8_slabs_sharded``), the same columns,
   rerank source, filter and batches through ``build_sharded``: every query
   certified and equal to phase 4's truth, the pruned and evaluated chunks
   the host count, K1 launched once per shard and batch, PATH_ROUNDS timed
   rounds (median q/s beside the single-device main path's), one round
   traced (K1's ms per shard launch, the idle share) and the merge timed;
   (b) ``certify=False`` on the same store (K2 per shard), recall@10
   against the truth (``evaluate.mean_recall_at_k``); (c) a ``rows=2,
   batch=2`` mesh: the same answers as (a), every query certified; (d) a
   2M x 768 f32 store over ``rows=2``: K4 fast-exact per shard, equal to the
   exact truth; (e) ``ShardedVecStore`` over 1M x 768 f32 rows, equal to
   the exact top-10; (f) a 1M int8 store (``keep_host_f32``) saved as
   ``sharded-v1`` under the git-ignored ``chip_scratch/`` and loaded with
   and without a mesh: indices, scores bit for bit, flags and chunk counts
   equal; the directory's bytes, save and load seconds;
   4pm. a mesh across two processes on the card (``spawn`` workers, gloo
   between them, ``parallel.init_distributed(..., local_devices=[cuda:0,
   cuda:0])``, ``make_mesh(rows=4)``: two of 4p's four shards each), phase
   4's f32 tensor handed to both through CUDA IPC: the main path's store
   built by ``materialize_int8_slabs_sharded`` and ``build_sharded``, every
   query certified and equal to phase 4's truth, the pruned chunks the host
   count, the same answers on both processes, K1 twice a batch in each,
   no nvcc run and no ``aot`` compile in either (the parent built every
   library), PATH_ROUNDS timed rounds (median q/s beside 4p's and the
   single path's), one round traced in each process (K1's ms, the idle
   share), the exchange's calls and ms a batch; ``certify=False`` (K2 per
   shard, recall@10); 4p's 1M int8 store built by both and saved as
   ``sharded-v1`` (two manifests, ``process_count`` 2), loaded by the
   parent onto its one-process mesh and onto one device (scores bit for
   bit); a take-all of 4 queries over it (a stable sort, equal to the
   parent's). A worker that fails, disagrees or outlives its 300 s fails
   the run;
   4s. bench.py's full column mix (price / version, String ``category``,
   DateTime ``listed``): a second 10M x 768 int8 store ingested from the
   same f32 CUDA tensor (``with_vectors(tensor, n_rows=n)``, quantized slab
   by slab; its codes, norms and residuals equal phase 4's
   ``materialize_int8_slabs`` ingest bit for bit) with the device Bloom
   build (``OTTERS_BLOOM_DEVICE=1``, equal to the host build bit for bit);
   the ingest and both Bloom builds timed; ``precompile`` of the bench's
   two filters (count and seconds); then PATH_ROUNDS rounds of 8 pipelined
   batches of 256 certified Cosine ``string_eq`` queries (K1, median q/s)
   with no nvcc build and no plan / aot_key cache miss, every query
   certified and equal to the exact f32 top-10 of the rows it keeps, and
   one round traced;
   4m. the MetaStore lifecycle (``native.available()`` must hold: g++
   builds the host library). (a) On 4s's store, the extended string
   filters ``contains("_1")``, ``starts_with("cat_0")``, ``ends_with("7")``,
   ``fuzzy("cat_7", 1)`` and ``~contains("_1") & price < 50``: the cold
   hostmask timed (the column's arena pack once, then each filter's scan),
   PATH_ROUNDS rounds of 8 pipelined certified batches (median q/s), every
   query certified and equal to the exact f32 top-10 of the rows the filter
   keeps (the truth from Python's ``in`` / ``startswith`` / ``endswith`` and
   a plain Levenshtein on each category value), the pruned chunks equal to
   the chunks with no matching row, no new hostmask or plan miss after the
   warm-up, one round traced (K1's ms per batch, the idle share). (b)
   ``delete_rows`` of 100,000 seeded rows plus the first batch's exact
   top-10 under the bench filter, timed: no deleted row returned, every
   query certified and equal to the truth over the survivors, ``len``
   right. (c) 10M x 768 int8 stores over the bench columns sorted by price
   and Z-ordered over (price, version, listed), built from the f32 CUDA
   tensor (gathered slab by slab) with phase 4's ``fetch_vectors`` source
   (called with original ids): build seconds beside 4s's unsorted build,
   the pruned chunks equal to the host zonemap count over the permuted
   columns, original ids, certified and equal to phase 4's truth, median
   q/s of PATH_ROUNDS rounds, the peak memory. (d) At 1M x 768 (the append
   rebuild holds the f32 snapshot on the host twice, and the file holds it
   once): int8 and bf16 stores with ``keep_host_f32``, sorted by price, 1%
   deleted; an append of 10,000 rows (the survivors' codes and residuals
   bit for bit; certified answers equal to the truth over survivors and
   appended rows); 1% deleted again, ``save`` to a file under ``build/``
   and ``load`` onto the default device: the same indices, scores bit for
   bit, ``certified`` flags, chunk counts and cert hints; the file's size,
   save and load seconds; a 1M f32 ``VecStore`` (K4) round-tripped the same
   way. One JSON line of these numbers with the card's name and power limit
   and the phase's seconds;
   4f. bfloat16 storage: a 10M x 768 bf16 store made on the device from
   the same f32 rows (which stay the rerank source), the same columns,
   filter and batches; certified ``take(10, rerank_from=100)`` for Cosine
   (K1 over bf16 rows), Dot (K5) and Euclid take-min (K5), every query
   certified and equal to the exact f32 filtered top-10; uncertified
   Cosine ``take(10)`` (K4 over bf16 rows, every check passing), equal to
   the exact top-10 of the stored values; the same at the store precisions
   "default" (8 batches) and "bf16" (one): K6 over bf16 rows, equal to the
   exact top-10 of the one-pass scores, recall@10 against the f32 truth
   reported; the uncertified Cosine and "default" rounds traced (scan ms
   per batch, the rest, the idle share); the five bf16-row modes timed
   (K1, K5, K6 and K4 over bf16 rows also at b = 1, 64 and 512);
   4g. 1M x 768 bf16 stores: exact ties in more bins than the fast mode
   examines (its check fails, K3 over bf16 rows reruns) and Dot / Euclid
   near-ties that make the certificate widen on K5;
   4b. adversarial near-ties (1M x 768) that make the certificate widen
   through the fused kernel and past it into the scan program;
   4d. depths: 250,000-row stores at d = 100 (stored as 112) and d = 2,048
   through MetaStore (certified int8 Cosine on K1, certified bf16 Dot on
   K5, precision "default" over f32 rows on K6 and over bf16 rows on
   K6-bf16, uncertified f32 Cosine on K4, uncertified bf16 Cosine on
   K4-bf16, and uncertified int8 on K2), each equal to its exact truth; at
   2,048 K1, K5, K6, K6-bf16 and K4-bf16 run their deep-row plan and K4 its
   streamed one, and K2 runs its kernel at d = 3,072 too (its resident
   int8 query block with two ring stages), each with nothing routed
   (``kernel_takes.routed``); the seven modes against their plain versions
   at each depth;
   4w. the split plan at ``openai5m.f1p``'s shape: 5M bf16 rows of depth
   1,536 (rounded from f32, with residuals), half the chunks dead;
   K1-bf16 (Cosine, and Gt), K5 (Dot, Euclid) and K6-bf16 (Cosine, Euclid)
   through their wrappers at b = 256 and 600 against their plain versions,
   each launch counted on ``split_launches`` (zeroed before it), then each
   timed at b = 256 beside its library call and its bound;
5. the twin of examples/demo.py on the card;
   5e. the twins of examples/async_serving.py, catalog.py,
   certified_search.py and multichip.py (``otters_tpu_torch.examples``) at
   their default sizes, each with its checks (multichip over the card
   listed four times, ``rows=2, batch=2``);
6. bench.py's exact-f32 section: a 4M x 768 f32 store built on the device,
   the same columns and filter, pipelined ``take(10)`` batches of 256
   Cosine queries through the verified fast-exact K4 (every check passes)
   in PATH_ROUNDS timed rounds and one traced round (K4's ms per batch,
   the rest, the idle share), one Dot and one Euclid batch, each equal to
   the exact f32 truth; the same 8 batches at the store precision
   "default" through K6 over f32 rows, equal to the exact top-10 of the
   one-pass scores; K4, K3 and K6 timed at these shapes;
   6t. take-all on the same store: ``collect()`` with no ``take`` for 16
   Cosine queries under the bench's filter (the windowed host collection),
   equal to a stable sort of the filtered f32 score matrix;
   6b. exact ties copied into more bins than the fast mode examines: its
   check fails and K3 reruns, equal to the truth; a Dot ``vec_filter(Eq)``
   and a ``take(200)`` reach K3 directly;
   6v. the VPU metrics (Manhattan, Hamming, Jaccard; plain torch programs,
   no kernel of their own): a 4M x 768 store of integer rows 0..3 made on
   the card, f32 (the tensor adopted with no copy) and bf16, the phase 4s
   columns, filtered by ``category`` so that every odd 8192-row tile is
   dead: the pruned scan evaluates exactly half the tiles; one batch of 64
   per metric and storage, ``take(10)`` and ``take(10, rerank_from=100)``,
   equal to the exact float64 truth; 4 pipelined batches of 256 Manhattan
   queries timed pruned and unfiltered (q/s); a VecStore Manhattan query
   over 1M rows;
7. VecStore at 1M x 768: f32 and bf16 storage (K4) and int8 storage
   (K2), each equal to the exact top-10 of its storage; a windowed
   take-all of 1.2M results equal to a stable sort of the score matrix;
   7f. the on-card differential fuzz (``otters_tpu_torch.differential_fuzz``,
   the port of scripts/tpu_differential_fuzz.py): trials drawn from seed 7
   in the script's space (600k or 1M rows, d 64-768, b 1-256, k 5-100,
   chunks of 512-4096 rows, int8 or f32) until 8 of fused size ran, b = 8
   and chunks of 1000 among them, then a tie trial (rows copied from a few
   vectors) whose fast check fails; each through the kernels and again
   under ``OTTERS_DISABLE_PALLAS`` (the scan programs), equal within the
   script's tolerances; a fused-size trial launched its kernel in the first
   run (the tie trial K4 then K3) and none in the second; the direct-size
   trials are counted apart; each trial logged;
8. the three profiling probes (``otters_tpu_torch.profile_variants``,
   csrc/profile_probes.cu) at the shapes of
   scripts/kernel_profile_variants.py: each run by the module's timing
   entry, held against its plain version and timed beside a library
   yardstick and its bound (all three on the Hopper scan, each in K1_ROUNDS
   rounds interleaved with its library call); ``k_mm`` may not beat its
   FFMA bound.

Phases 4, 4s, 4m and 6 also trace one pipelined round with torch.profiler (device
time by kernel, the device's busy share). Every path sets the launch
counts to 0 before it runs and asserts that its kernel launched (the VPU
metrics of 6v run no kernel of their own). The script
prints the kernels JSON line and the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROWS = 10_000_000  # the bench's store (bench.py:38)
D = 768
B = 256
CHUNK = 1024
K = 10
K_WIDE = 100
BATCHES = 8
SLAB = 500_000
KERNEL_ROWS = 2_000_000  # the kernel phase's stores
F32_ROWS = 4_000_000  # bench.py's exact-f32 section (bench.py:10-11,39)
NEAR_ROWS = 1_000_000
VEC_ROWS = 1_000_000  # bench.py's 1M f32 section, through VecStore
N_DUP = 60  # bins holding copies of the tied row: more than 4k = 40
TAKE_ALL_B = 16  # queries of the take-all batches
K1_WIDE_B = 600  # K1's widest kernel-phase batch: ten query blocks, the last one partial
K1_ROUNDS = 7  # interleaved timing rounds of an sm90 kernel and its library call
# timed rounds of the main path and the bf16 paths (one round is ~50 ms of
# wall, so a host stall can halve one round's q/s): the median, every
# round logged
PATH_ROUNDS = 3
# the kernels on csrc/cert_scan_sm90.cuh
ROUND_MODES = ("K1", "K1-bf16", "K2", "K3", "K3-bf16", "K5", "K6", "K6-bf16", "K4", "K4-bf16")
SWEEP_B = (1, 64, 512)  # their other timed batch sizes, on their paths' stores
DEPTH_ROWS = 250_000  # the depth phase's stores (with 256 queries, fused-size)
DEPTHS = (100, 2048)  # stored as 112; past every resident query block
# K2 only: the deepest rows its resident int8 query block holds beside two
# ring stages
DEPTH_K2 = 3072
# the split plan's phase: openai5m.f1p's store (K1-bf16, K5 and K6-bf16
# keep the head of the query block resident and stream its tail)
SPLIT_ROWS = 5_000_000
SPLIT_D = 1536
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 1234


_LOG_PREFIX = ""  # a 4pm worker's rank


def log(msg: str) -> None:
    print(_LOG_PREFIX + msg, flush=True)


PHASE_MEMORY = {}  # phase -> device GB (held at its start, its peak, held at its end)


@contextlib.contextmanager
def phase(name: str):
    """Log a phase's start and end, its seconds and its device memory (the
    run has a card): the allocator's peak counter is reset at the start, so
    each phase's peak is its own (``PHASE_MEMORY``)."""
    import torch

    t0 = time.perf_counter()
    log(f"== {name}")
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated() / 1e9
    yield
    peak, end = torch.cuda.max_memory_allocated() / 1e9, torch.cuda.memory_allocated() / 1e9
    PHASE_MEMORY[name.split()[0]] = (start, peak, end)
    log(f"== {name}: done in {time.perf_counter() - t0:.2f} s; device memory {start:.1f} GB "
        f"at its start, peak {peak:.1f}, {end:.1f} at its end")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rows_alive(chunk_mask, n_pad):
    """[n_chunks] chunk mask -> [n_pad] row mask (padding rows dead)."""
    import torch

    alive = torch.repeat_interleave(chunk_mask, CHUNK)[:n_pad]
    if alive.shape[0] < n_pad:
        alive = torch.cat([alive, alive.new_zeros(n_pad - alive.shape[0])])
    return alive


CERT_MODES = ("K1", "K1-bf16", "K5")  # the certified scans
# K1's kernels for the profiler: cert_cos_binmax_kernel, and over int8 rows
# at more than one query block cert_cos_binmax_pair_kernel
K1_SCAN = "cert_cos_binmax"
# the kernel names of the uncertified scans on the Hopper scan, for the
# profiler (K4 over f32 rows on the exact f32 path, the others on the bf16
# store's paths); K4's matches both its plans' kernels, bf16x3_binmax_sm90_kernel
# and, at b > 64, bf16x3_binmax_pair_kernel
SCAN_NAMES = {"K4": "bf16x3_binmax", "K4-bf16": "bf16x3_binmax_sm90_kernel",
              "K6-bf16": "bf16_binmax_sm90_kernel", "K2": "int8_binmax_sm90_kernel"}


def mode_inputs(mode, dv, queries, chunk_mask, thr=0.0, metric=None, cmp=None):
    """A kernel's operands for a store, a query batch and a chunk mask,
    built the way the fused path builds them: the certified scans (K1, K5)
    through ``fused_topk.cert_scan`` (bf16-rounded queries, the certificate
    terms of ``metric``, the filter loosened), K2 quantizes the queries,
    K3 / K4 take them in f32, K6 rounded to bf16 with their f32 norms."""
    import torch

    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Metric

    n_pad = dv.vectors.shape[0]
    dev = queries.device
    alive = ft.bins_alive_from_chunk_mask(chunk_mask, CHUNK, n_pad)
    if mode in CERT_MODES:
        metric = metric or (Metric.DotProduct if mode == "K5" else Metric.Cosine)
        return ft.cert_scan(
            mode, dv.vectors, dv.norms_sq, dv.inv_norms, dv.valid, queries,
            rows_alive(chunk_mask, n_pad), torch.tensor(float(thr), device=dev), alive,
            metric=metric, cmp=cmp, resid=dv.resid,
        ).ops
    surv, n_surv = ft.survivor_bins(alive)
    rmask = (dv.valid & rows_alive(chunk_mask, n_pad)).float()
    q_ok = torch.ones(queries.shape[0], device=dev)
    thr_t = torch.full((1,), float(thr), device=dev)
    q = sc._quantize_rows_int8(queries.float())[0] if mode == "K2" else queries.float()
    q_sq, q_inv = sc._query_norms(q.float())
    if mode.startswith("K6"):
        q = q.bfloat16()
    return [q.contiguous(), dv.vectors, dv.inv_norms, dv.norms_sq, rmask, q_inv, q_sq,
            q_ok, thr_t, surv, n_surv]


def launch(mode, args, metric, take_min=False, cmp=None):
    """The kernel's wrapper on ``args`` (K1 is certified cosine only)."""
    from otters_tpu_torch.ops import fused_topk as ft

    if mode in ("K1", "K1-bf16"):
        return ft.KERNELS[mode](*args, cmp)
    return ft.KERNELS[mode](*args, metric, take_min, cmp)


def plain(mode, args, metric, take_min=False, cmp=None):
    """The kernel's plain torch version on ``args``."""
    from otters_tpu_torch.ops import fused_topk as ft

    if mode in ("K1", "K1-bf16"):
        return ft.cert_cos_binmax_plain(*args, cmp)
    if mode == "K5":
        return ft.cert_fold_binmax_plain(*args, metric=metric, take_min=take_min, cmp=cmp)
    return ft.binmax_plain(mode, *args, metric=metric, take_min=take_min, cmp=cmp)


def mode_tol(mode, args, metric, want):
    """Kernel vs plain tolerance on the bin maxima ``want``. K1: the
    certificate's ``mixed_cert_eps(d)``. K2: the int32 dots are exact in
    both, so 4 ulps of the epilogue. K3: the two sum in other orders,
    d 2^-24 |q| |v|. K4: both are bf16x3 sums within
    ``high_precision_bound(d)`` |q| |v| of the exact dot. K5: exact bf16
    products summed in f32 in other orders, 4 d 2^-24 |qh| |v|. K6: the
    same exact bf16 products summed in f32 in other orders, d 2^-24 |qh|
    |vh| (|vh| <= |v| (1 + 2^-8)). Dot / Euclid scale by max |q| max |v|
    (Euclid twice, for its -2 dot), plus 4 ulps (of the folded key for
    K5)."""
    import numpy as np

    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Metric

    d = args[0].shape[1]
    if mode in ("K1", "K1-bf16"):
        return sc.mixed_cert_eps(d)
    ulps = 4 * float(np.spacing(np.float32(float(want.abs().max()))))
    if mode == "K2":
        return ulps
    if mode == "K5":
        base = 4 * d * 2.0**-24
    elif mode.startswith(("K3", "K6")):
        base = d * 2.0**-24
    else:
        base = sc.high_precision_bound(d)
    if metric is Metric.Cosine:
        return base + ulps
    scale = float(args[0].float().norm(dim=1).max()) * float(args[3].max().sqrt())
    scale *= 1 + 2.0**-7 if mode.startswith("K6") else 1.0
    return base * scale * (2.0 if metric is Metric.Euclidean else 1.0) + ulps


def compare_mode(mode, args, metric, take_min=False, cmp=None):
    """Kernel vs plain on the same operands -> (max abs error, tolerance),
    checked."""
    import torch

    got = launch(mode, args, metric, take_min, cmp)
    want = plain(mode, args, metric, take_min, cmp)
    sync(got.device)
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w), f"{mode}: -inf pattern differs from the plain version"
    assert bool(fin_w.any()) and not bool(fin_w.all()), f"{mode}: degenerate test pattern"
    err = float((got[fin_w] - want[fin_w]).abs().max())
    tol = mode_tol(mode, args, metric, want[fin_w])
    assert err <= tol, f"{mode} {metric} {cmp}: max |kernel - plain| = {err} > {tol}"
    return err, tol


def one_row_per_bin(mode, args, salt):
    """(live bins, one row of each, the operands that make each bin max
    exactly that row's accumulated dot: unit norms, no lane or certificate
    term, no filter, and the Dot metric for K2 - K5)."""
    import torch

    from otters_tpu_torch.ops import fused_topk as ft

    q, v, surv, n_surv = args[0], args[1], args[-2], args[-1]
    n_pad, dev, b = v.shape[0], q.device, q.shape[0]
    live = surv[: int(n_surv[0])].long()
    rows = live * ft.BIN + (live * 37 + salt) % ft.BIN
    rmask = torch.zeros(n_pad, device=dev)
    rmask[rows] = 1.0
    ones_n, ones_b = torch.ones(n_pad, device=dev), torch.ones(b, device=dev)
    zero_n, zero_b, zero_1 = (torch.zeros(m, device=dev) for m in (n_pad, b, 1))
    if mode in ("K1", "K1-bf16"):
        ops = [q, v, ones_n, rmask, zero_n, ones_b, ones_b, zero_1, surv, n_surv]
    elif mode == "K5":
        ops = [q, v, ones_n, ones_n, rmask, zero_n, zero_n, ones_b, zero_b, ones_b,
               zero_b, zero_b, zero_b, zero_1, surv, n_surv]
    else:
        ops = [q, v, ones_n, ones_n, rmask, ones_b, zero_b, ones_b, zero_1, surv, n_surv]
    return live, rows, ops


def accumulation_error(mode, args):
    """K1 / K3 / K4 / K5 / K6 dots against float64 over one unmasked row
    per live bin, twice -> (worst |dot - ref| / (|q| |v|) with ref the
    float64 value of what the mode computes: the exact dot for K1 / K5 (of
    their bf16 queries) and K3, the sum of the split products for K4 (over
    bf16 rows the low plane is 0), the product of the bf16-rounded rows for
    K6; the same against the exact dot)."""
    from otters_tpu_torch.types import Metric

    worst_ref = worst_true = 0.0
    for salt in (11, 301):
        live, rows, ops = one_row_per_bin(mode, args, salt)
        got = launch(mode, ops, Metric.DotProduct)[live].double()  # [n_live, b]
        q, vr = args[0], args[1][rows]
        exact = vr.double() @ q.double().T
        if mode.startswith("K4"):
            qh, vh = q.bfloat16(), vr.bfloat16()
            ql = (q - qh.float()).bfloat16().double()
            vl = (vr.float() - vh.float()).bfloat16().double()
            qh, vh = qh.double(), vh.double()
            ref = vh @ qh.T + vl @ qh.T + vh @ ql.T
        elif mode.startswith("K6"):
            ref = vr.bfloat16().double() @ q.double().T
        else:
            ref = exact
        scale = vr.double().norm(dim=1)[:, None] * q.double().norm(dim=1)[None, :]
        nz = scale > 0
        worst_ref = max(worst_ref, float(((got - ref).abs()[nz] / scale[nz]).max()))
        worst_true = max(worst_true, float(((got - exact).abs()[nz] / scale[nz]).max()))
    return worst_ref, worst_true


def kernel_phase(torch, dev):
    """Every kernel vs its plain version at d = 768, b = 256 and 70, 2M rows
    (int8, f32 and bf16 stores of the same rows) with half the chunks dead:
    every metric, Gt / Lt / Eq filters, nothing alive; K2's dots bit for
    bit; the others against float64 (K1, K3, K5 within d 2^-24, K4 within
    its bound's 4 d 2^-24 share) -> (worst error over tolerance per kernel,
    accumulation errors)."""
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Cmp, Metric

    n = KERNEL_ROWS
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    f32 = torch.zeros((sc.pad_rows(n), D), device=dev)
    f32[:n] = torch.randn((n, D), generator=g, device=dev)
    dv8 = sc.materialize_int8_slabs(lambda s, r: f32[s : s + r], n, D, SLAB, device=dev)
    dvf = sc.materialize_f32_slabs(lambda s, r: f32[s : s + r], n, D, SLAB, device=dev)
    dvb = sc.materialize_from_device(f32, n_valid=n, dtype=torch.bfloat16)
    del f32
    chunk_mask = torch.arange(-(-n // CHUNK), device=dev) % 2 == 1
    all_queries = torch.randn((K1_WIDE_B, D), generator=g, device=dev)
    queries = all_queries[:B]
    ratio = dict.fromkeys(ft.KERNELS, 0.0)
    cases = [
        ("K1", dv8, Metric.Cosine, False, None, 0.0, B),
        ("K1", dv8, Metric.Cosine, False, Cmp.Gt, 0.05, 70),
        ("K1", dv8, Metric.Cosine, False, None, 0.0, 1),
        ("K1", dv8, Metric.Cosine, False, Cmp.Gte, 0.05, K1_WIDE_B),
        ("K2", dv8, Metric.Cosine, False, None, 0.0, B),
        ("K2", dv8, Metric.Cosine, False, Cmp.Gt, 0.05, 70),
        ("K2", dv8, Metric.Cosine, True, Cmp.Lte, -0.05, B),
        ("K2", dv8, Metric.DotProduct, False, None, 0.0, 1),
        ("K2", dv8, Metric.Euclidean, True, None, 0.0, K1_WIDE_B),
        ("K3", dvf, Metric.Cosine, False, Cmp.Gte, 0.05, B),
        ("K3", dvf, Metric.DotProduct, False, None, 0.0, 70),
        ("K3", dvf, Metric.Euclidean, True, Cmp.Lt, 1450.0, B),
        ("K3", dvf, Metric.Cosine, False, None, 0.0, 1),
        ("K3", dvf, Metric.DotProduct, False, Cmp.Gt, 2.0, K1_WIDE_B),
        ("K4", dvf, Metric.Cosine, False, None, 0.0, B),
        ("K4", dvf, Metric.DotProduct, False, Cmp.Gt, 2.0, 70),
        ("K4", dvf, Metric.Euclidean, True, None, 0.0, B),
        ("K4", dvf, Metric.Cosine, False, Cmp.Gte, 0.05, 1),
        ("K4", dvf, Metric.Euclidean, True, Cmp.Lte, 1450.0, K1_WIDE_B),
        ("K1-bf16", dvb, Metric.Cosine, False, None, 0.0, B),
        ("K1-bf16", dvb, Metric.Cosine, False, Cmp.Gt, 0.05, 70),
        ("K1-bf16", dvb, Metric.Cosine, False, Cmp.Gt, 0.05, 1),
        ("K1-bf16", dvb, Metric.Cosine, False, None, 0.0, K1_WIDE_B),
        ("K5", dvb, Metric.DotProduct, False, None, 0.0, B),
        ("K5", dvb, Metric.DotProduct, False, Cmp.Gt, 2.0, 70),
        ("K5", dvb, Metric.Euclidean, True, None, 0.0, B),
        ("K5", dvb, Metric.Euclidean, True, Cmp.Lt, 1450.0, 70),
        ("K5", dvb, Metric.DotProduct, False, Cmp.Gte, 2.0, 1),
        ("K5", dvb, Metric.Euclidean, True, Cmp.Lte, 1450.0, K1_WIDE_B),
        ("K3-bf16", dvb, Metric.Cosine, False, Cmp.Gte, 0.05, B),
        ("K3-bf16", dvb, Metric.Euclidean, True, Cmp.Lt, 1450.0, 70),
        ("K3-bf16", dvb, Metric.DotProduct, False, None, 0.0, 1),
        ("K3-bf16", dvb, Metric.Cosine, False, Cmp.Gt, 0.05, K1_WIDE_B),
        ("K4-bf16", dvb, Metric.Cosine, False, None, 0.0, B),
        ("K4-bf16", dvb, Metric.DotProduct, False, Cmp.Gt, 2.0, 70),
        ("K4-bf16", dvb, Metric.Euclidean, True, None, 0.0, B),
        ("K4-bf16", dvb, Metric.Cosine, False, Cmp.Gte, 0.05, 1),
        ("K4-bf16", dvb, Metric.Euclidean, True, Cmp.Lte, 1450.0, K1_WIDE_B),
        ("K6", dvf, Metric.Cosine, False, Cmp.Gt, 0.05, B),
        ("K6", dvf, Metric.DotProduct, False, None, 0.0, 70),
        ("K6", dvf, Metric.Euclidean, True, Cmp.Lt, 1450.0, B),
        ("K6", dvf, Metric.Cosine, False, Cmp.Lte, 0.05, 1),
        ("K6", dvf, Metric.DotProduct, False, Cmp.Gte, 2.0, K1_WIDE_B),
        ("K6-bf16", dvb, Metric.Cosine, False, None, 0.0, 70),
        ("K6-bf16", dvb, Metric.DotProduct, False, Cmp.Gt, 2.0, B),
        ("K6-bf16", dvb, Metric.Euclidean, True, Cmp.Lt, 1450.0, 70),
        ("K6-bf16", dvb, Metric.Cosine, False, Cmp.Lte, 0.05, 1),
        ("K6-bf16", dvb, Metric.DotProduct, False, Cmp.Gte, 2.0, K1_WIDE_B),
    ]
    for mode, dv, metric, take_min, cmp, thr, b in cases:
        args = mode_inputs(mode, dv, all_queries[:b], chunk_mask, thr, metric, cmp)
        err, tol = compare_mode(mode, args, metric, take_min, cmp)
        ratio[mode] = max(ratio[mode], err / tol)
        log(f"{mode} vs plain ({n} rows, b={b}, {metric.value}"
            f"{' take-min' if take_min else ''}, {cmp.value if cmp else 'no'} filter): "
            f"max_abs_err={err:.3e} tol={tol:.3e} err/tol={err / tol:.3f}")
    # Eq needs scores that both versions compute exactly: integer rows and
    # queries, Dot metric
    ni = 200_000
    ints = torch.zeros((sc.pad_rows(ni), D), device=dev)
    ints[:ni] = torch.randint(-2, 3, (ni, D), generator=g, device=dev).float()
    dvi = sc.materialize_f32_slabs(lambda s, r: ints[s : s + r], ni, D, SLAB, device=dev)
    qi = torch.randint(-2, 3, (64, D), generator=g, device=dev).float()
    thr = float(qi[0] @ ints[777])
    args = mode_inputs("K3", dvi, qi, torch.arange(-(-ni // CHUNK), device=dev) % 2 == 1, thr)
    err, tol = compare_mode("K3", args, Metric.DotProduct, False, Cmp.Eq)
    ratio["K3"] = max(ratio["K3"], err / tol)
    log(f"K3 vs plain ({ni} integer rows, b=64, dot_product, Eq {thr}): max_abs_err={err:.3e} "
        f"tol={tol:.3e} err/tol={err / tol:.3f}")
    del ints, dvi, args
    # nothing alive: every block returns at once
    for mode, dv in (("K1", dv8), ("K2", dv8), ("K3", dvf), ("K4", dvf), ("K6", dvf),
                     ("K1-bf16", dvb), ("K3-bf16", dvb), ("K4-bf16", dvb), ("K5", dvb),
                     ("K6-bf16", dvb)):
        metric = Metric.DotProduct if mode == "K5" else Metric.Cosine
        args = mode_inputs(mode, dv, queries, torch.zeros_like(chunk_mask), metric=metric)
        out0 = launch(mode, args, metric)
        sync(dev)
        assert bool(torch.isneginf(out0).all()), f"{mode}: n_surv = 0 must leave every bin -inf"
    # K2's int32 dots are those of an exact integer product, bit for bit
    args = mode_inputs("K2", dv8, queries, chunk_mask)
    live, rows, ops = one_row_per_bin("K2", args, 11)
    got = launch("K2", ops, Metric.DotProduct)[live].double()
    exact = dv8.vectors[rows].double() @ args[0].double().T  # |dot| < 2^53: exact
    assert torch.equal(got, exact), "K2: int32 dots differ from the exact integer product"
    log(f"K2 dots: {got.numel()} equal to the exact integer product bit for bit")
    acc = {}
    gamma = D * 2.0**-24
    for mode, dv in (("K1", dv8), ("K3", dvf), ("K4", dvf), ("K6", dvf), ("K1-bf16", dvb),
                     ("K5", dvb), ("K3-bf16", dvb), ("K4-bf16", dvb), ("K6-bf16", dvb)):
        args = mode_inputs(mode, dv, queries, chunk_mask)
        ref_err, true_err = accumulation_error(mode, args)
        acc[mode] = ref_err
        if mode.startswith("K4"):
            lim, hpb = 4 * gamma, sc.high_precision_bound(D)
            log(f"{mode} accumulation error: max |dot - f64(split products)| / (|q||v|) = "
                f"{ref_err:.3e} (the bound's 4*d*2^-24 share = {lim:.3e}); vs the exact "
                f"dot {true_err:.3e} (high_precision_bound = {hpb:.3e})")
            assert ref_err <= lim, f"{mode} accumulation error exceeds the bound's share"
            assert true_err <= hpb, f"{mode} error exceeds high_precision_bound(d)"
        else:
            what = "f64(bf16-rounded operands)" if mode.startswith("K6") else "f64"
            log(f"{mode} accumulation error: max |dot - {what}| / (|q||v|) = {ref_err:.3e} "
                f"(d*2^-24 = {gamma:.3e}); vs the exact dot {true_err:.3e}")
            assert ref_err <= gamma, f"{mode} accumulation error exceeds d*2^-24"
    del dv8, dvf, dvb, args, ops
    torch.cuda.empty_cache()
    return ratio, acc


def exact_topk(torch, vectors, n, queries, metric, k, *, take_min=False, row_ok=None,
               one_pass=False):
    """The exact global top-k over every (query, row) pair of ``vectors[:n]``,
    the port's score formulas in full f32 (TF32 off) with the row norms
    taken from the rows, slab by slab -> (rows, scores), best first.
    ``row_ok(rows)`` masks rows out (the filter); an int8 store's dots are
    exact in f32 (|dot| < 2^24). ``one_pass``: the dots of the store
    precisions "default" / "bf16", bf16-rounded queries x rows rounded to
    bf16 (exact products, an f32 matmul), the norms still the unrounded
    queries' and the stored rows'."""
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    q = queries.float()
    q_sq, q_inv = sc._query_norms(q)
    keys, rows, scores = [], [], []
    for s in range(0, n, SLAB):
        e = min(n, s + SLAB)
        v = vectors[s:e].float()
        nsq, inv = sc._query_norms(v)
        dots = sc.one_pass_dots(q, vectors[s:e]) if one_pass else q @ v.T
        sc_ = ft._scores(dots, q_inv[:, None], q_sq[:, None], inv[None, :], nsq[None, :],
                         metric)
        key = -sc_ if take_min else sc_
        if row_ok is not None:
            key = torch.where(row_ok(torch.arange(s, e, device=q.device))[None, :], key,
                              float("-inf"))
        top = torch.topk(key.reshape(-1), min(k, key.numel()))
        keys.append(top.values)
        rows.append(top.indices % (e - s) + s)
        scores.append(sc_.reshape(-1)[top.indices])
    top = torch.topk(torch.cat(keys), k)
    return torch.cat(rows)[top.indices].tolist(), torch.cat(scores)[top.indices].tolist()


def odd_chunks(rows):
    """The rows the bench's filter keeps (its columns fail on even chunks)."""
    return (rows // CHUNK) % 2 == 1




def score_tol(metric, queries, dv):
    """Two f32 sums of one dot in other orders differ by <= 2 d 2^-24 |q| |v|
    (Cosine: |q| |v| = 1 after the norms), plus the epilogue's ulps."""
    from otters_tpu_torch.types import Metric

    scale = 1.0
    if metric is not Metric.Cosine:
        scale = float(queries.float().norm(dim=1).max()) * float(dv.norms_sq.max().sqrt())
        scale *= 2.0 if metric is Metric.Euclidean else 1.0
    return 2 * queries.shape[1] * 2.0**-24 * scale


def check_topk(label, rows, scores, want_rows, want_scores, tol):
    """The port's top-k equals the exact truth: the same rows (a multiset: a
    row can win for two queries) except where a row ties the k-th score
    within ``tol`` (two f32 sums of one dot may round apart), and the scores
    rank for rank within ``tol``. -> (boundary ties, max score error)."""
    from collections import Counter

    assert len(rows) == len(want_rows), f"{label}: {len(rows)} results, truth {len(want_rows)}"
    kth = want_scores[-1]
    got_s, want_s = dict(zip(rows, scores)), dict(zip(want_rows, want_scores))
    got_c, want_c = Counter(rows), Counter(want_rows)
    diff = list(((got_c - want_c) + (want_c - got_c)).elements())
    for r in diff:
        s = got_s[r] if r in got_s else want_s[r]
        assert abs(s - kth) <= tol, (
            f"{label}: row {r} (score {s}) is not in both top-k; the k-th truth score is {kth}"
        )
    err = max(abs(a - b) for a, b in zip(sorted(scores), sorted(want_scores)))
    assert err <= tol, f"{label}: scores differ from the truth by {err} > {tol}"
    return len(diff), err


class GcClock:
    """The time Python's cyclic garbage collector takes while it is on:
    the collections of each generation and their milliseconds, read from
    ``gc.callbacks`` (a stall on the host shows here when the collector
    walks large containers, e.g. a 10M-string column)."""

    def __init__(self):
        self.ms = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = None

    def _hook(self, phase_, info):
        if phase_ == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms[info["generation"]] += (time.perf_counter() - self._t0) * 1e3
            self.count[info["generation"]] += 1
            self._t0 = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._hook)

    def __str__(self):
        return (f"gc {sum(self.count)} collections ({self.count[2]} full), "
                f"{sum(self.ms):.1f} ms ({self.ms[2]:.1f} full)")


def timed_rounds(torch, dev, submit, read_launches):
    """PATH_ROUNDS timed rounds of a path: each sets every launch count to
    0, submits its pipelined batches (``submit()`` -> pendings), resolves
    them and synchronises -> (the last round's pendings, results and
    launch counts, the median q/s, every round's q/s). Each round's time in
    the garbage collector is logged."""
    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft

    rounds, gcs = [], []
    for _ in range(PATH_ROUNDS):
        ft.reset_launches()
        sync(dev)
        with GcClock() as gc_clock:
            t0 = time.perf_counter()
            pend = submit()
            results = tx.resolve(pend)
            sync(dev)
            elapsed = time.perf_counter() - t0
        rounds.append(len(pend) * B / elapsed)
        gcs.append(f"{elapsed * 1e3:.1f} ms, {gc_clock}")
    log(f"  rounds: {'; '.join(gcs)}")
    return pend, results, read_launches(), statistics.median(rounds), rounds


def counts():
    from otters_tpu_torch.ops import fused_topk as ft

    return {m: fn.launches for m, fn in ft.KERNELS.items()}


def price_version_columns(n):
    """bench.py's columns (bench.py:236-263, without the strings)."""
    import numpy as np

    from otters_tpu_torch import Column, DataType

    idx = np.arange(n)
    even = (idx // CHUNK) % 2 == 0
    price = np.where(even, 80.0 + (idx % 20), 10.0 + (idx % 20)).astype(np.float64)
    version = np.where(even, 1, 3).astype(np.int32)
    return [
        Column("price", DataType.Float64).from_values(price),
        Column("version", DataType.Int32).from_values(version),
    ]


def main_path(torch, dev, n, card=""):
    """The bench's workload on the port, through the public API."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_pad = sc.pad_rows(n)
    t0 = time.perf_counter()
    f32 = torch.empty((n_pad, D), device=dev)
    for s in range(0, n, SLAB):
        r = min(SLAB, n - s)
        f32[s : s + r] = torch.randn((r, D), generator=g, device=dev)
    f32[n:] = 0.0
    dv8 = sc.materialize_int8_slabs(lambda s, r: f32[s : s + r], n, D, SLAB, device=dev)
    sync(dev)
    synth_s = time.perf_counter() - t0
    log(f"{n} x {D} f32 synthesis + int8 quantization: {synth_s:.2f} s "
        f"(f32 {f32.nbytes / 1e9:.1f} GB, int8 {dv8.vectors.nbytes / 1e9:.1f} GB)")

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    t0 = time.perf_counter()
    store = (
        tx.MetaStore.from_columns(price_version_columns(n))
        .with_vectors(dv8, n_rows=n)
        .with_chunk_size(CHUNK)
        .with_rerank_source(fetch_vectors=fetch)
        .with_device(dev)
        .build()
    )
    sync(dev)
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s, chunks={store.n_chunks()}")

    def pending(q):
        return (
            store.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
            .take(K, rerank_from=K_WIDE).collect_async()
        )

    batches = [torch.randn((B, D), generator=g, device=dev) for _ in range(BATCHES)]
    warm = torch.randn((B, D), generator=g, device=dev)
    small = torch.randn((32, D), generator=g, device=dev)
    # warm-up: builds nothing new, but pays first-call costs and lets the
    # certificate learn its width for this plan shape
    t0 = time.perf_counter()
    warm_p = pending(warm)
    tx.resolve([warm_p])
    log(f"warm-up batch: {time.perf_counter() - t0:.2f} s, "
        f"scan_k_wide={warm_p.stats().scan_k_wide}")

    pend, results, launches, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches],
        lambda: ft.cert_cos_binmax.launches)
    log(f"main path: {BATCHES} pipelined batches of {B}, {PATH_ROUNDS} rounds: "
        f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, "
        f"median {qps:.1f} q/s (build {build_s:.2f} s) on {card}; K1 launches {launches}")
    if dev.type == "cuda":
        assert launches >= BATCHES, f"K1 launched {launches} times for {BATCHES} scans"
    for i, p in enumerate(pend):
        st = p.stats()
        assert st.certified is True, f"batch {i} not certified: {st}"
        # the even chunks are pruned: half of them (n_chunks // 2 at 10M)
        assert st.pruned_chunks == (store.n_chunks() + 1) // 2, f"batch {i}: {st}"
    small_res = pending(small).result()
    checked = 0
    truths = []
    for q, res in list(zip(batches, results)) + [(small, small_res)]:
        gt_rows, gt_scores = exact_topk(torch, f32, n, q, tx.Metric.Cosine, K,
                                        row_ok=odd_chunks)
        truths.append(gt_rows)
        assert sorted(res.indices) == sorted(gt_rows), (res.indices, gt_rows)
        want = dict(zip(gt_rows, gt_scores))
        err = max(abs(s - want[r]) for r, s in zip(res.indices, res.scores))
        assert err <= 1e-5, f"rerank score differs from the f32 truth by {err}"
        checked += q.shape[0]
    log(f"exact f32 ground truth: top-{K} equal for {checked} queries "
        f"({BATCHES} batches of {B} + one of 32)")
    prof = profile_batches(torch, pending, batches, K1_SCAN)
    stats = {"qps": qps, "qps_rounds": rounds, "build_s": build_s, "synth_s": synth_s,
             "launches": launches, "scan_k_wide": pend[-1].stats().scan_k_wide,
             "profile": prof}
    return store, f32, batches, truths[:BATCHES], stats


def bench_filter():
    import otters_tpu_torch as tx

    return tx.col("price").lt(50.0) & tx.col("version").gte(2)


def uncert_path(torch, store, batches, truths, card=""):
    """bench.py's ``filtered_uncert`` on the 10M int8 store: the same filter
    and batches, ``take(10, rerank_from=100, certify=False)``, so the scan
    is K2 (int8 queries x int8 rows, exact int32 dots) and the rerank exact
    f32; PATH_ROUNDS timed rounds (median q/s) and one traced round (K2's
    ms per batch, the rest of the device time, the idle share). Recall@10
    against the f32 truth is reported, not promised."""
    import otters_tpu_torch as tx

    def pending(q):
        return (
            store.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
            .take(K, rerank_from=K_WIDE, certify=False).collect_async()
        )

    dev = batches[0].device
    tx.resolve([pending(batches[-1])])  # warm-up
    pend, results, launched, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches], counts)
    hits = [len(set(res.indices) & set(gt)) / K for res, gt in zip(results, truths)]
    recall = sum(hits) / len(hits)
    log(f"filtered_uncert: {len(batches)} pipelined batches of {B}, {PATH_ROUNDS} rounds: "
        f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} q/s on {card}; "
        f"launches {launched}; recall@{K} vs the f32 truth {recall:.4f} (per batch {hits})")
    for i, p in enumerate(pend):
        st = p.stats()
        assert st.certified is None, f"batch {i}: an uncertified query reports {st.certified}"
        assert st.pruned_chunks == (store.n_chunks() + 1) // 2, f"batch {i}: {st}"
        assert len(results[i]) == K
    prof = None
    if dev.type == "cuda":
        assert launched["K2"] >= len(batches) and launched["K1"] == 0, launched
        prof = profile_batches(torch, pending, batches, SCAN_NAMES["K2"])
    assert recall > 0.5, f"filtered_uncert recall@{K} = {recall}"
    return {"qps": qps, "qps_rounds": rounds, "launches": launched["K2"], "recall": recall,
            "profile": prof}


# ---------------------------------------------------------------------------
# Phase 4p: the row-sharded stores over a mesh of devices
# ---------------------------------------------------------------------------

SHARD_F32_ROWS = 2_000_000  # 4p (d): the sharded exact f32 store
SHARD_VEC_ROWS = 1_000_000  # 4p (e): ShardedVecStore; (f): the saved store
SHARD_VEC_B = 16  # 4p (e): queries of the ShardedVecStore search


def mesh_devices(torch, dev, n):
    """``n`` mesh entries: the card listed ``n`` times, or the real devices
    in turn when there are several."""
    count = torch.cuda.device_count()
    if count > 1:
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


def f32_slabs(torch, f32, n):
    """``slab_fn(start, rows)`` over rows ``0 .. n`` of the seeded f32 rows,
    zero past ``n`` (the sharded geometry pads further than the tensor)."""

    def slab_fn(start, rows):
        end = min(start + rows, n)
        part = f32[start:end] if end > start else f32[:0]
        if part.shape[0] == rows:
            return part
        return torch.cat([part, part.new_zeros((rows - part.shape[0], f32.shape[1]))])

    return slab_fn


def sharded_store(torch, mesh, f32, n, fetch=None, storage="int8"):
    """A sharded store over rows ``0 .. n`` of the seeded f32 rows with the
    bench's price / version columns, built slab by slab into each shard ->
    (store, build seconds)."""
    import otters_tpu_torch as tx
    from otters_tpu_torch import parallel

    t0 = time.perf_counter()
    make = (parallel.materialize_int8_slabs_sharded if storage == "int8"
            else parallel.materialize_f32_slabs_sharded)
    dv = make(f32_slabs(torch, f32, n), n, D, SLAB, mesh, chunk_size=CHUNK)
    b = (tx.MetaStore.from_columns(price_version_columns(n)).with_vectors(dv, n_rows=n)
         .with_chunk_size(CHUNK))
    if fetch is not None:
        b = b.with_rerank_source(fetch_vectors=fetch)
    store = b.build_sharded(mesh)
    for d in {mesh.devices[r, 0] for r in range(mesh.shape["rows"])}:
        sync(d)
    return store, time.perf_counter() - t0


def merge_ms(torch, mesh, b, k):
    """The device time of the lead device's merge of one batch's partials:
    one k-sized (rows, scores, ok) partial per program of the mesh, merged
    by the stable top-k (``dist_query.merge_partials``)."""
    from otters_tpu_torch.parallel.dist_query import merge_partials

    dev = mesh.lead
    n_prog = mesh.shape["rows"] * mesh.shape["batch"]
    parts = [(torch.randint(0, 1 << 20, (k,), device=dev, dtype=torch.int32),
              torch.rand(k, device=dev), torch.ones(k, dtype=torch.bool, device=dev))
             for _ in range(n_prog)]

    def run():
        _, _, _, sel = merge_partials(parts, k, False, dev)
        return sel

    return time_ms(run, reps=20)


def sharded_phase(torch, dev, f32, batches, truths, main_qps, card):
    """Phase 4p: the row-sharded stores on the card -> their numbers.

    (a) the certified main path over a ``rows=4`` mesh (the card listed four
    times): phase 4's rows quantized slab by slab into four int8 shards,
    8 pipelined batches, every query certified and equal to phase 4's
    truth, K1 launched once per shard and batch, median q/s beside the
    single-device path's, one round traced; (b) ``certify=False`` on the
    same store (K2 per shard), recall@10; (c) a ``rows=2, batch=2`` mesh,
    the same answers as (a); (d) a 2M f32 store over ``rows=2`` (K4
    fast-exact per shard) equal to the exact truth; (e) ``ShardedVecStore``
    over 1M f32 rows equal to the exact truth; (f) a 1M int8 store saved as
    ``sharded-v1`` and loaded with and without a mesh, the answers bit for
    bit."""
    import shutil
    import tempfile

    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch import parallel
    from otters_tpu_torch.evaluate import mean_recall_at_k
    from otters_tpu_torch.ops import fused_topk as ft

    n = ROWS
    out = {"card": card}

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    # (a) the certified main path over four row shards
    mesh = parallel.make_mesh(rows=4, batch=1, devices=mesh_devices(torch, dev, 4))
    store, build_s = sharded_store(torch, mesh, f32, n, fetch)
    n_chunks = store.n_chunks()
    log(f"4p (a) {n} x {D} int8 over {mesh}: built in {build_s:.2f} s, chunks {n_chunks}, "
        f"{store._dv.vectors.shards[0].shape[0]} rows a shard")

    def pending(q, certify=None, st=None):
        return ((st or store).query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
                .take(K, rerank_from=K_WIDE, certify=certify).collect_async())

    t0 = time.perf_counter()
    tx.resolve([pending(batches[-1])])  # warm-up: the certificate learns its width
    log(f"4p (a) warm-up batch: {time.perf_counter() - t0:.2f} s")
    pend, results, launched, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches], counts)
    log(f"4p (a) sharded certified path: {BATCHES} pipelined batches of {B}, {PATH_ROUNDS} "
        f"rounds: {', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} q/s against "
        f"the single-device main path's {main_qps:.1f} q/s on {card}; launches {launched}")
    assert launched["K1"] == 4 * BATCHES and launched["K2"] == 0, launched
    for i, (p, res, gt) in enumerate(zip(pend, results, truths)):
        st = p.stats()
        assert st.certified is True, f"4p (a) batch {i} not certified: {st}"
        assert st.pruned_chunks == (n_chunks + 1) // 2, f"4p (a) batch {i}: {st}"
        assert st.evaluated_chunks == n_chunks - st.pruned_chunks, st
        assert sorted(res.indices) == sorted(gt), (i, res.indices, gt)
    prof = profile_batches(torch, pending, batches, K1_SCAN)
    merge = merge_ms(torch, mesh, B, K_WIDE)
    log(f"4p (a) K1 per shard launch {prof['scan_ms_per_batch'] / 4:.3f} ms, the merge "
        f"{merge:.3f} ms a batch, idle share {prof['idle_share']:.3f}")
    out["a"] = {"qps": qps, "qps_rounds": rounds, "main_qps": main_qps, "build_s": build_s,
                "launches": launched["K1"], "profile": prof,
                "k1_ms_per_shard_launch": prof["scan_ms_per_batch"] / 4, "merge_ms": merge}
    want_a = [r.indices for r in results]

    # (b) uncertified on the same store: K2 on every shard
    tx.resolve([pending(batches[-1], certify=False)])
    pend, results, launched, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q, certify=False) for q in batches], counts)
    assert launched["K2"] == 4 * BATCHES and launched["K1"] == 0, launched
    recall = mean_recall_at_k(truths, [r.indices for r in results])
    log(f"4p (b) uncertified (K2 per shard): median {qps:.1f} q/s on {card}, "
        f"recall@{K} {recall:.4f}; launches {launched}")
    assert recall > 0.5, recall
    out["b"] = {"qps": qps, "qps_rounds": rounds, "launches": launched["K2"], "recall": recall}
    del store, pend, results
    torch.cuda.empty_cache()

    # (c) rows=2, batch=2: the same answers as (a)
    mesh_c = parallel.make_mesh(rows=2, batch=2, devices=mesh_devices(torch, dev, 4))
    store_c, build_c = sharded_store(torch, mesh_c, f32, n, fetch)
    tx.resolve([pending(batches[-1], st=store_c)])
    ft.reset_launches()
    t0 = time.perf_counter()
    pend = [pending(q, st=store_c) for q in batches]
    results = tx.resolve(pend)
    sync(dev)
    qps_c = len(batches) * B / (time.perf_counter() - t0)
    launched = counts()
    assert launched["K1"] == 4 * BATCHES, launched  # 2 row shards x 2 batch columns
    for i, (p, res) in enumerate(zip(pend, results)):
        assert p.stats().certified is True, (i, p.stats())
        assert res.indices == want_a[i], (i, res.indices, want_a[i])
    log(f"4p (c) rows=2, batch=2: built in {build_c:.2f} s, {qps_c:.1f} q/s (one round), "
        f"every query certified and equal to (a); launches {launched}")
    out["c"] = {"qps": qps_c, "build_s": build_c, "launches": launched["K1"]}
    del store_c, pend, results
    torch.cuda.empty_cache()

    # (d) 2M f32 over rows=2: K4 fast-exact per shard, equal to the truth
    mesh_d = parallel.make_mesh(rows=2, batch=1, devices=mesh_devices(torch, dev, 2))
    nd = SHARD_F32_ROWS
    store_d, build_d = sharded_store(torch, mesh_d, f32, nd, storage="float32")
    plan = lambda q: (store_d.query_batch(q, tx.Metric.Cosine)  # noqa: E731
                      .meta_filter(bench_filter()).take(K).collect_async())
    tx.resolve([plan(batches[-1])])
    ft.reset_launches()
    res_d = tx.resolve([plan(q) for q in batches[:2]])
    launched = counts()
    assert launched["K4"] == 2 * 2 and launched["K3"] == 0, launched
    tol = score_tol(tx.Metric.Cosine, batches[0], None)  # Cosine: no norms
    worst = 0.0
    for i, (q, res) in enumerate(zip(batches[:2], res_d)):
        want = exact_topk(torch, f32, nd, q, tx.Metric.Cosine, K, row_ok=odd_chunks)
        _, e = check_topk(f"4p (d) batch {i}", res.indices, res.scores, *want, tol)
        worst = max(worst, e)
    log(f"4p (d) {nd} x {D} f32 over rows=2: built in {build_d:.2f} s, 2 batches equal to "
        f"the exact truth (max score diff {worst:.2e}); launches {launched}")
    out["d"] = {"build_s": build_d, "launches": launched["K4"], "max_err": worst}
    del store_d, res_d
    torch.cuda.empty_cache()

    # (e) ShardedVecStore over 1M f32 rows (no kernel, as in the JAX package)
    nv = SHARD_VEC_ROWS
    t0 = time.perf_counter()
    vs = parallel.ShardedVecStore(mesh, f32[:nv])
    build_e = time.perf_counter() - t0
    q = batches[0][:SHARD_VEC_B]
    t0 = time.perf_counter()
    got = vs.search(q, tx.Metric.Cosine, k=K)
    search_e = time.perf_counter() - t0
    want = exact_topk(torch, f32, nv, q, tx.Metric.Cosine, K)
    _, e = check_topk("4p (e)", [r.index for r in got], [r.score for r in got], *want,
                      score_tol(tx.Metric.Cosine, q, None))
    log(f"4p (e) ShardedVecStore {nv} x {D} over rows=4: built {build_e:.2f} s, search of "
        f"{SHARD_VEC_B} queries {search_e:.3f} s, top-{K} equal to the exact truth "
        f"(max score diff {e:.2e})")
    out["e"] = {"build_s": build_e, "search_s": search_e, "max_err": e}
    del vs
    torch.cuda.empty_cache()

    # (f) sharded-v1: save a 1M int8 store, load it with and without a mesh
    host = f32[:nv].cpu().numpy()
    store_f = (tx.MetaStore.from_columns(price_version_columns(nv)).with_vectors(host)
               .with_chunk_size(CHUNK).with_storage_dtype("int8")
               .with_rerank_source(keep_host_f32=True).build_sharded(mesh))
    del host
    # the checkout's git-ignored scratch directory
    scratch_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_scratch")
    os.makedirs(scratch_root, exist_ok=True)
    scratch = tempfile.mkdtemp(dir=scratch_root)
    try:
        path = os.path.join(scratch, "sharded_store")
        t0 = time.perf_counter()
        store_f.save(path)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        t0 = time.perf_counter()
        loaded_mesh = tx.MetaStore.load(path, mesh=mesh)
        load_mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded_one = tx.MetaStore.load(path, device=dev)
        load_one_s = time.perf_counter() - t0

        def answers(st):
            pend = [pending(q, st=st) for q in batches[:2]]
            res = tx.resolve(pend)
            return [(r.indices, r.scores, p.stats().certified, p.stats().evaluated_chunks,
                     p.stats().pruned_chunks) for p, r in zip(pend, res)]

        want_f = answers(store_f)
        assert all(a[2] is True for a in want_f), want_f
        for name, st in (("mesh", loaded_mesh), ("one device", loaded_one)):
            assert answers(st) == want_f, f"4p (f) the store loaded onto {name} answers otherwise"
        log(f"4p (f) sharded-v1 of {nv} x {D} int8 (keep_host_f32): {size} bytes, save "
            f"{save_s:.2f} s, load onto the mesh {load_mesh_s:.2f} s, onto one device "
            f"{load_one_s:.2f} s; indices, scores bit for bit, flags and chunk counts equal")
        out["f"] = {"bytes": size, "save_s": save_s, "load_mesh_s": load_mesh_s,
                    "load_one_device_s": load_one_s}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    del store_f, loaded_mesh, loaded_one
    torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


# ---------------------------------------------------------------------------
# Phase 4pm: a mesh across two processes on the card
# ---------------------------------------------------------------------------

PM_TIMEOUT_S = 300  # each worker's limit
PM_TAKE_ALL_B = 4  # queries of the take-all over the saved store


def answers_of(st, batches, pending):
    """Each batch's (indices, scores, certified, evaluated, pruned) on ``st``."""
    import otters_tpu_torch as tx

    pend = [pending(q, st=st) for q in batches]
    res = tx.resolve(pend)
    return [[r.indices, [float(x) for x in r.scores], p.stats().certified,
             p.stats().evaluated_chunks, p.stats().pruned_chunks] for p, r in zip(pend, res)]


def take_all_of(st, q):
    """``collect()`` with no ``take`` of ``q`` under the bench's filter ->
    [count, sha256 of the indices and score bits]; its scores must be a
    stable sort (non-increasing)."""
    import hashlib

    import numpy as np

    import otters_tpu_torch as tx

    res = st.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter()).collect()
    scores = np.asarray(res.scores, np.float32)
    assert np.all(np.diff(scores) <= 0), "the take-all is not sorted"
    h = hashlib.sha256(np.asarray(res.indices, np.int64).tobytes())
    h.update(scores.tobytes())
    return [len(res.indices), h.hexdigest()]


def pm_worker(rank, port, shared, batches_np, truths, path, outq):
    """One of phase 4pm's two processes: (rank, its numbers) on ``outq``, or
    (rank, {"error": the traceback}). ``shared`` holds phase 4's f32 tensor
    (CUDA IPC); the worker takes it out, and drops it before it ends, so
    the parent may free the rows (an IPC block a consumer never released
    stays allocated in the producer)."""
    import gc
    import traceback

    global _LOG_PREFIX
    _LOG_PREFIX = f"[4pm rank {rank}] "
    try:
        res = pm_run(rank, port, shared.pop(), batches_np, truths, path)
    except BaseException:
        res = {"error": traceback.format_exc()}
    gc.collect()
    outq.put((rank, res))


def pm_run(rank, port, f32, batches_np, truths, path):
    """Phase 4pm in one worker: the main path's store over the two
    processes' ``rows=4`` mesh, its rounds and checks, ``certify=False``,
    then the saved 1M store -> the numbers and answers the parent checks."""
    import numpy as np
    import torch

    import otters_tpu_torch as tx
    from otters_tpu_torch import aot, kernels, parallel
    from otters_tpu_torch.evaluate import mean_recall_at_k
    from otters_tpu_torch.parallel import exchange

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = f32.device  # phase 4's tensor, through CUDA IPC
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    parallel.init_distributed(f"127.0.0.1:{port}", 2, rank, local_devices=[dev, dev])
    mesh = parallel.make_mesh(rows=4)
    assert mesh.programs() == [(2 * rank, 0), (2 * rank + 1, 0)], mesh
    log(f"init_distributed + make_mesh: {time.perf_counter() - t0:.2f} s, {mesh}")
    batches = [torch.from_numpy(b).to(dev) for b in batches_np]
    out = {}

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    store, build_s = sharded_store(torch, mesh, f32, ROWS, fetch)
    n_chunks = store.n_chunks()
    log(f"{ROWS} x {D} int8 over two processes: built in {build_s:.2f} s")

    def pending(q, certify=None, st=None):
        return ((st or store).query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
                .take(K, rerank_from=K_WIDE, certify=certify).collect_async())

    tx.resolve([pending(batches[-1])])  # warm-up: the certificate learns its width
    calls0, secs0 = exchange.calls, exchange.seconds
    pend, results, launched, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches], counts)
    per_batch = PATH_ROUNDS * BATCHES
    ex_calls = (exchange.calls - calls0) / per_batch
    ex_ms = (exchange.seconds - secs0) * 1e3 / per_batch
    log(f"certified path: {BATCHES} pipelined batches of {B}, {PATH_ROUNDS} rounds: "
        f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} q/s (this process's "
        f"wall); launches {launched}; the exchange {ex_calls:.2f} calls, {ex_ms:.3f} ms a batch")
    assert launched["K1"] == 2 * BATCHES and launched["K2"] == 0, launched
    assert ex_calls <= 2, ex_calls
    for i, (p, res, gt) in enumerate(zip(pend, results, truths)):
        st = p.stats()
        assert st.certified is True, f"4pm batch {i} not certified: {st}"
        assert st.pruned_chunks == (n_chunks + 1) // 2, f"4pm batch {i}: {st}"
        assert sorted(res.indices) == sorted(gt), (i, res.indices, gt)
    prof = profile_batches(torch, pending, batches, K1_SCAN)
    out["a"] = {"qps": qps, "qps_rounds": rounds, "build_s": build_s, "launches": launched["K1"],
                "exchange_calls_per_batch": ex_calls, "exchange_ms_per_batch": ex_ms,
                "profile": prof, "k1_ms_per_shard_launch": prof["scan_ms_per_batch"] / 2,
                "answers": [r.indices for r in results]}

    tx.resolve([pending(batches[-1], certify=False)])
    pend, results, launched, qps_b, _ = timed_rounds(
        torch, dev, lambda: [pending(q, certify=False) for q in batches], counts)
    assert launched["K2"] == 2 * BATCHES and launched["K1"] == 0, launched
    recall = mean_recall_at_k(truths, [r.indices for r in results])
    log(f"uncertified (K2 per shard): median {qps_b:.1f} q/s, recall@{K} {recall:.4f}; "
        f"launches {launched}")
    assert recall > 0.5, recall
    out["b"] = {"qps": qps_b, "launches": launched["K2"], "recall": recall}
    del store, pend, results
    torch.cuda.empty_cache()

    nv = SHARD_VEC_ROWS
    host = f32[:nv].cpu().numpy()
    t0 = time.perf_counter()
    store_f = (tx.MetaStore.from_columns(price_version_columns(nv)).with_vectors(host)
               .with_chunk_size(CHUNK).with_storage_dtype("int8")
               .with_rerank_source(keep_host_f32=True).build_sharded(mesh))
    del host
    t1 = time.perf_counter()
    store_f.save(path)  # collective: each process's shards and manifest
    save_s = time.perf_counter() - t1
    out["f"] = {"build_s": t1 - t0, "save_s": save_s,
                "answers": answers_of(store_f, batches[:2], pending),
                "take_all": take_all_of(store_f, batches[0][:PM_TAKE_ALL_B])}
    assert all(a[2] is True for a in out["f"]["answers"]), out["f"]["answers"]
    log(f"{nv} x {D} int8 built in {t1 - t0:.2f} s, saved as sharded-v1 in {save_s:.2f} s; "
        f"take-all of {PM_TAKE_ALL_B} queries: {out['f']['take_all'][0]} results")
    del store_f
    out["nvcc_runs"], out["aot_stats"] = kernels.nvcc_runs, dict(aot.stats)
    assert kernels.nvcc_runs == 0 and aot.stats["compiles"] == 0, (kernels.nvcc_runs, aot.stats)
    return out


def two_process_phase(torch, dev, f32, batches, truths, main_qps, sharded_qps, card):
    """Phase 4pm: two spawned workers on the card form a gloo group and a
    ``rows=4`` mesh across them (see ``pm_run``); the parent checks that
    they agree, then loads their saved store onto its one-process mesh and
    onto one device: answers bit for bit, the take-all equal -> the
    numbers. A worker that fails, or outlives PM_TIMEOUT_S, fails the
    phase (both are killed)."""
    import queue
    import shutil
    import socket
    import tempfile

    import otters_tpu_torch as tx
    from otters_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    scratch_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_scratch")
    os.makedirs(scratch_root, exist_ok=True)
    scratch = tempfile.mkdtemp(dir=scratch_root)
    path = os.path.join(scratch, "two_process_store")
    ctx = torch.multiprocessing.get_context("spawn")
    outq = ctx.Queue()
    host_batches = [b.cpu().numpy() for b in batches]
    procs = [ctx.Process(target=pm_worker, args=(rank, port, [f32], host_batches, truths, path,
                                                 outq)) for rank in (0, 1)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < 2:
            left = PM_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                rank, res = outq.get(timeout=max(left, 0.1))
            except queue.Empty:
                raise AssertionError(f"4pm: a worker outlived {PM_TIMEOUT_S} s") from None
            assert "error" not in res, f"4pm worker {rank} failed:\n{res['error']}"
            got[rank] = res
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0, f"4pm worker exit code {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if dev.type == "cuda":
            torch.cuda.ipc_collect()  # the f32 rows' block, released by the workers
    wall = time.perf_counter() - t0
    try:
        for key in ("answers",):
            assert got[0]["a"][key] == got[1]["a"][key], "4pm: the processes answered otherwise"
        assert got[0]["f"] == {**got[1]["f"], "build_s": got[0]["f"]["build_s"],
                               "save_s": got[0]["f"]["save_s"]}, "4pm: (f) differs"
        manifests = sorted(f for f in os.listdir(path) if f.startswith("manifest"))
        assert manifests == ["manifest_00000.json", "manifest_00001.json"], manifests
        for m in manifests:
            with open(os.path.join(path, m)) as f:
                assert json.load(f)["process_count"] == 2

        def pending(q, st):
            return (st.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
                    .take(K, rerank_from=K_WIDE).collect_async())

        mesh = parallel.make_mesh(rows=4, devices=[dev] * 4)
        for name, st in (("a one-process mesh", tx.MetaStore.load(path, mesh=mesh)),
                         ("one device", tx.MetaStore.load(path, device=dev))):
            assert answers_of(st, batches[:2], pending) == got[0]["f"]["answers"], \
                f"4pm: the two-process save loaded onto {name} answers otherwise"
            if name == "a one-process mesh":
                assert take_all_of(st, batches[0][:PM_TAKE_ALL_B]) == got[0]["f"]["take_all"], \
                    "4pm: the take-all differs from the one-process mesh's"
            del st
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    qps = [got[r]["a"]["qps"] for r in (0, 1)]
    log(f"4pm two processes on one card: median q/s {qps[0]:.1f} / {qps[1]:.1f} (each "
        f"process's wall) against 4p's one-process rows=4 {sharded_qps:.1f} and the single "
        f"path's {main_qps:.1f} on {card}; K1 {[got[r]['a']['launches'] for r in (0, 1)]} "
        f"launches, K1 per shard launch "
        f"{[round(got[r]['a']['k1_ms_per_shard_launch'], 3) for r in (0, 1)]} ms, idle share "
        f"{[round(got[r]['a']['profile']['idle_share'], 3) for r in (0, 1)]}, the exchange "
        f"{[round(got[r]['a']['exchange_ms_per_batch'], 3) for r in (0, 1)]} ms and "
        f"{got[0]['a']['exchange_calls_per_batch']:.2f} calls a batch; the save loaded bit for "
        f"bit; phase wall {wall:.1f} s")
    for r in (0, 1):
        for part in ("a", "f"):
            got[r][part].pop("answers", None)
    return {"card": card, "wall_s": wall, "ranks": got, "sharded_qps": sharded_qps,
            "main_qps": main_qps}


CAT_VOCAB = [f"cat_{v:02d}" for v in range(16)]  # bench.py:233


def bench_columns(n):
    """bench.py's full column mix (bench.py:236-262): price / version, a
    String ``category`` clustered 16 ways per chunk (CAT_VOCAB) and a
    DateTime ``listed`` (epoch millis over 2023-2024, clustered by chunk)."""
    import numpy as np

    from otters_tpu_torch import Column, DataType

    chunk_id = np.arange(n) // CHUNK
    base = 1_672_531_200_000  # 2023-01-01
    return price_version_columns(n) + [
        Column("category", DataType.String).from_values([CAT_VOCAB[c] for c in chunk_id % 16]),
        Column("listed", DataType.DateTime).from_values(
            (base + (chunk_id % 730) * 86_400_000).astype(np.int64)),
    ]


def cat3_rows(rows):
    """The rows ``category == CAT_VOCAB[3]`` keeps: chunk id = 3 (mod 16)."""
    return (rows // CHUNK) % 16 == 3


def string_phase(torch, dev, f32, dv8, card=""):
    """Phase 4s: the bench's full column mix over a 10M x 768 int8 store
    ingested from phase 4's f32 CUDA tensor (``with_vectors(tensor,
    n_rows=n)``, quantized slab by slab on the card), with the device Bloom
    build (OTTERS_BLOOM_DEVICE=1). Checks: the int8 codes, norms, inverse
    norms and residuals equal phase 4's ``materialize_int8_slabs`` ingest of
    the same rows bit for bit; the device Bloom matrix equals the host build
    bit for bit. Then ``precompile`` (the bench's two filters, batches of 1
    and 256, rerank_from=100, pipeline depths 1 and 8) and PATH_ROUNDS timed
    rounds of 8 pipelined batches of 256 certified Cosine ``string_eq``
    queries: no nvcc build and no new miss of the plan / aot_key caches,
    every query certified, each top-10 equal to the exact f32 top-10 of the
    rows the filter keeps, the chunks it prunes pruned, K1 launched every
    batch; one round traced (K1's ms per batch, the rest, the idle
    share)."""
    import os

    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch import kernels
    from otters_tpu_torch.ops import bloom as bloom_ops
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import hashing
    from otters_tpu_torch.ops import scoring as sc

    n = ROWS
    t0 = time.perf_counter()
    cols = bench_columns(n)
    cols_s = time.perf_counter() - t0

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    os.environ["OTTERS_BLOOM_DEVICE"] = "1"
    try:
        t0 = time.perf_counter()
        store = (
            tx.MetaStore.from_columns(cols).with_vectors(f32, n_rows=n)
            .with_storage_dtype("int8").with_chunk_size(CHUNK)
            .with_rerank_source(fetch_vectors=fetch).with_device(dev).build()
        )
        sync(dev)
        build_s = time.perf_counter() - t0
    finally:
        del os.environ["OTTERS_BLOOM_DEVICE"]
    bs = store.build_stats()
    dv = store._dv
    for name in ("vectors", "norms_sq", "inv_norms", "valid", "resid", "resid_bin", "resid_max"):
        a, b = getattr(dv, name), getattr(dv8, name)
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (
            f"tensor ingest {name} differs from the materialize_int8_slabs ingest")
    assert dv.vectors.stride() == dv8.vectors.stride()
    if dev.type == "cuda":
        log(f"4s memory after the ingest: {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB "
            f"allocated (the f32 rows {f32.nbytes / 1e9:.1f} GB, phase 4's int8 rows and this "
            f"store's {dv.vectors.nbytes / 1e9:.1f} GB each), the phase's peak so far "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB of 80")
    log(f"4s ingest: with_vectors(f32 CUDA tensor, n_rows={n}) -> int8 in "
        f"{bs.vectors_ingest_duration:.3f} s (slabs of {sc.INGEST_SLAB_ROWS} rows); "
        f"codes, norms, inverse norms and resid equal the materialize_int8_slabs ingest bit "
        f"for bit; zonemaps + Bloom {bs.zonemap_build_duration:.3f} s; build {build_s:.2f} s; "
        f"columns {cols_s:.2f} s; on {card}")

    # the Bloom matrix: the store's (device-built) against the host build of
    # the same hashes, each build timed on its own
    category = store.columns()["category"]
    strings = list(category.values())[:n]
    nulls = np.asarray(category.null_mask(), dtype=bool)[:n]
    t0 = time.perf_counter()
    g1, g2 = hashing.hash_strings(strings)
    hash_s = time.perf_counter() - t0
    params = store._bloom_params["category"]
    n_chunks = store.n_chunks()
    t0 = time.perf_counter()
    host = bloom_ops.build_matrix(g1, g2, nulls, np.arange(n, dtype=np.int64) // CHUNK,
                                  n_chunks, params, chunk_size=CHUNK)
    host_s = time.perf_counter() - t0
    dev_times = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        built = bloom_ops.build_matrix_device(g1, g2, nulls, CHUNK, n_chunks, params, dev)
        sync(dev)
        dev_times.append(time.perf_counter() - t0)
    stored = store._device_cols["category"]["bloom"]
    assert torch.equal(stored, built)
    assert np.array_equal(stored.cpu().numpy().view(np.uint32), host), (
        "the device Bloom matrix differs from the host build")
    log(f"4s Bloom ({n_chunks} chunks x {params.words} words, {params.k_hashes} hashes): "
        f"device build equal to the host build bit for bit; host build {host_s:.3f} s, "
        f"device build {statistics.median(dev_times):.3f} s (median of 3: "
        f"{', '.join(f'{t:.3f}' for t in dev_times)}), shared host hashing {hash_s:.3f} s; "
        f"on {card}")

    string_eq = tx.col("category").eq(CAT_VOCAB[3])
    t0 = time.perf_counter()
    readied = store.precompile(filters=[bench_filter(), string_eq], batch_sizes=(1, B), k=K,
                               rerank_from=K_WIDE, pipeline_depths=(1, 8))
    sync(dev)
    precompile_s = time.perf_counter() - t0
    log(f"4s precompile: {readied} programs readied in {precompile_s:.2f} s on {card}; "
        f"cache_stats {store.cache_stats()}")

    def pending(q):
        return (store.query_batch(q, tx.Metric.Cosine).meta_filter(string_eq)
                .take(K, rerank_from=K_WIDE).collect_async())

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    batches = [torch.randn((B, D), generator=g, device=dev) for _ in range(BATCHES)]
    before, nvcc_before = store.cache_stats(), kernels.nvcc_runs
    pend, results, launches, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches], lambda: ft.cert_cos_binmax.launches)
    after = store.cache_stats()
    assert kernels.nvcc_runs == nvcc_before, "a string_eq batch built a kernel"
    for name in ("plan", "aot_key"):
        assert after[name]["misses"] == before[name]["misses"], (name, before, after)
    log(f"4s string_eq: {BATCHES} pipelined batches of {B}, {PATH_ROUNDS} rounds: "
        f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} q/s on {card}; "
        f"K1 launches {launches}; no nvcc build, no plan / aot_key miss")
    if dev.type == "cuda":
        assert launches >= BATCHES, f"K1 launched {launches} times for {BATCHES} batches"
    live_chunks = len(range(3, n_chunks, 16))
    for i, p in enumerate(pend):
        st = p.stats()
        assert st.certified is True, f"string_eq batch {i} not certified: {st}"
        assert st.pruned_chunks == n_chunks - live_chunks, f"string_eq batch {i}: {st}"
    for q, res in zip(batches, results):
        gt_rows, gt_scores = exact_topk(torch, f32, n, q, tx.Metric.Cosine, K, row_ok=cat3_rows)
        assert sorted(res.indices) == sorted(gt_rows), (res.indices, gt_rows)
        want = dict(zip(gt_rows, gt_scores))
        err = max(abs(s - want[r]) for r, s in zip(res.indices, res.scores))
        assert err <= 1e-5, f"string_eq rerank score differs from the f32 truth by {err}"
    log(f"4s exact f32 ground truth: top-{K} equal for {BATCHES} batches of {B}; "
        f"pruned {n_chunks - live_chunks} of {n_chunks} chunks")
    prof = None
    if dev.type == "cuda":
        prof = profile_batches(torch, pending, batches, K1_SCAN)
    return store, {
        "ingest_s": bs.vectors_ingest_duration, "build_s": build_s, "bloom_host_s": host_s,
        "bloom_device_s": statistics.median(dev_times), "hash_s": hash_s,
        "precompile_s": precompile_s, "precompiled": readied, "string_eq_qps": qps,
        "string_eq_qps_rounds": rounds, "k1_launches": launches, "profile": prof}


# ---------------------------------------------------------------------------
# Phase 4m: the MetaStore lifecycle
# ---------------------------------------------------------------------------

LIFE_ROWS = 1_000_000  # (d): the append rebuild holds the f32 snapshot on the host twice
LIFE_APPEND = 10_000
LIFE_DELETE = 100_000  # (b): seeded tombstones in the 10M store


def levenshtein(a: str, b: str) -> int:
    """The plain full-table edit distance over UTF-8 bytes (the truth for
    the port's banded ``fuzzy``)."""
    a, b = a.encode("utf-8"), b.encode("utf-8")
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# the extended string filters of 4m (a): (the port's expression, the host
# truth on one category value with Python's own operators, and whether the
# bench's price < 50 leaf joins it)
LIFE_FILTERS = {
    "contains": (lambda tx: tx.col("category").contains("_1"), lambda v: "_1" in v, False),
    "starts_with": (lambda tx: tx.col("category").starts_with("cat_0"),
                    lambda v: v.startswith("cat_0"), False),
    "ends_with": (lambda tx: tx.col("category").ends_with("7"), lambda v: v.endswith("7"), False),
    "fuzzy": (lambda tx: tx.col("category").fuzzy("cat_7", 1),
              lambda v: levenshtein(v, "cat_7") <= 1, False),
    "not_contains_price": (
        lambda tx: ~tx.col("category").contains("_1") & tx.col("price").lt(50.0),
        lambda v: "_1" not in v, True),
}


def life_chunk_keep(torch, dev, name, n_chunks):
    """The host truth of a 4m (a) filter per chunk (bench_columns: one
    category value and one price band per chunk) -> (a device bool tensor
    over chunk ids, the number of live chunks)."""
    _, truth, price = LIFE_FILTERS[name]
    keep16 = [truth(v) for v in CAT_VOCAB]
    keep = [keep16[c % 16] and (not price or c % 2 == 1) for c in range(n_chunks)]
    return torch.tensor(keep, device=dev), sum(keep)


def check_truth(torch, label, f32, n, batches, results, row_ok):
    """Each result's top-10 equals the exact f32 top-10 of ``f32[:n]``
    under ``row_ok`` (the rows' ids in that tensor's order)."""
    import otters_tpu_torch as tx

    for q, res in zip(batches, results):
        gt_rows, gt_scores = exact_topk(torch, f32, n, q, tx.Metric.Cosine, K, row_ok=row_ok)
        assert sorted(res.indices) == sorted(gt_rows), (label, res.indices, gt_rows)
        want = dict(zip(gt_rows, gt_scores))
        err = max(abs(s - want[r]) for r, s in zip(res.indices, res.scores))
        assert err <= 1e-5, f"{label}: rerank score differs from the f32 truth by {err}"


def life_strings(torch, dev, store, f32, batches, card):
    """4m (a): the extended string filters on phase 4s's 10M store -> stats."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft

    n, n_chunks = store.n_rows, store.n_chunks()
    store._str_arena_cache.clear()
    t0 = time.perf_counter()
    store._column_arena("category")
    pack_s = time.perf_counter() - t0
    log(f"4m (a) arena pack of 'category' ({n} strings, once per column): {pack_s:.3f} s")
    out = {"arena_pack_s": pack_s}
    for name, (expr, _, _) in LIFE_FILTERS.items():
        flt = expr(tx)
        keep, live = life_chunk_keep(torch, dev, name, n_chunks)
        plan = store.query_batch(batches[0], tx.Metric.Cosine).meta_filter(flt)
        t0 = time.perf_counter()
        plan._lower_plan()  # the cold hostmask: the scan, the masks, their copies
        sync(dev)
        scan_s = time.perf_counter() - t0

        def pending(q, flt=flt):
            return (store.query_batch(q, tx.Metric.Cosine).meta_filter(flt)
                    .take(K, rerank_from=K_WIDE).collect_async())

        tx.resolve([pending(batches[-1])])  # warm-up
        before = store.cache_stats()
        pend, results, launches, qps, rounds = timed_rounds(
            torch, dev, lambda: [pending(q) for q in batches],
            lambda: ft.cert_cos_binmax.launches)
        after = store.cache_stats()
        for cache in ("hostmask", "plan"):
            assert after[cache]["misses"] == before[cache]["misses"], (name, before, after)
        if dev.type == "cuda":
            assert launches >= BATCHES, f"{name}: K1 launched {launches} times"
        for i, p in enumerate(pend):
            st = p.stats()
            assert st.certified is True, f"4m {name} batch {i} not certified: {st}"
            assert st.pruned_chunks == n_chunks - live, f"4m {name} batch {i}: {st}, live {live}"
        check_truth(torch, f"4m {name}", f32, n, batches, results,
                    lambda rows, keep=keep: keep[rows // CHUNK])
        # the host verification result() runs on one batch's scan candidates
        rows, _, valid = pend[0]._fetched[:3]
        cand = np.asarray(rows)[np.asarray(valid, dtype=bool)].tolist()
        t0 = time.perf_counter()
        assert all(pend[0]._plan._row_satisfies(i) for i in cand)
        verify_ms = (time.perf_counter() - t0) * 1e3
        prof = None
        if dev.type == "cuda":
            prof = profile_batches(torch, pending, batches, K1_SCAN)
        log(f"4m (a) {name}: cold hostmask {scan_s:.3f} s (scan + masks); {BATCHES} pipelined "
            f"batches of {B}, {PATH_ROUNDS} rounds: {', '.join(f'{r:.1f}' for r in rounds)} q/s, "
            f"median {qps:.1f} q/s on {card}; K1 launches {launches}; {n_chunks - live} of "
            f"{n_chunks} chunks pruned; certified, equal to the host truth; no new hostmask "
            f"or plan miss; host verification of a batch's {len(cand)} candidates "
            f"{verify_ms:.3f} ms")
        out[name] = {"hostmask_s": scan_s, "qps": qps, "qps_rounds": rounds,
                     "verify_ms_per_batch": verify_ms,
                     "k1_launches": launches, "pruned": n_chunks - live, "profile": prof}
    out["cache_stats"] = store.cache_stats()
    return out


def life_delete(torch, dev, store, f32, batches, truths, card):
    """4m (b): delete_rows on the same 10M store: LIFE_DELETE seeded rows
    plus the bench filter's exact top-10 rows of the first batch -> stats."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft

    n = store.n_rows
    rng = np.random.default_rng(SEED + 21)
    dead = np.unique(np.concatenate([rng.choice(n, LIFE_DELETE, replace=False),
                                     np.asarray(truths[0], dtype=np.int64)]))
    t0 = time.perf_counter()
    store.delete_rows(dead)
    sync(dev)
    delete_s = time.perf_counter() - t0
    assert len(store) == n - len(dead), (len(store), n, len(dead))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[torch.from_numpy(dead).to(dev)] = False

    def pending(q):
        return (store.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
                .take(K, rerank_from=K_WIDE).collect_async())

    tx.resolve([pending(batches[-1])])
    pend, results, launches, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches], lambda: ft.cert_cos_binmax.launches)
    if dev.type == "cuda":
        assert launches >= BATCHES, f"K1 launched {launches} times"
    dead_set = set(dead.tolist())
    for i, (p, res) in enumerate(zip(pend, results)):
        assert p.stats().certified is True, f"4m delete batch {i}: {p.stats()}"
        assert not dead_set & set(res.indices), f"4m delete batch {i} returned a deleted row"
    assert set(truths[0]) <= dead_set  # every first-batch winner is gone
    check_truth(torch, "4m delete", f32, n, batches, results,
                lambda rows: odd_chunks(rows) & alive[rows])
    log(f"4m (b) delete_rows of {len(dead)} rows ({LIFE_DELETE} seeded + the first batch's "
        f"exact top-{K}): {delete_s:.3f} s; len {len(store)}; the bench filter: "
        f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} q/s on {card}; "
        f"K1 launches {launches}; no deleted row returned, certified, equal to the truth over "
        f"the survivors")
    return {"deleted": int(len(dead)), "delete_s": delete_s, "qps": qps, "qps_rounds": rounds,
            "k1_launches": launches}


def zonemap_pruned(store):
    """The host zonemap count of the bench filter over a store's (permuted)
    columns: chunks with min price < 50 and max version >= 2 survive."""
    import numpy as np

    n, c = store.n_rows, store.chunk_size()
    offs = np.arange(0, n, c)
    cols = store.columns()
    pmin = np.minimum.reduceat(np.asarray(cols["price"].values())[:n], offs)
    vmax = np.maximum.reduceat(np.asarray(cols["version"].values())[:n], offs)
    return store.n_chunks() - int(((pmin < 50.0) & (vmax >= 2)).sum())


def life_layouts(torch, dev, f32, batches, truths, unsorted_build_s, card):
    """4m (c): sorted and Z-ordered 10M x 768 int8 stores over the bench's
    columns, built from the f32 CUDA tensor (gathered slab by slab), with
    phase 4's fetch_vectors rerank source (called with original ids)."""
    import os

    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft

    n = ROWS

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    out = {}
    for name, layout in (("sort_by_price", lambda b: b.with_sort_by("price")),
                         ("z_order", lambda b: b.with_z_order(["price", "version", "listed"]))):
        cols = bench_columns(n)
        os.environ["OTTERS_BLOOM_DEVICE"] = "1"  # as 4s's unsorted build
        try:
            sync(dev)
            t0 = time.perf_counter()
            store = layout(
                tx.MetaStore.from_columns(cols).with_vectors(f32, n_rows=n)
                .with_storage_dtype("int8").with_chunk_size(CHUNK)
                .with_rerank_source(fetch_vectors=fetch).with_device(dev)).build()
            sync(dev)
            build_s = time.perf_counter() - t0
        finally:
            del os.environ["OTTERS_BLOOM_DEVICE"]
        pruned = zonemap_pruned(store)

        def pending(q, store=store):
            return (store.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
                    .take(K, rerank_from=K_WIDE).collect_async())

        tx.resolve([pending(batches[-1])])
        pend, results, launches, qps, rounds = timed_rounds(
            torch, dev, lambda: [pending(q) for q in batches],
            lambda: ft.cert_cos_binmax.launches)
        if dev.type == "cuda":
            assert launches >= BATCHES, f"{name}: K1 launched {launches} times"
        for i, p in enumerate(pend):
            st = p.stats()
            assert st.certified is True, f"4m {name} batch {i}: {st}"
            assert st.pruned_chunks == pruned, f"4m {name} batch {i}: {st}, zonemap {pruned}"
        for res, gt in zip(results, truths):  # original ids: phase 4's truth
            assert sorted(res.indices) == sorted(gt), (name, res.indices, gt)
        check_truth(torch, f"4m {name}", f32, n, batches[:1], results[:1], odd_chunks)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        log(f"4m (c) {name}: build {build_s:.2f} s (unsorted 4s build {unsorted_build_s:.2f} s), "
            f"{pruned} of {store.n_chunks()} chunks pruned (the host zonemap count over the "
            f"permuted columns); {', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} "
            f"q/s on {card}; K1 launches {launches}; original ids, certified, equal to the f32 "
            f"truth; the phase's peak device memory so far {peak:.1f} GB")
        out[name] = {"build_s": build_s, "pruned": pruned, "qps": qps, "qps_rounds": rounds,
                     "k1_launches": launches, "peak_gb": peak}
        del store, pend, results, pending
        torch.cuda.empty_cache()
    return out


def life_columns(n, start=0):
    """bench_columns' values for rows start .. start + n as appended lists:
    every appended row passes the bench filter."""
    return {"price": [10.0 + (i % 20) for i in range(start, start + n)],
            "version": [3] * n,
            "category": [CAT_VOCAB[i % 16] for i in range(start, start + n)],
            "listed": [1_672_531_200_000] * n}


def life_append_save(torch, dev, f32, card, scratch):
    """4m (d): append and persistence at LIFE_ROWS x 768, int8 (K1) and
    bf16 (K1-bf16), keep_host_f32, sorted by price, 1% deleted; then a 1M
    f32 VecStore (K4) saved and loaded."""
    import os

    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft

    n = LIFE_ROWS
    log(f"4m (d) at {n} rows, not {ROWS}: at {ROWS} the append rebuild would hold the "
        f"{ROWS * D * 4 / 1e9:.1f} GB f32 snapshot on the host twice, and the file would "
        f"hold it once more")
    rng = np.random.default_rng(SEED + 31)
    g = torch.Generator(device=dev).manual_seed(SEED + 32)
    host = f32[:n].cpu().numpy()
    new_rows = torch.randn((LIFE_APPEND, D), generator=g, device=dev)
    new_host = new_rows.cpu().numpy()
    batches = [torch.randn((B, D), generator=g, device=dev) for _ in range(2)]
    dead = rng.choice(n, n // 100, replace=False)
    out = {}
    for storage, kernel in (("int8", "K1"), ("bfloat16", "K1-bf16")):
        old = (tx.MetaStore.from_columns(bench_columns(n)).with_vectors(host)
               .with_storage_dtype(storage).with_chunk_size(CHUNK).with_sort_by("price")
               .with_rerank_source(keep_host_f32=True).with_device(dev).build())
        old.delete_rows(dead)
        sync(dev)
        t0 = time.perf_counter()
        new = old.append(new_host, life_columns(LIFE_APPEND))
        sync(dev)
        append_s = time.perf_counter() - t0
        keep = np.setdiff1d(np.arange(n), dead)
        assert new.n_rows == len(keep) + LIFE_APPEND == len(new)
        # the survivors' codes and residuals, bit for bit across the append
        inv_old, inv_new = np.argsort(old._index_map), np.argsort(new._index_map)
        old_pos = torch.from_numpy(inv_old[keep]).to(dev)
        new_pos = torch.from_numpy(inv_new[: len(keep)]).to(dev)
        assert torch.equal(old._dv.vectors[old_pos], new._dv.vectors[new_pos]), storage
        assert torch.equal(old._dv.resid[old_pos], new._dv.resid[new_pos]), storage
        del old, old_pos, new_pos
        truth = torch.cat([f32[torch.from_numpy(keep).to(dev)], new_rows])
        oc = new._orig_columns
        passing = torch.from_numpy(
            (np.asarray(oc["price"].values()) < 50.0) & (np.asarray(oc["version"].values()) >= 2)
        ).to(dev)

        def pending(q, store):
            return (store.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter())
                    .take(K, rerank_from=K_WIDE).collect_async())

        ft.reset_launches()
        pend = [pending(q, new) for q in batches]
        res = tx.resolve(pend)
        launches = counts()[kernel]
        if dev.type == "cuda":
            assert launches >= len(batches), f"{kernel} launched {launches} times"
        assert all(p.stats().certified is True for p in pend), [p.stats() for p in pend]
        check_truth(torch, f"4m append {storage}", truth, new.n_rows, batches, res,
                    lambda rows: passing[rows])
        del truth
        # tombstones cross the file too
        new.delete_rows(rng.choice(new.n_rows, new.n_rows // 100, replace=False))
        pend = [pending(q, new) for q in batches]
        res = tx.resolve(pend)
        path = f"{scratch}/lifecycle_{storage}.npz"
        t0 = time.perf_counter()
        new.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = tx.MetaStore.load(path)  # the default device: the card
        sync(dev)
        load_s = time.perf_counter() - t0
        os.remove(path)
        assert loaded.device == new.device and len(loaded) == len(new)
        assert loaded.cert_hints() == new.cert_hints()
        pend2 = [pending(q, loaded) for q in batches]
        res2 = tx.resolve(pend2)
        for a, b, pa, pb in zip(res, res2, pend, pend2):
            assert b.indices == a.indices and b.scores == a.scores, storage
            sa, sb = pa.stats(), pb.stats()
            assert (sb.certified, sb.pruned_chunks, sb.evaluated_chunks) == (
                sa.certified, sa.pruned_chunks, sa.evaluated_chunks), (sa, sb)
        log(f"4m (d) {storage}: {n} rows sorted by price, {len(dead)} deleted, append "
            f"{LIFE_APPEND} rows in {append_s:.2f} s (survivors' codes and residuals bit for "
            f"bit; certified, equal to the truth over survivors + appended); {kernel} launches "
            f"{launches}; save {save_s:.2f} s ({size / 1e9:.2f} GB), load {load_s:.2f} s: the "
            f"same indices, scores bit for bit, certified flags and chunk counts; on {card}")
        out[storage] = {"append_s": append_s, "save_s": save_s, "load_s": load_s,
                        "file_bytes": size, "launches": launches}
        del new, loaded
        torch.cuda.empty_cache()

    vec = tx.VecStore(D, device=dev)
    vec.add_vectors(host)
    q_np = batches[0].cpu().numpy()
    ft.reset_launches()
    a = vec.query(q_np, tx.Metric.Cosine).take(K).collect()
    launches = counts()["K4"]
    if dev.type == "cuda":
        assert launches >= 1, f"K4 launched {launches} times"
    path = f"{scratch}/lifecycle_vec.npz"
    t0 = time.perf_counter()
    vec.save(path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    loaded = tx.VecStore.load(path)
    b = loaded.query(q_np, tx.Metric.Cosine).take(K).collect()
    load_s = time.perf_counter() - t0
    os.remove(path)
    assert [(r.index, r.score) for r in b] == [(r.index, r.score) for r in a]
    log(f"4m (d) VecStore f32 {n} x {D}: K4 launches {launches}; save {save_s:.2f} s "
        f"({size / 1e9:.2f} GB), load + first query {load_s:.2f} s: the same indices and "
        f"scores bit for bit")
    out["vecstore"] = {"save_s": save_s, "load_query_s": load_s, "file_bytes": size,
                       "k4_launches": launches}
    return out


def life_launches(life, storage):
    """The launches of phase 4m's paths on a storage's K1 (each path's own
    run, the counts set to 0 before it)."""
    out = {}
    if storage == "int8":
        out.update({f"strings {k}": v["k1_launches"] for k, v in life["strings"].items()
                    if isinstance(v, dict) and "k1_launches" in v})
        out["delete"] = life["delete"]["k1_launches"]
        out.update({k: v["k1_launches"] for k, v in life["layouts"].items()})
    out["append"] = life["append_save"][storage]["launches"]
    return out


def lifecycle_phase(torch, dev, held, f32, batches, truths, unsorted_build_s, card):
    """Phase 4m: the MetaStore lifecycle (extended string filters, deletes,
    sorted and Z-ordered stores, append, persistence) -> its numbers.
    ``held`` holds phase 4s's store, which is freed before (c)."""
    import shutil
    import tempfile

    from otters_tpu_torch import native
    from otters_tpu_torch.aot import cache_dir

    assert native.available(), "the native host library did not build (g++)"
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    qs = [torch.randn((B, D), generator=g, device=dev) for _ in range(BATCHES)]
    out = {"native_available": True}
    store = held.pop()
    out["strings"] = life_strings(torch, dev, store, f32, qs, card)
    out["delete"] = life_delete(torch, dev, store, f32, batches, truths, card)
    del store
    torch.cuda.empty_cache()
    out["layouts"] = life_layouts(torch, dev, f32, batches, truths, unsorted_build_s, card)
    scratch = tempfile.mkdtemp(dir=cache_dir())  # inside the checkout, git-ignored
    try:
        out["append_save"] = life_append_save(torch, dev, f32, card, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def split_phase(torch, dev):
    """K1-bf16, K5 and K6-bf16 on the split plan at ``openai5m.f1p``'s shape
    (SPLIT_ROWS bf16 rows of depth SPLIT_D, half the chunks dead): each
    through its wrapper at b = 256 and 600 against its plain version, every
    launch on the split plan (``split_launches`` zeroed before it), then
    timed at b = 256 -> {mode: time_mode's numbers}."""
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Cmp, Metric

    n, d = SPLIT_ROWS, SPLIT_D
    for mode in ("K1-bf16", "K5", "K6-bf16"):
        plan = ft.sm90_plan(mode, d, 1)
        assert plan.split, f"{mode} at d = {d}: {plan} is not the split plan"
        log(f"{mode} at d = {d}: {plan}, {ft.kernel_smem_bytes(mode, d, 1)} B of shared memory")
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    f32 = torch.zeros((sc.pad_rows(n), d), device=dev)
    for s in range(0, n, SLAB):
        r = min(SLAB, n - s)
        f32[s : s + r] = torch.randn((r, d), generator=g, device=dev)
    dvb = sc.materialize_from_device(f32, n_valid=n, dtype=torch.bfloat16)
    del f32
    torch.cuda.empty_cache()
    n_chunks = -(-n // CHUNK)
    chunk_mask = torch.arange(n_chunks, device=dev) % 2 == 1
    queries = torch.randn((K1_WIDE_B, d), generator=g, device=dev)
    cases = [
        ("K1-bf16", Metric.Cosine, False, None, 0.0),
        ("K1-bf16", Metric.Cosine, False, Cmp.Gt, 0.05),
        ("K5", Metric.DotProduct, False, None, 0.0),
        # squared distances about 3,072: at 2,950 some bins hold no row of
        # a query, none of them by a row within the tolerance of the
        # threshold (at 2,900, b = 600, one such row flips a bin's -inf
        # between kernel and plain, on the narrow plan as on the split)
        ("K5", Metric.Euclidean, True, Cmp.Lt, 2950.0),
        ("K6-bf16", Metric.Cosine, False, None, 0.0),
        ("K6-bf16", Metric.Euclidean, True, None, 0.0),
    ]
    for mode, metric, take_min, cmp, thr in cases:
        for b in (B, K1_WIDE_B):
            args = mode_inputs(mode, dvb, queries[:b], chunk_mask, thr, metric, cmp)
            ft.reset_launches()
            err, tol = compare_mode(mode, args, metric, take_min, cmp)
            fn = ft.KERNELS[mode]
            assert (fn.launches, fn.split_launches) == (1, 1), (
                f"{mode} b={b}: {fn.launches} launches, {fn.split_launches} on the split plan")
            log(f"{mode} vs plain on the split plan ({n} rows, d={d}, b={b}, {metric.value}"
                f"{' take-min' if take_min else ''}, {cmp.value if cmp else 'no'} filter): "
                f"max_abs_err={err:.3e} tol={tol:.3e} err/tol={err / tol:.3f}, "
                f"split_launches {fn.split_launches} of {fn.launches}")
    timing = {}
    for mode in ("K1-bf16", "K5", "K6-bf16"):
        ft.reset_launches()
        timing[mode] = time_mode(torch, mode, dvb, queries[:B], n_chunks,
                                 Metric.DotProduct if mode == "K5" else None)
        fn = ft.KERNELS[mode]
        assert fn.launches > 0 and fn.split_launches == fn.launches, (
            f"{mode}: {fn.split_launches} of {fn.launches} launches on the split plan")
        timing[mode]["split_launches"] = fn.split_launches
    assert ft.kernel_takes.routed == 0, "a query was routed away from the kernels by shape"
    del dvb
    torch.cuda.empty_cache()
    return timing


def library_fn(torch, mode, q, v_live, n_live):
    """One PyTorch call (plus a bin max) for the same function: the
    yardstick; the port never calls it. K1 / K5: a bf16 matmul on rows cast
    beforehand (bf16 rows as they are); K2: ``torch._int_mm`` (which takes
    more than 16 queries: a smaller batch padded with zero queries); K3: an f32
    matmul, TF32 off, on rows upcast beforehand; K4: three bf16 matmuls on
    planes split beforehand (two over bf16 rows, whose low plane is 0); K6:
    one bf16 matmul on rows cast beforehand."""
    from otters_tpu_torch.ops import fused_topk as ft

    b = q.shape[0]

    def binmax(x):
        return x.reshape(b, n_live, ft.BIN).amax(dim=2)

    if mode in CERT_MODES or mode.startswith("K6"):
        vb = v_live.bfloat16()
        return lambda: binmax(torch.matmul(q, vb.T))
    if mode == "K2":
        qm = q if b > 16 else torch.nn.functional.pad(q, (0, 0, 0, 32 - b))
        return lambda: binmax(torch._int_mm(qm, v_live.T)[:b])
    if mode.startswith("K3"):
        v32 = v_live.float()
        return lambda: binmax(torch.matmul(q, v32.T))
    qh, vh = q.bfloat16(), v_live.bfloat16()
    if mode == "K4-bf16":
        ql = (q - qh.float()).bfloat16()
        return lambda: binmax(torch.matmul(qh, vh.T) + torch.matmul(ql, vh.T))
    ql, vl = (q - qh.float()).bfloat16(), (v_live - vh.float()).bfloat16()
    return lambda: binmax(
        torch.matmul(qh, vh.T) + torch.matmul(qh, vl.T) + torch.matmul(ql, vh.T)
    )


def scan_bound(mode, n_live, b, v_elt, q_elt, d=D):
    """-> (bound ms, "bytes" or "operations", bytes, operations) for one call
    over ``n_live`` live bins of depth ``d`` (Cosine; K5 Dot or Euclid). The function must
    read each live row once with the side data it needs (Cosine: inv and
    rmask, K1 also its lane; K5: nsq, rmask and both lanes), each query with
    its per-query values (q_inv and q_ok; K5 q_sq, q_ok, c0, c1, c2), thr
    and the live part of the survivor list with its count, and write the
    live bins' maxima once (the dead bins' -inf is the wrapper's fill, not
    the function's work). K4 does three products, two over bf16 rows."""
    from otters_tpu_torch.ops import fused_topk as ft

    live_rows = n_live * ft.BIN
    side = {"K1": 12, "K1-bf16": 12, "K5": 16}.get(mode, 8)
    per_query = 20 if mode == "K5" else 8
    bytes_moved = (live_rows * (d * v_elt + side) + b * (d * q_elt + per_query) + 4
                   + n_live * 4 + 4 + n_live * b * 4)
    products = {"K4": 3, "K4-bf16": 2}.get(mode, 1)
    ops = 2.0 * b * d * live_rows * products
    peak = {"K2": PEAK_INT8_OPS, "K3": PEAK_F32_FLOPS,
            "K3-bf16": PEAK_F32_FLOPS}.get(mode, PEAK_BF16_FLOPS)
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            bytes_moved, ops)


def time_mode(torch, mode, dv, queries, n_chunks, metric=None):
    """A kernel at a path's shapes (Cosine unless ``metric`` is named, half
    the chunks dead): held against plain, then timed beside plain, the
    yardstick and the bound."""
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.types import Metric

    metric = metric or Metric.Cosine
    take_min = metric is Metric.Euclidean
    chunk_mask = torch.arange(n_chunks, device=queries.device) % 2 == 1
    args = mode_inputs(mode, dv, queries, chunk_mask, metric=metric)
    err, tol = compare_mode(mode, args, metric, take_min)
    n_live = int(args[-1][0])
    live_rows = n_live * ft.BIN
    kernel = lambda: launch(mode, args, metric, take_min)  # noqa: E731
    plain_ms = time_ms(lambda: plain(mode, args, metric, take_min), reps=3, warm=1)
    live = args[-2][:n_live].long()
    rows = (live[:, None] * ft.BIN + torch.arange(ft.BIN, device=live.device)).reshape(-1)
    v_live = dv.vectors[rows]
    library = library_fn(torch, mode, args[0], v_live, n_live)
    extra = {}
    if mode in ROUND_MODES:
        # the sm90 kernels are close to their library calls: time both in
        # interleaved rounds and keep each one's median and range
        rounds = [(time_ms(kernel, reps=10), time_ms(library, reps=10))
                  for _ in range(K1_ROUNDS)]
        ks, ls = zip(*rounds)
        kernel_ms, library_ms = statistics.median(ks), statistics.median(ls)
        extra = {"ms_range": [min(ks), max(ks)], "library_ms_range": [min(ls), max(ls)],
                 "rounds": K1_ROUNDS}
        log(f"{mode} b={args[0].shape[0]}: {K1_ROUNDS} rounds, kernel median {kernel_ms:.3f} "
            f"ms (range {min(ks):.3f}-{max(ks):.3f}), library median {library_ms:.3f} ms "
            f"(range {min(ls):.3f}-{max(ls):.3f}), kernel faster in "
            f"{sum(k < lb for k, lb in rounds)} of {K1_ROUNDS}")
    else:
        kernel_ms = time_ms(kernel, reps=10)
        library_ms = time_ms(library, reps=10)
    del v_live, library
    torch.cuda.empty_cache()
    d = dv.vectors.shape[1]
    bound_ms, bound_by, bytes_moved, ops = scan_bound(
        mode, n_live, args[0].shape[0], dv.vectors.element_size(), args[0].element_size(), d
    )
    tflops = ops / (kernel_ms * 1e-3) / 1e12
    log(f"{mode} ({metric.value}) at the path's shapes, b={args[0].shape[0]}, d={d}: live rows "
        f"{live_rows}, kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}: {bytes_moved / 1e9:.3f} GB, {ops / 1e12:.3f} T ops), "
        f"bound share {bound_ms / kernel_ms:.3f}, {tflops:.1f} TFLOP/s, "
        f"max_abs_err {err:.3e} (tol {tol:.3e})")
    return dict(max_abs_err=err, tol=tol, ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / kernel_ms, tflops=tflops, live_rows=live_rows, **extra)


def b_sweep(torch, mode, dv, queries, n_chunks, metric=None):
    """An sm90 kernel (a mode of ROUND_MODES) at the other batch sizes of
    SWEEP_B on a path's store: each held against plain and timed beside the
    library call and the bound -> {b: time_mode's numbers}."""
    return {b: time_mode(torch, mode, dv, queries[:b], n_chunks, metric) for b in SWEEP_B}


def profile_batches(torch, pending, batches, scan=None):
    """One pipelined round under torch.profiler: device time by kernel and
    the device's busy share of the wall time; with ``scan`` (a substring of
    the scan kernel's name) also its time per batch, which must not be 0, the
    rest of the device time per batch and the idle share -> those numbers."""
    import otters_tpu_torch as tx
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tx.resolve([pending(q) for q in batches])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile: {len(batches)} batches, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if scan is None:
        return None
    scan_ms = sum(e.self_device_time_total for e in events if scan in e.key) / 1e3
    assert scan_ms > 0, f"no device time under a kernel named like {scan!r}"
    n = len(batches)
    out = {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
           "scan_ms_per_batch": scan_ms / n, "rest_ms_per_batch": (busy_ms - scan_ms) / n,
           "idle_ms_per_batch": (wall_ms - busy_ms) / n}
    log(f"profile per batch: {scan} {out['scan_ms_per_batch']:.3f} ms, other device work "
        f"{out['rest_ms_per_batch']:.3f} ms, idle {out['idle_ms_per_batch']:.3f} ms "
        f"(idle share {out['idle_share']:.3f})")
    return out


def bf16_path(torch, dev, f32, batches, truths, card=""):
    """bfloat16 storage at the bench's size: a 10M x 768 bf16 store made on
    the device from the main path's seeded f32 rows (its residuals computed
    slab by slab), the f32 rows as the rerank source, the same columns,
    filter and batches. Certified ``take(10, rerank_from=100)`` for Cosine
    (K1 over bf16 rows), Dot (K5) and Euclid take-min (K5): every query
    certified, every top-10 equal to the exact f32 filtered top-10. Then
    uncertified Cosine ``take(10)``: K4 over bf16 rows with every check
    passing, equal to the exact top-10 of the stored values; and the same
    at the store precisions "default" (8 batches) and "bf16" (one): K6 over
    bf16 rows, equal to the exact top-10 of the one-pass scores, recall@10
    against the main path's f32 ``truths`` reported, not promised."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n = ROWS
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    t0 = time.perf_counter()
    dvb = sc.materialize_from_device(f32, n_valid=n, dtype=torch.bfloat16)
    sync(dev)
    ingest_s = time.perf_counter() - t0

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    t0 = time.perf_counter()
    store = (
        tx.MetaStore.from_columns(price_version_columns(n))
        .with_vectors(dvb, n_rows=n).with_chunk_size(CHUNK)
        .with_rerank_source(fetch_vectors=fetch).with_device(dev).build()
    )
    sync(dev)
    build_s = time.perf_counter() - t0
    log(f"{n} x {D} bf16 store ({dvb.vectors.nbytes / 1e9:.1f} GB) from the f32 rows: "
        f"{ingest_s:.2f} s, build {build_s:.2f} s, chunks={store.n_chunks()}, "
        f"max resid {float(dvb.resid_max):.3e}")
    on_card = dev.type == "cuda"
    out = {"build_s": build_s, "ingest_s": ingest_s}

    def run(metric, mode, take, label, truth_rows, qs=batches, one_pass=False):
        def pending(q):
            plan = store.query_batch(q, metric).meta_filter(bench_filter())
            return plan.take(K, **take).collect_async()

        tx.resolve([pending(torch.randn((B, D), generator=g, device=dev))])  # warm-up
        pend, results, launched, qps, rounds = timed_rounds(
            torch, dev, lambda: [pending(q) for q in qs], counts)
        certify = "rerank_from" in take
        for i, p in enumerate(pend):
            st = p.stats()
            assert st.certified is (True if certify else None), f"{label} batch {i}: {st}"
            assert st.pruned_chunks == (store.n_chunks() + 1) // 2, f"{label} batch {i}: {st}"
        if on_card:
            assert launched[mode] >= len(qs), (label, launched)
            if mode == "K4-bf16":
                assert launched["K3-bf16"] == 0, launched  # every check passed
            if mode.startswith("K6"):  # no other scan ran
                assert sum(launched.values()) == launched[mode], launched
        take_min = metric is tx.Metric.Euclidean
        ties, worst = 0, 0.0
        for i, (q, res) in enumerate(zip(qs, results)):
            want = exact_topk(torch, truth_rows, n, q, metric, K, take_min=take_min,
                              row_ok=odd_chunks, one_pass=one_pass)
            t, e = check_topk(f"{label} batch {i}", res.indices, res.scores, *want,
                              score_tol(metric, q, dvb))
            ties, worst = ties + t, max(worst, e)
        recall = None  # against the main path's f32 truth, a Cosine one
        if metric is tx.Metric.Cosine:
            hits = [len(set(res.indices) & set(gt)) / K for res, gt in zip(results, truths)]
            recall = sum(hits) / len(hits)
        log(f"{label}: {len(qs)} pipelined batches of {B}, {PATH_ROUNDS} rounds: "
            f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, "
            f"median {qps:.1f} q/s on {card}; scan_k_wide={pend[-1].stats().scan_k_wide}; "
            f"top-{K} equal to the exact {'one-pass ' if one_pass else ''}truth for all "
            f"{len(qs) * B} queries (max score diff {worst:.2e}, boundary ties {ties}); "
            f"recall@{K} vs the f32 truth {recall}; launches {launched}")
        prof = None
        if on_card and metric is tx.Metric.DotProduct and certify:
            profile_batches(torch, pending, batches)
        elif on_card and mode in SCAN_NAMES and qs is batches:
            # the paths of this store's redesigned uncertified scans
            prof = profile_batches(torch, pending, batches, SCAN_NAMES[mode])
        return {"qps": qps, "qps_rounds": rounds, "launches": launched[mode], "recall": recall,
                "profile": prof}

    for key, metric, mode in (("cosine", tx.Metric.Cosine, "K1-bf16"),
                              ("dot", tx.Metric.DotProduct, "K5"),
                              ("euclid", tx.Metric.Euclidean, "K5")):
        label = f"bf16 certified {metric.value}"
        out[key] = run(metric, mode, dict(rerank_from=K_WIDE), label, f32)
    out["uncert"] = run(tx.Metric.Cosine, "K4-bf16", {}, "bf16 uncertified Cosine take(10)",
                        dvb.vectors)
    for prec, qs in (("default", batches), ("bf16", batches[:1])):
        store.precision = prec
        out[prec] = run(tx.Metric.Cosine, "K6-bf16", {},
                        f'bf16 store at precision "{prec}", Cosine take(10)', dvb.vectors,
                        qs=qs, one_pass=True)
    store.precision = "highest"
    return store, dvb, out


def bf16_small_phase(torch, dev):
    """1M x 768 bf16 stores. (a) Small-integer rows (exact in bf16) with query
    0's top row copied into N_DUP > 4k bins: the fast K4 check fails, K3
    over bf16 rows reruns, and the answer is the lowest-index copies. (b)
    test_cert_metrics.py's near-ties at d = 768 (192 rows along one
    direction, norms 3e-5 apart: far below bf16 rounding): certified Dot
    and Euclid ``take(10, rerank_from=16)`` must widen on K5 and equal the
    exact f32 truth, in order. The batch of 8 queries makes the store large
    enough (8 x 1M candidates) for the fused kernel rather than the direct
    program."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n = NEAR_ROWS
    n_pad = sc.pad_rows(n)
    on_card = dev.type == "cuda"
    ids = [tx.Column("id", tx.DataType.Int64).from_values(np.arange(n))]
    g = torch.Generator(device=dev).manual_seed(SEED + 8)

    # (a) the failed fast check
    u = torch.randint(-3, 4, (D,), generator=g, device=dev).float()
    step = (n // ft.BIN) // N_DUP
    dup_rows = torch.arange(N_DUP, device=dev) * step * ft.BIN + 200
    rows = torch.zeros((n_pad, D), device=dev)
    rows[:n] = torch.randint(-3, 4, (n, D), generator=g, device=dev).float()
    rows[dup_rows] = u
    dvb = sc.materialize_from_device(rows, n_valid=n, dtype=torch.bfloat16)
    del rows
    store = tx.MetaStore.from_columns(ids).with_vectors(dvb, n_rows=n).with_device(dev).build()
    queries = torch.cat([u[None, :], torch.randint(-3, 4, (7, D), generator=g, device=dev).float()])
    ft.reset_launches()
    res = store.query_batch(queries, tx.Metric.Cosine).take(K).collect()
    near = counts()
    want = exact_topk(torch, dvb.vectors, n, queries, tx.Metric.Cosine, K)
    check_topk("bf16 near-ties", res.indices, res.scores, *want,
               score_tol(tx.Metric.Cosine, queries, dvb))
    assert sorted(res.indices) == dup_rows[:K].tolist(), (res.indices, dup_rows[:K].tolist())
    if on_card:
        assert near["K4-bf16"] >= 1 and near["K3-bf16"] >= 1, near
    log(f"bf16 exact ties ({N_DUP} copies of query 0's top row, {n} x {D}): the check failed "
        f"and K3 over bf16 rows reran; top-{K} = the {K} lowest-index copies; launches {near}")
    del store, dvb
    torch.cuda.empty_cache()

    # (b) near-ties for the general fold
    n_tie = 192
    uu = torch.randn(D, generator=g, device=dev)
    uu /= uu.norm()
    f32 = torch.zeros((n_pad, D), device=dev)
    f32[:n] = 0.05 * torch.randn((n, D), generator=g, device=dev)
    scale = 1.0 + 3e-5 * torch.randperm(n_tie, generator=g, device=dev).float()
    w = torch.randn((n_tie, D), generator=g, device=dev)
    w -= (w @ uu)[:, None] * uu[None, :]
    w /= w.norm(dim=1, keepdim=True)
    a = 0.2 * torch.rand((n_tie, 1), generator=g, device=dev)
    f32[:n_tie] = scale[:, None] * (uu[None, :] + a * w)
    dvb = sc.materialize_from_device(f32, n_valid=n, dtype=torch.bfloat16)

    def fetch(ids_):
        return f32[torch.as_tensor(np.asarray(ids_, dtype=np.int64), device=dev)]

    # query 0 along the ties; 7 more of the same norm in random directions,
    # whose best scores stay far from query 0's, so the batch's global top-k
    # is query 0's (and the batch is large enough for the fused kernel)
    others = torch.randn((7, D), generator=g, device=dev)
    q = torch.cat([2.0 * uu[None, :], 2.0 * others / others.norm(dim=1, keepdim=True)])
    widen = {}
    for metric in (tx.Metric.DotProduct, tx.Metric.Euclidean):
        # a store each: the widths that certified are remembered per store
        # and plan shape, and the second metric would start at the first's
        store = (tx.MetaStore.from_columns(ids).with_vectors(dvb, n_rows=n)
                 .with_rerank_source(fetch_vectors=fetch).with_device(dev).build())
        ft.reset_launches()
        p = store.query_batch(q, metric).take(K, rerank_from=16).collect_async()
        res = p.result()
        st = p.stats()
        launched = counts()
        take_min = metric is tx.Metric.Euclidean
        rows_t, scores_t = exact_topk(torch, f32, n, q, metric, K, take_min=take_min)
        assert st.certified is True and st.scan_k_wide > 16, (metric, st)
        assert res.indices == rows_t, (metric, res.indices, rows_t)
        err = max(abs(a_ - b_) for a_, b_ in zip(res.scores, scores_t))
        assert err <= score_tol(metric, q, dvb), (metric, err)
        if on_card:
            assert launched["K5"] >= 2, ("the widen loop should rescan on K5", launched)
        widen[metric.value] = st.scan_k_wide
        log(f"bf16 near-ties {metric.value}: certified at scan_k_wide={st.scan_k_wide} after "
            f"{launched['K5']} K5 launches; top-{K} equal to the f32 truth in order (max score "
            f"diff {err:.2e})")
    return {"launches": near["K3-bf16"], "widen": widen}


def widen_phase(torch, dev):
    """Adversarial near-ties (1M x 768, 3000 rows whose int8 order is
    scrambled): the certificate must widen through the fused kernel's
    widths and past it into the scan program, then match the f32 truth."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n, n_tie = 1_000_000, 3000
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    u = torch.randn(D, generator=g, device=dev)
    u /= u.norm()
    f32 = torch.randn((sc.pad_rows(n), D), generator=g, device=dev)
    w = torch.randn((n_tie, D), generator=g, device=dev)
    w -= (w @ u)[:, None] * u[None, :]
    w /= w.norm(dim=1, keepdim=True)
    # cosines 0.9988 .. 0.9950: all 3000 sit inside one int8 residual
    # (~8e-3), so no width below 3000 can certify
    eps = 0.05 + 0.05 * torch.randperm(n_tie, generator=g, device=dev) / n_tie
    f32[:n_tie] = u[None, :] + eps[:, None] * w
    f32[n:] = 0.0
    dv8 = sc.materialize_int8_slabs(lambda s, r: f32[s : s + r], n, D, SLAB, device=dev)

    def fetch(ids):
        return f32[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    store = (
        tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64).from_values(np.arange(n))])
        .with_vectors(dv8, n_rows=n).with_rerank_source(fetch_vectors=fetch)
        .with_device(dev).build()
    )
    queries = torch.cat([u[None, :], torch.randn((7, D), generator=g, device=dev)])
    before = ft.cert_cos_binmax.launches
    p = store.query_batch(queries, tx.Metric.Cosine).take(K, rerank_from=20).collect_async()
    res = p.result()
    st = p.stats()
    launches = ft.cert_cos_binmax.launches - before
    rows, scores = exact_topk(torch, f32, n, queries, tx.Metric.Cosine, K)
    truth = dict(zip(rows, scores))
    err = max(abs(sv - truth.get(r, float("inf"))) for r, sv in zip(res.indices, res.scores))
    log(f"near-ties: certified={st.certified} scan_k_wide={st.scan_k_wide} "
        f"K1 launches={launches}; top-{K} vs f32 truth: max score diff {err:.2e}")
    assert st.certified is True and st.scan_k_wide > ft.FUSED_K_MAX, st
    if dev.type == "cuda":
        assert launches >= 2, "the widen loop should rescan on the fused kernel"
    assert sorted(res.indices) == sorted(truth) and err <= 1e-5, (res.indices, truth)


def f32_path(torch, dev, card=""):
    """bench.py's exact-f32 section (4M x 768, bench.py:678-737) on the port:
    a store built on the device slab by slab, the bench's columns and
    filter, pipelined ``take(10)`` batches of 256 Cosine queries timed in
    PATH_ROUNDS rounds (median q/s). The scan is the verified fast-exact K4
    and every check must pass (no K3 rerun); every top-10 equals the exact
    f32 truth. Then one batch each of Dot and Euclid (take-min), and a
    traced round (K4's ms per batch, the rest of the device time, the idle
    share)."""
    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n = F32_ROWS
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    t0 = time.perf_counter()
    dv = sc.materialize_f32_slabs(
        lambda s, r: torch.randn((r, D), generator=g, device=dev), n, D, SLAB, device=dev
    )
    sync(dev)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = (
        tx.MetaStore.from_columns(price_version_columns(n))
        .with_vectors(dv, n_rows=n).with_chunk_size(CHUNK).with_device(dev).build()
    )
    sync(dev)
    build_s = time.perf_counter() - t0
    log(f"{n} x {D} f32 store ({dv.vectors.nbytes / 1e9:.1f} GB): synthesis "
        f"{synth_s:.2f} s, build {build_s:.2f} s, chunks={store.n_chunks()}")

    def pending(q, metric=tx.Metric.Cosine):
        return store.query_batch(q, metric).meta_filter(bench_filter()).take(K).collect_async()

    batches = [torch.randn((B, D), generator=g, device=dev) for _ in range(BATCHES)]
    t0 = time.perf_counter()
    tx.resolve([pending(torch.randn((B, D), generator=g, device=dev))])
    log(f"warm-up batch: {time.perf_counter() - t0:.2f} s")
    pend, results, launched, qps, rounds = timed_rounds(
        torch, dev, lambda: [pending(q) for q in batches], counts)
    log(f"f32 path: {BATCHES} pipelined batches of {B}, {PATH_ROUNDS} rounds: "
        f"{', '.join(f'{r:.1f}' for r in rounds)} q/s, median {qps:.1f} q/s on {card}; "
        f"launches {launched}")
    if dev.type == "cuda":
        # K4 scanned every batch and no check failed (a failure reruns K3)
        assert launched["K4"] >= BATCHES and launched["K3"] == 0, launched
    for i, p in enumerate(pend):
        assert p.stats().pruned_chunks == (store.n_chunks() + 1) // 2, p.stats()
    tol = score_tol(tx.Metric.Cosine, batches[0], dv)
    ties, worst = 0, 0.0
    for i, (q, res) in enumerate(zip(batches, results)):
        want = exact_topk(torch, dv.vectors, n, q, tx.Metric.Cosine, K, row_ok=odd_chunks)
        t, e = check_topk(f"f32 batch {i}", res.indices, res.scores, *want, tol)
        ties, worst = ties + t, max(worst, e)
    log(f"exact f32 truth: top-{K} equal for {BATCHES} batches of {B} "
        f"(max score diff {worst:.2e}, tol {tol:.2e}, boundary ties {ties})")
    for metric in (tx.Metric.DotProduct, tx.Metric.Euclidean):
        q = torch.randn((B, D), generator=g, device=dev)
        ft.reset_launches()
        res = pending(q, metric).result()
        launched_m = counts()
        if dev.type == "cuda":
            assert launched_m["K4"] >= 1 and launched_m["K3"] == 0, (metric, launched_m)
        tol_m = score_tol(metric, q, dv)
        want = exact_topk(torch, dv.vectors, n, q, metric, K,
                          take_min=metric is tx.Metric.Euclidean, row_ok=odd_chunks)
        t, e = check_topk(f"f32 {metric.value}", res.indices, res.scores, *want, tol_m)
        log(f"f32 {metric.value}{' (take-min)' if metric is tx.Metric.Euclidean else ''}: "
            f"top-{K} equal to the exact truth (max score diff {e:.2e}, tol {tol_m:.2e}, "
            f"boundary ties {t}); launches {launched_m}")
    prof = None
    if dev.type == "cuda":
        prof = profile_batches(torch, pending, batches, SCAN_NAMES["K4"])
    stats = {"qps": qps, "qps_rounds": rounds, "launches": launched["K4"], "profile": prof,
             "synth_s": synth_s, "build_s": build_s, "queries": torch.cat(batches[:2])}
    stats["default"] = one_pass_batches(torch, store, dv, pending, batches, card)
    return store, dv, batches[0], stats


def one_pass_batches(torch, store, dv, pending, batches, card):
    """The f32 path's batches at the store precision "default": K6 over f32
    rows (rounded to bf16 in the kernel) and no other scan; each top-10
    equal to the exact top-10 of the one-pass scores."""
    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft

    dev = batches[0].device
    store.precision = "default"
    tx.resolve([pending(batches[-1])])  # warm-up
    ft.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    pend = [pending(q) for q in batches]
    results = tx.resolve(pend)
    sync(dev)
    elapsed = time.perf_counter() - t0
    launched = counts()
    store.precision = "highest"
    qps = len(batches) * B / elapsed
    if dev.type == "cuda":
        assert launched["K6"] >= len(batches), launched
        assert sum(launched.values()) == launched["K6"], launched
    tol = score_tol(tx.Metric.Cosine, batches[0], dv)
    ties, worst = 0, 0.0
    for i, (q, res) in enumerate(zip(batches, results)):
        want = exact_topk(torch, dv.vectors, F32_ROWS, q, tx.Metric.Cosine, K,
                          row_ok=odd_chunks, one_pass=True)
        t, e = check_topk(f"f32 default batch {i}", res.indices, res.scores, *want, tol)
        ties, worst = ties + t, max(worst, e)
    log(f'f32 store at precision "default": {len(batches)} pipelined batches of {B} in '
        f"{elapsed:.3f} s = {qps:.1f} q/s on {card}; top-{K} equal to the exact one-pass "
        f"truth (max score diff {worst:.2e}, boundary ties {ties}); launches {launched}")
    return {"qps": qps, "launches": launched["K6"]}


def sorted_truth(torch, dv, queries, metric, k, row_ok=None):
    """The take-all truth: the filtered f32 score matrix of every (query,
    row) pair, its windows scored as the store scores them (one f32 matmul
    of the queries with each ``_window_size`` block of rows, TF32 off),
    then a stable descending sort of the flat keys on the device (ties
    lower flat index first) -> (rows, scores) of the first k."""
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n_pad = dv.vectors.shape[0]
    b = queries.shape[0]
    q = queries.float()
    q_sq, q_inv = sc._query_norms(q)
    w = sc._window_size(n_pad, b)
    scores = torch.empty((b, n_pad), device=q.device)
    for s in range(0, n_pad, w):
        scores[:, s : s + w] = ft._scores(q @ dv.vectors[s : s + w].float().T, q_inv[:, None],
                                          q_sq[:, None], dv.inv_norms[None, s : s + w],
                                          dv.norms_sq[None, s : s + w], metric)
    ok = dv.valid if row_ok is None else dv.valid & row_ok(torch.arange(n_pad, device=q.device))
    key = torch.where(ok[None, :], scores, float("-inf")).reshape(-1)
    order = torch.sort(key, descending=True, stable=True)[1][:k]
    return (order % n_pad).cpu().numpy(), scores.reshape(-1)[order].cpu().numpy()


def check_sorted(label, rows, scores, want_rows, want_scores, tol):
    """A take-all result equals its sorted truth: the same rows in the same
    order, scores within ``tol``."""
    import numpy as np

    rows, scores = np.asarray(rows), np.asarray(scores)
    assert rows.shape == want_rows.shape, f"{label}: {rows.shape} results, truth {want_rows.shape}"
    wrong = int((rows != want_rows).sum())
    assert wrong == 0, f"{label}: {wrong} of {len(rows)} rows out of the truth's order"
    err = float(np.abs(scores - want_scores).max())
    assert err <= tol, f"{label}: scores differ from the truth by {err} > {tol}"
    return err


def take_all_phase(torch, store, dv, card):
    """Take-all on the 4M x 768 f32 store: ``collect()`` with no ``take``
    for 16 Cosine queries under the bench's filter. The default k is the
    store's row count, far past any device top-k, so score windows stream
    to the host, which sorts every live (query, row) pair; no kernel runs.
    The result equals the sorted truth."""
    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    dev = dv.vectors.device
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    q = torch.randn((TAKE_ALL_B, D), generator=g, device=dev)
    assert sc.needs_windowed(dv.vectors.shape[0], TAKE_ALL_B, store.n_rows)
    ft.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    res = store.query_batch(q, tx.Metric.Cosine).meta_filter(bench_filter()).collect()
    secs = time.perf_counter() - t0
    assert sum(counts().values()) == 0, counts()
    st = store.last_query_stats()
    assert st.pruned_chunks == (store.n_chunks() + 1) // 2, st
    want = sorted_truth(torch, dv, q, tx.Metric.Cosine, store.n_rows, row_ok=odd_chunks)
    err = check_sorted("take-all", res.indices, res.scores, *want,
                       score_tol(tx.Metric.Cosine, q, dv))
    log(f"take-all: {TAKE_ALL_B} Cosine queries x {store.n_rows} rows under the filter, "
        f"collect() with no take: {len(res)} results in {secs:.3f} s on {card}, equal to the "
        f"sorted truth in order (max score diff {err:.2e}); no kernel launched")
    return {"seconds": secs, "results": len(res)}


def near_tie_path(torch, dev):
    """A store where the fast check must fail, through the public API: the
    top row of query 0 is copied into N_DUP > 4k bins, so the fast mode's
    candidate bins cannot hold every tie and its check fails; K3 reruns and
    the answer is the lowest-index copies. Then a Dot ``vec_filter(Eq)`` and
    a ``take(200)``, which go to K3 directly. Rows and queries are small
    integers so Eq sees exact scores."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n = NEAR_ROWS
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    u = torch.randint(-3, 4, (D,), generator=g, device=dev).float()
    step = (n // ft.BIN) // N_DUP
    dup_rows = torch.arange(N_DUP, device=dev) * step * ft.BIN + 200

    def slab(s, r):
        x = torch.randint(-3, 4, (r, D), generator=g, device=dev).float()
        inside = dup_rows[(dup_rows >= s) & (dup_rows < s + r)]
        x[inside - s] = u
        return x

    dv = sc.materialize_f32_slabs(slab, n, D, SLAB, device=dev)
    store = (
        tx.MetaStore.from_columns([tx.Column("id", tx.DataType.Int64).from_values(np.arange(n))])
        .with_vectors(dv, n_rows=n).with_device(dev).build()
    )
    queries = torch.cat([u[None, :], torch.randint(-3, 4, (7, D), generator=g, device=dev).float()])
    on_card = dev.type == "cuda"

    ft.reset_launches()
    res = store.query_batch(queries, tx.Metric.Cosine).take(K).collect()
    near = counts()
    want = exact_topk(torch, dv.vectors, n, queries, tx.Metric.Cosine, K)
    check_topk("near-ties", res.indices, res.scores, *want,
               score_tol(tx.Metric.Cosine, queries, dv))
    assert sorted(res.indices) == dup_rows[:K].tolist(), (res.indices, dup_rows[:K].tolist())
    if on_card:
        assert near["K4"] >= 1 and near["K3"] >= 1, near
    log(f"near-ties ({N_DUP} copies of query 0's top row, {n} x {D}): the check failed and "
        f"K3 reran; top-{K} = the {K} lowest-index copies, as the truth; launches {near}")

    # Dot with an Eq score filter: exact integer scores; the answer is the
    # matching pairs in slot order (bin, query, row), the first k of them
    thr = float(queries[1] @ dv.vectors[4321])
    ft.reset_launches()
    res = (store.query_batch(queries, tx.Metric.DotProduct).vec_filter(thr, tx.Cmp.Eq)
           .take(K).collect())
    eq = counts()
    dots = queries @ dv.vectors[:n].T
    qi, ri = torch.nonzero(dots == thr, as_tuple=True)
    order = sorted(zip((ri // ft.BIN).tolist(), qi.tolist(), ri.tolist()))
    want_rows = [r for _, _, r in order[:K]]
    assert sorted(res.indices) == sorted(want_rows), (res.indices, want_rows)
    assert all(s == thr for s in res.scores), res.scores
    if on_card:
        assert eq["K3"] >= 1 and eq["K4"] == 0, eq
    log(f"Dot vec_filter(Eq {thr}): {len(order)} matching pairs, top-{K} equal to the "
        f"truth; launches {eq}")

    # k > 128: no fast mode
    ft.reset_launches()
    res = store.query_batch(queries, tx.Metric.Cosine).take(200).collect()
    wide = counts()
    want = exact_topk(torch, dv.vectors, n, queries, tx.Metric.Cosine, 200)
    t, e = check_topk("take(200)", res.indices, res.scores, *want,
                      score_tol(tx.Metric.Cosine, queries, dv))
    if on_card:
        assert wide["K3"] >= 1 and wide["K4"] == 0, wide
    log(f"take(200): equal to the exact truth (max score diff {e:.2e}, boundary ties {t}); "
        f"launches {wide}")
    return {"launches": near["K3"]}


VPU_B = 64  # queries of each checked VPU batch
VPU_TIMED_BATCHES = 4


def vpu_scores64(torch, q, v, metric):
    """Exact float64 VPU scores [B, M] of queries [B, D] against rows [M, D]:
    Manhattan by ``torch.cdist(p=1)``, Hamming and Jaccard by broadcasts
    over blocks of rows (every sum of these integer rows is exact)."""
    from otters_tpu_torch.types import Metric

    q = q.double()
    out = torch.empty((q.shape[0], v.shape[0]), dtype=torch.float64, device=q.device)
    blk = max(1, (1 << 25) // (q.shape[0] * q.shape[1]))
    if metric is Metric.Manhattan:
        blk *= 64
    for s in range(0, v.shape[0], blk):
        vb = v[s : s + blk].double()
        if metric is Metric.Manhattan:
            out[:, s : s + blk] = torch.cdist(q, vb, p=1)
            continue
        qb, vb = q[:, None, :], vb[None, :, :]
        if metric is Metric.Hamming:
            out[:, s : s + blk] = (qb != vb).sum(-1).double()
        else:
            num = torch.minimum(qb, vb).sum(-1)
            den = torch.maximum(qb, vb).sum(-1)
            out[:, s : s + blk] = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out


def check_vpu(torch, label, res_rows, res_scores, truth, rows_of, k, take_min):
    """A VPU top-k against the float64 truth ``truth`` [B, M] over the rows
    ``rows_of`` [M] the query may return. The scores (rounded to f32, the
    port's type) equal the truth's best k, in take order; every pair better
    than the k-th is returned (the same multiset of rows); each returned row
    has its score for some query; a row tied with the k-th may be any of the
    tied ones (the tie order is held against the JAX package on the CPU)."""
    from collections import Counter

    t32 = truth.float()
    key = -t32 if take_min else t32
    best = torch.topk(key.reshape(-1), k).values
    want = (-best if take_min else best).tolist()
    assert list(res_scores) == want, f"{label}: scores {res_scores} != truth {want}"
    kth = float(best[-1])
    better = (key > kth).nonzero()
    want_better = Counter(rows_of[better[:, 1]].tolist())
    got_better = Counter(r for r, s in zip(res_rows, res_scores)
                         if (-s if take_min else s) > kth)
    assert got_better == want_better, f"{label}: rows better than the k-th differ"
    for r, s in zip(res_rows, res_scores):
        j = min(int(torch.searchsorted(rows_of, r)), rows_of.shape[0] - 1)  # rows_of ascends
        assert int(rows_of[j]) == r and bool((t32[:, j] == s).any()), (
            f"{label}: row {r} does not score {s} for any query")


def vpu_phase(torch, dev, card=""):
    """Phase 6v: the VPU metrics (Manhattan, Hamming, Jaccard) at 4M x 768
    over rows of small non-negative integers (0..3, seeded, made on the
    card: exact in bf16, where all three metrics mean something), with the
    phase 4s columns, stored as f32 (the tensor adopted with no copy) and
    as bf16. The filter ``category == CAT_VOCAB[3]`` keeps chunk ids = 3
    (mod 16): every odd 8192-row tile is dead, so the pruned scan
    (``scoring.scan_pruned_topk_core``) evaluates exactly half the tiles.
    Each metric over each storage runs one batch of 64 queries, ``take(10)``
    and ``take(10, rerank_from=100)``, each equal to the exact float64
    truth (:func:`check_vpu`). Timed: 4 pipelined batches of 256 filtered
    Manhattan queries over the f32 rows, and the same batches unfiltered
    (the panel program over every tile), each checked likewise. Last, a
    VecStore Manhattan query of 4 over 1M rows against its truth."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Metric

    n = F32_ROWS
    n_pad = sc.pad_rows(n)
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    t0 = time.perf_counter()
    rows = torch.zeros((n_pad, D), device=dev)
    for s in range(0, n, SLAB):
        r = min(SLAB, n - s)
        rows[s : s + r] = torch.randint(0, 4, (r, D), generator=g, device=dev).float()
    cols = bench_columns(n)
    sync(dev)
    synth_s = time.perf_counter() - t0

    def fetch(ids):
        return rows[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

    stores = {}
    for storage in ("float32", "bfloat16"):
        stores[storage] = (
            tx.MetaStore.from_columns(cols).with_vectors(rows, n_rows=n)
            .with_storage_dtype(storage).with_chunk_size(CHUNK)
            .with_rerank_source(fetch_vectors=fetch).with_device(dev).build()
        )
        log(f"6v {storage} store: ingest "
            f"{stores[storage].build_stats().vectors_ingest_duration:.3f} s")
    assert stores["float32"]._dv.vectors.data_ptr() == rows.data_ptr()
    n_chunks = stores["float32"].n_chunks()
    n_tiles = n_pad // sc.SCAN_TILE
    string_eq = tx.col("category").eq(CAT_VOCAB[3])
    all_rows = torch.arange(n, device=dev)
    live = all_rows[cat3_rows(all_rows)]
    live_chunks = len(range(3, n_chunks, 16))
    scanned = []
    orig = sc.scan_pruned_topk_core

    def counting(*a, **kw):  # the tiles the pruned scan evaluates
        scanned.append(int(a[7].sum()))
        return orig(*a, **kw)

    sc.scan_pruned_topk_core = counting
    checked = 0
    try:
        for metric in (Metric.Manhattan, Metric.Hamming, Metric.Jaccard):
            q = torch.randint(0, 4, (VPU_B, D), generator=g, device=dev).float()
            take_min = metric is not Metric.Jaccard
            truth = vpu_scores64(torch, q, rows[live], metric)
            for storage, store in stores.items():
                for rerank in (None, K_WIDE):
                    scanned.clear()
                    t0 = time.perf_counter()
                    res = (store.query_batch(q, metric).meta_filter(string_eq)
                           .take(K, rerank_from=rerank).collect())
                    dt = time.perf_counter() - t0
                    st = store.last_query_stats()
                    assert scanned == [n_tiles // 2], (scanned, n_tiles)
                    assert st.pruned_chunks == n_chunks - live_chunks, st
                    assert st.certified is None, st
                    label = f"6v {metric.value} {storage} take({K}" + (
                        f", rerank_from={rerank})" if rerank else ")")
                    check_vpu(torch, label, res.indices, res.scores, truth, live, K, take_min)
                    checked += 1
                    log(f"{label}: equal to the float64 truth; {scanned[0]} of {n_tiles} "
                        f"tiles evaluated; {dt * 1e3:.1f} ms on {card}")
    finally:
        sc.scan_pruned_topk_core = orig

    # timed: 4 pipelined batches of 256 Manhattan queries over the f32 rows,
    # pruned and over every tile
    store = stores["float32"]
    del stores
    batches = [torch.randint(0, 4, (B, D), generator=g, device=dev).float()
               for _ in range(VPU_TIMED_BATCHES)]
    timing = {}
    for label, expr, rows_of in (("pruned", string_eq, live), ("unfiltered", None, all_rows)):
        def pending(q, expr=expr):
            plan = store.query_batch(q, Metric.Manhattan)
            if expr is not None:
                plan = plan.meta_filter(expr)
            return plan.take(K).collect_async()

        tx.resolve([pending(batches[0])])  # warm-up
        sync(dev)
        t0 = time.perf_counter()
        results = tx.resolve([pending(q) for q in batches])
        sync(dev)
        el = time.perf_counter() - t0
        timing[label] = VPU_TIMED_BATCHES * B / el
        # every batch of the pruned run, the first of the unfiltered one
        for i, (q, res) in enumerate(zip(batches, results)):
            if expr is None and i:
                break
            truth = vpu_scores64(torch, q, rows[rows_of], Metric.Manhattan)
            check_vpu(torch, f"6v Manhattan {label} batch {i}", res.indices, res.scores,
                      truth, rows_of, K, True)
            del truth
        log(f"6v Manhattan {label}: {VPU_TIMED_BATCHES} pipelined batches of {B} over "
            f"{n} x {D} f32 rows in {el:.3f} s: {timing[label]:.2f} q/s on {card}")
    log(f"6v unfiltered / pruned time: {timing['pruned'] / timing['unfiltered']:.3f} "
        f"(the pruned scan reads {n_tiles // 2} of {n_tiles} tiles)")
    del store
    torch.cuda.empty_cache()

    # VecStore: one Manhattan batch of 4 queries over 1M of these rows
    v_rows = rows[:VEC_ROWS].cpu().numpy()
    del rows
    torch.cuda.empty_cache()
    vs = tx.VecStore(D, device=dev)
    vs.add_vectors(v_rows)
    q = torch.randint(0, 4, (4, D), generator=g, device=dev).float()
    res = vs.query(q.cpu().numpy(), Metric.Manhattan).take(K).collect()
    truth = vpu_scores64(torch, q, torch.as_tensor(v_rows, device=dev), Metric.Manhattan)
    check_vpu(torch, "6v VecStore Manhattan", [r.index for r in res], [r.score for r in res],
              truth, torch.arange(VEC_ROWS, device=dev), K, True)
    log(f"6v VecStore Manhattan ({VEC_ROWS} x {D}, 4 queries): equal to the float64 truth")
    return {"synth_s": synth_s, "checked": checked, "pruned_qps": timing["pruned"],
            "unfiltered_qps": timing["unfiltered"]}


def vecstore_path(torch, dev):
    """VecStore at 1M x 768: 256 Cosine queries, ``take(10)``. f32 and bf16
    storage run K4 with its check (no K3 rerun) and equal the exact truth
    of their stored values; int8 storage runs K2 and equals the exact
    top-10 of its quantized scores (recall@10 against the f32 truth is
    reported)."""
    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n = VEC_ROWS
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    host = torch.randn((n, D), generator=g, device=dev).cpu().numpy()
    queries = torch.randn((B, D), generator=g, device=dev)
    q_np = queries.cpu().numpy()
    out, f32_truth = {}, None
    for dtype, mode in (("float32", "K4"), ("bfloat16", "K4-bf16"), ("int8", "K2")):
        store = tx.VecStore(D, dtype=dtype, device=dev)
        store.add_vectors(host)
        t0 = time.perf_counter()
        dv = store.device()
        sync(dev)
        upload_s = time.perf_counter() - t0
        ft.reset_launches()
        t0 = time.perf_counter()
        res = store.query(q_np, tx.Metric.Cosine).take(K).collect()
        query_s = time.perf_counter() - t0
        launched = counts()
        rows, scores = [r.index for r in res], [r.score for r in res]
        if dtype == "int8":
            q_truth = sc._quantize_rows_int8(queries)[0].float()
        else:
            q_truth = queries
        want = exact_topk(torch, dv.vectors, n, q_truth, tx.Metric.Cosine, K)
        t, e = check_topk(f"VecStore {dtype}", rows, scores, *want,
                          score_tol(tx.Metric.Cosine, q_truth, dv))
        if dtype == "float32":
            f32_truth = want[0]
        recall = len(set(rows) & set(f32_truth)) / K
        if dev.type == "cuda":
            assert launched[mode] >= 1, launched
            if mode.startswith("K4"):
                assert launched["K3"] == launched["K3-bf16"] == 0, launched
        log(f"VecStore {dtype} ({n} x {D}, upload {upload_s:.2f} s): {B} queries take({K}) "
            f"in {query_s:.3f} s, equal to the exact truth of its storage (max score diff "
            f"{e:.2e}, boundary ties {t}); recall@{K} vs f32 {recall:.2f}; launches {launched}")
        out[mode] = launched[mode]
        if dtype == "float32":
            out["take_all_s"] = vec_take_all(torch, store, dv, q_np[:4])
        del store, dv
        torch.cuda.empty_cache()
    return out


def vec_take_all(torch, store, dv, q_np):
    """VecStore's windowed take-all: 4 queries, take(1.2 n) (past the direct
    program's share of the 4n candidates), equal to the sorted truth."""
    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import scoring as sc

    k = len(store) * 6 // 5
    assert sc.needs_windowed(dv.vectors.shape[0], len(q_np), k)
    t0 = time.perf_counter()
    res = store.query(q_np, tx.Metric.DotProduct).take(k).collect()
    secs = time.perf_counter() - t0
    q = torch.from_numpy(q_np).to(dv.vectors.device)
    want = sorted_truth(torch, dv, q, tx.Metric.DotProduct, k)
    err = check_sorted("VecStore take-all", [r.index for r in res], [r.score for r in res],
                       *want, score_tol(tx.Metric.DotProduct, q, dv))
    log(f"VecStore take-all: {len(q_np)} Dot queries take({k}) in {secs:.3f} s, equal to the "
        f"sorted truth in order (max score diff {err:.2e})")
    return secs


FUZZ_TRIALS = 8  # phase 7f: fused-size trials, as scripts/tpu_differential_fuzz.py's 8
FUZZ_SEED = 7


def fuzz_phase(dev, card=""):
    """The on-card differential fuzz (``otters_tpu_torch.differential_fuzz``
    from seed 7): FUZZ_TRIALS fused-size trials at least (b = 8 and chunks
    of 1000 among them), the direct-size trials drawn on the way, and the
    tie trial; each once through the kernels and once with
    ``OTTERS_DISABLE_PALLAS`` (the scan programs), equal within the script's
    tolerances; a fused-size trial launched its kernel in the first run
    (the tie trial K4 and its K3 re-run), none launched in the second and
    its batch was routed -> (the records, the launches of each kernel over
    the first runs)."""
    from otters_tpu_torch import differential_fuzz as fz

    recs = fz.run(FUZZ_TRIALS, FUZZ_SEED, device=dev,
                  log=lambda r: log(fz.describe(r) + f" on {card}"))
    launches = {}
    for r in recs:
        assert not r["switch_launches"], r
        for mode, n in r["kernel_launches"].items():
            launches[mode] = launches.get(mode, 0) + n
    drawn, tie = recs[:-1], recs[-1]
    fused = [r for r in drawn if r["route"] == "fused"]
    direct = [r for r in drawn if r["route"] == "direct"]
    assert len(fused) >= FUZZ_TRIALS and all(r["kernel_launches"] for r in fused)
    assert any(r["b"] == fz.COVER_B for r in fused)
    assert any(r["chunk"] == fz.COVER_CHUNK for r in fused)
    assert tie["ties"] and tie["kernel_launches"] == {"K4": 1, "K3": 1}, tie
    log(f"7f: {len(fused)} of {len(fused)} fused-size trials passed (at least {FUZZ_TRIALS}; "
        f"b = {fz.COVER_B} in {sum(r['b'] == fz.COVER_B for r in fused)}, chunks of "
        f"{fz.COVER_CHUNK} in {sum(r['chunk'] == fz.COVER_CHUNK for r in fused)}), a kernel "
        f"launched in each first run, none under OTTERS_DISABLE_PALLAS")
    log(f"7f: {len(direct)} direct-size trials (b x rows <= 2^22: trials "
        f"{[r['trial'] for r in direct]}) ran the direct program in both runs, equal")
    log(f"7f: the tie trial (trial {tie['trial']}) failed the fast check: K4 then K3 "
        f"{tie['kernel_launches']}, equal to the scan program; launches over every first run "
        f"{launches}")
    return recs, launches


def probe_bound(name, n_pad, d, b, t):
    """-> (bound ms, "bytes" or "operations") of one probe call: each input
    read once (v, or VH and VL; the queries), the output written once; the
    tile product's operations, k_planes three of them in bf16."""
    from otters_tpu_torch import profile_variants as pv

    out_cols = 2 if name == "k_mm" else t // pv.BIN
    bytes_moved = (n_pad * d * (4 if name != "k_planes" else 2 * 2) + b * d * 4
                   + (n_pad // t) * b * out_cols * 4)
    ops = 2.0 * b * d * n_pad * (3 if name == "k_planes" else 1)
    peak = PEAK_BF16_FLOPS if name == "k_planes" else PEAK_F32_FLOPS
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def probes_phase(torch, dev):
    """The three probes at scripts/kernel_profile_variants.py's shapes: the
    module's timing run (the probes' path, its launches counted), then each
    held against its plain version (k_mm / k_mm_bins within d 2^-24 |q| |v|,
    two f32 sums in other orders; k_planes within high_precision_bound(d)
    |q| |v|) and timed beside the plain version, a library yardstick (an
    f32 matmul, TF32 off, or three bf16 matmuls on the planes, then a bin
    max) and the bound; each probe (all on the Hopper scan) and its library
    call in K1_ROUNDS interleaved rounds (median, range and rounds won).
    k_mm may not beat its FFMA bound: nvcc must not have dropped the tile
    columns it never writes."""
    from otters_tpu_torch import profile_variants as pv
    from otters_tpu_torch.ops import scoring as sc

    ops = pv.make_inputs(dev, seed=SEED + 10)
    n_pad, d = ops["v"].shape
    b, t = ops["q"].shape[0], pv.T
    pv.reset_launches()
    times = pv.run(ops)
    launched = {name: fn.launches for name, fn in pv.PROBES.items()}
    on_card = dev.type == "cuda"
    if on_card:
        assert all(c >= 1 for c in launched.values()), launched
    scale = float(ops["q"].norm(dim=1).max()) * float(ops["v"].norm(dim=1).max())
    nb = t // pv.BIN
    out = {}
    for name, fn in pv.PROBES.items():
        args = pv.probe_args(name, ops)
        pv_ms = times[name]  # the timing run's median of 10 calls
        got = fn(*args)
        want = pv.PLAIN[name](*args)
        sync(dev)
        err = float((got - want).abs().max())
        base = sc.high_precision_bound(d) if name == "k_planes" else d * 2.0**-24
        tol = base * scale
        assert err <= tol, f"{name}: max |kernel - plain| = {err} > {tol}"
        plain_ms = time_ms(lambda: pv.PLAIN[name](*args), reps=3, warm=1)
        q = ops["q"]
        if name == "k_planes":
            qh, ql = pv.split_planes(q)
            vh, vl = ops["vh"], ops["vl"]

            def library():
                dots = torch.matmul(qh, vh.T) + torch.matmul(qh, vl.T) + torch.matmul(ql, vh.T)
                return dots.reshape(b, n_pad // pv.BIN, pv.BIN).amax(dim=2)
        else:
            v = ops["v"]

            def library():
                return torch.matmul(q, v.T).reshape(b, n_pad // pv.BIN, pv.BIN).amax(dim=2)
        # close to its library call: both in interleaved rounds, each one's
        # median and range
        rounds = [(time_ms(lambda: fn(*args), reps=10), time_ms(library, reps=10))
                  for _ in range(K1_ROUNDS)]
        ks, ls = zip(*rounds)
        times[name], library_ms = statistics.median(ks), statistics.median(ls)
        won = sum(k < lb for k, lb in rounds)
        extra = {"ms_range": [min(ks), max(ks)], "library_ms_range": [min(ls), max(ls)],
                 "rounds": K1_ROUNDS, "rounds_won": won, "run_ms": pv_ms}
        log(f"{name}: {K1_ROUNDS} rounds, kernel median {times[name]:.3f} ms (range "
            f"{min(ks):.3f}-{max(ks):.3f}), library median {library_ms:.3f} ms (range "
            f"{min(ls):.3f}-{max(ls):.3f}), kernel faster in {won} of {K1_ROUNDS}")
        bound_ms, bound_by = probe_bound(name, n_pad, d, b, t)
        if on_card and name == "k_mm":
            assert times[name] >= bound_ms, f"k_mm {times[name]} ms beats its bound {bound_ms} ms"
        log(f"{name} at the script's shapes ({n_pad} x {d}, b={b}, t={t}, {nb} bins a tile): "
            f"kernel {times[name]:.3f} ms, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}), max_abs_err {err:.3e} (tol {tol:.3e}); "
            f"launches {launched[name]}")
        out[name] = dict(launches=launched[name], max_abs_err=err, tol=tol, ms=times[name],
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, kernel_phase_err_over_tol=err / tol, **extra)
        del got, want
        torch.cuda.empty_cache()
    return out


def depth_phase(torch, dev):
    """Fused-size stores (DEPTH_ROWS rows, 256 queries, the bench's columns
    and filter) at d = 100 (stored as 112) and d = 2,048 (past the resident
    query block of every sm90 kernel: their deep-row plan) through
    MetaStore: certified int8 Cosine (K1) and bf16 Dot (K5) ``take(10,
    rerank_from=100)``, every query certified and equal to the exact f32
    truth; precision "default" over f32 rows (K6) and over bf16 rows
    (K6-bf16), uncertified f32 and bf16 Cosine (K4 and K4-bf16, the fast
    mode with its check) and uncertified int8 (K2), each equal to the exact
    truth of its scores. Launch counts and ``kernel_takes.routed`` show
    what served each: K1, K5, K6, K4, K6-bf16 and K4-bf16 launch at both
    depths and K2 at DEPTH_K2 too, with nothing routed. Then the seven
    modes against their plain versions at each depth (K2 alone at
    DEPTH_K2) -> {d: {label: launches}}."""
    import numpy as np

    import otters_tpu_torch as tx
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    n = DEPTH_ROWS
    n_pad = sc.pad_rows(n)
    chunk_mask = torch.arange(-(-n // CHUNK), device=dev) % 2 == 1
    out = {}
    for d in DEPTHS + (DEPTH_K2,):
        g = torch.Generator(device=dev).manual_seed(SEED + 10 + d)
        f32 = torch.zeros((n_pad, d), device=dev)
        f32[:n] = torch.randn((n, d), generator=g, device=dev)
        q = torch.randn((B, d), generator=g, device=dev)

        def fetch(ids, _f=f32):
            return _f[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)]

        def store_of(dv, rerank):
            b = (tx.MetaStore.from_columns(price_version_columns(n)).with_vectors(dv, n_rows=n)
                 .with_chunk_size(CHUNK).with_device(dev))
            return (b.with_rerank_source(fetch_vectors=fetch) if rerank else b).build()

        dv8 = sc.materialize_int8_slabs(lambda s, r: f32[s : s + r], n, d, SLAB, device=dev)
        uncert = ("uncertified int8", dv8, tx.Metric.Cosine, False, "highest", "K2")
        cases = [uncert]
        if d != DEPTH_K2:
            dvb = sc.materialize_from_device(f32, n_valid=n, dtype=torch.bfloat16)
            dvf = sc.materialize_f32_slabs(lambda s, r: f32[s : s + r], n, d, SLAB, device=dev)
            cases = [("certified int8 Cosine", dv8, tx.Metric.Cosine, True, "highest", "K1"),
                     ("certified bf16 Dot", dvb, tx.Metric.DotProduct, True, "highest", "K5"),
                     ('f32 "default"', dvf, tx.Metric.Cosine, False, "default", "K6"),
                     ("uncertified f32 Cosine", dvf, tx.Metric.Cosine, False, "highest", "K4"),
                     ('bf16 "default"', dvb, tx.Metric.Cosine, False, "default", "K6-bf16"),
                     ("uncertified bf16 Cosine", dvb, tx.Metric.Cosine, False, "highest",
                      "K4-bf16"),
                     uncert]
        res_d = {}
        for label, dv, metric, certify, prec, mode in cases:
            store = store_of(dv, certify)
            store.precision = prec
            ft.reset_launches()
            plan = store.query_batch(q, metric).meta_filter(bench_filter())
            res = plan.take(K, **(dict(rerank_from=K_WIDE) if certify else {})).collect()
            launched, routed = counts(), ft.kernel_takes.routed
            st = store.last_query_stats()
            assert st.certified is (True if certify else None), (d, label, st)
            assert st.pruned_chunks == (store.n_chunks() + 1) // 2, (d, label, st)
            q_truth = sc._quantize_rows_int8(q)[0].float() if mode == "K2" else q
            rows = f32 if certify else dv.vectors
            want = exact_topk(torch, rows, n, q_truth, metric, K, row_ok=odd_chunks,
                              one_pass=prec == "default")
            ties, err = check_topk(f"d={d} {label}", res.indices, res.scores, *want,
                                   score_tol(metric, q_truth, dv))
            # every kernel takes any d (the plain versions serve a CPU
            # rehearsal, uncounted)
            assert ft.kernel_takes(mode, d), (d, label)
            assert routed == 0 and (launched[mode] >= 1 or dev.type != "cuda"), (
                d, label, launched, routed)
            res_d[label] = launched[mode]
            log(f"d={d} (stored {sc.pad_depth(d)}) {label}: {n} rows, {B} queries, top-{K} "
                f"equal to the exact {'f32 ' if certify else ''}truth (max score diff "
                f"{err:.2e}, boundary ties {ties}); {mode} launched {launched[mode]} times, "
                f"{routed} queries routed")
            del store
        compared = [("K2", dv8, tx.Metric.Cosine)]
        if d != DEPTH_K2:
            compared = [("K1", dv8, tx.Metric.Cosine), ("K5", dvb, tx.Metric.DotProduct),
                        ("K6", dvf, tx.Metric.Cosine), ("K4", dvf, tx.Metric.Cosine),
                        ("K6-bf16", dvb, tx.Metric.Cosine),
                        ("K4-bf16", dvb, tx.Metric.Cosine), *compared]
        for mode, dv, metric in compared:
            for b in (1, B):
                args = mode_inputs(mode, dv, q[:b], chunk_mask, metric=metric)
                e, tol = compare_mode(mode, args, metric)
                log(f"d={d} {mode} vs plain ({n} rows, b={b}, plan "
                    f"{tuple(ft.sm90_plan(mode, sc.pad_depth(d), b))}): max_abs_err={e:.3e} "
                    f"tol={tol:.3e}")
        if d != DEPTH_K2:
            del dvb, dvf
        out[d] = res_d
        del f32, dv8, q, cases, uncert
        torch.cuda.empty_cache()
    return out


def examples_phase(torch, dev, card=""):
    """The twins of examples/async_serving.py, catalog.py,
    certified_search.py and multichip.py on the card at their default
    sizes, each with its checks (``multichip`` over the card listed four
    times: ``rows=2, batch=2``) -> the seconds of each."""
    from otters_tpu_torch.examples import async_serving, catalog, certified_search, multichip

    out = {}

    def run(name, fn):
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            got = fn()
        out[name] = time.perf_counter() - t0
        lines = [ln for ln in text.getvalue().splitlines() if ln and not set(ln) <= set("+-")]
        log(f"{name} ({out[name]:.2f} s on {card}): " + " / ".join(
            ln for ln in lines if "|" not in ln))
        return got, text.getvalue()

    (results, results8), _ = run("async_serving", lambda: async_serving.main(device=dev))
    assert len(results) == 8 and all(len(r) == K for r in results + results8)
    assert all(v == "cat_3" for r in results for v in r.column("category").string_values())
    (store, r8), text = run("catalog", lambda: catalog.main(device=dev))
    assert store.device.type == "cuda" and "pruned_chunks" in text
    assert len(r8) == 5 and all(v == "electronics" for v in r8.column("category").string_values())
    (res, st), _ = run("certified_search", lambda: certified_search.main(device=dev))
    assert st.certified is True and len(res) == K
    (mstore, mres), text = run("multichip", lambda: multichip.main(devices=[dev] * 4))
    assert "mesh: {'rows': 2, 'batch': 2} over 4 x " + torch.cuda.get_device_name(dev) in text
    assert len(mstore) == 100_000 + 3 and len(mres) == K
    assert "identical results" in text
    return out


def demo_phase():
    from otters_tpu_torch.demo import main as demo

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        store, res = demo(1000, 100)
    text = out.getvalue()
    st = store.last_query_stats()
    assert store.device.type == "cuda"
    assert (st.total_chunks, st.pruned_chunks) == (8, 4), st
    assert len(res) == 5
    assert all(v == 3 for v in res.column("version").values())
    assert all(p < 50 for p in res.column("price").values())
    log(text.split("=== Meta query top 5 (ASCII table) ===")[1].split("Last Meta")[0].strip())
    log("demo twin: pruned_chunks=4 of 8, all results version=3 and price<50")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 1
    # the kernels are what this run measures: the opt-in to the scan
    # programs must not be set (phase 7f sets it for its second runs only)
    assert not os.environ.get("OTTERS_DISABLE_PALLAS"), "OTTERS_DISABLE_PALLAS is set"
    try:
        import otters_tpu_torch  # noqa: F401
        from otters_tpu_torch import kernels
        from otters_tpu_torch.ops import fused_topk as ft
        from otters_tpu_torch.types import Metric
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})", file=sys.stderr)
        return 1
    # exact f32 products for the rerank / rescore (the port checks these)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    with phase("1 card"):
        card = card_line()
        log(card)
    with phase("2 build"):
        t0 = time.perf_counter()
        kernels.build(kernels.SOURCES)
        log(f"nvcc build of {', '.join(s + '.cu' for s in kernels.SOURCES)} (in parallel): "
            f"{time.perf_counter() - t0:.2f} s")
        for name, text in kernels.build_logs.items():
            log(f"[{name}] {text.strip()}")
    with phase("3 kernels vs plain (K1 - K6, int8 / f32 / bf16 rows), accumulation errors"):
        err_ratio, acc = kernel_phase(torch, dev)
    with phase(f"4 main path ({ROWS} x {D})"):
        ft.reset_launches()
        store, f32, batches, truths, stats = main_path(torch, dev, ROWS, card)
    with phase("4u filtered_uncert on the same store (K2)"):
        uncert = uncert_path(torch, store, batches, truths, card)
        timing = {m: time_mode(torch, m, store._dv, batches[0], store.n_chunks())
                  for m in ("K1", "K2")}
        sweep = {m: b_sweep(torch, m, store._dv, torch.cat(batches[:2]), store.n_chunks())
                 for m in ("K1", "K2")}
        dv8 = store._dv
        del store
        torch.cuda.empty_cache()
    with phase(f"4p the row-sharded stores ({ROWS} x {D} int8 over rows=4 and rows=2 x "
               f"batch=2, {SHARD_F32_ROWS} f32 over rows=2, ShardedVecStore, sharded-v1)"):
        sharded = sharded_phase(torch, dev, f32, batches, truths, stats["qps"], card)
        torch.cuda.empty_cache()
    log("phase 4p: " + json.dumps(sharded))
    with phase(f"4pm a mesh across two processes on the card ({ROWS} x {D} int8, rows=4, "
               "gloo)"):
        two_proc = two_process_phase(torch, dev, f32, batches, truths, stats["qps"],
                                     sharded["a"]["qps"], card)
    log("phase 4pm: " + json.dumps(two_proc))
    with phase(f"4s the bench's full column mix ({ROWS} x {D}): tensor ingest, device Bloom "
               "build, precompile, string_eq (K1)"):
        store4s, strings = string_phase(torch, dev, f32, dv8, card)
        del dv8
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with phase(f"4m the MetaStore lifecycle ({ROWS} x {D} int8, K1): extended string filters, "
               f"delete_rows, sorted and Z-ordered stores; append and persistence at "
               f"{LIFE_ROWS} x {D}"):
        held = [store4s]  # the phase frees it after (a) and (b)
        del store4s
        lifecycle = lifecycle_phase(torch, dev, held, f32, batches, truths,
                                    strings["build_s"], card)
        torch.cuda.empty_cache()
    log("phase 4m: " + json.dumps({"card": card, "seconds": time.perf_counter() - t0,
                                   **lifecycle}))
    with phase(f"4f bfloat16 storage ({ROWS} x {D}): K1 / K5 certified, K4 uncertified, "
               "K6 at the one-pass precisions"):
        store, dvb, bf16 = bf16_path(torch, dev, f32, batches, truths, card)
        del f32
        torch.cuda.empty_cache()
        n_chunks = store.n_chunks()
        del store
        for m in ("K1-bf16", "K4-bf16", "K3-bf16", "K6-bf16"):
            timing[m] = time_mode(torch, m, dvb, batches[0], n_chunks)
        timing["K5"] = time_mode(torch, "K5", dvb, batches[0], n_chunks, Metric.DotProduct)
        k5_euclid = time_mode(torch, "K5", dvb, batches[0], n_chunks, Metric.Euclidean)
        sweep["K1-bf16"] = b_sweep(torch, "K1-bf16", dvb, torch.cat(batches[:2]), n_chunks)
        sweep["K5"] = b_sweep(torch, "K5", dvb, torch.cat(batches[:2]), n_chunks,
                              Metric.DotProduct)
        for m in ("K6-bf16", "K4-bf16"):
            sweep[m] = b_sweep(torch, m, dvb, torch.cat(batches[:2]), n_chunks)
        del dvb, batches
        torch.cuda.empty_cache()
    with phase(f"4g bf16 stores ({NEAR_ROWS} x {D}): failed check (K3), near-ties (K5 widen)"):
        bf16_small = bf16_small_phase(torch, dev)
        torch.cuda.empty_cache()
    with phase("4b certificate widening on adversarial near-ties"):
        widen_phase(torch, dev)
        torch.cuda.empty_cache()
    with phase(f"4d depths {DEPTHS} and {DEPTH_K2} ({DEPTH_ROWS} rows): any d on the kernels, "
               "deep rows on the deep-row plan, nothing routed"):
        depth = depth_phase(torch, dev)
    with phase(f"4w the split plan ({SPLIT_ROWS} x {SPLIT_D} bf16 rows, openai5m.f1p's shape): "
               "K1-bf16, K5, K6-bf16 against plain, split_launches, timed"):
        split = split_phase(torch, dev)
    with phase("5 demo twin"):
        demo_phase()
    with phase("5e the example twins (async_serving, catalog, certified_search, multichip)"):
        examples = examples_phase(torch, dev, card)
    with phase(f"6 exact f32 path ({F32_ROWS} x {D}, K4 fast-exact; K6 at \"default\")"):
        store, dv, q0, f32_stats = f32_path(torch, dev, card)
        for m in ("K4", "K3", "K6"):
            timing[m] = time_mode(torch, m, dv, q0, store.n_chunks())
        for m in ("K6", "K4"):
            sweep[m] = b_sweep(torch, m, dv, f32_stats["queries"], store.n_chunks())
    with phase(f"6t take-all on the same store ({TAKE_ALL_B} queries, windowed)"):
        take_all = take_all_phase(torch, store, dv, card)
        del store, dv
        torch.cuda.empty_cache()
    with phase(f"6b failed fast check, Eq and take(200) ({NEAR_ROWS} x {D}, K3)"):
        near = near_tie_path(torch, dev)
        torch.cuda.empty_cache()
    with phase(f"6v VPU metrics ({F32_ROWS} x {D}, f32 and bf16 rows): the pruned scan, "
               "the rerank, VecStore"):
        vpu = vpu_phase(torch, dev, card)
        torch.cuda.empty_cache()
    with phase(f"7 VecStore ({VEC_ROWS} x {D}, f32 and bf16 K4, int8 K2, take-all)"):
        vec = vecstore_path(torch, dev)
    with phase(f"7f the on-card differential fuzz ({FUZZ_TRIALS}+ fused-size trials and a tie "
               "trial, kernels against OTTERS_DISABLE_PALLAS)"):
        fuzz, fuzz_launches = fuzz_phase(dev, card)
        torch.cuda.empty_cache()
    with phase("8 profiling probes (k_mm, k_mm_bins, k_planes) at the script's shapes"):
        probes = probes_phase(torch, dev)

    top = max(PHASE_MEMORY, key=lambda p: PHASE_MEMORY[p][1])
    log(f"peak device memory allocated: {PHASE_MEMORY[top][1]:.1f} GB, in phase {top}; "
        "each phase's (GB at its start, peak, at its end): " + json.dumps(
            {p: [round(x, 2) for x in m] for p, m in PHASE_MEMORY.items()}))
    bf16_path_name = f"bf16 {ROWS} x {D}"
    modes = [
        ("K1", "cert_cos_binmax", "cert_cos_binmax", ":123 (_kernel[certify,cert_cos])",
         stats["launches"],
         {"path": f"certified main path {ROWS} x {D}", "path_qps": stats["qps"],
          "lifecycle_launches": life_launches(lifecycle, "int8"),
          "sharded_launches": {"rows=4": sharded["a"]["launches"],
                               "rows=2 x batch=2": sharded["c"]["launches"]},
          "sharded_path_qps": sharded["a"]["qps"],
          "two_process_launches": [two_proc["ranks"][r]["a"]["launches"] for r in (0, 1)],
          "two_process_qps": [two_proc["ranks"][r]["a"]["qps"] for r in (0, 1)],
          "sharded_ms_per_shard_launch": sharded["a"]["k1_ms_per_shard_launch"],
          "batch_sweep": sweep["K1"], "path_profile": stats["profile"],
          "depth_launches": {d: depth[d]["certified int8 Cosine"] for d in DEPTHS}}),
        ("K2", "int8_binmax", "int8_binmax", ":149 (_kernel[int8, uncertified])",
         uncert["launches"],
         {"path": f"filtered_uncert {ROWS} x {D}", "path_qps": uncert["qps"],
          "path_qps_rounds": uncert["qps_rounds"], "path_profile": uncert["profile"],
          "recall_at_10": uncert["recall"], "vecstore_launches": vec["K2"],
          "sharded_launches": {"rows=4 uncertified": sharded["b"]["launches"]},
          "two_process_launches": [two_proc["ranks"][r]["b"]["launches"] for r in (0, 1)],
          "sharded_recall_at_10": sharded["b"]["recall"],
          "batch_sweep": sweep["K2"],
          "depth_launches": {d: depth[d]["uncertified int8"] for d in depth}}),
        ("K3", "f32_binmax", "f32_binmax", ":182 (_kernel[prec=highest])", near["launches"],
         {"path": f"near-tie strict rerun {NEAR_ROWS} x {D}"}),
        ("K4", "bf16x3_binmax", "bf16x3_binmax", ":168 (_kernel[prec=high, fast])",
         f32_stats["launches"],
         {"path": f"exact f32 {F32_ROWS} x {D}", "path_qps": f32_stats["qps"],
          "path_qps_rounds": f32_stats["qps_rounds"], "path_profile": f32_stats["profile"],
          "vecstore_launches": vec["K4"], "batch_sweep": sweep["K4"],
          "sharded_launches": {f"{SHARD_F32_ROWS} f32 rows=2": sharded["d"]["launches"]},
          "lifecycle_vecstore_launches": lifecycle["append_save"]["vecstore"]["k4_launches"],
          "depth_launches": {d: depth[d]["uncertified f32 Cosine"] for d in DEPTHS}}),
        ("K1-bf16", "cert_cos_binmax_bf16", "cert_cos_binmax",
         ":234 (_kernel[certify,cert_cos], bf16 rows)", bf16["cosine"]["launches"],
         {"path": f"certified Cosine {bf16_path_name}",
          "lifecycle_launches": life_launches(lifecycle, "bfloat16"),
          "path_qps": bf16["cosine"]["qps"], "batch_sweep": sweep["K1-bf16"],
          "split_plan": split["K1-bf16"]}),
        ("K5", "cert_fold_binmax", "cert_fold_binmax",
         ":244 (_kernel[certify, general fold])", bf16["dot"]["launches"],
         {"path": f"certified Dot {bf16_path_name}",
          "path_qps": bf16["dot"]["qps"],
          "euclid_path_qps": bf16["euclid"]["qps"],
          "euclid_launches": bf16["euclid"]["launches"],
          "euclid_ms": k5_euclid["ms"], "euclid_plain_ms": k5_euclid["plain_ms"],
          "euclid_max_abs_err": k5_euclid["max_abs_err"],
          "near_tie_scan_k_wide": bf16_small["widen"], "batch_sweep": sweep["K5"],
          "split_plan": split["K5"],
          "depth_launches": {d: depth[d]["certified bf16 Dot"] for d in DEPTHS}}),
        ("K3-bf16", "f32_binmax_bf16", "f32_binmax",
         ":182 (_kernel[prec=highest], bf16 rows)", bf16_small["launches"],
         {"path": f"bf16 near-tie strict rerun {NEAR_ROWS} x {D}"}),
        ("K4-bf16", "bf16x3_binmax_bf16", "bf16x3_binmax",
         ":168 (_kernel[prec=high, fast], bf16 rows)", bf16["uncert"]["launches"],
         {"path": f"uncertified Cosine {bf16_path_name}", "path_qps": bf16["uncert"]["qps"],
          "path_profile": bf16["uncert"]["profile"],
          "vecstore_launches": vec["K4-bf16"], "batch_sweep": sweep["K4-bf16"],
          "depth_launches": {d: depth[d]["uncertified bf16 Cosine"] for d in DEPTHS}}),
        ("K6", "bf16_binmax", "bf16_binmax",
         ":182 (_kernel[prec=default/bf16], Precision.DEFAULT)", f32_stats["default"]["launches"],
         {"path": f'precision "default" exact-f32 store {F32_ROWS} x {D}',
          "path_qps": f32_stats["default"]["qps"], "batch_sweep": sweep["K6"],
          "depth_launches": {d: depth[d]['f32 "default"'] for d in DEPTHS}}),
        ("K6-bf16", "bf16_binmax_bf16", "bf16_binmax",
         ":182 (_kernel[prec=default/bf16], Precision.DEFAULT, bf16 rows)",
         bf16["default"]["launches"],
         {"path": f'precision "default" Cosine {bf16_path_name}',
          "path_qps": bf16["default"]["qps"], "recall_at_10": bf16["default"]["recall"],
          "path_profile": bf16["default"]["profile"],
          "bf16_precision_qps": bf16["bf16"]["qps"], "batch_sweep": sweep["K6-bf16"],
          "split_plan": split["K6-bf16"],
          "depth_launches": {d: depth[d]['bf16 "default"'] for d in DEPTHS}}),
    ]
    entries = []
    for mode, name, source, line, launches, extra in modes:
        entries.append({
            "name": name, "route": "cuda",
            "source": f"otters_tpu_torch/csrc/{source}.cu",
            "replaces": f"otters_tpu/ops/pallas_topk.py{line}",
            "launches": launches, **timing[mode],
            # the worst max |kernel - plain| / tolerance over the kernel
            # phase's cases, each case against its own tolerance
            "kernel_phase_err_over_tol": err_ratio[mode],
            **({"accumulation_rel_err": acc[mode]} if mode in acc else {}),
            **extra,
        })
    probe_lines = {"k_mm": ":11 (k_mm)", "k_mm_bins": ":16 (k_mm_bins)",
                   "k_planes": ":24 (k_planes)"}
    for name, stats_ in probes.items():
        entries.append({
            "name": name, "route": "cuda", "source": "otters_tpu_torch/csrc/profile_probes.cu",
            "replaces": f"scripts/kernel_profile_variants.py{probe_lines[name]}, "
                        "launched by run :40",
            **stats_, "path": "python -m otters_tpu_torch.profile_variants",
        })
    assert len(entries) == 13, len(entries)
    for e in entries:
        mode = {"int8_binmax": "K2", "f32_binmax": "K3", "bf16x3_binmax": "K4"}.get(e["name"])
        if mode is not None:
            e["fuzz_launches"] = fuzz_launches.get(mode, 0)
    log("phases 4s / 6v / 5e / 7f: " + json.dumps({"card": card, "4s": strings, "6v": vpu,
                                                   "5e": examples, "7f": fuzz}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
