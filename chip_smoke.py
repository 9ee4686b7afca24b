#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (otters_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. the card: name and power limit (nvidia-smi);
2. the build: every Hopper kernel of the main path from ``csrc/`` with nvcc
   (one process per source, started together);
3. the kernel phase: K1 (csrc/cert_cos_binmax.cu) against its plain torch
   version at d = 768, b = 256, 1024-row chunks with half of them pruned,
   plus its accumulation error against float64 dots;
4. the main path at the bench's size: a 10M x 768 int8 store quantized on
   the device from seeded f32 rows, bench.py's price/version columns, the
   filter ``price < 50 & version >= 2`` (prunes half the chunks), pipelined
   ``collect_async`` batches of 256 Cosine queries with
   ``take(10, rerank_from=100)`` and ``resolve``; every query certified and
   equal to an exact f32 filtered top-10; then K1 timed at these shapes
   against its plain version, a library yardstick and its bound;
   4b. adversarial near-ties (1M x 768) that make the certificate widen
   through the fused kernel and past it into the scan program;
5. the twin of examples/demo.py on the card.

Phase 4 also traces one pipelined round with torch.profiler (device time
by kernel, the device's busy share). The script prints the kernels JSON
line and the card's name and power limit, and last ``{"ok": true,
"device": {...}}``. Any failed check exits non-zero without that line; so
does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
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
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
SEED = 1234


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: done in {time.perf_counter() - t0:.2f} s")


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


def k1_inputs(dv, queries, chunk_mask):
    """K1's operands for a store, a query batch and a chunk mask, built the
    way the fused path builds them (certified cosine, no score filter)."""
    import torch

    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Metric

    n_pad, d = dv.vectors.shape
    qh32, c0, _, _ = sc.cert_query_coeffs(Metric.Cosine, queries, d)
    _, q_inv = sc._query_norms(qh32)
    alive = ft.bins_alive_from_chunk_mask(chunk_mask, CHUNK, n_pad)
    surv, n_surv = ft.survivor_bins(alive)
    rows_alive = torch.repeat_interleave(chunk_mask, CHUNK)[:n_pad]
    if rows_alive.shape[0] < n_pad:
        rows_alive = torch.cat([rows_alive, rows_alive.new_zeros(n_pad - rows_alive.shape[0])])
    rmask = (dv.valid & rows_alive).float()
    thr = torch.zeros(1, device=queries.device)
    q_ok = torch.ones(queries.shape[0], device=queries.device)
    return [qh32.to(torch.bfloat16), dv.vectors, dv.inv_norms, rmask, dv.resid,
            q_inv, q_ok, thr, surv, n_surv]


def compare_k1(args, cmp=None):
    """Kernel vs plain on the same operands -> max abs error (checked)."""
    import torch

    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops.scoring import mixed_cert_eps

    got = ft.cert_cos_binmax(*args, cmp)
    want = ft.cert_cos_binmax_plain(*args, cmp)
    torch.cuda.synchronize()
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    assert torch.equal(fin_g, fin_w), "K1: -inf pattern differs from the plain version"
    assert bool(fin_w.any()) and not bool(fin_w.all()), "K1: degenerate test pattern"
    err = float((got[fin_w] - want[fin_w]).abs().max())
    tol = mixed_cert_eps(args[0].shape[1])
    assert err <= tol, f"K1: max |kernel - plain| = {err} > mixed_cert_eps = {tol}"
    return err, tol


def accumulation_error(args):
    """Largest |kernel dot - float64 dot| / (|qh| |v|) over one unmasked row
    per live bin: with unit norms and zero lanes K1's bin max is exactly the
    accumulated dot of that row."""
    import torch

    from otters_tpu_torch.ops import fused_topk as ft

    q, v, _, _, _, _, _, _, surv, n_surv = args
    n_pad = v.shape[0]
    live = surv[: int(n_surv[0])].long()
    worst = 0.0
    for salt in (11, 301):
        rows = live * ft.BIN + (live * 37 + salt) % ft.BIN
        rmask = torch.zeros(n_pad, device=q.device)
        rmask[rows] = 1.0
        ones_b = torch.ones(q.shape[0], device=q.device)
        out = ft.cert_cos_binmax(
            q, v, torch.ones(n_pad, device=q.device), rmask,
            torch.zeros(n_pad, device=q.device), ones_b, ones_b,
            torch.zeros(1, device=q.device), surv, n_surv, None,
        )
        got = out[live].double()
        vr = v[rows].double()
        qd = q.double()
        exact = vr @ qd.T
        scale = vr.norm(dim=1)[:, None] * qd.norm(dim=1)[None, :]
        nz = scale > 0
        worst = max(worst, float(((got - exact).abs()[nz] / scale[nz]).max()))
    return worst


def kernel_phase(torch, dev):
    """K1 vs plain at d = 768, b = 256, 2M rows, half the chunks dead."""
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc
    from otters_tpu_torch.types import Cmp

    n = 2_000_000
    g = torch.Generator(device=dev).manual_seed(SEED)
    dv = sc.materialize_int8_slabs(
        lambda s, r: torch.randn((r, D), generator=g, device=dev), n, D, SLAB, device=dev
    )
    n_chunks = -(-n // CHUNK)
    chunk_mask = torch.arange(n_chunks, device=dev) % 2 == 1
    queries = torch.randn((B, D), generator=g, device=dev)
    args = k1_inputs(dv, queries, chunk_mask)
    err, tol = compare_k1(args)
    log(f"K1 vs plain (2M rows, b={B}, no filter): max_abs_err={err:.3e} tol={tol:.3e}")
    # a score filter, a batch that is not a whole number of query blocks
    args70 = k1_inputs(dv, queries[:70].contiguous(), chunk_mask)
    args70[7] = torch.full((1,), 0.05, device=dev)
    err70, _ = compare_k1(args70, Cmp.Gt)
    log(f"K1 vs plain (b=70, Gt 0.05): max_abs_err={err70:.3e}")
    # nothing alive: every block returns at once
    none_alive = list(args)
    none_alive[8], none_alive[9] = ft.survivor_bins(
        torch.zeros(dv.vectors.shape[0] // ft.BIN, dtype=torch.bool, device=dev)
    )
    out0 = ft.cert_cos_binmax(*none_alive)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(out0).all()), "K1: n_surv = 0 must leave every bin -inf"
    acc = accumulation_error(args)
    gamma = D * 2.0**-24
    log(f"K1 accumulation error: max |dot - f64| / (|qh||v|) = {acc:.3e}  "
        f"(d*2^-24 = {gamma:.3e}, mixed_cert_eps = {sc.mixed_cert_eps(D):.3e})")
    assert acc <= gamma, "K1 accumulation error exceeds the certificate's d*2^-24 share"
    del dv, args, args70, none_alive
    torch.cuda.empty_cache()
    return acc


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


def ground_truth(f32, n, queries, k=K):
    """Exact f32 filtered (odd chunks) global top-k of one batch, in slabs."""
    import torch

    qn = queries / queries.norm(dim=1, keepdim=True)
    best_s = torch.empty(0, device=f32.device)
    best_r = torch.empty(0, dtype=torch.int64, device=f32.device)
    for s in range(0, n, SLAB):
        rows = torch.arange(s, min(n, s + SLAB), device=f32.device)
        keep = rows[(rows // CHUNK) % 2 == 1]
        if keep.numel() == 0:
            continue
        v = f32[keep]
        vn = v / v.norm(dim=1, keepdim=True)
        scores = (qn @ vn.T).reshape(-1)
        top = torch.topk(scores, min(k, scores.numel()))
        best_s = torch.cat([best_s, top.values])
        best_r = torch.cat([best_r, keep[top.indices % keep.numel()]])
    top = torch.topk(best_s, k)
    return best_r[top.indices].tolist(), top.values.tolist()


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

    def flt():
        return tx.col("price").lt(50.0) & tx.col("version").gte(2)

    def pending(q):
        return (
            store.query_batch(q, tx.Metric.Cosine).meta_filter(flt())
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

    ft.cert_cos_binmax.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    pend = [pending(q) for q in batches]
    results = tx.resolve(pend)
    sync(dev)
    elapsed = time.perf_counter() - t0
    launches = ft.cert_cos_binmax.launches
    qps = BATCHES * B / elapsed
    log(f"main path: {BATCHES} pipelined batches of {B} in {elapsed:.3f} s = "
        f"{qps:.1f} q/s (build {build_s:.2f} s) on {card}; K1 launches {launches}")
    if dev.type == "cuda":
        assert launches >= BATCHES, f"K1 launched {launches} times for {BATCHES} scans"
    for i, p in enumerate(pend):
        st = p.stats()
        assert st.certified is True, f"batch {i} not certified: {st}"
        # the even chunks are pruned: half of them (n_chunks // 2 at 10M)
        assert st.pruned_chunks == (store.n_chunks() + 1) // 2, f"batch {i}: {st}"
    small_res = pending(small).result()
    checked = 0
    for q, res in list(zip(batches, results)) + [(small, small_res)]:
        gt_rows, gt_scores = ground_truth(f32, n, q)
        assert sorted(res.indices) == sorted(gt_rows), (res.indices, gt_rows)
        want = dict(zip(gt_rows, gt_scores))
        err = max(abs(s - want[r]) for r, s in zip(res.indices, res.scores))
        assert err <= 1e-5, f"rerank score differs from the f32 truth by {err}"
        checked += q.shape[0]
    log(f"exact f32 ground truth: top-{K} equal for {checked} queries "
        f"({BATCHES} batches of {B} + one of 32)")
    if dev.type == "cuda":
        profile_batches(torch, pending, batches)
    stats = {"qps": qps, "build_s": build_s, "synth_s": synth_s,
             "launches": launches, "scan_k_wide": pend[-1].stats().scan_k_wide}
    return store, f32, batches[0], stats


def profile_batches(torch, pending, batches):
    """One pipelined round under torch.profiler: device time by kernel and
    the device's busy share of the wall time."""
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


def time_k1(torch, store, queries):
    """K1, its plain version and a library yardstick at the main path's
    shapes, and the bound for the same work."""
    from otters_tpu_torch.ops import fused_topk as ft

    dv = store._dv
    n_chunks = store.n_chunks()
    chunk_mask = torch.arange(n_chunks, device=queries.device) % 2 == 1
    args = k1_inputs(dv, queries, chunk_mask)
    err, tol = compare_k1(args)
    n_live = int(args[9][0])
    live_rows = n_live * ft.BIN
    kernel_ms = time_ms(lambda: ft.cert_cos_binmax(*args))
    plain_ms = time_ms(lambda: ft.cert_cos_binmax_plain(*args), reps=20, warm=1)
    # yardstick: one bf16 matmul of the queries against the live rows (cast
    # to bf16 beforehand) plus a max over 512-row bins; the port never uses it
    live = args[8][:n_live].long()
    rows = (live[:, None] * ft.BIN + torch.arange(ft.BIN, device=live.device)).reshape(-1)
    v_bf16 = dv.vectors[rows].to(torch.bfloat16)
    q_bf16 = args[0]
    library_ms = time_ms(
        lambda: torch.matmul(q_bf16, v_bf16.T).reshape(B, n_live, ft.BIN).amax(dim=2)
    )
    del v_bf16
    n_bins = dv.vectors.shape[0] // ft.BIN
    bytes_moved = (live_rows * D + live_rows * 12 + B * D * 2 + B * 8 + 4
                   + n_bins * 4 + n_bins * B * 4)
    ops = 2.0 * B * D * live_rows
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / PEAK_BF16_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    log(f"K1 at the main path: live rows {live_rows}, kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), max_abs_err {err:.3e}")
    return dict(
        max_abs_err=err, tol=tol, ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
    )


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
    qn = queries / queries.norm(dim=1, keepdim=True)
    vn = f32[:n] / f32[:n].norm(dim=1, keepdim=True)
    top = torch.topk((qn @ vn.T).reshape(-1), K)
    truth = dict(zip((top.indices % n).tolist(), top.values.tolist()))
    err = max(abs(sv - truth.get(r, float("inf"))) for r, sv in zip(res.indices, res.scores))
    log(f"near-ties: certified={st.certified} scan_k_wide={st.scan_k_wide} "
        f"K1 launches={launches}; top-{K} vs f32 truth: max score diff {err:.2e}")
    assert st.certified is True and st.scan_k_wide > ft.FUSED_K_MAX, st
    if dev.type == "cuda":
        assert launches >= 2, "the widen loop should rescan on the fused kernel"
    assert sorted(res.indices) == sorted(truth) and err <= 1e-5, (res.indices, truth)


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
    try:
        import otters_tpu_torch  # noqa: F401
        from otters_tpu_torch import kernels
        from otters_tpu_torch.ops import fused_topk as ft
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
        kernels.build(["cert_cos_binmax"])
        log(f"nvcc build of cert_cos_binmax.cu: {time.perf_counter() - t0:.2f} s")
        for name, text in kernels.build_logs.items():
            log(f"[{name}] {text.strip()}")
    with phase("3 kernel (K1 vs plain, accumulation error)"):
        acc = kernel_phase(torch, dev)
    with phase(f"4 main path ({ROWS} x {D})"):
        store, f32, q0, stats = main_path(torch, dev, ROWS, card)
        del f32
        torch.cuda.empty_cache()
        timing = time_k1(torch, store, q0)
        del store
        torch.cuda.empty_cache()
    with phase("4b certificate widening on adversarial near-ties"):
        widen_phase(torch, dev)
        torch.cuda.empty_cache()
    with phase("5 demo twin"):
        demo_phase()

    entry = {
        "name": "cert_cos_binmax",
        "route": "cuda",
        "source": "otters_tpu_torch/csrc/cert_cos_binmax.cu",
        "replaces": "otters_tpu/ops/pallas_topk.py:123 (_kernel[certify,cert_cos])",
        "launches": stats["launches"],
        **timing,
        "kernel_ms": timing["ms"],
        "accumulation_rel_err": acc,
        "main_path_qps": stats["qps"],
        "main_path_rows": ROWS,
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
