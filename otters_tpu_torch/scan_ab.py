"""The sm90 scan kernels' times at their paths' shapes, compared between
source trees.

    python otters_tpu_torch/scan_ab.py [ROOT:LABEL ...] [--rounds N]
        [--modes K1,K1-bf16,K2,K3,K3-bf16,K5,K6,K6-bf16,K4,K4-bf16,k_planes,k_mm,
                 k_mm_bins]
        [--b 64,256]

Each ROOT is a checkout (or a copy of ``otters_tpu_torch/`` under ROOT);
the default is this checkout. The trees are measured in interleaved rounds
(A, B, A, B, ...), each in a process of its own that imports the package
from its ROOT and builds its kernels there. Per tree and round it prints
one JSON line with, per kernel and batch size: the per-call median of 10
CUDA-event timings, three back-to-back means of 10 calls, the max error
against the plain version on 40 bins (the probes: on every bin), the
SASS statistics of each FFMA kernel (registers, spills, its loop's
instruction mix), and the
library call (one bf16 matmul on rows cast beforehand, then the bin max;
K4-bf16: two, one per query plane; K4 and k_planes: three, on planes split
beforehand; K2 ``torch._int_mm``; K3, K3-bf16, k_mm and k_mm_bins one f32
matmul, TF32 off, on rows upcast beforehand). The shapes are the paths' of
``chip_smoke.py`` at d = 768, half the 1024-row chunks pruned: K1 and K2
over 10,000,384 int8 rows (K1 ``wide``: queries whose magnitudes span more
than f16's range, so the scan multiplies in bf16; K2 with int8 queries)
and K1-bf16 / K5 (Dot) / K6-bf16 / K4-bf16 / K3-bf16 (Cosine) over as many
bf16 rows; K6, K4 and K3 (Cosine) over 4,000,256 f32 rows; the probes
k_planes, k_mm and k_mm_bins at the shapes of
scripts/kernel_profile_variants.py (1,007,616 f32 rows or their VH / VL,
every bin). The rows and their side data are random, made
on the device from a seed. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

D, BIN = 768, 512
N_BINS = {"K1": 19532, "K1-bf16": 19532, "K2": 19532, "K3": 7813, "K3-bf16": 19532,
          "K5": 19532, "K6": 7813, "K6-bf16": 19532, "K4": 7813, "K4-bf16": 19532}
F32_ROWS = ("K6", "K4", "K3")  # the modes over f32 rows


def _timers(torch):
    def per_call(fn, reps=10, warm=3):
        for _ in range(warm):
            fn()
        ts = []
        for _ in range(reps):
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(a.elapsed_time(e))
        return round(statistics.median(ts), 3)

    def back_to_back(fn, reps=10):
        out = []
        for _ in range(3):
            torch.cuda.synchronize()
            a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            e.record()
            e.synchronize()
            out.append(round(a.elapsed_time(e) / reps, 3))
        return out

    return per_call, back_to_back


def _operands(torch, ft, mode, g, dev):
    """(rows, a function of the kernel's queries (bf16; K4 and K3 f32, K2
    int8) giving the wrapper's args, kernel, plain) of ``mode``."""
    n = N_BINS[mode] * BIN
    if mode in ("K1", "K2"):
        v = torch.randint(-127, 128, (n, D), generator=g, device=dev, dtype=torch.int8)
    elif mode in F32_ROWS:
        v = torch.randn((n, D), generator=g, device=dev)
    else:
        v = torch.randn((n, D), generator=g, device=dev).bfloat16()
    inv = torch.rand(n, generator=g, device=dev) * 0.01 + 0.001
    rmask = (torch.rand(n, generator=g, device=dev) < 0.9).float()
    lane = torch.rand(n, generator=g, device=dev) * 1e-5
    nsq = v[:, :64].float().square().sum(1) * (D / 64)
    thr = torch.zeros(1, device=dev)

    def args(qk, surv, n_surv):
        b = qk.shape[0]
        q_inv = 1.0 / qk.float().norm(dim=1)
        ones = torch.ones(b, device=dev)
        if mode in ("K1", "K1-bf16"):
            return (qk, v, inv, rmask, lane, q_inv, ones, thr, surv, n_surv)
        q_sq = qk.float().square().sum(1)
        if mode == "K5":
            c = torch.full((b,), 1e-4, device=dev)
            return (qk, v, inv, nsq, rmask, lane, lane * 0.5, q_inv, q_sq, ones, c, c, c, thr,
                    surv, n_surv)
        return (qk, v, inv, nsq, rmask, q_inv, q_sq, ones, thr, surv, n_surv)

    if mode in ("K1", "K1-bf16"):
        return v, args, lambda a: ft.KERNELS[mode](*a), lambda a: ft.cert_cos_binmax_plain(*a)
    if mode == "K5":
        return (v, args, lambda a: ft.cert_fold_binmax(*a, ft.Metric.DotProduct, False, None),
                lambda a: ft.cert_fold_binmax_plain(*a, metric=ft.Metric.DotProduct,
                                                    take_min=False, cmp=None))
    return (v, args, lambda a: ft.KERNELS[mode](*a, ft.Metric.Cosine, False, None),
            lambda a: ft.binmax_plain(mode, *a, metric=ft.Metric.Cosine, take_min=False,
                                      cmp=None))


def _library(torch, mode, q, v_live, b, vl_live=None):
    """One PyTorch call (per product) for the same dots, then the bin max:
    the yardstick. K4 / k_planes: the rows' low plane ``vl_live`` beside
    their high plane ``v_live``; K2 the int8 queries and rows, K3 the f32
    queries and rows (upcast beforehand)."""
    if mode == "K2":
        return lambda: torch._int_mm(q, v_live.T).reshape(b, -1, BIN).amax(dim=2)
    if mode.startswith("K3"):
        return lambda: torch.matmul(q, v_live.T).reshape(b, -1, BIN).amax(dim=2)
    qb = q.bfloat16()
    if mode.startswith("K4") or mode == "k_planes":
        ql = (q - qb.float()).bfloat16()
        if vl_live is None:  # K4-bf16: the rows' low plane is 0
            return lambda: (torch.matmul(qb, v_live.T) + torch.matmul(ql, v_live.T)).reshape(
                b, -1, BIN).amax(dim=2)
        return lambda: (torch.matmul(qb, v_live.T) + torch.matmul(qb, vl_live.T)
                        + torch.matmul(ql, v_live.T)).reshape(b, -1, BIN).amax(dim=2)
    return lambda: torch.matmul(qb, v_live.T).reshape(b, -1, BIN).amax(dim=2)


def _measure_probe(torch, name, dev, bs, per_call, back_to_back, res):
    """The probe ``name`` (k_planes, k_mm or k_mm_bins) at the script's
    shapes, every bin, for each b; the library call one f32 matmul (k_mm,
    k_mm_bins: TF32 off) or three bf16 ones on the planes, then the bin
    max."""
    from otters_tpu_torch import profile_variants as pv

    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((pv.N_PAD, D), generator=g, device=dev)
    if name == "k_planes":
        rows = pv.split_planes(v)
        del v
    else:
        rows = (v,)
    fn, plain = pv.PROBES[name], pv.PLAIN[name]
    for b in bs:
        q = torch.randn((b, D), generator=g, device=dev)
        err = float((fn(q, *rows) - plain(q, *rows)).abs().max())
        res[f"{name} b={b} normal"] = {"per_call": per_call(lambda: fn(q, *rows)),
                                       "b2b": back_to_back(lambda: fn(q, *rows)), "err": err}
        lib = "k_planes" if name == "k_planes" else "K3"
        res[f"{name} b={b} library"] = per_call(_library(torch, lib, q, rows[0], b, *rows[1:]))


def _sass_stats(kernels) -> dict:
    """Per FFMA kernel of the loaded libraries (``cuobjdump -sass``; ptxas
    -v reports only the launch's register count): the highest register
    the code uses, its local stores (spills), and over its FFMA loop the
    instructions, FFMAs, shared loads and FFMAs that read two sources
    without a reuse flag from one register bank (register number mod 4)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    ffma = re.compile(r"\bFFMA R\d+, R(\d+)(\.reuse)?, R(\d+)(\.reuse)?, R(\d+)")
    out = {}
    for name in sorted(kernels._libs):
        sass = subprocess.run([tool, "-sass", kernels._lib_path(name)], capture_output=True,
                              text=True).stdout
        for fn in sass.split("Function : ")[1:]:
            code = [ln for ln in fn.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
            at = [i for i, ln in enumerate(code) if " FFMA " in ln]
            if len(at) < 256:
                continue
            # the chunk loop: after the last branch, sync or barrier wait
            # before the first FFMA, to the backward branch after the last
            mark = re.compile(r" BRA |BSSY|SYNCS")
            head = max(i for i in range(at[0]) if mark.search(code[i])) + 1
            tail = next(i for i in range(at[-1], len(code)) if " BRA " in code[i])
            loop = code[head : tail + 1]
            same_bank = 0
            for ln in loop:
                m = ffma.search(ln)
                if m:
                    srcs = [int(m[1])] * (not m[2]) + [int(m[3])] * (not m[4]) + [int(m[5])]
                    same_bank += len({r % 4 for r in srcs}) < len(srcs)
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", "\n".join(code))]
            out[fn.split()[0]] = {
                "max_reg": max(regs), "local_stores": sum("STL" in ln for ln in code),
                "loop": len(loop), "ffma": len(at), "lds": sum(" LDS" in ln for ln in loop),
                "same_bank_ffma": same_bank}
    return out


def _measure(root: str, label: str, modes, bs) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from otters_tpu_torch import kernels
    from otters_tpu_torch.ops import fused_topk as ft
    from otters_tpu_torch.ops import scoring as sc

    assert ft.__file__.startswith(os.path.abspath(root)), ft.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    per_call, back_to_back = _timers(torch)
    res = {"label": label}
    for mode in modes:
        if mode in ("k_planes", "k_mm", "k_mm_bins"):
            _measure_probe(torch, mode, dev, bs, per_call, back_to_back, res)
            continue
        g = torch.Generator(device=dev).manual_seed(0)
        v, args, kernel, plain = _operands(torch, ft, mode, g, dev)
        n_bins = N_BINS[mode]
        surv, n_surv = ft.survivor_bins((torch.arange(n_bins, device=dev) // 2) % 2 == 1)
        live = surv[: int(n_surv[0])].long()
        rows = (live[:, None] * BIN + torch.arange(BIN, device=dev)).reshape(-1)
        # the library call's operands, cast beforehand
        v_live = (v[rows] if mode == "K2" else v[rows].float() if mode.startswith("K3")
                  else v[rows].bfloat16())
        vl_live = (v[rows] - v_live.float()).bfloat16() if mode == "K4" else None
        sl = torch.tensor([40], dtype=torch.int32, device=dev)
        for b in bs:
            q = torch.randn((b, D), generator=g, device=dev)
            for kind in ("normal", "wide") if mode == "K1" else ("normal",):
                qk = q.clone()
                if kind == "wide":  # every query: half its elements 2^-40 of the rest
                    qk[:, ::2] *= 2.0 ** -40
                if mode == "K2":
                    qk = sc._quantize_rows_int8(qk)[0]
                elif not mode.startswith(("K3", "K4")):
                    qk = qk.bfloat16()
                a = args(qk, surv, n_surv)
                got = kernel(a)
                want = plain(a[:-2] + (surv[:40].contiguous(), sl))
                err = float((got[live[:40]] - want[live[:40]]).abs().max())
                res[f"{mode} b={b} {kind}"] = {"per_call": per_call(lambda: kernel(a)),
                                              "b2b": back_to_back(lambda: kernel(a)),
                                              "err": err}
            qlib = a[0] if mode == "K2" else q
            res[f"{mode} b={b} library"] = per_call(
                _library(torch, mode, qlib, v_live, b, vl_live))
        del v, v_live, vl_live
        torch.cuda.empty_cache()
    res["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in kernels.build_logs.items()}
    res["sass"] = _sass_stats(kernels)
    return res


def main(argv) -> int:
    opts = {"--rounds": "2", "--modes": "K1,K1-bf16,K5,K6,K6-bf16,K4,K4-bf16,k_planes",
            "--b": "64,256"}
    for key in list(opts):
        if key in argv:
            i = argv.index(key)
            opts[key] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    if argv and argv[0] == "--child":
        modes, bs = opts["--modes"].split(","), [int(x) for x in opts["--b"].split(",")]
        print(json.dumps(_measure(argv[1], argv[2], modes, bs)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [a.split(":", 1) for a in argv] or [[here, "this"]]
    rc = 0
    for _ in range(int(opts["--rounds"])):
        for root, label in trees:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, label,
                                "--modes", opts["--modes"], "--b", opts["--b"]],
                               capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            print(lines[-1] if lines else json.dumps({"label": label, "rc": p.returncode,
                                                      "stderr": p.stderr[-2000:]}), flush=True)
            rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
