"""K1's time at the main path's shapes, compared between source trees.

    python otters_tpu_torch/k1_ab.py [ROOT:LABEL ...] [--rounds N]

Each ROOT is a checkout (or a copy of ``otters_tpu_torch/`` under ROOT);
the default is this checkout. The trees are measured in interleaved rounds
(A, B, A, B, ...), each in a process of its own that imports the package
from its ROOT and builds its kernels there. Per tree and round it prints
one JSON line: K1 over int8 rows at b = 64 and 256 on 9,766 live bins of
a 10,000,384-row store (the main path's count), the per-call median of 10
CUDA-event timings and three back-to-back means of 10 calls, the max
error against the plain version on 40 bins, the same with queries whose
magnitudes span more than f16's range (``wide``: over int8 rows the scan
then multiplies in bf16), and the library call (one bf16 matmul on rows
cast beforehand, then the bin max). Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

D, N_BINS, BIN = 768, 19532, 512


def _measure(root: str, label: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from otters_tpu_torch import kernels
    from otters_tpu_torch.ops import fused_topk as ft

    assert ft.__file__.startswith(os.path.abspath(root)), ft.__file__
    dev = torch.device("cuda")
    n = N_BINS * BIN
    g = torch.Generator(device=dev).manual_seed(0)
    v = torch.randint(-127, 128, (n, D), generator=g, device=dev, dtype=torch.int8)
    inv = torch.rand(n, generator=g, device=dev) * 0.01 + 0.001
    rmask = (torch.rand(n, generator=g, device=dev) < 0.9).float()
    lane_a = torch.rand(n, generator=g, device=dev) * 1e-5
    surv, n_surv = ft.survivor_bins((torch.arange(N_BINS, device=dev) // 2) % 2 == 1)
    thr = torch.zeros(1, device=dev)
    live = surv[: int(n_surv[0])].long()
    rows = (live[:, None] * BIN + torch.arange(BIN, device=dev)).reshape(-1)
    v_live = v[rows].bfloat16()

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

    res = {"label": label}
    for b in (64, 256):
        q = torch.randn((b, D), generator=g, device=dev)
        for kind in ("normal", "wide"):
            qk = q.clone()
            if kind == "wide":  # every query: half its elements 2^-40 of the rest
                qk[:, ::2] *= 2.0 ** -40
            qk = qk.bfloat16()
            q_inv = 1.0 / qk.float().norm(dim=1)
            args = (qk, v, inv, rmask, lane_a, q_inv, torch.ones(b, device=dev), thr, surv,
                    n_surv)
            fn = lambda: ft.cert_cos_binmax(*args)  # noqa: E731
            got = fn()
            sl = torch.tensor([40], dtype=torch.int32, device=dev)
            want = ft.cert_cos_binmax_plain(*args[:8], surv[:40].contiguous(), sl)
            err = float((got[live[:40]] - want[live[:40]]).abs().max())
            res[f"b={b} {kind}"] = {"per_call": per_call(fn), "b2b": back_to_back(fn),
                                   "err": err}
        res[f"b={b} library"] = per_call(
            lambda: torch.matmul(q.bfloat16(), v_live.T).reshape(b, -1, BIN).amax(dim=2))
    res["ptxas"] = [ln.strip() for ln in kernels.build_logs.get("cert_cos_binmax", "").splitlines()
                    if "registers" in ln or "stack" in ln or "spill" in ln]
    return res


def main(argv) -> int:
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if argv and argv[0] == "--child":
        print(json.dumps(_measure(argv[1], argv[2])), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [a.split(":", 1) for a in argv] or [[here, "this"]]
    rc = 0
    for _ in range(rounds):
        for root, label in trees:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, label],
                               capture_output=True, text=True)
            lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
            print(lines[-1] if lines else json.dumps({"label": label, "rc": p.returncode,
                                                      "stderr": p.stderr[-2000:]}), flush=True)
            rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
