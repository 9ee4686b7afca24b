"""Run one cell of the benchmark of ``otters_tpu_torch`` on its H100s.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks`` last); the numbers compared
with the reference, each beside its limit, are also the last lines of
standard error. The cell's ``chips`` cards (``cuda:0`` ...) hold its store.
With no CUDA device, or fewer than the cell asks for, it prints no result
and exits with 3.
"""

import time

T_PROCESS = time.perf_counter()  # the start of set-up

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fixed_caches() -> None:
    """Every compiled artifact in fixed directories of the checkout, so that
    only a cell's first run there builds."""
    build = os.path.join(ROOT, "build")
    os.environ["OTTERS_AOT_CACHE"] = os.path.join(build, "otters_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches()
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT  # the package ``benchmark``, not its files as modules
    else:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark import guard, harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 3
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), devices, T_PROCESS)
    found = guard.offenders()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
