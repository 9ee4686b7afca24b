"""The readings that the limit of ``worst_gap`` is set from, for one cell.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--program-seconds 3]

For each seed, in one process: the cell's inputs at its own size, the f32
reference's answers for every pool entry (the truth), and the control's:
the same reference in TF32, put in the program's place and judged as the
program is. With ``--program-seconds``, also the program's readings: a run
of the cell (``harness.run_cell``) with a window of that length on the same
seed. The benchmark's own runs never run the control. A cell of several
chips takes that many cards (``cuda:0`` ...), as ``run.py`` does. Prints one
line a seed and, last, a JSON object of every reading.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_verdict(cell, seed: int, devices, overrides=None):
    """The TF32 control's verdict on one seed's inputs (``devices``: one
    device or a list, as ``harness.run_cell`` takes them)."""
    from benchmark import data, harness, judge, reference, spec, system

    sz = harness.sizes(cell, overrides)
    devs = system.devices(devices)
    inputs = data.make(cell.config, sz["rows"], sz["dim"], sz["pool"], sz["batch"], seed,
                       devs[0])
    filt = cell.mix["filter"]
    keep = reference.keep_mask(inputs.columns[filt["column"]], filt["op"],
                               spec.keep_from(cell.mix, sz["rows"]))
    metric, k = cell.config["metric"], int(cell.mix["k"])
    on = system.cards(devs) or devs[:1]
    truth = reference.topk(inputs.rows, keep, inputs.queries, k, metric, devices=on)
    ctl = reference.topk(inputs.rows, keep, inputs.queries, k, metric, tf32=True, devices=on)
    # the control answers as the program does: its scores, not its keys
    answers = [judge.Answer(i, rows, reference.key(keys, metric))
               for i, (rows, keys) in enumerate(zip(ctl.rows, ctl.keys))]
    return judge.judge(answers, truth, inputs.rows, inputs.queries, keep,
                       float(cell.config["limits"]["worst_gap"]),
                       bool(cell.config.get("certified", False)), metric)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from benchmark.run import fixed_caches

    fixed_caches()
    import torch

    from benchmark import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the control runs on {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    torch.backends.cuda.matmul.allow_tf32 = False
    readings = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        got = {"control": control_verdict(cell, seed, devices).checks()}
        torch.cuda.empty_cache()
        if args.program_seconds > 0:
            out = harness.run_cell(cell, seed, args.program_seconds, False, devices,
                                   time.perf_counter())
            got["program"] = out["checks"]
            got["program_correct"] = out["correct"]
            torch.cuda.empty_cache()
        readings[seed] = got
        line = ", ".join(f"{side} {got[side]['worst_gap']['value']!r}"
                         for side in ("program", "control") if side in got)
        print(f"seed {seed}: worst_gap {line} ({time.perf_counter() - t0:.1f} s)",
              file=sys.stderr, flush=True)
    print(json.dumps({"workload": cell.name, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
