"""Readings for a cell's limits: the program's compared numbers on many
seeds, and the control's (the reference in the next lower precision, in
the program's place) on some of them, all in one process.

    python3 -m port_bench.calibrate --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 5 [--fault half] [--out calib.jsonl]

Prints one JSON line per seed: {"seed", "program": {...}, "control":
{...}}. Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default="")
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--fault", default="", help="plant a fault of port_bench.faults in the "
                   "program first (unchanged, half, altered)")
    args = p.parse_args(argv)
    import torch

    from port_bench import harness

    torch.set_num_threads(4)
    cell = harness.load_cell(args.root, args.workload)
    drv = harness.runner_of(cell)
    if args.fault:
        from port_bench import faults

        obj, attr, fn = faults.BY_RUNNER[cell.traffic["runner"]](args.fault)
        setattr(obj, attr, fn)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = harness.Context(cell, seed, args.seconds, False)
        t0 = time.perf_counter()
        st = drv.setup(ctx)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        win = drv.window(ctx, st)
        peak = torch.cuda.max_memory_allocated()
        drv.release(st)
        rec = {"workload": args.workload, "fault": args.fault, "seed": seed, "setup_s": setup_s,
               "window": win["metrics"], "memory_peak_bytes": peak,
               "program": {k: v for k, (v, _) in drv.judge(ctx, st).items()}}
        if seed in controls:
            rec["control"] = drv.control(ctx, st)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del st
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
