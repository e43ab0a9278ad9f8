"""Where the time of the PyTorch port's batched heuristic rollout goes, on one
CUDA GPU.

    python scripts/profile_torch_rollout.py [--steps 50] [--repeats 3]
        [--out chiprun_out/profile_torch_rollout.json]

1. Cells: reset + `steps` steps of dispatcher + step (`heuristic_rollout`)
   for each (env id, B, bfs_kernel) below, host wall clock around work that
   ends in torch.cuda.synchronize(), after one warm-up each. The cells run in
   turn, `repeats` rounds, so a slow spell of the host falls on all of them;
   every reading is kept. Peak device memory per cell.
2. Medium, B = 2048: dispatcher and step timed apart, synchronised after
   each (host bound, so the sum exceeds the unsynchronised step).
3. Medium, B = 2048: a torch.profiler trace of 10 steps: device busy time
   (kernels and copies), kernel launches and copies per step, and the
   device ops that take the most time.

Prints one line per reading and writes everything as JSON to --out.
Imports torch only (not jax).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from swarm_ode_tpu_torch.config import EnvConfig  # noqa: E402
from swarm_ode_tpu_torch.env import step as step_mod  # noqa: E402
from swarm_ode_tpu_torch.env.layout import build_layout  # noqa: E402
from swarm_ode_tpu_torch.env.state import make_params  # noqa: E402
from swarm_ode_tpu_torch.policies.heuristic import (  # noqa: E402
    heuristic_rollout,
    init_state,
    make_policy,
)

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
# (env id, B, bfs_kernel): the first benchmark's candidate cells, then the
# medium batch sweep.
CELLS = [
    (MEDIUM, 2048, "auto"),
    ("tarware-extralarge-19agvs-9pickers-partialobs-v1", 1024, "auto"),
    (MEDIUM, 2048, "int32"),
    ("tarware-tiny-3agvs-2pickers-partialobs-v1", 2048, "auto"),
    (MEDIUM, 64, "auto"),
    (MEDIUM, 8192, "auto"),
    (MEDIUM, 32768, "auto"),
]


def setup(env_id, bfs_kernel):
    cfg = EnvConfig.from_env_id(env_id, bfs_kernel=bfs_kernel)
    lay = build_layout(cfg)
    return lay, make_params(cfg, lay, "cuda")


def cell_rate(lay, pp, B, steps, gen):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = heuristic_rollout(pp, lay, B, steps, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return B * steps / dt, int(out.replan_overflow.sum())


def split(lay, pp, B, steps, gen):
    """Mean synchronised ms per step of the dispatcher and of the step."""
    policy = make_policy(pp, lay)
    es = step_mod.reset(pp, B, gen)
    h = init_state(pp, B)
    t_pol = t_step = 0.0
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actions, h = policy(pp, es, h)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        torch.cuda.synchronize()
        t_pol += t1 - t0
        t_step += time.perf_counter() - t1
    return 1e3 * t_pol / steps, 1e3 * t_step / steps


def trace(lay, pp, B, steps, gen):
    """Device busy ms, launches and copies per step from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    policy = make_policy(pp, lay)
    es = step_mod.reset(pp, B, gen)
    h = init_state(pp, B)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            actions, h = policy(pp, es, h)
            es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    launches = sum(1 for e in events if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    copies = sum(1 for e in events if e.name.startswith("cudaMemcpy"))
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        # None: the profiler saw no device activity, so nothing was measured.
        "device_busy_ms_per_step": busy_us / 1e3 / steps if device else None,
        "launches_per_step": launches / steps,
        "memcpy_per_step": copies / steps,
        "top_device_ops_ms_per_step": {k[:80]: v / 1e3 / steps for k, v in top},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile_torch_rollout.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    built = {}
    peak = {}
    for env_id, B, kern in CELLS:
        lay, pp = built.setdefault((env_id, kern), setup(env_id, kern))
        torch.cuda.reset_peak_memory_stats()
        cell_rate(lay, pp, B, args.steps, gen)  # warm-up
        peak[(env_id, B, kern)] = torch.cuda.max_memory_allocated() / 2**30
    rates = {c: [] for c in CELLS}
    for _ in range(args.repeats):
        for env_id, B, kern in CELLS:
            lay, pp = built[(env_id, kern)]
            rate, overflow = cell_rate(lay, pp, B, args.steps, gen)
            rates[(env_id, B, kern)].append((rate, overflow))
    cells = []
    for (env_id, B, kern), rs in rates.items():
        lay, pp = built[(env_id, kern)]
        row = {
            "env_id": env_id, "B": B, "bfs_kernel": pp.bfs_kernel, "steps": args.steps,
            "steps_per_sec": [r for r, _ in rs],
            "ms_per_step": [1e3 * B / r for r, _ in rs],
            "overflow": [o for _, o in rs],
            "peak_gib": peak[(env_id, B, kern)],
        }
        cells.append(row)
        print(f"cell {env_id} B={B} {pp.bfs_kernel}: steps/s "
              + ", ".join(f"{r:.1f}" for r in row["steps_per_sec"])
              + f"; overflow {row['overflow']}; peak {row['peak_gib']:.3f} GiB", flush=True)

    lay, pp = built[(MEDIUM, "auto")]
    pol_ms, step_ms = split(lay, pp, 2048, 20, gen)
    print(f"medium B=2048, synchronised ms/step: dispatcher {pol_ms:.3f}, step {step_ms:.3f}",
          flush=True)
    prof = trace(lay, pp, 2048, 10, gen)
    print(f"medium B=2048 trace of 10 steps: {json.dumps(prof)}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cells": cells,
                   "split_ms_per_step": {"dispatcher": pol_ms, "step": step_ms},
                   "trace_medium_2048": prof}, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
