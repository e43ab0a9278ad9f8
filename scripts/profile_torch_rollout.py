"""Where the time of the PyTorch port's batched heuristic rollout and of its
GDE server goes, on one CUDA GPU.

    python scripts/profile_torch_rollout.py [--steps 50] [--repeats 3]
        [--out chiprun_out/profile_torch_rollout.json]

1. Cells: reset + `steps` steps of dispatcher + step (`heuristic_rollout`)
   for each (env id, B, bfs_kernel, bfs_backend) below, host wall clock
   around work that ends in torch.cuda.synchronize(), after one warm-up
   each. The cells run in turn, `repeats` rounds, so a slow spell of the
   host falls on all of them; every reading is kept. Peak device memory
   per cell.
2. Medium, B = 2048: dispatcher and step timed apart, synchronised after
   each (host bound, so the sum exceeds the unsynchronised step).
3. Medium, B = 2048, compacted and full-field replan: a torch.profiler
   trace of 10 steps each: device busy time (kernels and copies), kernel
   launches and copies per step, and the device ops that take the most
   time.
4. GDE serving (medium, windows of 5 x 28 x 435, euler over t = 0..4,
   seeded weights of the flagship's shape) at B = 128, 512 and 2048
   windows: synchronised ms per batch of its stages (observe + push_frame,
   graph + edge list, the edges' K4 plan, the ODE solve with decoding, plan
   included) and of the whole server, and a torch.profiler trace of 5
   batches at B = 512.

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
from swarm_ode_tpu_torch.env.observations import observe  # noqa: E402
from swarm_ode_tpu_torch.env.state import make_params  # noqa: E402
from swarm_ode_tpu_torch.graphs import temporal  # noqa: E402
from swarm_ode_tpu_torch.models.gde import GraphODE  # noqa: E402
from swarm_ode_tpu_torch.ops.segment_pallas import segment_plan  # noqa: E402
from swarm_ode_tpu_torch.policies.heuristic import (  # noqa: E402
    heuristic_rollout,
    init_state,
    make_policy,
)
from swarm_ode_tpu_torch.serving import make_gde_fn  # noqa: E402

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
# (env id, B, bfs_kernel, bfs_backend): the first benchmark's candidate
# cells, then the medium batch sweep.
CELLS = [
    (MEDIUM, 2048, "auto", "auto"),
    ("tarware-extralarge-19agvs-9pickers-partialobs-v1", 1024, "auto", "auto"),
    (MEDIUM, 2048, "int32", "auto"),
    ("tarware-tiny-3agvs-2pickers-partialobs-v1", 2048, "auto", "auto"),
    (MEDIUM, 2048, "auto", "xla"),
    (MEDIUM, 64, "auto", "auto"),
    (MEDIUM, 8192, "auto", "auto"),
    (MEDIUM, 32768, "auto", "auto"),
]
GDE_BATCHES = (128, 512, 2048)
WINDOW, HORIZON = 5, 4


def setup(env_id, bfs_kernel, bfs_backend):
    cfg = EnvConfig.from_env_id(env_id, bfs_kernel=bfs_kernel, bfs_backend=bfs_backend)
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
    return _summary(prof.events(), steps)


def _summary(events, steps):
    """Device busy ms, launches, copies and the top device ops per step."""
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


def served_windows(lay, pp, B, gen):
    """B full windows of a heuristic rollout's observations, and its state."""
    policy = make_policy(pp, lay)
    es = step_mod.reset(pp, B, gen)
    h = init_state(pp, B)
    w = temporal.init_window(B, WINDOW, pp.num_agents, 435, device="cuda")
    for _ in range(WINDOW + 2):
        actions, h = policy(pp, es, h)
        es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        w = temporal.push_frame(w, observe(pp, es))
    return w, es


def synced_ms(fn, reps):
    """Mean host ms of fn() ending in a synchronise, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def gde_stages(lay, pp, B, gen, reps=10):
    """Synchronised ms per batch of the server's stages and of the server."""
    torch.manual_seed(0)
    model = GraphODE(435, pp.num_agvs, pp.num_pickers, 64, "euler").cuda()
    predict = make_gde_fn(model, None, 5.0, HORIZON)
    w, es = served_windows(lay, pp, B, gen)
    t_span = torch.arange(HORIZON + 1, dtype=torch.float32, device="cuda")
    g = temporal.build_temporal_batch(w.obs, w.count, pp.num_agvs, 5.0)
    edges = temporal.temporal_edges(g)

    def graph():
        gg = temporal.build_temporal_batch(w.obs, w.count, pp.num_agvs, 5.0)
        return temporal.temporal_edges(gg)

    def solve():
        with torch.no_grad():
            return model.apply_batched(g, t_span, edges=edges)

    torch.cuda.reset_peak_memory_stats()
    out = {
        "B": B,
        "observe_push_ms": synced_ms(lambda: temporal.push_frame(w, observe(pp, es)), reps),
        "graph_edges_ms": synced_ms(graph, reps),
        "plan_ms": synced_ms(lambda: segment_plan(edges[1], edges[2], g.x.shape[:3].numel(),
                                                  rows=edges[0]), reps),
        "solve_decode_ms": synced_ms(solve, reps),
        "server_ms": synced_ms(lambda: predict(w.obs, w.count), reps),
        "valid_edges": int(edges[2].sum()),
        "edge_slots": int(edges[2].shape[0]),
    }
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["windows_per_sec"] = B / out["server_ms"] * 1e3
    return out, (predict, w)


def gde_trace(predict, w, batches=5):
    """torch.profiler over `batches` calls of the server."""
    from torch.profiler import ProfilerActivity, profile

    predict(w.obs, w.count)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            predict(w.obs, w.count)
        torch.cuda.synchronize()
    return _summary(prof.events(), batches)


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
    for env_id, B, kern, backend in CELLS:
        lay, pp = built.setdefault((env_id, kern, backend), setup(env_id, kern, backend))
        torch.cuda.reset_peak_memory_stats()
        cell_rate(lay, pp, B, args.steps, gen)  # warm-up
        peak[(env_id, B, kern, backend)] = torch.cuda.max_memory_allocated() / 2**30
    rates = {c: [] for c in CELLS}
    for _ in range(args.repeats):
        for env_id, B, kern, backend in CELLS:
            lay, pp = built[(env_id, kern, backend)]
            rate, overflow = cell_rate(lay, pp, B, args.steps, gen)
            rates[(env_id, B, kern, backend)].append((rate, overflow))
    cells = []
    for (env_id, B, kern, backend), rs in rates.items():
        lay, pp = built[(env_id, kern, backend)]
        row = {
            "env_id": env_id, "B": B, "bfs_kernel": pp.bfs_kernel,
            "bfs_backend": pp.bfs_backend, "steps": args.steps,
            "steps_per_sec": [r for r, _ in rs],
            "ms_per_step": [1e3 * B / r for r, _ in rs],
            "overflow": [o for _, o in rs],
            "peak_gib": peak[(env_id, B, kern, backend)],
        }
        cells.append(row)
        print(f"cell {env_id} B={B} {pp.bfs_kernel} backend={pp.bfs_backend}: steps/s "
              + ", ".join(f"{r:.1f}" for r in row["steps_per_sec"])
              + f"; overflow {row['overflow']}; peak {row['peak_gib']:.3f} GiB", flush=True)

    lay, pp = built[(MEDIUM, "auto", "auto")]
    pol_ms, step_ms = split(lay, pp, 2048, 20, gen)
    print(f"medium B=2048, synchronised ms/step: dispatcher {pol_ms:.3f}, step {step_ms:.3f}",
          flush=True)
    prof = trace(lay, pp, 2048, 10, gen)
    print(f"medium B=2048 trace of 10 steps: {json.dumps(prof)}", flush=True)
    xlay, xpp = built[(MEDIUM, "auto", "xla")]
    prof_xla = trace(xlay, xpp, 2048, 10, gen)
    print(f"medium B=2048 full-field trace of 10 steps: {json.dumps(prof_xla)}", flush=True)

    gde = []
    for B in GDE_BATCHES:
        row, server = gde_stages(lay, pp, B, gen)
        gde.append(row)
        print(f"gde serving: {json.dumps(row)}", flush=True)
        if B == 512:
            gde_prof = gde_trace(*server)
    print(f"gde serving B=512 trace of 5 batches: {json.dumps(gde_prof)}", flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "cells": cells,
                   "split_ms_per_step": {"dispatcher": pol_ms, "step": step_ms},
                   "trace_medium_2048": prof, "trace_medium_2048_full_field": prof_xla,
                   "gde_serving": gde, "trace_gde_512": gde_prof}, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
