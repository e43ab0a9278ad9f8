"""Tracing and profiling hooks: a torch.profiler trace, wall-clock timers per
pipeline stage, and best-of-N throughput.

Counterpart of `swarm_ode_tpu/utils/profiling.py`. Where the JAX package
blocks on an array (`jax.block_until_ready`), the port synchronises the
device of each tensor it is given: the card's work is queued, and a host
clock read without a synchronise measures the queueing. Tensors on the CPU
need none.

    timer = StageTimer()
    with timer.stage("step", block_on=state):   # waits for the card at exit
        state = step(state)
    timer.summary({"step": num_envs})            # env steps/s of the stage

    with trace("runs/trace"):                    # a Chrome trace file there
        step(state)
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from swarm_ode_tpu_torch.utils.tree import tree_leaves


def synchronize(tree) -> None:
    """Wait for every card that holds a tensor of `tree`."""
    for dev in {x.device for x in tree_leaves(tree) if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/swarm_ode_tpu_torch_trace"):
    """Capture a torch.profiler trace of the block (the CPU, and the card
    when there is one) and write it into `log_dir` as a Chrome trace
    (`trace_<pid>_<ns>.json`; chrome://tracing or Perfetto reads it).
    Yields log_dir."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Wall-clock accumulator per pipeline stage (env step, graph build,
    odeint, grad), with per-stage throughput summaries."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block. block_on: a tensor or a tree of them; the stage
        ends when the devices that hold them have finished their queued
        work."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            synchronize(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self, units_per_call: Optional[Dict[str, float]] = None):
        """{stage: {'total_s', 'calls', 'mean_s'[, 'throughput']}}: the
        throughput, units a second, where units_per_call names the stage."""
        out = {}
        for name, tot in self.totals.items():
            n = self.counts[name]
            rec = {"total_s": tot, "calls": n, "mean_s": tot / n}
            if units_per_call and name in units_per_call:
                rec["throughput"] = units_per_call[name] * n / tot
            out[name] = rec
        return out


def device_throughput(fn, args, units: float, repeats: int = 3) -> float:
    """Best-of-`repeats` throughput (units a second) of fn(*args), after one
    warm-up call; each call is timed until the devices of its output have
    finished."""
    synchronize(fn(*args))
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        best = max(best, units / (time.perf_counter() - t0))
    return best
