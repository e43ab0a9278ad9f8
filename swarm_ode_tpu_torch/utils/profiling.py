"""Tracing and profiling hooks: spans and counters inside the program, a
torch.profiler trace, and wall-clock timers per pipeline stage.

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

Spans and counters mark where the program's work happens, and cost a flag
check while no torch profiler runs:

    with span("env.step.move"):                  # a host range of the trace
        ...
    count("replan.rows_run", K)                  # a host number, or a tensor
    counters()                                   # every counter, read once

Spans are host events of the profiler, on the clock of its device events,
so a trace (`trace` here, or any torch.profiler run) holds them nested
around the launches they make. They are kept in the profiler's memory with
its other events and written out only where the profiler is asked to
write. The spans and counters of the program, and where each is marked:

  heuristic.policy                  policies/heuristic.heuristic_policy
  env.step                          env/step.step, with one child per phase:
    env.step.targets / .replan / .escape / .conflicts / .stuck / .move
    / .deliver                      phases 1a, 1b, 1c, 2, 3, 4, 5
  serve.graph, serve.solve (child serve.plan), serve.decode
                                    serving.GDEPredictor.forward
  train.batch, train.forward, train.backward, train.optimizer
                                    train/train_gde.window_batch, train_step
  setup.kernel_library              ops/_build.library: build or cache, load
  setup.k4_first_call               the first call of the K4 op
  replan.rows_needed, replan.rows_run
                                    rows the step needs, rows K1 runs
  serve.edges_valid, serve.edge_slots
                                    graphs/temporal.temporal_edges
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

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


# The host range a span enters: the RecordFunction that torch's own
# generated code enters, which makes no dispatcher call (record_function
# makes two).
_RANGE = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, object] = {}
_SETUP: List[Tuple[str, int, int]] = []


def span(name: str):
    """A context that marks its block as the span `name` while a torch
    profiler runs, and does nothing otherwise.

    The gate is torch's own flag for a running profiler
    (`torch.autograd.profiler._is_profiler_enabled`), one attribute read of
    55-66 ns. Off, a span is that read and the enter and exit of one shared
    null context, with no dispatcher call and no allocation: 0.53 us a
    `with span(...)` block, 0.18 us more a call of a `spanned` function.
    The flag is up for every kineto profiler, also one that records the
    device alone; neither it nor torch's C++ state (`_profiler_enabled`,
    `_profiler_type`) tells such a pass from one with host events. The
    range tells them apart: it records only where the profiler registered
    host callbacks, so a device-only pass holds no span (0.65 us a span)
    and a pass with host events every span (3.1 us a span), where a
    record_function range costs 14-18 us in each. All measured on the host
    of an NVIDIA H100 80GB HBM3 at 700 W, torch 2.11. The spans stay in the
    profiler's memory with its other events; nothing here writes them.
    While torch.export or torch.compile traces (`torch.compiler.
    is_compiling`, read only once the flag is up: 0.14 us on a CPU host),
    a span is off too, so the traced programs are the same with or without
    a profiler running."""
    if _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling():
        return _RANGE(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function runs inside span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
                return fn(*args, **kwargs)
            with _RANGE(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, value) -> None:
    """Add `value` to the counter `name` while a torch profiler runs (the
    gate of `span`); nothing otherwise, and nothing is computed then.

    value: a host number, summed on the host (0.11 us off, 0.6 us on), or
    a tensor, whose elements are summed on its device into a device
    accumulator with no host synchronisation (a rollout's (B, A) bool
    mask: four launches a call on the H100, for the sum and the add). A
    counter takes one kind of value. Every kineto profiler raises the gate,
    a device-only pass too, so a counter counts in each traced pass: read
    counters as ratios, or as sums over the passes. They stay in memory
    until `counters` reads them. While torch.export or torch.compile
    traces, a count is off, as a span is."""
    if not _autograd_profiler._is_profiler_enabled or torch.compiler.is_compiling():
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum(dtype=torch.int64)
    acc = _COUNTS.get(name)
    _COUNTS[name] = value if acc is None else acc + value


def counters() -> Dict[str, int]:
    """Every counter's sum so far in this process, the device accumulators
    read back in one copy per device."""
    out: Dict[str, int] = {}
    on_device: Dict[torch.device, List[str]] = {}
    for name, value in _COUNTS.items():
        if isinstance(value, torch.Tensor):
            on_device.setdefault(value.device, []).append(name)
        else:
            out[name] = int(value)
    for names in on_device.values():
        out.update(zip(names, torch.stack([_COUNTS[n] for n in names]).tolist()))
    return out


@contextlib.contextmanager
def setup_span(name: str):
    """span(name) around one-time set-up (a library's build and load, a
    first call), whose host-clock start and end (`time.perf_counter_ns`)
    are also kept in memory, since set-up runs with no profiler. Read them
    with `setup_spans`."""
    t0 = time.perf_counter_ns()
    with span(name):
        yield
    _SETUP.append((name, t0, time.perf_counter_ns()))


def setup_spans() -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every set-up span ended in this process,
    in the order they ended."""
    return list(_SETUP)
