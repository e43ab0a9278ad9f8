"""A bounded traced slice of a cell's steady work, read in memory.

A slice is two passes over the same steady work, each synchronised at both
ends. The light pass records the device's activity alone: its wall seconds
and the device's busy seconds (the union of its events) give the idle
share, with the host slowed as little as the profiler allows. The full pass
adds the host's events and the ops grouped by input shape (record_shapes),
which cost the host several microseconds a launch: it gives the launch
counts, the kernels' rooflines and the breakdown. Nothing is written to
disk: no Chrome trace.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

# Host runtime calls that put work on the device's queue.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


@dataclasses.dataclass
class Slice:
    device_events: List[Tuple[str, float, float]]  # (name, start us, end us)
    host_events: List[Tuple[str, float, float]]
    ops: List[Dict]  # key_averages by input shape: name, shapes, count, device_us
    window_s: float  # the light pass's wall seconds
    busy_s: float  # the light pass's device-busy seconds
    full_window_s: float = 0.0  # the full pass's, for the profiler's cost
    full_busy_s: float = 0.0

    def device_us(self, needle: str) -> Tuple[int, float]:
        """(launches, device us) of the device events whose name holds
        `needle`."""
        hit = [e for e in self.device_events if needle in e[0]]
        return len(hit), sum(e[2] - e[1] for e in hit)

    def launches(self) -> int:
        """The host's calls that queued device work (LAUNCH_CALLS)."""
        return sum(1 for e in self.host_events if e[0] in LAUNCH_CALLS)


def _union_us(spans: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class Pass:
    """One profiler pass, started and stopped by the caller (synchronised at
    both ends); `full` adds the host's events and the ops' input shapes."""

    def __init__(self, full: bool):
        self.full = full
        self.prof = None
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        on_card = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if on_card else []
        if self.full or not on_card:
            acts = [ProfilerActivity.CPU] + acts
        self.prof = profile(activities=acts, record_shapes=self.full)
        _sync()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def events(self):
        dev, host = [], []
        for e in self.prof.events():
            rng = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                marker = e.name.startswith("ProfilerStep") or getattr(e, "is_user_annotation",
                                                                      False)
                if not marker:
                    dev.append(rng)
            else:
                host.append(rng)
        return dev, host


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def warm() -> None:
    """One empty pass of each kind, so that neither measured pass pays the
    profiler's first start."""
    for full in (False, True):
        p = Pass(full)
        p.start()
        p.stop()


def read(light: Pass, full: Pass) -> Slice:
    """The slice of a light and a full pass over the same steady work."""
    ldev, _ = light.events()
    dev, host = full.events()
    ops = []
    for a in full.prof.key_averages(group_by_input_shape=True):
        ops.append({"name": a.key, "shapes": a.input_shapes, "count": a.count,
                    "device_us": float(getattr(a, "device_time_total", 0.0)
                                       or getattr(a, "cuda_time_total", 0.0))})
    return Slice(dev, host, ops, light.window_s, _union_us([(s, e) for _, s, e in ldev]) / 1e6,
                 full.window_s, _union_us([(s, e) for _, s, e in dev]) / 1e6)


def traced(fn) -> Slice:
    """fn() once under each pass, light first; fn runs the same amount of
    steady work each time it is called."""
    warm()
    light, full = Pass(False), Pass(True)
    for p in (light, full):
        p.start()
        fn()
        p.stop()
    return read(light, full)


def breakdown(sl: Slice, top: int = 10) -> Dict[str, List]:
    """The device's operations that took most time, and the longest idle
    gaps between device events summed by the innermost host event running at
    the gap's start: at most `top` of each, [name, seconds]."""
    by_op = defaultdict(float)
    for name, s, e in sl.device_events:
        by_op[name[:64]] += (e - s) / 1e6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    spans = sorted((s, e) for _, s, e in sl.device_events)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    hosts = sorted(sl.host_events, key=lambda h: h[1])
    starts = [h[1] for h in hosts]
    by_host = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        inner, inner_len = "host_idle", float("inf")
        for name, s, e in hosts[max(0, i - 400):i]:
            if s <= g0 < e and e - s < inner_len:
                inner, inner_len = name, e - s
        by_host[inner[:64]] += (g1 - g0) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in device_ops],
            "idle_gaps": [[k, v] for k, v in idle]}
