"""What the per-layer readers take from the program's own spans and
counters (`swarm_ode_tpu_torch.utils.profiling`): span intervals among a
traced slice's host events, the launches and idle gaps that fall inside
them, the program's counters and its set-up spans.

Each function gives None where the program has none of what it reads (a
program without these spans or counters), so that a reader reports
nothing there and does not raise.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from port_bench import tracing


def union(pairs) -> List[Tuple[float, float]]:
    """(start, end) pairs merged into sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(pairs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intervals(host_events, name: str) -> List[Tuple[float, float]]:
    """The host events named `name` as sorted disjoint intervals (us)."""
    return union((s, e) for n, s, e in host_events if n == name)


def inside(iv: List[Tuple[float, float]], t: float) -> bool:
    """Whether t lies in one of the sorted disjoint intervals `iv`."""
    i = bisect.bisect_right(iv, (t, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= t < iv[i][1]


def launches_per_step(m, name: str) -> Optional[float]:
    """Host calls that queued device work (tracing.LAUNCH_CALLS) that start
    inside the span `name`, per traced step of the full pass."""
    iv = intervals(m.slice.host_events, name)
    if not iv:
        return None
    n = sum(1 for c, s, _ in m.slice.host_events if c in tracing.LAUNCH_CALLS and inside(iv, s))
    return n / m.counters["steps"]


def idle_gaps(device_events) -> List[Tuple[float, float]]:
    """The gaps (us) between the device's events, where no event runs."""
    gaps, end = [], None
    for s, e in sorted((s, e) for _, s, e in device_events):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_share(m, name: str) -> Optional[float]:
    """The share (%) of the full pass's idle gaps, by time, whose gap begins
    while the host is inside the span `name`."""
    iv = intervals(m.slice.host_events, name)
    gaps = idle_gaps(m.slice.device_events)
    total = sum(e - s for s, e in gaps)
    if not iv or total <= 0:
        return None
    return 100.0 * sum(e - s for s, e in gaps if inside(iv, s)) / total


def ratio(numerator: str, denominator: str) -> Optional[float]:
    """100 x one of the program's counters (`profiling.counters()`) over
    another, or None where the program has no counters or the second is
    missing or 0."""
    from swarm_ode_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    c = read() if read is not None else None
    if not c or not c.get(denominator):
        return None
    return 100.0 * c.get(numerator, 0) / c[denominator]


def setup_seconds() -> Optional[float]:
    """Seconds inside the program's set-up spans (`profiling.setup_spans()`,
    named `setup.*`), a span inside another counted once, or None."""
    from swarm_ode_tpu_torch.utils import profiling

    read = getattr(profiling, "setup_spans", None)
    if read is None:
        return None
    iv = union((s, e) for n, s, e in read() if n.startswith("setup."))
    return sum(e - s for s, e in iv) / 1e9 if iv else None
