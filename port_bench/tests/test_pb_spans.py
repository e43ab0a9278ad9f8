"""The readers of the program's spans and counters (port_bench/spans.py and
the six metrics that use it): their arithmetic on a slice made by hand,
nothing reported (and nothing raised) where the program has no spans or
counters, and a traced tiny run of each cell they read."""
from __future__ import annotations

import time

import pytest

from port_bench import harness, tracing
from port_bench.tests import helpers
from swarm_ode_tpu_torch.ops import segment_pallas
from swarm_ode_tpu_torch.utils import profiling

# Two steps: the dispatcher's span, then the step's, each twice; launch
# calls inside each, one outside both; device events whose idle gaps begin
# in a policy span (2 + 1 us) and in a step span (1 us).
HOST = [("heuristic.policy", 0.0, 10.0), ("env.step", 10.0, 20.0),
        ("heuristic.policy", 20.0, 30.0), ("env.step", 30.0, 40.0),
        ("cudaLaunchKernel", 1.0, 2.0), ("cudaLaunchKernel", 3.0, 4.0),
        ("cudaMemcpyAsync", 11.0, 12.0), ("cudaLaunchKernel", 13.0, 14.0),
        ("cudaLaunchKernel", 21.0, 22.0), ("aten::add", 22.0, 23.0),
        ("cudaLaunchKernel", 31.0, 32.0), ("cudaLaunchKernel", 41.0, 42.0)]
DEVICE = [("k", 0.0, 5.0), ("k", 7.0, 15.0), ("k", 16.0, 25.0), ("k", 26.0, 50.0)]
BY_HAND = {"policy_launches.rollout": 1.5, "step_launches.rollout": 1.5,
           "policy_idle.rollout": 75.0}


def _read(name, host=HOST, device=DEVICE):
    bench = {"paths": ["port_bench"]}
    sl = tracing.Slice(device, host, [], 1.0, 0.5)
    inp = harness.LayerInput(sl, {"steps": 2}, {}, {}, {})
    return harness.load_module(harness.reader_path(helpers.REPO, bench, name)).read(inp)


@pytest.mark.parametrize("name", sorted(BY_HAND))
def test_span_readers_by_hand(name):
    assert _read(name) == BY_HAND[name]
    without = [h for h in HOST if not h[0].startswith(("heuristic.", "env."))]
    assert _read(name, host=without) is None


def test_counter_readers_by_hand(monkeypatch):
    """replan_need and edge_fill divide the program's counters; set-up
    counts a span nested in another once; a program without counters or
    set-up spans (the parent's) reports nothing."""
    monkeypatch.setattr(profiling, "_COUNTS", {"replan.rows_needed": 30, "replan.rows_run": 128,
                                               "serve.edges_valid": 7, "serve.edge_slots": 50})
    monkeypatch.setattr(profiling, "_SETUP", [("setup.kernel_library", 2_000_000_000,
                                               2_500_000_000),
                                              ("setup.k4_first_call", 1_000_000_000,
                                               3_000_000_000)])
    assert _read("replan_need.rollout") == 100.0 * 30 / 128
    assert _read("edge_fill.serve") == 100.0 * 7 / 50
    assert _read("program_setup_s") == 2.0
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(profiling, "_SETUP", [])
    assert _read("replan_need.rollout") is None and _read("program_setup_s") is None
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.delattr(profiling, "setup_spans")
    for name in ("replan_need.rollout", "edge_fill.serve", "program_setup_s"):
        assert _read(name) is None


class _AtenOps:
    """Every aten op counts as a launch call: the CPU has no CUDA runtime."""

    def __contains__(self, name):
        return name.startswith("aten::")


@pytest.mark.parametrize("workload,reported", [
    ("rollout.medium_19x9", {"policy_launches.rollout", "step_launches.rollout",
                             "replan_need.rollout"}),
    ("gde_serve.medium_19x9", {"edge_fill.serve", "program_setup_s"}),
])
def test_a_traced_tiny_run_reports_them(workload, reported, tmp_path, monkeypatch):
    """On the CPU a traced run reports the new metrics that need no card
    (policy_idle reads device gaps; the rollouts' set-up span is the kernel
    library's load): the launch metrics stay inside launches_per_step, with
    few launches outside both spans, and edge_fill is the share the runner
    logs."""
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(profiling, "_SETUP", [])
    monkeypatch.setattr(segment_pallas, "_CALLED", False)
    monkeypatch.setattr(tracing, "LAUNCH_CALLS", _AtenOps())
    cell = harness.load_cell(helpers.tiny_root(tmp_path), workload)
    log = []
    ctx = harness.Context(cell, 2**31 + 5, 0.5, True, device="cpu", log=log.append)
    res = harness.run_cell(ctx, time.perf_counter())
    m = {k: v["value"] for k, v in res["metrics"].items()}
    new = {"policy_launches.rollout", "step_launches.rollout", "policy_idle.rollout",
           "replan_need.rollout", "edge_fill.serve", "program_setup_s"}
    assert res["correct"] is True and new & set(m) == reported
    if workload.startswith("rollout"):
        inside = m["policy_launches.rollout"] + m["step_launches.rollout"]
        assert 0.98 * m["launches_per_step.rollout"] < inside < m["launches_per_step.rollout"]
        assert 0 < m["replan_need.rollout"] <= 100
    else:
        words = next(x for x in log if "valid edges" in x).split()
        valid, slots = int(words[words.index("edges") + 1]), int(words[words.index("of") + 1])
        assert m["edge_fill.serve"] == 100.0 * valid / slots
        assert m["program_setup_s"] > 0
