"""The port's spans and counters (utils/profiling.span, count, counters,
setup_span) on the CPU: nothing recorded and no op added with no profiler
running; under a CPU torch.profiler the rollout's, the server's and the
set-up's spans where the program reaches them, nested as documented, and
the counters the benchmark's readers divide; export unchanged; and a traced
run of the benchmark's rollout and serving cells at a tiny size reporting
the metrics that read them."""
import ctypes
import io
import pathlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from port_bench.reference.tarware import config as rconfig
from port_bench.reference.tarware import layout as rlayout
from port_bench.reference.tarware import state as rstate
from port_bench.reference.tarware.bfs import compaction_rows
from port_bench.reference.tarware.step import draw_noise
from port_bench.tests import helpers
from swarm_ode_tpu_torch import serving
from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env.layout import build_layout
from swarm_ode_tpu_torch.env.state import make_params
from swarm_ode_tpu_torch.graphs.temporal import (build_temporal_batch, edge_capacity,
                                                 temporal_edges)
from swarm_ode_tpu_torch.models.gde import GraphODE
from swarm_ode_tpu_torch.ops import _build, segment_pallas
from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout
from swarm_ode_tpu_torch.utils import profiling

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
PHASES = ("env.step.targets", "env.step.replan", "env.step.escape", "env.step.conflicts",
          "env.step.stuck", "env.step.move", "env.step.deliver")


@pytest.fixture
def fresh(monkeypatch):
    """Counters and set-up spans of this test alone."""
    monkeypatch.setattr(profiling, "_COUNTS", {})
    monkeypatch.setattr(profiling, "_SETUP", [])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append(str(func))
        return func(*args, **(kwargs or {}))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _ranges(prof, name):
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == name)


def _within(inner, outer):
    return any(s <= a and b <= e for s, e in outer for a, b in [inner])


def _medium(B):
    cfg = EnvConfig.from_env_id(MEDIUM)
    lay = build_layout(cfg)
    return make_params(cfg, lay, device="cpu"), lay


def test_off_spans_and_counts_record_nothing_and_add_no_op(fresh):
    """With no profiler running, span, spanned and count dispatch no op,
    compute nothing and leave the counters as they were."""
    assert not torch.autograd.profiler._is_profiler_enabled
    need = torch.ones(4, 3, dtype=torch.bool)
    before = profiling.counters()
    wrapped = profiling.spanned("test.fn")(lambda x: x)
    with _Ops() as ops:
        with profiling.span("test.span"):
            pass
        profiling.count("test.device", need)
        profiling.count("test.host", 7)
        assert wrapped(3) == 3
    assert ops.calls == []
    assert profiling.span("a") is profiling.span("b")
    assert profiling.counters() == before
    assert profiling._COUNTS == {}


def test_rollout_spans_nest_and_replan_rows_count(fresh):
    """A 3-step heuristic_rollout at B = 8 under a CPU profiler: one
    heuristic.policy and one env.step a step, disjoint, each phase of the
    step inside an env.step; replan.rows_run is compaction_rows(B, A, frac)
    a launch, and the rows needed lie between 1 and that."""
    params, lay = _medium(8)
    gen = torch.Generator().manual_seed(3)
    heuristic_rollout(params, lay, 8, 1, gen)
    with _cpu_profile() as prof:
        heuristic_rollout(params, lay, 8, 3, gen)
    policy, step = _ranges(prof, "heuristic.policy"), _ranges(prof, "env.step")
    assert len(policy) == len(step) == 3
    assert not any(_within(p, step) or _within(s, policy) for p in policy for s in step)
    for name in PHASES:
        phases = _ranges(prof, name)
        assert len(phases) == 3 and all(_within(p, step) for p in phases), name
    c = profiling.counters()
    K = compaction_rows(8, params.num_agents, params.replan_row_frac)
    assert K < 8 * params.num_agents
    assert c["replan.rows_run"] == 3 * K
    assert 0 < c["replan.rows_needed"] <= 3 * K


def _windows(B=3, W=4, N=5, D=9, seed=0):
    gen = torch.Generator().manual_seed(seed)
    obs = torch.rand(B, W, N, D, generator=gen) * 8.0
    return obs, torch.tensor([W, 2, 1][:B], dtype=torch.int32)


def test_serve_edge_counters_and_spans(fresh):
    """serve.edges_valid and serve.edge_slots count temporal_edges' valid
    edges and its B x edge_capacity slots; a served batch holds the server's
    spans, serve.plan inside serve.solve."""
    obs, count = _windows()
    B, W, N, D = obs.shape
    g = build_temporal_batch(obs, count, 3, 5.0)
    with _cpu_profile():
        _, _, valid = temporal_edges(g)
    c = profiling.counters()
    assert c["serve.edges_valid"] == int(valid.sum()) > 0
    assert c["serve.edge_slots"] == B * edge_capacity(W, N) == valid.numel()
    predict = serving.make_gde_fn(GraphODE(D, 3, 2, 8).init_(torch.Generator().manual_seed(0)),
                                  horizon=3)
    with _cpu_profile() as prof:
        predict(obs, count)
    spans = {n: _ranges(prof, n) for n in ("serve.graph", "serve.solve", "serve.plan",
                                           "serve.decode")}
    assert all(len(r) == 1 for r in spans.values()), spans
    assert _within(spans["serve.plan"][0], spans["serve.solve"])
    assert profiling.counters()["serve.edges_valid"] == 2 * int(valid.sum())


@pytest.mark.parametrize("profiled", [False, True])
def test_export_gde_holds_no_span(fresh, profiled):
    """export_gde of a tiny GDE, with and without a profiler running while
    it traces, has no profiler node, counts nothing and serves what the
    eager predictor does."""
    W, N, D = 4, 5, 9
    predict = serving.make_gde_fn(GraphODE(D, 3, 2, 8).init_(torch.Generator().manual_seed(1)),
                                  horizon=3)
    if profiled:
        with _cpu_profile():
            blob = serving.export_gde(predict, W, N, D)
    else:
        blob = serving.export_gde(predict, W, N, D)
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not any("profiler" in t or "record_function" in t for t in targets)
    assert profiling._COUNTS == {}
    obs, count = _windows(B=1)
    assert torch.equal(serving.load_gde(blob, device="cpu")(obs[0], count[0]),
                       predict(obs[0], count[0]))


def test_setup_spans_where_the_cpu_path_reaches_them(fresh, monkeypatch, tmp_path):
    """setup.k4_first_call on the op's first call and never again, on the
    host's clock and, under a profiler, in its trace; setup.kernel_library
    on the library's first load (the build and the ctypes load stood in
    for: the CPU path never loads the library)."""
    monkeypatch.setattr(segment_pallas, "_CALLED", False)
    data = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    plan = segment_pallas.segment_plan(torch.tensor([1, 0, 1, 1]), None, 2,
                                       rows=torch.arange(4), num_rows=4)
    with _cpu_profile() as prof:
        first = segment_pallas.segment_sum_planned(data, *plan)
    assert torch.equal(segment_pallas.segment_sum_planned(data, *plan), first)
    spans = profiling.setup_spans()
    assert [s[0] for s in spans] == ["setup.k4_first_call"] and spans[0][1] <= spans[0][2]
    assert len(_ranges(prof, "setup.k4_first_call")) == 1

    class Lib:
        def __getattr__(self, name):
            return ctypes.CFUNCTYPE(ctypes.c_int)()

    monkeypatch.setattr(_build, "_library", None)
    monkeypatch.setattr(_build, "build", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    lib = _build.library()
    assert _build.library() is lib
    assert [s[0] for s in profiling.setup_spans()] == ["setup.k4_first_call",
                                                       "setup.kernel_library"]


class _AtenOps:
    """Stands in for the CUDA runtime's launch calls on the CPU: every aten
    op of the full pass counts as a launch."""

    def __contains__(self, name):
        return name.startswith("aten::")


def _aten_ops(fn) -> int:
    with _cpu_profile() as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::"))


def _traced(tmp_path, workload, monkeypatch):
    """A traced run of the cell at the tiny size, aten ops counted as
    launches; (result, the runner's log)."""
    import time

    from port_bench import harness, tracing

    monkeypatch.setattr(tracing, "LAUNCH_CALLS", _AtenOps())
    cell = harness.load_cell(helpers.tiny_root(tmp_path), workload)
    log = []
    ctx = harness.Context(cell, 2**31 + 11, 0.5, True, device="cpu", log=log.append)
    return harness.run_cell(ctx, time.perf_counter()), log


def test_traced_rollout_reports_the_program_spans_metrics(fresh, tmp_path, monkeypatch):
    """A traced tiny rollout cell reports policy_launches, step_launches and
    replan_need; the two launch metrics make up launches_per_step less the
    benchmark's draws and the rollout loop's totals (four `+=` and
    `returns += rewards.sum(1)`), each counted apart."""
    res, _ = _traced(tmp_path, "rollout.medium_19x9", monkeypatch)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] is True
    assert m["policy_launches.rollout"] > 0 and m["step_launches.rollout"] > 0
    assert 0 < m["replan_need.rollout"] <= 100
    B = helpers.TINY["rollout"]["batch"]
    rcfg = rconfig.EnvConfig.from_env_id(MEDIUM)
    params = rstate.make_params(rcfg, rlayout.build_layout(rcfg), device="cpu")
    draws = _aten_ops(lambda: draw_noise(params, B, torch.Generator().manual_seed(0)))
    totals = [torch.zeros(B, dtype=torch.int32) for _ in range(4)]
    returns, rewards = torch.zeros(B), torch.zeros(B, params.num_agents)

    def loop():
        for t in totals:
            t += t
        returns.add_(rewards.sum(1))

    outside = (m["launches_per_step.rollout"] - m["policy_launches.rollout"]
               - m["step_launches.rollout"])
    assert outside == draws + _aten_ops(loop)


def test_traced_serving_reports_edge_fill_as_the_runner_logs(fresh, tmp_path, monkeypatch):
    """A traced tiny serving cell reports edge_fill, equal to the valid-edge
    share the runner logs from the reference's own adjacency, and the
    seconds of the set-up span of K4's first call."""
    monkeypatch.setattr(segment_pallas, "_CALLED", False)
    res, log = _traced(tmp_path, "gde_serve.medium_19x9", monkeypatch)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] is True
    line = next(x for x in log if "valid edges" in x).split()
    valid, slots = int(line[line.index("edges") + 1]), int(line[line.index("of") + 1])
    assert m["edge_fill.serve"] == 100.0 * valid / slots
    assert [s[0] for s in profiling.setup_spans()] == ["setup.k4_first_call"]
    assert m["program_setup_s"] > 0
