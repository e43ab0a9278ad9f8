"""The yardstick's counts on small shapes, and the per-layer readers on
hand-made slices."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import counts, harness, tracing
from port_bench.corpus import make_weights
from port_bench.reference import gde as ref
from port_bench.tests import helpers


@pytest.mark.parametrize("node_dim,hidden,window,agents,horizon", [
    (5, 3, 2, 3, 1), (7, 4, 3, 2, 2), (435, 64, 5, 28, 4)])
def test_gde_window_flops_are_the_dense_products(node_dim, hidden, window, agents, horizon):
    """Every product with a weight (the reference's 2-D products, torch's
    aten.mm) of one window's forward; the aggregation (aten.bmm) is not a
    model FLOP."""
    w = make_weights(node_dim, hidden, torch.Generator().manual_seed(0), "cpu")
    obs = torch.rand(1, window, agents, node_dim)
    with FlopCounterMode(display=False) as fc:
        ref.trajectories(w, obs, torch.tensor([window]), 1, 5.0, horizon)
    got = fc.get_flop_counts()["Global"]
    assert got[torch.ops.aten.mm] == counts.gde_window_flops(node_dim, hidden, window, agents,
                                                             horizon)
    assert counts.gde_window_flops(435, 64, 5, 28, 4) == 135_116_240


def test_kernel_counts_and_bounds():
    assert counts.k1_bytes_ops(rows=128, cells=10, envs=4) == (4 * 10 + 2 * 10 + 24 * 128,
                                                              5 * 128 * 10)
    nbytes, ops = counts.k4_bytes_ops(width=8, valid_edges=30, distinct_sources=12, nodes=20)
    assert nbytes == 4 * (12 * 8 + 30 + 20 + 1 + 20 * 8) and ops == 30 * 8 + 20 * 8
    assert counts.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert counts.bound_s(1.0, 67e12) == (1.0, "operations")


def _slice(device_events, host_events=(), ops=(), window_s=1.0):
    spans = [(s, e) for _, s, e in device_events]
    return tracing.Slice(list(device_events), list(host_events), list(ops), window_s,
                         tracing._union_us(spans) / 1e6)


def _read(name, sl, counters, e2e=None, config=None, traffic=None):
    path = harness.reader_path(helpers.REPO, {"paths": ["port_bench"]}, name)
    return harness.load_module(path).read(harness.LayerInput(sl, counters, e2e or {},
                                                             config or {}, traffic or {}))


def test_readers_on_a_hand_made_slice():
    dev = [("bfs_query_kernel<16>", 0.0, 10.0), ("elementwise", 20.0, 30.0),
           ("bfs_query_kernel<16>", 40.0, 50.0), ("copy", 45.0, 55.0)]
    host = [("cudaLaunchKernel", 0, 1)] * 6 + [("cudaMemcpyAsync", 2, 3), ("aten::add", 0, 15)]
    sl = _slice(dev, host, window_s=100e-6)
    assert sl.busy_s == pytest.approx(35e-6)
    assert _read("device_idle.rollout", sl, {}) == pytest.approx(65.0)
    assert _read("launches_per_step.rollout", sl, {"steps": 2}) == pytest.approx(3.5)
    c = {"k1_rows": 1000, "k1_cells": 600, "k1_envs": 50}
    bound, _ = counts.bound_s(*counts.k1_bytes_ops(1000, 600, 50))
    assert _read("k1_roofline.rollout", sl, c) == pytest.approx(100 * bound / 10e-6)
    assert _read("k1_roofline.rollout", _slice([("x", 0.0, 1.0)]), c) is None
    bd = tracing.breakdown(sl)
    assert bd["device_ops"][0] == ["bfs_query_kernel<16>", pytest.approx(20e-6)]
    assert [g[0] for g in bd["idle_gaps"]] == ["aten::add", "host_idle"]


def test_k4_roofline_reads_widths_from_the_ops_shapes():
    op = "swarm_ode_tpu_torch::segment_sum_planned"
    ops = [{"name": op, "shapes": [[20, 8], [30], [21]], "count": 4, "device_us": 0.0},
           {"name": op, "shapes": [[20, 4], [30], [21]], "count": 2, "device_us": 0.0}]
    dev = [("segment_sum_kernel<8>", 10.0 * i, 10.0 * i + 2.0) for i in range(6)]
    counters = {"batches": 2, "nodes": 20, "valid_edges": [30, 20], "distinct_sources": [12, 9]}
    want = sum(counts.bound_s(*counts.k4_bytes_ops(wd, e, s, 20))[0] * n / 2
               for e, s in ((30, 12), (20, 9)) for wd, n in ((8, 4), (4, 2)))
    got = _read("k4_roofline.serve", _slice(dev, ops=ops), counters)
    assert got == pytest.approx(100 * want / 12e-6)


def test_mfu_uses_the_configurations_shapes_and_the_float32_peak():
    cfg = {"gde": {"node_dim": 435, "hidden_dim": 64, "seq_len": 5}, "num_agvs": 19,
           "num_pickers": 9}
    sl = _slice([])
    train = _read("mfu.train", sl, {}, {"train_windows_per_s": 1e5}, cfg, {"horizon": 4})
    serve = _read("mfu.serve", sl, {}, {"gde_windows_per_s": 1e5}, cfg, {"horizon": 4})
    assert serve == pytest.approx(100 * 135_116_240 * 1e5 / 67e12)
    assert train == pytest.approx(3 * serve)
