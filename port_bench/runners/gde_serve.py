"""GDE serving traffic: one caller, closed loop. Each request is a batch of
B windows (W frames of N agents x D features, float32) cut on the device
from the serving corpus at (episode, t) pairs drawn from the seed, so the
warm-up windows (t < W - 1) come in their real share. Each batch goes
through the program's `serving.make_gde_fn(horizon)` predictor: graph,
edge list, plan, K4 in every SAGE aggregation, euler solve, decoder; the
caller waits for its predictions before sending the next.

A batch's latency runs from its submission to its predictions, on the
device's clock: CUDA events recorded before the predictor's first call and
after its last, with the device idle at submission. The rate is every
window predicted in the window over the window's seconds (host clock).

Judge: a sample of the window's batches, drawn from the seed, is predicted
again by the plain reference (`reference/gde.py`, float64 on the device)
from the same windows; compared is the largest gap of a predicted position
over the largest position the reference predicts. Windows with a
non-finite prediction are counted as failed.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from port_bench import corpus, tracing
from port_bench.runners import gde as G
from port_bench.runners.common import FEED, sampler, sync
from port_bench.reference import gde as ref


@dataclasses.dataclass
class State:
    sz: G.Sizes
    data: dict
    weights: dict
    pairs: torch.Tensor
    predict: object
    served: list = dataclasses.field(default_factory=list)
    want: list = dataclasses.field(default_factory=list)  # the reference's, once computed


def _cut(ctx, st: State, k: int):
    T, Hz = int(ctx.traffic["episode_steps"]), int(ctx.traffic["horizon"])
    obs, count, _, _ = ref.cut_windows(st.data["episodes"], st.data["positions"],
                                       st.pairs[k % st.pairs.shape[0]], st.sz.window, Hz, T)
    return obs, count.to(torch.int32)


def setup(ctx) -> State:
    from swarm_ode_tpu_torch.serving import make_gde_fn

    G.precision(ctx.config)
    sz = G.sizes(ctx.config)
    tr = ctx.traffic
    Hz, B = int(tr["horizon"]), int(tr["batch"])
    E, T = int(tr["episodes"]), int(tr["episode_steps"])
    t0 = time.perf_counter()
    data, weights = G.make_inputs(ctx, sz, Hz)
    gen = corpus.generator(ctx.seed, ctx.device, FEED)
    n = int(tr["max_batches"])
    pairs = torch.stack([torch.randint(0, E, (n, B), generator=gen, device=ctx.device),
                         torch.randint(0, T - 1, (n, B), generator=gen, device=ctx.device)],
                        -1).to(torch.int32)
    predict = make_gde_fn(G.program_model(ctx, sz, weights), distance_threshold=sz.threshold,
                          horizon=Hz, num_agvs=sz.num_agvs)
    st = State(sz, data, weights, pairs, predict)
    sync(ctx.device)
    t1 = time.perf_counter()
    for k in range(int(tr["warmup_batches"])):
        predict(*_cut(ctx, st, n - 1 - k))
    sync(ctx.device)
    ctx.log(f"[gde_serve] set-up: inputs and model {t1 - t0:.3f} s, warm-up "
            f"{time.perf_counter() - t1:.3f} s")
    return st


def window(ctx, st: State) -> dict:
    on_card = torch.device(ctx.device).type == "cuda"
    lat_ms, k = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        obs, count = _cut(ctx, st, k)
        sync(ctx.device)
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = st.predict(obs, count)
            end.record()
            end.synchronize()
            lat_ms.append(start.elapsed_time(end))
        else:
            s = time.perf_counter()
            out = st.predict(obs, count)
            lat_ms.append(1e3 * (time.perf_counter() - s))
        st.served.append(out)
        k += 1
    window_s = time.perf_counter() - t0
    B = st.pairs.shape[1]
    bad = sum(int((~torch.isfinite(o)).reshape(B, -1).any(1).sum()) for o in st.served)
    p95 = float(np.percentile(np.asarray(lat_ms), 95))
    ctx.log(f"[gde_serve] {k} batches of {B} windows in {window_s:.3f} s; latency median "
            f"{float(np.median(lat_ms)):.4f} ms, p95 {p95:.4f} ms")
    return {"metrics": {"gde_windows_per_s": k * B / window_s, "gde_batch_ms_p95": p95},
            "attempted": k * B, "failed": bad}


def trace(ctx, st: State):
    n = int(ctx.traffic["trace_batches"])
    base = st.pairs.shape[0] // 2
    batches = [_cut(ctx, st, base + i) for i in range(n)]

    def run():
        for obs, count in batches:
            st.predict(obs, count)
        sync(ctx.device)

    run()
    sl = tracing.traced(run)
    edges, sources = [], []
    for obs, count in batches:
        adj = ref.adjacency(obs, count, st.sz.num_agvs, st.sz.threshold)
        edges.append(int(adj.sum()))
        sources.append(int((adj.sum(2) > 0).sum()))
    B, W, N, _ = batches[0][0].shape
    slots = B * (W * N * (N - 1) + (W - 1) * N)
    ctx.log(f"[gde_serve] traced batches: valid edges {sum(edges)} of {slots * n} slots "
            f"({100.0 * sum(edges) / (slots * n):.3f}%)")
    return sl, {"batches": n, "batch": B, "nodes": B * W * N, "valid_edges": edges,
                "distinct_sources": sources, "slots": slots}


def release(st: State) -> None:
    st.predict = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _reference(ctx, st: State, k: int, dtype, tf32: bool = False):
    obs, count = _cut(ctx, st, k)
    w = {n: v.to(dtype) for n, v in st.weights.items()}
    Hz = int(ctx.traffic["horizon"])
    traj = ref.trajectories(w, obs.to(dtype), count, st.sz.num_agvs, st.sz.threshold, Hz, tf32)
    return ref.newest(traj, count)


def _picks(ctx, st: State):
    n = min(int(ctx.traffic["sample_batches"]), len(st.served))
    return sorted(int(k) for k in sampler(ctx.seed).choice(len(st.served), n, replace=False))


def pred_gap(got, want) -> float:
    """Largest gap of a prediction over the largest reference position."""
    num = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    return num / max(float(w.double().abs().max()) for w in want)


def _want(ctx, st: State, picks):
    if not st.want:
        t0 = time.perf_counter()
        with torch.no_grad():
            st.want = [_reference(ctx, st, k, torch.float64) for k in picks]
        ctx.log(f"[gde_serve] reference of {len(picks)} batches in float64: "
                f"{time.perf_counter() - t0:.1f} s")
    return st.want


def judge(ctx, st: State) -> dict:
    picks = _picks(ctx, st)
    want = _want(ctx, st, picks)
    gap = pred_gap([st.served[k] for k in picks], want)
    if not np.isfinite(gap):
        gap = float("inf")
    return {"pred_gap": (gap, ctx.traffic["limits"]["pred_gap"])}


def control(ctx, st: State) -> dict:
    """The control's reading: the reference in float32 with TF32 products
    (on the card; emulated on the CPU) in the program's place."""
    picks = _picks(ctx, st)
    on_card = torch.device(ctx.device).type == "cuda"
    want = _want(ctx, st, picks)
    with torch.no_grad():
        if on_card:
            G.precision(ctx.config, tf32=True)
        try:
            low = [_reference(ctx, st, k, torch.float32, tf32=not on_card) for k in picks]
        finally:
            G.precision(ctx.config)
    return {"pred_gap": pred_gap(low, want)}
