"""GDE training traffic: B windows a step, drawn without repeats from a
permutation of the corpus's windows made on the device from the seed each
epoch, cut by the program's `train/train_gde.window_batch` and trained on by
its `train_step` with `_batch_loss(horizon, horizon_weights)`: the
structured SAGE path, autograd, the global-norm clip and AdamW. The loss is
read back once an epoch of the corpus, the trainer's own cadence.

Set-up builds one model and optimizer state from the benchmark's weights and
drives them through the first `check_steps` steps of the feed, through the
window's own call; the window continues the same training.

Judge: the plain reference (`reference/gde.py`, float64 on the device, in
blocks of windows) follows those first steps from the same weights and
windows. Compared: each step's loss (relative gap), the first step's
gradient as the optimizer got it (clipped; read from its first moment,
mu / (1 - b1)) and the parameters' change over the steps, each by the worst
leaf's gap of norms against the larger of that leaf's and the median leaf's
reference norm. Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change (Adam moves them by round-off).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from port_bench import corpus, tracing
from port_bench.runners import gde as G
from port_bench.runners.common import FEED, leaf_gap, sync
from port_bench.reference import gde as ref

B1 = 0.9  # optax.adamw's default, the program's too


class Feed:
    """(B, 2) int32 (episode, t) pairs on the device: an epoch's permutation
    of the E x (T - 1) windows, B at a time; the rest of an epoch that
    fills no batch is dropped, as the trainer drops it."""

    def __init__(self, ctx, episodes: int, steps: int, batch: int):
        self.gen = corpus.generator(ctx.seed, ctx.device, FEED)
        self.device, self.per_ep, self.batch = ctx.device, steps - 1, batch
        self.total = episodes * self.per_ep
        self.per_epoch = self.total // batch
        self.perm, self.at = None, self.per_epoch

    def __call__(self) -> torch.Tensor:
        if self.at == self.per_epoch:
            self.perm = torch.randperm(self.total, generator=self.gen, device=self.device)
            self.at = 0
        idx = self.perm[self.at * self.batch:(self.at + 1) * self.batch]
        self.at += 1
        return torch.stack([idx // self.per_ep, idx % self.per_ep], 1).to(torch.int32)


@dataclasses.dataclass
class State:
    sz: G.Sizes
    data: dict
    weights: dict
    names: list
    prog: dict
    feed: Feed
    check_pairs: list
    losses: list
    mu1: list
    after: list
    steps_done: int = 0
    want: tuple = ()  # the reference's readings in float64, once computed


def _cfg(ctx):
    tr = ctx.traffic
    return int(tr["batch"]), int(tr["horizon"]), tuple(float(w) for w in tr["horizon_weights"])


def setup(ctx) -> State:
    from swarm_ode_tpu_torch.train.train_gde import (GDETrainConfig, _batch_loss, train_step,
                                                     window_batch)
    from swarm_ode_tpu_torch.utils.optim import adamw_init

    G.precision(ctx.config)
    sz = G.sizes(ctx.config)
    B, Hz, hw = _cfg(ctx)
    opt_cfg = ctx.config["gde"]["train"]
    data, weights = G.make_inputs(ctx, sz, Hz)
    model = G.program_model(ctx, sz, weights)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    tcfg = GDETrainConfig(batch_size=B, lr=opt_cfg["lr"], weight_decay=opt_cfg["weight_decay"],
                          grad_clip=opt_cfg["grad_clip"], hidden_dim=sz.hidden,
                          ode_solver=ctx.config["gde"]["ode_solver"],
                          distance_threshold=sz.threshold, horizon=Hz, horizon_weights=hw,
                          device_dtype="uint8")
    loss_fn = _batch_loss(model, sz.num_agvs, sz.threshold, horizon=Hz, horizon_weights=hw)
    T = int(ctx.traffic["episode_steps"])
    prog = {"model": model, "params": params, "opt": adamw_init(params), "loss_fn": loss_fn,
            "cfg": tcfg, "train_step": train_step,
            "batch": lambda pairs: window_batch(data, pairs, sz.window, horizon=Hz, true_len=T)}
    st = State(sz, data, weights, names, prog, Feed(ctx, int(ctx.traffic["episodes"]), T, B),
               [], [], [], [])
    for s in range(int(ctx.traffic["check_steps"])):
        pairs = st.feed()
        st.check_pairs.append(pairs.clone())
        st.losses.append(_step(st, pairs))
        if s == 0:
            st.mu1 = [m.clone() for m in prog["opt"].mu]
    st.after = [p.detach().clone() for p in params]
    for _ in range(int(ctx.traffic["warmup_steps"])):
        _step(st, st.feed())
    sync(ctx.device)
    return st


def _step(st: State, pairs):
    p = st.prog
    p["opt"], loss = p["train_step"](p["params"], p["opt"], p["loss_fn"], p["batch"](pairs),
                                     p["cfg"])
    st.steps_done += 1
    return loss


def window(ctx, st: State) -> dict:
    B = st.feed.batch
    pending, steps, bad = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        pending.append(_step(st, st.feed()))
        steps += 1
        if len(pending) == st.feed.per_epoch:
            bad += int((~torch.isfinite(torch.stack(pending))).sum())
            pending = []
    sync(ctx.device)
    window_s = time.perf_counter() - t0
    if pending:
        bad += int((~torch.isfinite(torch.stack(pending))).sum())
    ctx.log(f"[gde_train] {steps} steps of {B} windows in {window_s:.3f} s")
    return {"metrics": {"train_windows_per_s": steps * B / window_s}, "attempted": steps * B,
            "failed": bad * B}


def trace(ctx, st: State):
    steps = int(ctx.traffic["trace_steps"])

    def run():
        for _ in range(steps):
            _step(st, st.feed())

    run()
    return tracing.traced(run), {"steps": steps, "batch": st.feed.batch}


def release(st: State) -> None:
    st.prog = {}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_steps(ctx, st: State, dtype, emulate_tf32: bool = False):
    """The reference's first steps from the benchmark's weights on the check
    steps' windows: (losses, the first step's clipped gradient, the change of
    every leaf), in `dtype`, each step's gradient summed over blocks of
    windows. `emulate_tf32` rounds every product's operands to TF32 (the
    CPU stand-in for the card's TF32)."""
    B, Hz, hw = _cfg(ctx)
    opt = ctx.config["gde"]["train"]
    T = int(ctx.traffic["episode_steps"])
    block = int(ctx.traffic["reference_block"])
    p0 = [st.weights[n].to(dtype) for n in st.names]
    params = list(p0)
    mu = [torch.zeros_like(p) for p in p0]
    nu = [torch.zeros_like(p) for p in p0]
    losses, g1 = [], None
    for s, pairs in enumerate(st.check_pairs, 1):
        grads = [torch.zeros_like(p) for p in p0]
        loss = 0.0
        for b0 in range(0, B, block):
            leaves = [p.detach().requires_grad_() for p in params]
            w = dict(zip(st.names, leaves))
            obs, count, next_pos, hweight = ref.cut_windows(
                st.data["episodes"], st.data["positions"], pairs[b0:b0 + block], st.sz.window,
                Hz, T, dtype)
            part = ref.window_losses(w, obs, count, next_pos, hweight, hw, st.sz.num_agvs,
                                     st.sz.threshold, tf32=emulate_tf32).sum() / B
            grads = [g + d for g, d in zip(grads, torch.autograd.grad(part, leaves))]
            loss += float(part.detach())
        grads = ref.clip_by_global_norm(grads, opt["grad_clip"])
        if s == 1:
            g1 = grads
        params, mu, nu = ref.adamw_step(params, grads, mu, nu, s, opt["lr"], opt["weight_decay"])
        losses.append(loss)
    return losses, g1, [p - q for p, q in zip(params, p0)]


def gaps(ctx, st: State, got, want) -> dict:
    """The compared numbers of `got` (losses, first gradient, change)
    against `want`, the reference's."""
    (l_g, g_g, d_g), (l_r, g_r, d_r) = got, want
    norms = [float(torch.linalg.vector_norm(g.double())) for g in g_r]
    med = float(np.median(norms))
    keep = [n >= 1e-3 * med for n in norms]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l_g, l_r)),
            "grad_gap": leaf_gap(g_g, g_r),
            "change_gap": leaf_gap(d_g, d_r, keep)}


def program_readings(st: State):
    losses = [float(x) for x in st.losses]
    grad = [m / (1 - B1) for m in st.mu1]
    change = [a - st.weights[n] for a, n in zip(st.after, st.names)]
    return losses, grad, change


def _want(ctx, st: State):
    if not st.want:
        t0 = time.perf_counter()
        st.want = reference_steps(ctx, st, torch.float64)
        ctx.log(f"[gde_train] reference, {len(st.check_pairs)} steps in float64: "
                f"{time.perf_counter() - t0:.1f} s")
    return st.want


def judge(ctx, st: State) -> dict:
    want = _want(ctx, st)
    got = program_readings(st)
    lim = ctx.traffic["limits"]
    out = {k: (v, lim[k]) for k, v in gaps(ctx, st, got, want).items()}
    if not all(math.isfinite(v) for v, _ in out.values()):
        out = {k: (math.inf, lim[k]) for k in out}
    return out


def control(ctx, st: State) -> dict:
    """The control's readings: the reference in float32 with TF32 products
    (on the card; emulated on the CPU) in the program's place."""
    want = _want(ctx, st)
    on_card = torch.device(ctx.device).type == "cuda"
    if on_card:
        G.precision(ctx.config, tf32=True)
    try:
        low = reference_steps(ctx, st, torch.float32, emulate_tf32=not on_card)
    finally:
        G.precision(ctx.config)
    return gaps(ctx, st, low, want)
