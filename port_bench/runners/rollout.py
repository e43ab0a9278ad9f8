"""Rollout traffic: B envs, episodes back to back, each a reset (made by the
benchmark from the seed) and `steps` of the FIFO dispatcher plus the env
step through the program's `policies/heuristic.heuristic_rollout`, with the
default compacted replan (K1). The step's random draws are the benchmark's,
drawn from the seed on the device as the episode asks for them and handed
in as `noise`; nothing waits on the host inside an episode.

The window closes at the end of the first episode that ends after
`--seconds`: every episode it holds is whole, and the rate is all of their
env steps over all of the window's time.

Judge: a sample of envs drawn from the seed over the window's episodes is
replayed by the plain reference (`reference/tarware`) from the same resets
and draws, on the device once the window has closed and the program's
state is released; every field of each env's final state, of the
dispatcher's state and of its delivery, clash, stuck and overflow totals
must be equal. The program's compacted replan runs K rows
(`bfs.compaction_rows`): the rows the step marks as needed, then the others
in batch order. So `sample_envs` are drawn past the first K rows, where a
row not needed never runs (the reference's default rule), and
`sample_low_envs` from the first `low_envs` envs, where every row runs (the
reference's `every_row` rule) while the batch's needed rows stay under K
less those envs' rows: `low_envs` x A rows, a share of the batch well
below the gap between the budget and the largest share of needed rows
(PERF.md). An env between the two gets some of its other rows run,
depending on how many rows the whole batch needs, which no replay of it
alone can follow. All of this holds while no needed row overflows the
budget, so the overflow over every env of every episode is compared too.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from port_bench import corpus, tracing
from port_bench.runners.common import NOISE, RESET, check_env, sampler, sync
from port_bench.reference.tarware import config as rconfig
from port_bench.reference.tarware import heuristic as rheuristic
from port_bench.reference.tarware import layout as rlayout
from port_bench.reference.tarware import state as rstate
from port_bench.reference.tarware import step as rstep
from port_bench.reference.tarware.bfs import compaction_rows

TOTALS = ("deliveries", "clashes", "stucks", "replan_overflow")
# Episode ids of the warm-up and the traced slice (the window's count from 0).
WARMUP, TRACED = 1 << 40, (1 << 40) + 2


class Draws(Sequence):
    """One episode's per-step draws, made on the device when the rollout
    asks for step t (in order), as the program's StepNoise."""

    def __init__(self, make, params, batch: int, steps: int, gen: torch.Generator, hooks=None):
        self.make, self.params, self.batch, self.steps, self.gen = make, params, batch, steps, gen
        self.hooks = hooks or {}  # {t: [callables run before step t's draw]}
        self.next = 0

    def __len__(self):
        return self.steps

    def __getitem__(self, t):
        if t != self.next:
            raise IndexError(f"draws are made in order: asked for {t}, next is {self.next}")
        self.next += 1
        for hook in self.hooks.get(t, ()):
            hook()
        n = rstep.draw_noise(self.params, self.batch, self.gen)
        return self.make(n.break_r, n.delivery_gumbel)


@dataclasses.dataclass
class State:
    ctx: object
    prog: dict
    ref_cfg: object
    ref_layout: object
    ref_params: object
    batch: int
    steps: int
    episodes: list = dataclasses.field(default_factory=list)
    judged: tuple = ()  # (picks, s0, draws, the reference's outputs), once judged


def _reset(st: State, episode: int):
    """The benchmark's reset of one episode: the reference's reset drawn
    from the episode's stream, on the device."""
    gen = corpus.generator(st.ctx.seed, st.ctx.device, RESET, episode)
    return rstep.reset(st.ref_params, st.batch, gen)


def _draws(st: State, episode: int, make, hooks=None):
    gen = corpus.generator(st.ctx.seed, st.ctx.device, NOISE, episode)
    return Draws(make, st.ref_params, st.batch, st.steps, gen, hooks)


def _episode(st: State, episode: int, steps: int, hooks=None):
    p = st.prog
    s0 = _reset(st, episode)
    es = p["EnvState"](**{f.name: getattr(s0, f.name) for f in dataclasses.fields(s0)})
    return p["heuristic_rollout"](p["params"], p["layout"], st.batch, steps, state=es,
                                  noise=_draws(st, episode, p["StepNoise"], hooks))


def setup(ctx) -> State:
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import EnvState, make_params
    from swarm_ode_tpu_torch.env.step import StepNoise
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    env_id = ctx.config["env_id"]
    cfg = EnvConfig.from_env_id(env_id)
    check_env(ctx.config, cfg)
    lay = build_layout(cfg)
    prog = {"params": make_params(cfg, lay, device=ctx.device), "layout": lay,
            "EnvState": EnvState, "StepNoise": StepNoise, "heuristic_rollout": heuristic_rollout}
    rcfg = rconfig.EnvConfig.from_env_id(env_id)
    rlay = rlayout.build_layout(rcfg)
    st = State(ctx, prog, rcfg, rlay, rstate.make_params(rcfg, rlay, device=ctx.device),
               int(ctx.traffic["batch"]), int(ctx.traffic["steps"]))
    # Warm-up: every shape of an episode's step (and the kernel's build).
    _episode(st, WARMUP, int(ctx.traffic["warmup_steps"]))
    sync(ctx.device)
    return st


def window(ctx, st: State) -> dict:
    t0 = time.perf_counter()
    while True:
        out = _episode(st, len(st.episodes), st.steps)
        st.episodes.append({"state": out.state, "heuristic": out.heuristic,
                            **{k: getattr(out, k) for k in TOTALS}})
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync(ctx.device)
    window_s = time.perf_counter() - t0
    n = len(st.episodes) * st.batch
    ctx.log(f"[rollout] {len(st.episodes)} episodes of {st.batch} envs x {st.steps} steps "
            f"in {window_s:.3f} s")
    return {"metrics": {"env_steps_per_s": n * st.steps / window_s}, "attempted": n,
            "failed": 0}


def trace(ctx, st: State):
    """Steady steps of one episode: after its reset and `trace_from` steps
    run untraced, the light pass over `trace_steps` steps, then the full
    pass over as many. The passes start and stop inside
    `heuristic_rollout`, at the draws of those steps."""
    steps, at = int(ctx.traffic["trace_steps"]), int(ctx.traffic["trace_from"])
    tracing.warm()
    light, full = tracing.Pass(False), tracing.Pass(True)
    hooks = {at: [light.start], at + steps: [light.stop, full.start], at + 2 * steps: [full.stop]}
    _episode(st, TRACED, at + 2 * steps + 1, hooks)
    sl = tracing.read(light, full)
    p = st.ref_params
    counters = {"steps": steps, "batch": st.batch,
                "k1_rows": compaction_rows(st.batch, p.num_agents, p.replan_row_frac),
                "k1_cells": p.grid_h * (p.grid_w + 1), "k1_envs": st.batch}
    return sl, counters


def release(st: State) -> None:
    st.prog = {}
    if st.ctx.device != "cpu":
        torch.cuda.empty_cache()


def _sample(ctx, st: State):
    """(episode, env) pairs to replay, drawn from the seed: `sample_envs`
    past the compacted block's first K rows, then `sample_low_envs` among
    the first `low_envs` envs."""
    p = st.ref_params
    first = -(-compaction_rows(st.batch, p.num_agents, p.replan_row_frac) // p.num_agents)
    low = int(ctx.traffic["low_envs"])
    if low >= first:
        raise ValueError(f"low_envs {low} reaches past the compacted block's {first} envs")
    rng, picks = sampler(ctx.seed), []
    for lo, hi, n in ((first, st.batch, ctx.traffic["sample_envs"]),
                      (0, low, ctx.traffic["sample_low_envs"])):
        envs = hi - lo
        k = min(int(n), envs * len(st.episodes))
        flat = rng.choice(envs * len(st.episodes), size=k, replace=False)
        picks += [(int(i) // envs, lo + int(i) % envs) for i in flat]
    return sorted(picks)


def _inputs(ctx, st: State, picks):
    """The sampled envs' resets and per-step draws, made again from the
    seed on the device."""
    s0s, draws = [], [[] for _ in range(st.steps)]
    for ep in sorted({e for e, _ in picks}):
        idx = torch.tensor([b for e, b in picks if e == ep], device=ctx.device)
        s0 = _reset(st, ep)
        s0s.append({f.name: getattr(s0, f.name)[idx] for f in dataclasses.fields(s0)})
        gen = corpus.generator(ctx.seed, ctx.device, NOISE, ep)
        for t in range(st.steps):
            n = rstep.draw_noise(st.ref_params, st.batch, gen)
            draws[t].append(n.delivery_gumbel[idx])
    s0 = rstep.EnvState(**{k: torch.cat([s[k] for s in s0s]) for k in s0s[0]})
    gumbel = torch.stack([torch.cat(d) for d in draws])
    return s0, gumbel


def replay(st: State, s0, gumbel, every_row, low_precision: bool = False):
    """The reference's rollout of the sampled envs on the draws' device,
    every row answered in the `every_row` envs; with `low_precision` (the
    control) its draws are held in bfloat16."""
    dev = gumbel.device
    rp = dataclasses.replace(rstate.make_params(st.ref_cfg, st.ref_layout, device=dev),
                             every_row=every_row.to(dev))
    if low_precision:
        gumbel = gumbel.to(torch.bfloat16).to(torch.float32)
    noise = [rstep.StepNoise(None, g) for g in gumbel]
    return rheuristic.heuristic_rollout(rp, st.ref_layout, gumbel.shape[1], st.steps,
                                        state=s0, noise=noise)


def _program_at(st: State, picks):
    """The program's final states and totals at the sampled envs, on the
    CPU, as {field: tensor} in the order of `picks`."""
    out = {}
    for ep in sorted({e for e, _ in picks}):
        idx = torch.tensor([b for e, b in picks if e == ep], device=st.ctx.device)
        rec = st.episodes[ep]
        part = {f"state.{f.name}": getattr(rec["state"], f.name)[idx].cpu()
                for f in dataclasses.fields(rec["state"])}
        part.update({f"dispatcher.{f.name}": getattr(rec["heuristic"], f.name)[idx].cpu()
                     for f in dataclasses.fields(rec["heuristic"])})
        part.update({k: rec[k][idx].cpu() for k in TOTALS})
        for k, v in part.items():
            out.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in out.items()}


def _reference_at(ref):
    """The reference's final states and totals, on the CPU, as
    {field: tensor}."""
    out = {f"state.{f.name}": getattr(ref.state, f.name) for f in dataclasses.fields(ref.state)}
    out.update({f"dispatcher.{f.name}": getattr(ref.heuristic, f.name)
                for f in dataclasses.fields(ref.heuristic)})
    out.update({k: getattr(ref, k) for k in TOTALS})
    return {k: v.cpu() for k, v in out.items()}


def envs_differing(got: dict, ref: dict) -> int:
    """Envs at which any field differs (a field missing on either side
    counts every env)."""
    n = next(iter(ref.values())).shape[0]
    bad = torch.zeros(n, dtype=torch.bool)
    for k in set(got) | set(ref):
        if k not in got or k not in ref or got[k].shape != ref[k].shape:
            return n
        bad |= (got[k] != ref[k]).reshape(n, -1).any(1)
    return int(bad.sum())


def _judged(ctx, st: State):
    if not st.judged:
        picks = _sample(ctx, st)
        s0, gumbel = _inputs(ctx, st, picks)
        every_row = torch.tensor([b < int(ctx.traffic["low_envs"]) for _, b in picks])
        t0 = time.perf_counter()
        ref = _reference_at(replay(st, s0, gumbel, every_row))
        sync(ctx.device)
        ctx.log(f"[rollout] reference replay of {len(picks)} envs x {st.steps} steps on "
                f"{ctx.device} ({int(every_row.sum())} with every row run): "
                f"{time.perf_counter() - t0:.1f} s")
        st.judged = (picks, s0, gumbel, every_row, ref)
    return st.judged


def judge(ctx, st: State) -> dict:
    picks, _, _, _, ref = _judged(ctx, st)
    lim = ctx.traffic["limits"]
    overflow = sum(int(e["replan_overflow"].sum()) for e in st.episodes)
    return {"envs_differing": (envs_differing(_program_at(st, picks), ref),
                               lim["envs_differing"]),
            "replan_overflow": (overflow, lim["replan_overflow"])}


def control(ctx, st: State) -> dict:
    """The control's readings: the reference with its draws in bfloat16 in
    the program's place, against the reference."""
    _, s0, gumbel, every_row, ref = _judged(ctx, st)
    low = _reference_at(replay(st, s0, gumbel, every_row, low_precision=True))
    return {"envs_differing": envs_differing(low, ref)}
