"""Behaviour cloning from logged dispatcher decisions, DAgger collection and
rollout evaluation of a clone.

Counterpart of `swarm_ode_tpu/train/train_bc.py` (BCConfig :47,
load_decision_arrays :67, train_bc :95, collect_dagger :292,
evaluate_policy :379). The datasets (data/collect.py) log, per step, the
observations, every agent's macro action and the pre-step busy flags: the
FIFO dispatcher's decisions, which become supervision here.

Training: masked cross-entropy over each agent's valid actions
(graphs/hetero.masks_from_feats), weighted to the decision points: idle
agents whose logged action is valid under the rebuilt mask, the loss
normalised by max(sum of weights, 1). The dataset is staged on the device
once (observations float16, cast to float32 per batch, as in JAX: the
graph is built from the rounded values); each epoch runs its minibatches
without a host read and reads its totals once at the end. The split and
each epoch's order come from `np.random.default_rng(cfg.seed)`, the same
numpy calls in the same order as JAX's, so both are JAX's exactly. The
best epoch by validation loss is returned and checkpointed as
{'q_params': ...}.

The clone is the network family of the RL agents (train/run_rl.make_network),
so its parameters warm-start IQL / QMIX (`RLRunConfig.init_q_from`) and
MAPPO (`rl/ppo.MAPPOConfig.init_from`).

`collect_dagger` rolls the clone (or a beta-mixture with the expert) and
labels every visited state with the stateless expert
(policies/heuristic.make_stateless_expert); `evaluate_policy` rolls the
clone greedily, through the claim auction, or sampled at a temperature.
Both step the env through env/step.step, so the replan query K1 runs in
every step on the card, and neither reads the device before its last step.
Their draws come from a torch.Generator or a draws object
(rl/draws.RolloutDraws: reset, step, gumbel, coin).

h5py is imported inside `load_decision_arrays` only: `train_bc(arrays=...)`
runs without it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.layout import Layout, build_layout
from swarm_ode_tpu_torch.env.observations import compute_valid_action_masks, observe
from swarm_ode_tpu_torch.env.state import EnvParams, make_params
from swarm_ode_tpu_torch.graphs.hetero import masks_from_feats, split_observation
from swarm_ode_tpu_torch.policies.heuristic import make_stateless_expert
from swarm_ode_tpu_torch.rl import coordination
from swarm_ode_tpu_torch.rl.dqn import adam_step, module_params, obs_q_values, value_and_grad
from swarm_ode_tpu_torch.rl.draws import as_draws
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager
from swarm_ode_tpu_torch.utils.metrics import pick_rate
from swarm_ode_tpu_torch.utils.optim import adamw_init


@dataclasses.dataclass
class BCConfig:
    env_id: str = "tarware-medium-19agvs-9pickers-partialobs-v1"
    files: Optional[List[str]] = None  # HDF5 dataset paths
    net: str = "gnode"  # run_rl.make_network's registry (gnode | gnode_comm | gnn)
    hidden_dim: int = 64
    lr: float = 1e-3
    epochs: int = 10
    batch_size: int = 64
    val_frac: float = 0.1  # episode-level split
    step_stride: int = 1  # subsample steps within episodes
    max_episodes: int = 0  # 0 = all
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    # Greedy rollout evaluation after training (0 = off).
    eval_episodes: int = 0
    eval_coordinated: bool = False
    device: str = "cuda"


def load_decision_arrays(files: List[str], stride: int = 1, max_episodes: int = 0):
    """Stack (obs, actions, busy) across episodes and files: float16 / int32 /
    bool arrays (N, A, obs_len), (N, A), (N, A) and the rows' (N,) int32
    episode ids, for the split."""
    import h5py  # only here: train_bc(arrays=...) runs without it

    obs_l, act_l, busy_l, ep_l = [], [], [], []
    ep_id = 0
    for path in files:
        with h5py.File(path, "r") as f:
            keys = sorted(k for k in f.keys() if k.startswith("episode_"))
            for k in keys:
                if max_episodes and ep_id >= max_episodes:
                    break
                g = f[k]["steps"]
                obs_l.append(g["observations"][::stride])
                act_l.append(g["actions"][::stride])
                busy_l.append(g["agent_busy"][::stride])
                ep_l.append(np.full(obs_l[-1].shape[0], ep_id, np.int32))
                ep_id += 1
    return (np.concatenate(obs_l).astype(np.float16), np.concatenate(act_l).astype(np.int32),
            np.concatenate(busy_l), np.concatenate(ep_l))


def batch_loss(net: nn.Module, net_params, params: EnvParams, obs: torch.Tensor,
               act: torch.Tensor, idle: torch.Tensor):
    """The masked cross-entropy of a batch at its decision points: (loss,
    (accuracy, sum of weights)), loss and accuracy normalised by max(sum of
    weights, 1)."""
    logits = obs_q_values(net, net_params, params, obs)
    masks = masks_from_feats(params, *split_observation(params, obs))
    a = act.long()[..., None]
    # Decision points: idle agents whose logged action is valid under the
    # rebuilt mask (rare capture-edge mismatches would otherwise inject
    # -log(~0) outliers).
    w = (idle & (masks.gather(-1, a)[..., 0] > 0)).to(torch.float32)
    masked = torch.where(masks > 0, logits, -1e9)
    ce = -coordination.log_softmax(masked).gather(-1, a)[..., 0]
    hit = (masked.argmax(dim=-1) == act.long()).to(torch.float32)
    wsum = w.sum(-1).sum()
    norm = torch.clamp(wsum, min=1.0)
    return (ce * w).sum(-1).sum() / norm, ((hit * w).sum(-1).sum() / norm, wsum)


def train_bc(cfg: BCConfig, verbose: bool = True, arrays=None, init_params=None) -> Dict:
    """Clone logged decisions on cfg.device.

    arrays: in-memory (obs, actions, busy, episode_ids) in place of
      cfg.files (the DAgger aggregation path; no h5py needed);
    init_params: the network's parameters (a state dict) to continue from
      in place of a fresh initialisation (drawn from a generator seeded
      with cfg.seed).
    Returns {'params' (the best epoch's, by validation loss), 'history',
    'best_val_loss', 'net' (the module), 'eval' when cfg.eval_episodes}."""
    from swarm_ode_tpu_torch.train.run_rl import RLRunConfig, make_network

    dev = torch.device(cfg.device)
    env_cfg = EnvConfig.from_env_id(cfg.env_id)
    params = make_params(env_cfg, build_layout(env_cfg), dev)
    gs_scale = 1.0 / float(max(params.grid_h, params.grid_w))
    net = make_network(RLRunConfig(net=cfg.net, hidden_dim=cfg.hidden_dim), params.num_actions,
                       coord_scale=gs_scale).to(dev)

    if arrays is None:
        arrays = load_decision_arrays(cfg.files, cfg.step_stride, cfg.max_episodes)
    obs_np, act_np, busy_np, ep_np = arrays
    n_eps = int(ep_np.max()) + 1
    rng = np.random.default_rng(cfg.seed)
    val_eps = set(rng.permutation(n_eps)[: max(1, int(n_eps * cfg.val_frac))].tolist())
    is_val = np.isin(ep_np, list(val_eps))
    if verbose:
        print(f"[bc] {obs_np.shape[0]} steps from {n_eps} episodes ({is_val.sum()} val rows), "
              f"idle fraction {(~busy_np).mean():.3f}", flush=True)

    if init_params is None:
        net.init_(torch.Generator(device=dev).manual_seed(cfg.seed))
        net_params = module_params(net)
    else:
        net_params = {k: v.detach().to(dev).clone() for k, v in init_params.items()}
    opt_state = adamw_init(list(net_params.values()))

    tr_idx, va_idx = np.where(~is_val)[0], np.where(is_val)[0]
    B = cfg.batch_size
    # The whole dataset on the device once, observations as float16.
    obs_dev = torch.from_numpy(np.ascontiguousarray(obs_np)).to(dev)
    act_dev = torch.from_numpy(np.ascontiguousarray(act_np)).to(dev)
    idle_dev = torch.from_numpy(~np.ascontiguousarray(busy_np)).to(dev)

    def run_split(p, opt_state, idx, train):
        order = rng.permutation(idx) if train else idx
        n_b = len(order) // B
        if n_b == 0:
            return p, opt_state, 0.0, 0.0
        order = torch.from_numpy(np.asarray(order[: n_b * B], np.int64).reshape(n_b, B)).to(dev)
        tot = torch.zeros(3, dtype=torch.float32, device=dev)
        for rows in order:
            obs_b = obs_dev[rows].to(torch.float32)
            act_b, idle_b = act_dev[rows], idle_dev[rows]
            if train:
                loss, (acc, w), (grads,) = value_and_grad(
                    lambda q: batch_loss(net, q, params, obs_b, act_b, idle_b), p,
                    has_aux=True)
                p, opt_state = adam_step(p, grads, opt_state, cfg.lr)
            else:
                with torch.no_grad():
                    loss, (acc, w) = batch_loss(net, p, params, obs_b, act_b, idle_b)
            tot = tot + torch.stack([loss * w, acc * w, w])
        # One host read an epoch: the totals.
        tot_l, tot_a, tot_w = (float(v) for v in tot.cpu())
        tot_w = max(tot_w, 1.0)
        return p, opt_state, tot_l / tot_w, tot_a / tot_w

    ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    history = []
    best = (np.inf, None)
    for ep in range(cfg.epochs):
        t0 = time.time()
        net_params, opt_state, tr_l, tr_a = run_split(net_params, opt_state, tr_idx, True)
        _, _, va_l, va_a = run_split(net_params, opt_state, va_idx, False)
        history.append({"epoch": ep, "train_loss": tr_l, "train_acc": tr_a, "val_loss": va_l,
                        "val_acc": va_a, "seconds": time.time() - t0})
        if va_l < best[0]:
            best = (va_l, {k: v.clone() for k, v in net_params.items()})
            if ckpt:
                ckpt.save(ep, {"q_params": best[1]}, force=True)
        if verbose:
            h = history[-1]
            print(f"[bc] epoch {ep}: train ce {tr_l:.4f} acc {tr_a:.3f} | val ce {va_l:.4f} "
                  f"acc {va_a:.3f} [{h['seconds']:.1f}s]", flush=True)

    out = {"params": best[1], "history": history, "best_val_loss": best[0], "net": net}
    if cfg.eval_episodes:
        g = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        out["eval"] = evaluate_policy(params, net, best[1], cfg.eval_episodes, g,
                                      coordinated=cfg.eval_coordinated, verbose=verbose)
    return out


def _policy_act(params: EnvParams, net, net_params, coordinated: bool, temperature: float):
    """act(obs, state, gumbel) -> (B, A) int32 actions of the clone:
    sampled from softmax(scores / temperature) through the claim auction
    when temperature > 0 (the serving operator), else greedy over the valid
    actions (-inf elsewhere), through the auction when `coordinated`."""
    rack_start = 1 + params.num_goals
    # A 0-d tensor: CUDA turns a division by a Python scalar into a product
    # with its reciprocal.
    temp = torch.tensor(temperature, dtype=torch.float32, device=params.device)

    @torch.no_grad()
    def act(obs, es, gumbel):
        scores = obs_q_values(net, net_params, params, obs)
        masks = compute_valid_action_masks(params, es)
        active = ~es.agent_busy
        if temperature > 0:
            return coordination.coordinated_sample(scores / temp, masks, params.num_agvs,
                                                   rack_start, gumbel, active=active)
        if coordinated:
            return coordination.coordinated_argmax(scores, masks, params.num_agvs, rack_start,
                                                   active=active)
        return torch.where(masks > 0, scores, -torch.inf).argmax(dim=-1).to(torch.int32)

    return act


def collect_dagger(params: EnvParams, layout: Layout, net: nn.Module, net_params, episodes: int,
                   draws, beta: float = 0.0, coordinated: bool = True,
                   temperature: float = 0.0, steps: int = 0, with_stats: bool = False):
    """DAgger collection: roll the clone (or, per env and step with
    probability beta, the expert), label every visited state with the
    stateless expert (Ross et al. 2011).

    draws: a torch.Generator or a draws object (reset, step, coin, and
    gumbel when temperature > 0); each step draws the clone's Gumbels
    first, then one uniform per env for the beta coin.
    Returns host arrays (obs float16 (N, A, obs_len), expert actions int32
    (N, A), busy bool (N, A)), N = steps * episodes in step-major order;
    with_stats adds a fourth item, the rollout's {'deliveries' (a mean per
    episode), 'replan_overflow' (the total)}."""
    draws = as_draws(params, draws)
    expert = make_stateless_expert(params, layout)
    act = _policy_act(params, net, net_params, coordinated, temperature)
    E = episodes
    steps = steps or params.max_steps or 500
    es = draws.reset(E)
    obs = observe(params, es)
    obs_l, act_l, busy_l, sums = [], [], [], []
    for _ in range(steps):
        a_exp = expert(params, es)
        a_clone = act(obs, es, draws.gumbel(E) if temperature > 0 else None)
        take_exp = draws.coin(E) < beta
        a = torch.where(take_exp[:, None], a_exp, a_clone).to(torch.int32)
        obs_l.append(obs.to(torch.float16))
        act_l.append(a_exp.to(torch.int32))
        busy_l.append(es.agent_busy)
        es, _, _, info = step_mod.step(params, es, a, noise=draws.step(E))
        obs = observe(params, es)
        sums.append(torch.stack([info["shelf_deliveries"].sum(), info["replan_overflow"].sum()]))
    flat = lambda xs: torch.stack(xs).flatten(0, 1).cpu().numpy()
    out = flat(obs_l), flat(act_l), flat(busy_l)
    if not with_stats:
        return out
    d, ovf = (int(v) for v in torch.stack(sums).sum(dim=0).cpu())
    return out + ({"deliveries": d / E, "replan_overflow": ovf},)


def evaluate_policy(params: EnvParams, net: nn.Module, net_params, episodes: int, draws,
                    coordinated: bool = False, temperature: float = 0.0,
                    verbose: bool = True, steps: int = 0) -> Dict:
    """Rollout evaluation of a clone over `episodes` fresh envs in lockstep
    (the reference's stat line, run_heuristic.py:30-58): greedy over the
    masked scores (through the claim auction when `coordinated`), or
    sampled through the auction at `temperature` > 0. draws: a
    torch.Generator or a draws object (reset, step, and gumbel when
    temperature > 0); episodes of `steps` steps (default the env's). Means
    per episode of the return, deliveries and clashes, and the replan
    query's overflow (a total)."""
    draws = as_draws(params, draws)
    act = _policy_act(params, net, net_params, coordinated, temperature)
    E = episodes
    steps = steps or params.max_steps or 500
    es = draws.reset(E)
    obs = observe(params, es)
    sums = []
    for _ in range(steps):
        a = act(obs, es, draws.gumbel(E) if temperature > 0 else None)
        es, rew, _, info = step_mod.step(params, es, a, noise=draws.step(E))
        obs = observe(params, es)
        sums.append(torch.stack([rew.sum(), info["shelf_deliveries"].sum().float(),
                                 info["clashes"].sum().float(),
                                 info["replan_overflow"].sum().float()]))
    r, d, c, ovf = (float(v) for v in torch.stack(sums).sum(dim=0).cpu())
    r, d, c = r / E, d / E, c / E
    res = {"episodes": E, "pick_rate": pick_rate(d, steps), "deliveries": d, "return": r,
           "clashes": c, "coordinated": bool(coordinated or temperature > 0),
           "temperature": temperature, "replan_overflow": int(ovf)}
    if verbose:
        tag = f" T={temperature}" if temperature > 0 else (" coord" if coordinated else "")
        print(f"[bc eval{tag}] pick_rate={res['pick_rate']:.2f} deliveries={d:.1f} "
              f"clashes={c:.1f} ({E} episodes)", flush=True)
    return res
