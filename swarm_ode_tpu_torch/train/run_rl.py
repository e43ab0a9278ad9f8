"""Online MARL (IQL, QMIX, COMA) on B lockstep envs.

Counterpart of `swarm_ode_tpu/train/run_rl.py` (RLRunConfig :40,
_make_network :131, _feats :186, _global_state :191, run_marl :205, its COMA
branches :263-276, :487, :589-627 and init_q_from :282-304; reference
run_gnode.py:1328-1531, gru.py:1035-1275, graph.py:632-701) for algo "iql",
"qmix" and "coma" and net "gnode", "gnode_comm", "gnn" and "gru" (IQL
only, as in JAX). Per episode stride: reset B envs -> observe -> hetero graph -> Q-network (COMA: the
actors) -> masked epsilon-greedy, sampling or the claim auction -> env step
(the replan query K1 on the card) -> replay -> one IQL or QMIX learn step
every `learn_every` env steps once the buffer is warm -> target sync -> one
stat line. COMA is on-policy: after each stride it takes `coma_updates`
updates, each on a batch sampled from that stride's transitions
(replay.sample_recent). The GRU network's hidden states start at zeros at
each reset, are carried from step to step (`MarlRun.hidden`), and go into
replay beside each transition (`extras`, and `next_extras` for the next
state) for the learn step to start its passes from. `init_q_from`
warm-starts an IQL or QMIX Q-network (and its target) from a
behaviour-cloning checkpoint (train/train_bc.py).

The JAX package runs an episode as one `lax.scan` with one transfer to the
host; here the episode is a Python loop of device work that never waits on
the card (replay's ptr and size are host integers, so readiness is known
without reading the device), and the episode's statistics come back in one
copy after it. A block whose buffer is not ready skips its learn step,
which JAX computes and throws away: the agent state is the same either
way, and the block's sample draw is still taken, so the draw order is
JAX's. Random draws come from a `MarlDraws` (one torch.Generator), or from
any object with its methods (the tests replay JAX's own keys).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.layout import build_layout
from swarm_ode_tpu_torch.env.observations import compute_valid_action_masks, observe
from swarm_ode_tpu_torch.env.state import EnvParams, make_params
from swarm_ode_tpu_torch.graphs.hetero import hetero_graph_from_obs, split_observation
from swarm_ode_tpu_torch.models.gnode import HeteroGraphODENetwork
from swarm_ode_tpu_torch.models.gru import HeteroGraphGRUNetwork
from swarm_ode_tpu_torch.models.hetero_gnn import HeteroGNNEncoder, HeteroGNNNetwork
from swarm_ode_tpu_torch.rl import replay
from swarm_ode_tpu_torch.rl.coma import COMAAgent, COMAConfig, COMAState
from swarm_ode_tpu_torch.rl.dqn import DQNConfig, DQNState, IQLAgent, draw_act_noise
from swarm_ode_tpu_torch.rl.draws import RolloutDraws
from swarm_ode_tpu_torch.rl.qmix import QMIXAgent, QMIXConfig
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager
from swarm_ode_tpu_torch.utils.logging import MetricsLogger
from swarm_ode_tpu_torch.utils.metrics import pick_rate

NETS = ("gnode", "gnode_comm", "gnn", "gru")
ALGOS = ("iql", "qmix", "coma")


@dataclasses.dataclass
class RLRunConfig:
    env_id: str = "tarware-medium-19agvs-9pickers-partialobs-v1"
    algo: str = "qmix"  # iql | qmix | coma
    net: str = "gnode"  # gnode | gnode_comm | gnn | gru (IQL only)
    num_envs: int = 1  # lockstep envs feeding the shared replay buffer
    num_episodes: int = 100
    hidden_dim: int = 64
    buffer_size: int = 20_000
    batch_size: int = 32
    learn_every: int = 1
    target_sync_episodes: int = 20  # IQL hard target sync
    buffer_clear_episodes: int = 0  # clear replay every N episodes; 0 = never
    # Team reward for QMIX and COMA: 'mean' keeps the value scale independent
    # of the agent count; 'sum' is the reference's convention.
    team_reward: str = "mean"
    n_step: int = 3  # n-step TD targets, never across episode boundaries
    value_transform: bool = True  # R2D2 h-transform of QMIX targets
    gamma: Optional[float] = None  # None = per-algo default
    td_clip: float = 0.0
    huber_delta: float = 0.0
    target_tau: float = 0.0
    epsilon_decay: Optional[float] = None
    epsilon_min: Optional[float] = None
    epsilon_start: Optional[float] = None
    # COMA is on-policy: after each stride, this many updates, each on a
    # batch sampled from the stride's own transitions (replay.sample_recent).
    coma_updates: int = 8
    # COMA's optimizer and entropy knobs (rl/coma.COMAConfig).
    coma_lr_actor: float = 1e-3
    coma_lr_critic: float = 1e-3
    coma_entropy: float = 0.01
    coma_entropy_decay: float = 1.0
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    # Greedy evaluation probe every `eval_every` episodes (0 = off):
    # `eval_episodes` fresh envs, no learning, no buffer writes.
    eval_every: int = 0
    eval_episodes: int = 8
    eval_stochastic: bool = False  # evaluate with epsilon-greedy at the agent's epsilon
    resume_from: Optional[str] = None  # checkpoint dir of a previous run
    # Warm-start the Q-network (and its target) from a behaviour-cloning
    # checkpoint ({'q_params': ...}, train/train_bc.py) of the same net and
    # hidden_dim; applied at init, before resume_from; IQL and QMIX only.
    init_q_from: Optional[str] = None
    coordinated: bool = False  # the claim auction (rl/coordination.py)
    device: str = "cuda"
    # Run each training episode under torch.cuda.set_sync_debug_mode("error"):
    # a host synchronisation inside an episode raises (the stats are read
    # after it). A check; on the card only.
    forbid_host_sync: bool = False


def make_network(cfg: RLRunConfig, action_size: int, coord_scale: float = 1.0):
    """The Q-network of `cfg.net` (on the CPU; the caller moves it)."""
    if cfg.net == "gnode":
        return HeteroGraphODENetwork(action_size, cfg.hidden_dim, coord_scale=coord_scale)
    if cfg.net == "gnode_comm":
        return HeteroGraphODENetwork(action_size, cfg.hidden_dim, coord_scale=coord_scale,
                                     comm=True)
    if cfg.net == "gnn":
        return HeteroGNNNetwork(action_size, cfg.hidden_dim, coord_scale=coord_scale)
    if cfg.net == "gru":
        return HeteroGraphGRUNetwork(action_size, cfg.hidden_dim, coord_scale=coord_scale)
    raise ValueError(f"net must be one of {NETS}, got {cfg.net!r}")


def _check_supported(cfg: RLRunConfig) -> None:
    if cfg.algo not in ALGOS:
        raise ValueError(f"algo must be one of {ALGOS}, got {cfg.algo!r}")
    if cfg.init_q_from and cfg.algo not in ("iql", "qmix"):
        raise ValueError("init_q_from supports algo in (iql, qmix)")
    if cfg.net == "gru" and cfg.algo != "iql":
        # The reference pairs the GRU network with IQL only (gru.py:1035-1275).
        raise ValueError("net='gru' currently supports algo='iql'")


def agent_params(astate: DQNState) -> Dict[str, torch.Tensor]:
    """The Q-network's parameters of an IQL or QMIX state (names without
    QMIX's `q.` prefix)."""
    p = astate.params
    if any(k.startswith("mixer.") for k in p):
        return {k[2:]: v for k, v in p.items() if k.startswith("q.")}
    return p


def feats_of(params: EnvParams, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
    a, p, l = split_observation(params, obs)
    return {"agv": a, "picker": p, "loc": l}


def global_state(feats, scale: float = 1.0) -> torch.Tensor:
    """(B, S) flat global state for the mixers: all node features
    concatenated, times `scale` (tames the raw coordinates)."""
    B = feats["agv"].shape[0]
    return torch.cat([feats["agv"].reshape(B, -1), feats["picker"].reshape(B, -1),
                      feats["loc"].reshape(B, -1)], dim=1) * scale


def global_state_dim(params: EnvParams) -> int:
    return 7 * params.num_agvs + 4 * params.num_pickers + 2 * params.num_racks


class MarlDraws(RolloutDraws):
    """run_marl's random draws from one torch.Generator on the params'
    device: the resets of each stride, each step's env draws, each act's
    draws (IQL / QMIX: the exploration draws; COMA: the Gumbels it samples
    with), each learn block's sample indices and each COMA update's offsets
    into the stride (`recent`). `split` gives the draws of an evaluation
    probe."""

    def __init__(self, params: EnvParams, generator: torch.Generator, coordinated: bool,
                 algo: str = "qmix"):
        super().__init__(params, generator)
        self.coordinated, self.algo = coordinated, algo

    def act(self, B: int):
        if self.algo == "coma":
            return self.gumbel(B)
        p = self.params
        return draw_act_noise(B, p.num_agents, p.num_actions, self.coordinated,
                              self.generator, p.device)

    def sample(self, size: int, batch_size: int) -> torch.Tensor:
        return torch.randint(0, max(size, 1), (batch_size,), generator=self.generator,
                             device=self.params.device)

    def recent(self, size: int, batch_size: int, window: int) -> torch.Tensor:
        """replay.sample_recent's offsets, uniform in [1, min(window, size)]."""
        w = max(min(window, size), 1)
        return torch.randint(1, w + 1, (batch_size,), generator=self.generator,
                             device=self.params.device)


def _state_tree(astate) -> dict:
    if isinstance(astate, COMAState):
        return astate.tree()
    return {"params": astate.params, "target_params": astate.target_params,
            "opt_state": astate.opt_state, "epsilon": astate.epsilon, "step": astate.step}


def _state_from_tree(tree: dict, like):
    return (COMAState if isinstance(like, COMAState) else DQNState)(**tree)


def make_agent(cfg: RLRunConfig, params: EnvParams):
    """(agent, network) of `cfg` on params.device; COMA's network is its
    actors (the encoder and the two heads)."""
    scale = 1.0 / float(max(params.grid_h, params.grid_w))
    if cfg.algo == "coma":
        # COMA's encoder is the GNN encoder whatever cfg.net is (JAX
        # run_rl.py:264).
        encoder = HeteroGNNEncoder(cfg.hidden_dim, 2, coord_scale=scale).to(params.device)
        ccfg = COMAConfig(lr_actor=cfg.coma_lr_actor, lr_critic=cfg.coma_lr_critic,
                          entropy_coef=cfg.coma_entropy, entropy_decay=cfg.coma_entropy_decay,
                          coordinated=cfg.coordinated)
        if cfg.gamma is not None:
            ccfg.gamma = cfg.gamma
        agent = COMAAgent(encoder, params, params.num_actions, global_state_dim(params),
                          cfg.hidden_dim, ccfg)
        return agent, agent.actors
    net = make_network(cfg, params.num_actions, coord_scale=scale).to(params.device)
    overrides = {k: getattr(cfg, k) for k in ("gamma", "epsilon_decay", "epsilon_min",
                                              "epsilon_start") if getattr(cfg, k) is not None}
    if cfg.algo == "iql":
        agent = IQLAgent(net, params, DQNConfig(batch_size=cfg.batch_size,
                                                coordinated=cfg.coordinated, **overrides))
    else:
        agent = QMIXAgent(net, params, global_state_dim(params), QMIXConfig(
            batch_size=cfg.batch_size, value_transform=cfg.value_transform,
            td_clip=cfg.td_clip, huber_delta=cfg.huber_delta, target_tau=cfg.target_tau,
            coordinated=cfg.coordinated, **overrides))
    return agent, net


def batch_from(sampled, algo: str, gamma: float, n_step: int, team_reward: str = "mean"):
    """A learn batch from replay.sample_nstep's sample: the per-link rewards
    (B, n, A) discounted over the valid links (IQL per agent; QMIX the team
    reward, the agents' mean or sum), gamma_eff = gamma**m for the chain
    length m; a GRU network's hidden states (extras, next_extras) pass
    through."""
    dev = sampled["nstep_valid"].device
    disc = gamma ** torch.arange(n_step, dtype=torch.float32, device=dev)
    valid = sampled["nstep_valid"].to(torch.float32)
    gamma_eff = gamma ** sampled["nstep_m"].to(torch.float32)
    r = sampled["nstep_rewards"]
    if algo == "iql":
        batch = {"obs_feats": sampled["obs_feats"], "next_feats": sampled["next_feats"],
                 "actions": sampled["actions"],
                 "rewards": (r * (disc * valid)[:, :, None]).sum(dim=1),
                 "dones": sampled["done"], "gamma_eff": gamma_eff}
        for k in ("extras", "next_extras"):
            if k in sampled:
                batch[k] = sampled[k]
        return batch
    team_k = r.mean(-1) if team_reward == "mean" else r.sum(-1)  # (B, n)
    return {"obs_feats": sampled["obs_feats"], "next_feats": sampled["next_feats"],
            "actions": sampled["actions"], "reward": (team_k * disc * valid).sum(dim=1),
            "global_state": sampled["global_state"],
            "next_global_state": sampled["next_global_state"],
            "done": sampled["done"], "gamma_eff": gamma_eff}


# Per-step sums an episode returns, in this column order.
STEP_STATS = ("reward", "deliveries", "clashes", "stucks", "replan_overflow")


def load_q_params(astate: DQNState, directory: str, algo: str) -> DQNState:
    """`astate` with its Q-network's parameters (QMIX's `q.` part) and their
    targets replaced by a behaviour-cloning checkpoint's {'q_params': ...};
    Adam's state, epsilon and step stay."""
    template = agent_params(astate)
    restored = CheckpointManager(directory).restore({"q_params": template})
    if restored is None:
        raise FileNotFoundError(f"init_q_from={directory}: no checkpoint found")
    qp = restored["q_params"]
    params = {**astate.params, **{f"q.{k}": v for k, v in qp.items()}} if algo == "qmix" else qp
    return astate.replace(params=params, target_params=dict(params))


class MarlRun:
    """One MARL run's pieces: the env params on cfg.device, the agent and
    its state, the replay buffer, the draws, and a GRU network's hidden
    states (`hidden`, None until the first step after a reset: zeros).
    `episode`, `coma_update` and `eval_probe` never wait on the card;
    run_marl drives them."""

    def __init__(self, cfg: RLRunConfig, draws=None, agent_state=None, verbose: bool = False):
        _check_supported(cfg)
        dev = torch.device(cfg.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("run_marl runs on the card (device='cuda') and none is "
                               "available; pass device='cpu' to run on the CPU")
        env_cfg = EnvConfig.from_env_id(cfg.env_id)
        self.cfg, self.device = cfg, dev
        self.params = params = make_params(env_cfg, build_layout(env_cfg), dev)
        self.steps = env_cfg.max_steps or 500
        self.learn_every = max(1, cfg.learn_every)
        if self.steps % self.learn_every:
            raise ValueError(
                f"learn_every={cfg.learn_every} must divide the episode length ({self.steps}): "
                "the episode runs as blocks of learn_every env steps with one gradient step "
                "per block")
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.draws = draws if draws is not None else MarlDraws(params, generator,
                                                               cfg.coordinated, cfg.algo)
        self.agent, self.net = make_agent(cfg, params)
        self.off_policy = cfg.algo in ("iql", "qmix")
        self.is_gru = cfg.net == "gru"
        self.hidden = None
        self.astate = agent_state if agent_state is not None else self.agent.init(generator)
        if cfg.init_q_from:
            self.astate = load_q_params(self.astate, cfg.init_q_from, cfg.algo)
            if verbose:
                print(f"[init] Q-network warm-started from {cfg.init_q_from}", flush=True)
        self.gs_scale = 1.0 / float(max(params.grid_h, params.grid_w))
        A, P, L, N = params.num_agvs, params.num_pickers, params.num_racks, params.num_agents
        f32 = dict(dtype=torch.float32, device=dev)
        feats0 = {"agv": torch.zeros(A, 7, **f32), "picker": torch.zeros(P, 4, **f32),
                  "loc": torch.zeros(L, 2, **f32)}
        gs0 = torch.zeros(global_state_dim(params), **f32)
        item = {
            "obs_feats": feats0, "next_feats": feats0,
            "actions": torch.zeros(N, dtype=torch.int32, device=dev),
            "rewards": torch.zeros(N, **f32),
            "global_state": gs0, "next_global_state": gs0,
            "done": torch.zeros((), dtype=torch.bool, device=dev),
            "_t": torch.zeros((), dtype=torch.int32, device=dev),
            "_ep": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.is_gru:
            h0 = tuple(h[0] for h in self.net.init_hidden(1, A, P))
            item["extras"], item["next_extras"] = h0, h0
        # Allocated once; add_batch writes into it in place.
        self.buf = replay.init(item, cfg.buffer_size)

    def warm_up(self) -> None:
        """One greedy act and env step of a throwaway env, drawn from a
        generator of its own: observe and step build small per-device
        constant tables with a host copy at their first call, and after
        this a host-sync-free episode holds only its own work. The step
        runs without the replan query (replan_mode "off": no K1 launch,
        which builds no table), and the run's draws, agent and buffer are
        untouched."""
        p = dataclasses.replace(self.params, replan_mode="off")
        g = torch.Generator(device=self.device).manual_seed(0)
        es = step_mod.reset(p, 1, g)
        a, _ = self._act(p, es, observe(p, es), None, None, training=False)
        step_mod.step(p, es, a, generator=g)

    def _act(self, p: EnvParams, es, obs, noise, hidden, training: bool = True):
        """The agent's actions on observations `obs` of states `es`, and a
        GRU network's new hidden states from the same pass, from `hidden`
        (None: zeros); `hidden` unchanged for the other networks."""
        graph, masks = hetero_graph_from_obs(p, obs), compute_valid_action_masks(p, es)
        if self.is_gru:
            return self.agent.act_and_hidden(self.astate, graph, masks, noise, training,
                                             ~es.agent_busy, hidden)
        return self.agent.act(self.astate, graph, masks, noise, training=training,
                              active=~es.agent_busy), hidden

    def env_step(self, es, obs, t: int, ep_idx: int):
        """One step of B envs: act, step (K1 on the card), one replay item
        per env; a GRU network's hidden states carried in `self.hidden`.
        Returns (state, observations, (5,) per-step sums)."""
        p, B, dev = self.params, es.batch, self.device
        feats = feats_of(p, obs)
        if self.is_gru and self.hidden is None:
            self.hidden = self.net.init_hidden(B, p.num_agvs, p.num_pickers)
        hidden = self.hidden
        actions, self.hidden = self._act(p, es, obs, self.draws.act(B), hidden)
        es, rew, done, info = step_mod.step(p, es, actions, noise=self.draws.step(B))
        obs = observe(p, es)
        feats2 = feats_of(p, obs)
        item = {
            "obs_feats": feats, "next_feats": feats2, "actions": actions, "rewards": rew,
            "global_state": global_state(feats, self.gs_scale),
            "next_global_state": global_state(feats2, self.gs_scale), "done": done,
            "_t": torch.full((B,), t, dtype=torch.int32, device=dev),
            "_ep": torch.full((B,), ep_idx, dtype=torch.int32, device=dev),
        }
        if self.is_gru:
            item["extras"], item["next_extras"] = hidden, self.hidden
        self.buf = replay.add_batch(self.buf, item)
        sums = torch.stack([rew.sum()] + [info[k].sum().float() for k in (
            "shelf_deliveries", "clashes", "stucks", "replan_overflow")])
        return es, obs, sums

    def learn_block(self) -> torch.Tensor:
        """The learn step closing a block (IQL and QMIX): sample (the draw is
        taken even when the buffer is not ready, as JAX's), learn when it
        is. Returns the loss (0 when not ready, and for COMA, which draws
        nothing here)."""
        cfg, B = self.cfg, self.cfg.num_envs
        if not self.off_policy:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        idx = self.draws.sample(self.buf.size, cfg.batch_size)
        # Warm start: chains need n_step * B slots of history.
        if self.buf.size < cfg.batch_size + cfg.n_step * B:
            return torch.zeros((), dtype=torch.float32, device=self.device)
        sampled = replay.sample_nstep(self.buf, cfg.batch_size, cfg.n_step, B, idx=idx)
        batch = batch_from(sampled, cfg.algo, self.agent.cfg.gamma, cfg.n_step, cfg.team_reward)
        self.astate, aux = self.agent.learn(self.astate, batch)
        return aux["loss"]

    def episode(self, es, t0: int, ep_idx: int):
        """One episode from states `es`; a learn step every learn_every env
        steps. Returns (final states, (steps, 5) per-step sums in
        STEP_STATS order, (blocks,) losses), on the device. A GRU network's
        hidden states start at zeros."""
        obs = observe(self.params, es)
        self.hidden = None
        outs, losses = [], []
        for tb in range(self.steps // self.learn_every):
            for k in range(self.learn_every):
                es, obs, sums = self.env_step(es, obs, t0 + tb * self.learn_every + k, ep_idx)
                outs.append(sums)
            losses.append(self.learn_block())
        return es, torch.stack(outs), torch.stack(losses)

    def coma_update(self):
        """One COMA update on a batch sampled from the newest stride
        (steps x B transitions) of the buffer. Returns its
        {'critic_loss', 'actor_loss'}, on the device."""
        cfg = self.cfg
        window = self.steps * cfg.num_envs
        off = self.draws.recent(self.buf.size, cfg.batch_size, window)
        sampled = replay.sample_recent(self.buf, cfg.batch_size, window, off=off)
        team = sampled["rewards"].mean(-1) if cfg.team_reward == "mean" else \
            sampled["rewards"].sum(-1)
        self.astate, aux = self.agent.update(self.astate, {
            "obs_feats": sampled["obs_feats"], "global_state": sampled["global_state"],
            "actions": sampled["actions"], "rewards": team,
            "next_global_state": sampled["next_global_state"], "dones": sampled["done"]})
        return aux

    def eval_probe(self, draws):
        """Greedy evaluation (epsilon-greedy with cfg.eval_stochastic):
        eval_episodes fresh envs for one episode, no learning, no buffer
        writes. Returns the mean return and deliveries per env, on the
        device."""
        p, E, stochastic = self.params, self.cfg.eval_episodes, self.cfg.eval_stochastic
        es = draws.reset(E)
        obs = observe(p, es)
        ret = torch.zeros((), dtype=torch.float32, device=self.device)
        deliv = torch.zeros_like(ret)
        hidden = None  # a GRU network's, zeros at the reset
        for _ in range(self.steps):
            actions, hidden = self._act(p, es, obs, draws.act(E) if stochastic else None,
                                        hidden, training=stochastic)
            es, rew, _, info = step_mod.step(p, es, actions, noise=draws.step(E))
            obs = observe(p, es)
            ret = ret + rew.sum()
            deliv = deliv + info["shelf_deliveries"].sum()
        return ret / E, deliv / E


def run_marl(cfg: RLRunConfig, logger: Optional[MetricsLogger] = None, verbose: bool = True,
             draws=None, agent_state=None) -> Dict:
    """Train (or, with num_episodes == 0, only evaluate) an IQL, QMIX or
    COMA agent.

    draws: the random draws (default MarlDraws from a generator seeded with
      cfg.seed); agent_state: the initial agent state in place of a fresh
      initialisation (init_q_from and resume_from still apply on top).
    Returns {'agent_state', 'history' (one stats dict per stride; COMA's
    with the last update's critic_loss and actor_loss, and loss the
    critic's), 'losses' (per stride, the (steps // learn_every,) learn
    losses, 0 where the buffer was not ready and for COMA), 'buffer'}."""
    run = MarlRun(cfg, draws, agent_state, verbose)
    steps, B, E = run.steps, cfg.num_envs, cfg.eval_episodes
    ep_base = 0
    if cfg.resume_from:
        rck = CheckpointManager(cfg.resume_from)
        restored = rck.restore({"agent": _state_tree(run.astate)})
        if restored is None:
            raise FileNotFoundError(f"resume_from={cfg.resume_from}: no checkpoint found")
        run.astate = _state_from_tree(restored["agent"], run.astate)
        ep_base = int(rck.latest_step()) + B
        if verbose:
            print(f"[resume] restored agent from {cfg.resume_from} step {rck.latest_step()} "
                  f"(continuing at episode {ep_base})", flush=True)

    def eval_stats():
        er, ed = (float(v) for v in run.eval_probe(run.draws.split()))
        return er, ed, pick_rate(ed, steps)

    if cfg.num_episodes == 0:
        er, ed, pr = eval_stats()
        stats = {"episode": ep_base, "eval_return": er, "eval_deliveries": ed,
                 "eval_pick_rate": pr}
        if verbose:
            print(f"[eval-only eps=0] pick_rate={pr:.2f} deliveries={ed:.1f} return={er:.2f} "
                  f"({E} greedy episodes)", flush=True)
        return {"agent_state": run.astate, "history": [stats], "losses": [], "buffer": run.buf}

    history, all_losses = [], []
    ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    guard = cfg.forbid_host_sync and run.device.type == "cuda"
    if guard:
        run.warm_up()
    for ep in range(0, cfg.num_episodes, B):
        es = run.draws.reset(B)
        t_start = time.time()
        with sync_guard(guard):
            es, outs, loss = run.episode(es, (ep_base + ep) * steps, ep_base + ep)
        outs, loss = outs.cpu().numpy(), loss.cpu().numpy()
        episode_seconds = time.time() - t_start
        all_losses.append(loss)
        rew_sum, deliv, clash, stuck = (outs[:, i] / B for i in range(4))
        coma_aux, t_updates = None, time.time()
        if cfg.algo == "coma":
            for _ in range(max(1, cfg.coma_updates)):
                coma_aux = run.coma_update()
        if cfg.algo == "iql" and (ep + 1) % cfg.target_sync_episodes == 0:
            run.astate = run.agent.sync_target(run.astate)
        if cfg.buffer_clear_episodes and (ep + B) % cfg.buffer_clear_episodes < B:
            run.buf = replay.clear(run.buf)
        stats = {
            "episode": ep_base + ep,
            "return": float(rew_sum.sum()),
            "deliveries": int(deliv.sum()),
            "clashes": int(clash.sum()),
            "stucks": int(stuck.sum()),
            "pick_rate": pick_rate(int(deliv.sum()), steps),
            "loss": float(loss[loss != 0].mean()) if (loss != 0).any() else 0.0,
            "replan_overflow": int(outs[:, 4].sum()),
            "seconds": time.time() - t_start,
            "episode_seconds": episode_seconds,
        }
        if coma_aux is not None:
            stats["critic_loss"] = float(coma_aux["critic_loss"])
            stats["actor_loss"] = float(coma_aux["actor_loss"])
            stats["loss"] = stats["critic_loss"]
            stats["coma_update_seconds"] = time.time() - t_updates
        if cfg.eval_every and (ep + B) % cfg.eval_every < B:
            er, ed, pr = eval_stats()
            stats.update(eval_return=er, eval_deliveries=ed, eval_pick_rate=pr)
            if verbose:
                print(f"[eval eps=0] Episode {ep_base + ep}: pick_rate={pr:.2f} "
                      f"deliveries={ed:.1f} return={er:.2f} ({E} greedy episodes)", flush=True)
        history.append(stats)
        if logger:
            logger.log(stats, step=ep)
        if verbose:
            print(f"[{cfg.algo}+{cfg.net}] Episode {ep_base + ep}: "
                  f"| [Overall Pick Rate={stats['pick_rate']:.2f}]"
                  f"| [Global return={stats['return']:.2f}]"
                  f"| [Total shelf deliveries={stats['deliveries']}]"
                  f"| [Total clashes={stats['clashes']}]"
                  f"| [Total stuck={stats['stucks']}]"
                  f" | [loss={stats['loss']:.4f}] [{stats['seconds']:.1f}s]", flush=True)
        # ep advances in strides of B envs; save when a multiple of
        # checkpoint_every falls inside this stride.
        if ckpt and (ep + B) % cfg.checkpoint_every < B:
            ckpt.save(ep_base + ep, {"agent": _state_tree(run.astate)}, force=True)
    return {"agent_state": run.astate, "history": history, "losses": all_losses,
            "buffer": run.buf}


@contextlib.contextmanager
def sync_guard(on: bool):
    """torch.cuda.set_sync_debug_mode("error") inside the block when `on`."""
    if not on:
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def main(argv=None) -> None:
    """The CLI of scripts/run_gnode.py for the port (on the card by
    default)."""
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--num_episodes", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--env_id", default="tarware-medium-19agvs-9pickers-partialobs-v1")
    p.add_argument("--algo", default="qmix", choices=["iql", "qmix", "coma"])
    p.add_argument("--net", default="gnode", choices=["gnode", "gnode_comm", "gnn", "gru"])
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every", type=int, default=100)
    p.add_argument("--num_envs", type=int, default=1)
    p.add_argument("--n_step", type=int, default=3)
    p.add_argument("--learn_every", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--no_value_transform", action="store_true",
                   help="disable R2D2 h-transform value rescaling (QMIX)")
    p.add_argument("--team_reward", default="mean", choices=["mean", "sum"])
    p.add_argument("--gamma", type=float, default=None,
                   help="discount override (default: per-algo reference value)")
    p.add_argument("--td_clip", type=float, default=0.0,
                   help="raw-space clamp on QMIX bootstrap targets (0 = off)")
    p.add_argument("--huber_delta", type=float, default=0.0,
                   help="Huber delta for the QMIX TD loss (0 = MSE)")
    p.add_argument("--target_tau", type=float, default=0.0,
                   help="Polyak target update rate (0 = hard sync)")
    p.add_argument("--epsilon_decay", type=float, default=None,
                   help="per-update epsilon decay override")
    p.add_argument("--eval_every", type=int, default=0,
                   help="greedy (epsilon=0) eval probe every N episodes (0=off)")
    p.add_argument("--eval_episodes", type=int, default=8)
    p.add_argument("--resume_from", default=None,
                   help="checkpoint dir to resume agent state from")
    p.add_argument("--init_q_from", default=None,
                   help="behaviour-cloning checkpoint dir to warm-start the Q-network from")
    p.add_argument("--coordinated", action="store_true",
                   help="conflict-masked sequential action selection (rl/coordination.py)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out_dir", default="runs", help="JSONL metrics directory")
    args = p.parse_args(argv)
    cfg = RLRunConfig(
        env_id=args.env_id, algo=args.algo, net=args.net, num_episodes=args.num_episodes,
        hidden_dim=args.hidden_dim, num_envs=args.num_envs, n_step=args.n_step,
        learn_every=args.learn_every, batch_size=args.batch_size,
        value_transform=not args.no_value_transform, team_reward=args.team_reward,
        gamma=args.gamma, td_clip=args.td_clip, huber_delta=args.huber_delta,
        target_tau=args.target_tau, epsilon_decay=args.epsilon_decay, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
        eval_every=args.eval_every, eval_episodes=args.eval_episodes,
        resume_from=args.resume_from, init_q_from=args.init_q_from,
        coordinated=args.coordinated, device=args.device)
    logger = MetricsLogger("swarm_ode", name=f"{args.net}+{args.algo}", config=vars(args),
                           out_dir=args.out_dir, use_wandb=False)
    run_marl(cfg, logger=logger)
    logger.finish()


if __name__ == "__main__":
    main()
