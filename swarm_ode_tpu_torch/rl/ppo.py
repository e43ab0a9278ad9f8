"""MAPPO: multi-agent PPO with a centralised value function, on B lockstep
envs.

Counterpart of `swarm_ode_tpu/rl/ppo.py` (MAPPOConfig :47, ValueNet :82,
_global_state :92, run_mappo :103); `_global_state` is
train/run_rl.global_state, batched. The actor is the RL agents' network
family (train/run_rl.make_network): its AGV and picker scores are the
logits, so a behaviour-cloning checkpoint (train/train_bc.py) warm-starts
it (`init_from`). The critic is V(global state), the global state scaled
by 1 / max(H, W), trained on GAE returns. Coordinated mode (the default)
samples through the claim auction (coordination.coordinated_sample) and
scores the taken actions under `sequential_log_prob`, that sampler's exact
density, so the PPO ratio is exact.

A stride is B episodes of T steps: the collection (`MappoRun.collect`)
steps the env through env/step.step (the replan query K1 on the card) and
never reads the device; GAE runs backwards over T with a bootstrap at the
stride's end only; the update (`MappoRun.update`) takes ppo_epochs epochs,
each a permutation of the N = T * B samples cut to whole minibatches. The
loss is pg + value_coef * v_loss - entropy_coef * entropy; the actor and
the critic each clip their gradient to max_grad_norm (optax's rule) before
their own Adam. Draws (resets, step draws, the sampling Gumbels, the
permutations) come from rl/draws.RolloutDraws or any object with its
methods (the tests give JAX's own).

With `mesh_devices` = n > 0 the envs are split over the n ranks of a
process group, one per device (parallel/mesh.py), as JAX splits them over
n devices. Each rank draws for all B envs, as one device would, and keeps
its B/n: its envs' trajectories are the one-device run's. The collection
(rollout, policy, GAE) needs no communication; run_mappo then gathers the
whole (T, B) stride on every rank (`gather`), and every rank takes the same
update on it, so the parameters stay equal with no gradient collective.
Rank 0 writes the checkpoints and the log.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from swarm_ode_tpu_torch.config import EnvConfig
from swarm_ode_tpu_torch.env import step as step_mod
from swarm_ode_tpu_torch.env.layout import build_layout
from swarm_ode_tpu_torch.env.observations import compute_valid_action_masks, observe
from swarm_ode_tpu_torch.env.state import make_params
from swarm_ode_tpu_torch.graphs.hetero import masks_from_feats
from swarm_ode_tpu_torch.models.init import dense_init_
from swarm_ode_tpu_torch.parallel import mesh as meshlib
from swarm_ode_tpu_torch.rl import coordination
from swarm_ode_tpu_torch.rl.dqn import adam_step, module_params, obs_q_values, value_and_grad
from swarm_ode_tpu_torch.rl.draws import RolloutDraws
from swarm_ode_tpu_torch.train.run_rl import (
    RLRunConfig,
    feats_of,
    global_state,
    global_state_dim,
    make_network,
    sync_guard,
)
from swarm_ode_tpu_torch.train.train_bc import evaluate_policy
from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager
from swarm_ode_tpu_torch.utils.metrics import pick_rate
from swarm_ode_tpu_torch.utils.optim import adamw_init


@dataclasses.dataclass
class MAPPOConfig:
    env_id: str = "tarware-medium-19agvs-9pickers-partialobs-v1"
    net: str = "gnn"
    hidden_dim: int = 64
    critic_hidden: int = 128
    num_envs: int = 8
    num_strides: int = 100  # each stride = num_envs full episodes
    lr: float = 3e-4
    lr_critic: float = 1e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ppo_epochs: int = 2
    minibatch: int = 128
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    coordinated: bool = True
    # Warm start: a checkpoint dir holding {'q_params': ...} from
    # train/train_bc.py (net and hidden_dim must match).
    init_from: Optional[str] = None
    # Data parallelism: split the env dimension over this many ranks, one per
    # device (0 = one device, no process group). num_envs must divide, and
    # the process group must have this many ranks.
    mesh_devices: int = 0
    seed: int = 0
    steps_override: int = 0  # 0 = the env's max_steps; short episodes for smokes
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 20  # strides
    eval_every: int = 0  # strides; 0 = off
    eval_episodes: int = 8
    device: str = "cuda"
    # Run each collection under torch.cuda.set_sync_debug_mode("error"): a
    # host synchronisation inside it raises. A check; on the card only.
    forbid_host_sync: bool = False


class ValueNet(nn.Module):
    """V(global state): (..., S) -> (...,); names as the flax tree's."""

    def __init__(self, state_dim: int, hidden: int = 128):
        super().__init__()
        self.Dense_0 = nn.Linear(state_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden)
        self.Dense_2 = nn.Linear(hidden, 1)

    def init_(self, generator: torch.Generator) -> "ValueNet":
        return dense_init_(self, generator)

    def forward(self, gs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.Dense_1(torch.relu(self.Dense_0(gs))))
        return self.Dense_2(h)[..., 0]


class MappoRun:
    """One MAPPO run's pieces on cfg.device: the env params, the actor
    (network and parameters), the critic, both Adam states, the draws and,
    with cfg.mesh_devices, the mesh (else None). `collect`, `update` and
    `eval_probe` never wait on the card; run_mappo drives them."""

    def __init__(self, cfg: MAPPOConfig, draws=None, verbose: bool = False):
        self.mesh = None
        if cfg.mesh_devices:
            if cfg.num_envs % cfg.mesh_devices:
                raise ValueError(f"num_envs={cfg.num_envs} must divide over "
                                 f"mesh_devices={cfg.mesh_devices}")
            self.mesh = meshlib.make_mesh(("dp",), device=cfg.device)
            if self.mesh.size != cfg.mesh_devices:
                raise ValueError(f"mesh_devices={cfg.mesh_devices} needs a process group of as "
                                 f"many ranks; it has {self.mesh.size}")
        dev = self.mesh.device if self.mesh else torch.device(cfg.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("run_mappo runs on the card (device='cuda') and none is "
                               "available; pass device='cpu' to run on the CPU")
        env_cfg = EnvConfig.from_env_id(cfg.env_id)
        self.cfg, self.device = cfg, dev
        self.params = p = make_params(env_cfg, build_layout(env_cfg), dev)
        self.T = cfg.steps_override or env_cfg.max_steps or 500
        self.gs_scale = 1.0 / float(max(p.grid_h, p.grid_w))
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        self.draws = draws if draws is not None else RolloutDraws(p, generator)
        self.net = make_network(RLRunConfig(net=cfg.net, hidden_dim=cfg.hidden_dim),
                                p.num_actions, coord_scale=self.gs_scale).to(dev)
        self.critic = ValueNet(global_state_dim(p), cfg.critic_hidden).to(dev)
        self.net.init_(generator)
        self.critic.init_(generator)
        self.actor_params, self.critic_params = module_params(self.net), module_params(self.critic)
        if cfg.init_from:
            restored = CheckpointManager(cfg.init_from).restore({"q_params": self.actor_params})
            if restored is None:
                raise FileNotFoundError(f"init_from={cfg.init_from}")
            self.actor_params = restored["q_params"]
            if verbose:
                print(f"[mappo] actor warm-started from {cfg.init_from}", flush=True)
        self.actor_opt = adamw_init(list(self.actor_params.values()))
        self.critic_opt = adamw_init(list(self.critic_params.values()))

    def warm_up(self) -> None:
        """One greedy act, density and env step of a throwaway env, drawn
        from a generator of its own, without the replan query: observe and
        step build small per-device constant tables with a host copy at
        their first call (see run_rl.MarlRun.warm_up). The run's draws and
        parameters are untouched."""
        p = dataclasses.replace(self.params, replan_mode="off")
        g = torch.Generator(device=self.device).manual_seed(0)
        es = step_mod.reset(p, 1, g)
        obs = observe(p, es)
        with torch.no_grad():
            logits = self.logits(self.actor_params, obs)
            masks = compute_valid_action_masks(p, es)
            a = coordination.coordinated_argmax(logits, masks, p.num_agvs, 1 + p.num_goals,
                                                active=~es.agent_busy)
            self.logp_taken(logits, masks, a, ~es.agent_busy)
            self.value(self.critic_params, global_state(feats_of(p, obs), self.gs_scale))
        step_mod.step(p, es, a, generator=g)

    def logits(self, actor_params, obs: torch.Tensor) -> torch.Tensor:
        """(B, A_total, num_actions): the actor's AGV and picker scores."""
        return obs_q_values(self.net, actor_params, self.params, obs)

    def value(self, critic_params, gs: torch.Tensor) -> torch.Tensor:
        return functional_call(self.critic, critic_params, (gs,))

    def logp_taken(self, logits, masks, actions, active):
        """(log-density of the taken actions, entropy), each (B, A): the
        claim auction's sequential density when coordinated, else the
        masked softmax's."""
        p = self.params
        if self.cfg.coordinated:
            return coordination.sequential_log_prob(logits, masks, actions, p.num_agvs,
                                                    1 + p.num_goals, active=active)
        lp = coordination.log_softmax(torch.where(masks > 0, logits, -1e9))
        return lp.gather(-1, actions.long()[..., None])[..., 0], coordination.entropy_of(lp)

    def share(self, tree):
        """This rank's envs of a tree drawn for all B (the tree itself on
        one device)."""
        return meshlib.shard_batch(self.mesh, tree) if self.mesh else tree

    def gather(self, traj: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole (T, B, ...) stride from every rank's (T, B/n, ...)
        share, on every rank (the share itself on one device)."""
        return meshlib.all_gather(self.mesh, traj, dim=1) if self.mesh else traj

    @torch.no_grad()
    def collect(self, draws=None) -> Dict[str, torch.Tensor]:
        """One stride: B fresh episodes of T steps under the current actor
        (this rank's B/n with a mesh; the draws are made for all B).
        Returns the (T, B, ...) trajectory on the device: obs, gs, actions,
        logp, active, reward (the team mean), deliv, overflow (the replan
        query's), adv and ret (GAE)."""
        cfg, p, draws = self.cfg, self.params, draws or self.draws
        B, T = cfg.num_envs, self.T
        es = self.share(draws.reset(B))
        obs = observe(p, es)
        keys = ("obs", "gs", "actions", "logp", "active", "reward", "deliv", "overflow")
        traj = {k: [] for k in keys}
        for _ in range(T):
            logits = self.logits(self.actor_params, obs)
            masks = compute_valid_action_masks(p, es)
            active = ~es.agent_busy
            gumbel = self.share(draws.gumbel(B))
            if cfg.coordinated:
                a = coordination.coordinated_sample(logits, masks, p.num_agvs, 1 + p.num_goals,
                                                    gumbel, active=active)
            else:
                a = (gumbel + torch.where(masks > 0, logits, -1e9)).argmax(-1).to(torch.int32)
            lp, _ = self.logp_taken(logits, masks, a, active)
            es2, rew, _, info = step_mod.step(p, es, a, noise=self.share(draws.step(B)))
            gs = global_state(feats_of(p, obs), self.gs_scale)
            for k, v in zip(keys, (obs, gs, a, lp, active, rew.mean(-1),
                                   info["shelf_deliveries"], info["replan_overflow"])):
                traj[k].append(v)
            es, obs = es2, observe(p, es2)
        traj = {k: torch.stack(v) for k, v in traj.items()}
        v_last = self.value(self.critic_params, global_state(feats_of(p, obs), self.gs_scale))
        v = self.value(self.critic_params, traj["gs"])  # (T, B)
        # GAE over time; episodes are fixed length, so the only bootstrap is
        # at the stride's end (is_last).
        advs = []
        adv_next, v_next = torch.zeros_like(v_last), v_last
        for t in reversed(range(T)):
            not_last = 0.0 if t == T - 1 else 1.0
            delta = traj["reward"][t] + cfg.gamma * v_next * not_last - v[t]
            adv_next = delta + cfg.gamma * cfg.gae_lambda * adv_next * not_last
            v_next = v[t]
            advs.append(adv_next)
        traj["adv"] = torch.stack(advs[::-1])
        traj["ret"] = traj["adv"] + v
        return traj

    def loss(self, ap, cp, data, adv, idx):
        """The PPO loss of the minibatch `idx` of the flattened stride:
        (total, (pg, v_loss, entropy))."""
        cfg = self.cfg
        obs_b, act_b = data["obs"][idx], data["actions"][idx]
        f = feats_of(self.params, obs_b)
        masks = masks_from_feats(self.params, f["agv"], f["picker"], f["loc"])
        lp_new, ent = self.logp_taken(self.logits(ap, obs_b), masks, act_b, data["active"][idx])
        # The shared team advantage broadcast to every agent's ratio.
        ratio = torch.exp(lp_new - data["logp"][idx])
        adv_b = adv[idx][:, None]
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_b
        pg = -torch.minimum(ratio * adv_b, clipped).mean()
        v_loss = ((self.value(cp, data["gs"][idx]) - data["ret"][idx]) ** 2).mean()
        ent_mean = ent.mean()
        total = pg + cfg.value_coef * v_loss - cfg.entropy_coef * ent_mean
        return total, (pg, v_loss, ent_mean)

    def minibatch_step(self, data, adv, idx):
        """One gradient step of both networks on the minibatch `idx` (the
        actor's and the critic's parameters and Adam states advance).
        Returns (pg, v_loss, entropy)."""
        cfg = self.cfg
        _, aux, (ag, cg) = value_and_grad(lambda a, c: self.loss(a, c, data, adv, idx),
                                          self.actor_params, self.critic_params, has_aux=True)
        self.actor_params, self.actor_opt = adam_step(self.actor_params, ag, self.actor_opt,
                                                      cfg.lr, cfg.max_grad_norm)
        self.critic_params, self.critic_opt = adam_step(self.critic_params, cg,
                                                        self.critic_opt, cfg.lr_critic,
                                                        cfg.max_grad_norm)
        return aux

    def update(self, traj: Dict[str, torch.Tensor], perms: Optional[Sequence[torch.Tensor]] = None,
               draws=None) -> Dict[str, torch.Tensor]:
        """ppo_epochs epochs of shuffled minibatches over the stride. perms:
        each epoch's permutation of range(N) (default drawn); each is cut to
        the whole minibatches. Returns the means of pg_loss, v_loss and
        entropy, on the device."""
        cfg, draws = self.cfg, draws or self.draws
        N = traj["reward"].shape[0] * traj["reward"].shape[1]
        MB = cfg.minibatch
        n_mb = N // MB
        data = {k: v.flatten(0, 1) for k, v in traj.items() if k not in ("deliv", "overflow")}
        adv = data["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        epochs = []
        for e in range(cfg.ppo_epochs):
            perm = perms[e] if perms is not None else draws.permutation(N)
            perm = perm.to(self.device)[: n_mb * MB].reshape(n_mb, MB)
            auxes = [self.minibatch_step(data, adv, idx) for idx in perm]
            epochs.append(torch.stack([torch.stack(a) for a in auxes]).mean(dim=0))
        m = torch.stack(epochs).mean(dim=0)
        return {"pg_loss": m[0], "v_loss": m[1], "entropy": m[2]}

    def eval_probe(self, draws):
        """Greedy rollouts of eval_episodes fresh envs for T steps
        (train_bc.evaluate_policy, through the claim auction when
        coordinated): (mean return, mean deliveries) per env."""
        res = evaluate_policy(self.params, self.net, self.actor_params, self.cfg.eval_episodes,
                              draws, coordinated=self.cfg.coordinated, verbose=False,
                              steps=self.T)
        return res["return"], res["deliveries"]


def run_mappo(cfg: MAPPOConfig, verbose: bool = True, logger=None, draws=None,
              run: Optional[MappoRun] = None) -> Dict:
    """Train MAPPO for cfg.num_strides strides (one collection and one update
    each). draws: the random draws (default RolloutDraws from a generator
    seeded with cfg.seed); run: a MappoRun of cfg to continue (default a
    fresh one). Returns {'actor_params', 'critic_params', 'history'}; each
    stride's stats add to JAX's the seconds of its collection and of its
    update and the replan query's overflow. With a mesh every rank returns
    the same; rank 0 logs, prints and writes the checkpoints."""
    run = run if run is not None else MappoRun(cfg, draws, verbose)
    B, T = cfg.num_envs, run.T
    ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    guard = cfg.forbid_host_sync and run.device.type == "cuda"
    if guard:
        run.warm_up()
    lead = run.mesh is None or run.mesh.rank == 0
    history = []
    for stride in range(cfg.num_strides):
        t0 = time.time()
        with sync_guard(guard):
            traj = run.collect()
        traj = run.gather(traj)
        deliv, overflow = (float(v) for v in torch.stack(
            [traj["deliv"].sum().float(), traj["overflow"].sum().float()]).cpu())
        deliv /= B
        t1 = time.time()
        aux = run.update(traj)
        stats = {
            "stride": stride,
            "episode": stride * B,
            "pick_rate": pick_rate(deliv, T),
            "deliveries": deliv,
            "return": float(traj["reward"].sum()) / B,
            "pg_loss": float(aux["pg_loss"]),
            "v_loss": float(aux["v_loss"]),
            "entropy": float(aux["entropy"]),
            "seconds": time.time() - t0,
            "collect_seconds": t1 - t0,
            "update_seconds": time.time() - t1,
            "replan_overflow": int(overflow),
        }
        if cfg.eval_every and (stride + 1) % cfg.eval_every == 0:
            er, ed = run.eval_probe(run.draws.split())
            stats["eval_pick_rate"] = pick_rate(ed, T)
            stats["eval_return"] = er
        history.append(stats)
        if logger and lead:
            logger.log(stats, step=stride)
        if verbose and lead:
            msg = (f"[mappo] stride {stride} (ep {stats['episode']}): "
                   f"pick_rate={stats['pick_rate']:.2f} return={stats['return']:.2f} "
                   f"pg={stats['pg_loss']:.4f} v={stats['v_loss']:.4f} "
                   f"H={stats['entropy']:.3f} [{stats['seconds']:.1f}s]")
            if "eval_pick_rate" in stats:
                msg += f" | eval={stats['eval_pick_rate']:.2f}"
            print(msg, flush=True)
        if ckpt and lead and (stride + 1) % cfg.checkpoint_every == 0:
            ckpt.save(stride, {"q_params": run.actor_params, "critic": run.critic_params},
                      force=True)
    return {"actor_params": run.actor_params, "critic_params": run.critic_params,
            "history": history}
