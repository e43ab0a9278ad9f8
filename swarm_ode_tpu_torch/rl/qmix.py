"""QMIX: monotonic value decomposition over graph Q-networks.

Counterpart of `swarm_ode_tpu/rl/qmix.py` (QMIXConfig :29, h_transform :70,
h_inverse :74, QMIXAgent :91; reference QMIXAgent, run_gnode.py:718-932):
a double-DQN target (argmax by the online network over the valid next
actions, or through the claim auction when `coordinated`, evaluated by the
target network), the hypernetwork mixer over the taken Q-values, optional
R2D2 value rescaling, TD clamping and Huber loss, the gradient clipped to
global norm 10.0, and Polyak or hard target sync. Functional like
rl/dqn.IQLAgent: parameters are one name -> tensor dict, `q.<name>` for the
Q-network and `mixer.<name>` for the mixer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.graphs.hetero import HeteroGraph
from swarm_ode_tpu_torch.models.qmix import HeteroQMIXMixer
from swarm_ode_tpu_torch.rl import coordination
from swarm_ode_tpu_torch.rl.dqn import (
    ActNoise,
    DQNState,
    epsilon_greedy,
    fresh_state,
    grads_and_update,
    graph_from_feats,
    masks_of,
    module_params,
    q_values,
)

QMIXState = DQNState


@dataclasses.dataclass
class QMIXConfig:
    # The reference learning_config (run_gnode.py:1328): lr 1e-4, gamma
    # 0.999, epsilon decay 0.999 to 0.1.
    lr: float = 1e-4
    gamma: float = 0.999
    epsilon_start: float = 1.0
    epsilon_decay: float = 0.999
    epsilon_min: float = 0.1
    grad_clip: float = 10.0
    batch_size: int = 32
    update_target_freq: int = 200
    target_tau: float = 0.0  # Polyak rate; 0 = hard sync every update_target_freq
    mixing_embed_dim: int = 32
    hypernet_embed: int = 64
    value_transform: bool = False  # R2D2's h-transform of the targets
    td_clip: float = 0.0  # raw-space clamp of bootstrap and target; 0 = off
    huber_delta: float = 0.0  # Huber TD loss; 0 = mean squared error
    coordinated: bool = False  # claim auction in act and in the target argmax


_H_EPS = 1e-2


def h_transform(x):
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + _H_EPS * x


def h_inverse(y):
    """Closed-form inverse of h (R2D2, Pohlen et al. 2018 eq. 2)."""
    s, a = torch.sign(y), y.abs()
    num = torch.sqrt(1.0 + 4.0 * _H_EPS * (a + 1.0 + _H_EPS)) - 1.0
    return s * ((num / (2.0 * _H_EPS)) ** 2 - 1.0)


def huber_loss(predictions, targets, delta: float):
    """optax.losses.huber_loss."""
    abs_errors = (predictions - targets).abs()
    quadratic = torch.clamp(abs_errors, max=delta)
    linear = abs_errors - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def _sub(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


class QMIXAgent:
    def __init__(self, network: nn.Module, env_params: EnvParams, global_state_dim: int,
                 config: QMIXConfig = QMIXConfig()):
        self.net = network
        self.env_params = env_params
        self.cfg = config
        self.global_state_dim = global_state_dim
        dev = next(network.parameters()).device
        self.mixer = HeteroQMIXMixer(env_params.num_agents, global_state_dim,
                                     config.mixing_embed_dim, config.hypernet_embed).to(dev)

    def init(self, generator: torch.Generator) -> QMIXState:
        """Fresh parameters drawn as flax initialises them (network first)."""
        self.net.init_(generator)
        self.mixer.init_(generator)
        params = {**{f"q.{k}": v for k, v in module_params(self.net).items()},
                  **{f"mixer.{k}": v for k, v in module_params(self.mixer).items()}}
        return fresh_state(params, self.cfg.epsilon_start)

    def q_values(self, params, graph: HeteroGraph) -> torch.Tensor:
        """Q-values of the Q-network part of `params` (the `q.` names)."""
        return q_values(self.net, _sub(params, "q"), graph)

    def mix(self, params, q_taken, global_state) -> torch.Tensor:
        return functional_call(self.mixer, _sub(params, "mixer"), (q_taken, global_state))

    @torch.no_grad()
    def act(self, state: QMIXState, graph: HeteroGraph, masks: torch.Tensor,
            noise: Optional[ActNoise], training: bool = True, active=None) -> torch.Tensor:
        q = self.q_values(state.params, graph)
        return epsilon_greedy(q, masks, state.epsilon, noise, self.env_params,
                              self.cfg.coordinated, active, training)

    def loss(self, params, target_params, batch: Dict) -> torch.Tensor:
        """batch: obs_feats / next_feats, global_state / next_global_state
        (B, S), actions (B, A), reward (B,) team, done (B,), gamma_eff (B,)."""
        cfg, ep = self.cfg, self.env_params
        g = graph_from_feats(ep, batch["obs_feats"])
        q = self.q_values(params, g)
        q_taken = q.gather(-1, batch["actions"].long()[..., None])[..., 0]  # (B, A)
        q_tot = self.mix(params, q_taken, batch["global_state"])  # (B,)
        with torch.no_grad():
            # Double DQN restricted to valid actions (run_gnode.py:869-883).
            nf = batch["next_feats"]
            gn = graph_from_feats(ep, nf)
            masks = masks_of(ep, nf)
            q_online = torch.where(masks > 0, self.q_values(params, gn), -1e9)
            if cfg.coordinated:
                # The same auction as act(): busy agents (targets read from
                # the features) select but never claim.
                a_star = coordination.coordinated_argmax(
                    q_online, masks, ep.num_agvs, 1 + ep.num_goals,
                    active=~coordination.busy_from_feats(nf["agv"], nf["picker"]))
            else:
                a_star = q_online.argmax(dim=-1)
            q_tgt = self.q_values(target_params, gn)
            next_q = q_tgt.gather(-1, a_star.long()[..., None])[..., 0]
            next_tot = self.mix(target_params, next_q, batch["next_global_state"])
            gamma_eff = batch.get("gamma_eff", cfg.gamma)
            not_done = 1.0 - batch["done"].to(torch.float32)
            boot = h_inverse(next_tot) if cfg.value_transform else next_tot
            if cfg.td_clip > 0:
                boot = torch.clamp(boot, -cfg.td_clip, cfg.td_clip)
            raw_target = batch["reward"] + gamma_eff * boot * not_done
            if cfg.td_clip > 0:
                raw_target = torch.clamp(raw_target, -cfg.td_clip, cfg.td_clip)
            target = h_transform(raw_target) if cfg.value_transform else raw_target
        if cfg.huber_delta > 0:
            return huber_loss(q_tot, target, cfg.huber_delta).mean()
        return ((q_tot - target) ** 2).mean()

    def learn_with_grads(self, state: QMIXState, batch: Dict):
        """One gradient step: (new state, {'loss', 'epsilon'}, grads by name)."""
        cfg = self.cfg
        loss, grads, params, opt_state = grads_and_update(
            lambda p: self.loss(p, state.target_params, batch), state.params,
            state.opt_state, cfg.grad_clip, cfg.lr)
        step = state.step + 1
        if cfg.target_tau > 0:
            tau = cfg.target_tau
            target_params = {k: (1.0 - tau) * t + tau * params[k]
                             for k, t in state.target_params.items()}
        else:
            sync = (step % cfg.update_target_freq) == 0
            target_params = {k: torch.where(sync, params[k], t)
                             for k, t in state.target_params.items()}
        epsilon = torch.clamp(state.epsilon * cfg.epsilon_decay, min=cfg.epsilon_min)
        new = QMIXState(params=params, target_params=target_params, opt_state=opt_state,
                        epsilon=epsilon, step=step)
        return new, {"loss": loss, "epsilon": epsilon}, grads

    def learn(self, state: QMIXState, batch: Dict):
        new, aux, _ = self.learn_with_grads(state, batch)
        return new, aux
