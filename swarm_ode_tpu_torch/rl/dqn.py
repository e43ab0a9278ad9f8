"""Independent Q-learning (IQL) over heterogeneous graph Q-networks.

Counterpart of `swarm_ode_tpu/rl/dqn.py` (DQNConfig, DQNState, IQLAgent:
act :91, learn :118, sync_target :189; reference SimpleIndependentDQN,
run_gnode.py:529-716): masked epsilon-greedy selection, per-agent TD
targets split by agent type, a target network, the gradient clipped to
global norm 1.0, epsilon decayed per learn call. A batch of B envs or
sampled transitions is one pass of the network over (B, ...) graphs.

The agent is functional like the JAX one: its state holds the parameters
as a name -> tensor dict that `torch.func.functional_call` runs the network
with, and `learn` returns a new state. optax's chain(clip_by_global_norm,
adam) is utils/optim's `clip_by_global_norm` and `adamw_update` with no
weight decay. The random draws of `act` are an `ActNoise`, from a
generator or passed in (the tests give JAX's own).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.env.step import draw_gumbel
from swarm_ode_tpu_torch.graphs.hetero import (
    HeteroGraph,
    build_hetero_graph,
    hetero_graph_from_obs,
    masks_from_feats,
)
from swarm_ode_tpu_torch.rl import coordination
from swarm_ode_tpu_torch.utils.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm


@dataclasses.dataclass
class DQNConfig:
    lr: float = 1e-3
    gamma: float = 0.99
    epsilon_start: float = 1.0
    epsilon_decay: float = 0.995
    epsilon_min: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 32
    # The claim auction (rl/coordination.py) for the behaviour policy only:
    # IQL's per-agent TD target stays an independent max.
    coordinated: bool = False


@dataclasses.dataclass
class DQNState:
    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: AdamWState
    epsilon: torch.Tensor  # () float32
    step: torch.Tensor  # () int32

    def replace(self, **changes) -> "DQNState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ActNoise:
    """The draws of one act call over B envs, in JAX's split order of the
    agent's key (k1, k2 = split(key)).

    explore_u: (B, A) uniforms; an agent explores where one is below
      epsilon (k2 independent, k1 coordinated).
    row: (B, A, n): Gumbels whose argmax over the valid actions is the
      random action (jax.random.categorical, k1; independent), or the
      uniform bids of exploring agents (k2; coordinated).
    """

    explore_u: torch.Tensor
    row: torch.Tensor


def draw_act_noise(B: int, A: int, n: int, coordinated: bool, generator: torch.Generator,
                   device) -> ActNoise:
    explore_u = torch.rand((B, A), generator=generator, device=device)
    if coordinated:
        row = torch.rand((B, A, n), generator=generator, device=device)
    else:
        row = draw_gumbel((B, A, n), generator, device)
    return ActNoise(explore_u, row)


def epsilon_greedy(q, masks, epsilon, noise: Optional[ActNoise], env_params: EnvParams,
                   coordinated: bool, active=None, training: bool = True) -> torch.Tensor:
    """(B, A) int32 masked epsilon-greedy actions (reference
    run_gnode.py:572-612), or the claim auction's when `coordinated`.
    Without `noise` (or not training) the choice is greedy."""
    rack_start = 1 + env_params.num_goals
    if noise is None:
        training = False
    if coordinated:
        if not training:
            return coordination.coordinated_argmax(q, masks, env_params.num_agvs, rack_start,
                                                   active)
        return coordination.coordinated_epsilon_greedy(
            q, masks, env_params.num_agvs, rack_start, epsilon, noise.explore_u, noise.row,
            active=active)
    greedy = torch.where(masks > 0, q, -torch.inf).argmax(dim=-1).to(torch.int32)
    if not training:
        return greedy
    # jax.random.categorical over logits 0 (valid) / -1e9: argmax of Gumbels
    # plus the logits.
    logits = torch.where(masks > 0, 0.0, -1e9)
    random_actions = (noise.row + logits).argmax(dim=-1).to(torch.int32)
    return torch.where(noise.explore_u < epsilon, random_actions, greedy)


def q_values(net: nn.Module, params: Dict[str, torch.Tensor], graph: HeteroGraph,
             extras=None) -> torch.Tensor:
    """(B, A_total, action_size): the AGVs' then the pickers' Q-values.
    `extras`: a recurrent network's hidden states (agv (B, A, H), picker
    (B, P, H)), passed after the graph."""
    return q_values_and_hidden(net, params, graph, extras)[0]


def q_values_and_hidden(net: nn.Module, params: Dict[str, torch.Tensor], graph: HeteroGraph,
                        extras=None):
    """(q_values, the network's new hidden states (agv, picker), or None for
    a network without)."""
    out = functional_call(net, params, (graph,) if extras is None else (graph, *extras))
    q = torch.cat([out["agv_q_values"], out["picker_q_values"]], dim=-2)
    return q, (out["agv_hidden"], out["picker_hidden"]) if "agv_hidden" in out else None


def obs_q_values(net: nn.Module, params: Dict[str, torch.Tensor], env_params: EnvParams,
                 obs: torch.Tensor) -> torch.Tensor:
    """q_values over observations (B, A_total, obs_len): the network's AGV
    and picker scores on their hetero graphs."""
    return q_values(net, params, hetero_graph_from_obs(env_params, obs))


def graph_from_feats(env_params: EnvParams, feats) -> HeteroGraph:
    return build_hetero_graph(env_params, feats["agv"], feats["picker"], feats["loc"])


def masks_of(env_params: EnvParams, feats) -> torch.Tensor:
    return masks_from_feats(env_params, feats["agv"], feats["picker"], feats["loc"])


def module_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of the module's parameters, by name."""
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def fresh_state(params: Dict[str, torch.Tensor], epsilon_start: float) -> DQNState:
    """An agent state at step 0: target = online, Adam's moments zero."""
    dev = next(iter(params.values())).device
    return DQNState(
        params=params, target_params=params, opt_state=adamw_init(list(params.values())),
        epsilon=torch.tensor(epsilon_start, dtype=torch.float32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def value_and_grad(loss_fn, *param_dicts, has_aux: bool = False):
    """jax.value_and_grad of loss_fn(*param_dicts) with respect to every
    dict of parameters: (loss, aux (None without has_aux; a tensor or a
    tuple of tensors, detached), [grads by name, one dict per argument]).
    The dicts are left as they were. Parameters the loss does not reach get
    zero gradients, as in JAX."""
    leaves = [[v.detach().requires_grad_(True) for v in d.values()] for d in param_dicts]
    with torch.enable_grad():
        out = loss_fn(*(dict(zip(d, lv)) for d, lv in zip(param_dicts, leaves)))
        loss, aux = out if has_aux else (out, None)
        flat = [v for lv in leaves for v in lv]
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, flat)]
    if isinstance(aux, torch.Tensor):
        aux = aux.detach()
    elif isinstance(aux, tuple):
        aux = tuple(a.detach() for a in aux)
    out_grads = []
    for d in param_dicts:
        out_grads.append(dict(zip(d, grads[:len(d)])))
        grads = grads[len(d):]
    return loss.detach(), aux, out_grads


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              opt_state: AdamWState, lr: float, grad_clip: Optional[float] = None):
    """optax's adam(lr), after clip_by_global_norm(grad_clip) when a clip is
    given: (new params by name, new optimizer state). `params` is left as
    it was."""
    g = [grads[k] for k in params]
    if grad_clip is not None:
        g = clip_by_global_norm(g, grad_clip)
    new = [v.detach().clone() for v in params.values()]
    opt_state = adamw_update(new, g, opt_state, lr, 0.0)
    return dict(zip(params, new)), opt_state


def grads_and_update(loss_fn, params: Dict[str, torch.Tensor], opt_state: AdamWState,
                     grad_clip: float, lr: float):
    """value_and_grad of loss_fn(params) then optax's chain(clip_by_global_norm,
    adam): (loss, grads by name, new params, new optimizer state). `params`
    is left as it was."""
    loss, _, (grads,) = value_and_grad(loss_fn, params)
    new, opt_state = adam_step(params, grads, opt_state, lr, grad_clip)
    return loss, grads, new, opt_state


class IQLAgent:
    """Functional IQL agent; `network` maps a HeteroGraph to
    {'agv_q_values', 'picker_q_values', ...} and holds the buffers the
    forward needs (on the device it runs on)."""

    def __init__(self, network: nn.Module, env_params: EnvParams,
                 config: DQNConfig = DQNConfig()):
        self.net = network
        self.env_params = env_params
        self.cfg = config

    def init(self, generator: torch.Generator) -> DQNState:
        """Fresh parameters drawn as flax initialises them."""
        self.net.init_(generator)
        return fresh_state(module_params(self.net), self.cfg.epsilon_start)

    def q_values(self, params, graph: HeteroGraph, extras=None) -> torch.Tensor:
        """`extras`: the recurrent state of a GRU network (reference
        gru.py:513-706 stores the hidden states beside the transitions)."""
        return q_values(self.net, params, graph, extras)

    @torch.no_grad()
    def act(self, state: DQNState, graph: HeteroGraph, masks: torch.Tensor,
            noise: Optional[ActNoise], training: bool = True, active=None,
            extras=None) -> torch.Tensor:
        """Masked epsilon-greedy over B envs (reference run_gnode.py:572-612)."""
        return self.act_and_hidden(state, graph, masks, noise, training, active, extras)[0]

    @torch.no_grad()
    def act_and_hidden(self, state: DQNState, graph: HeteroGraph, masks: torch.Tensor,
                       noise: Optional[ActNoise], training: bool = True, active=None,
                       extras=None):
        """(act's actions, the network's new hidden states from the same
        forward pass; None for a network without)."""
        q, hidden = q_values_and_hidden(self.net, state.params, graph, extras)
        return epsilon_greedy(q, masks, state.epsilon, noise, self.env_params,
                              self.cfg.coordinated, active, training), hidden

    def loss(self, params, target_params, batch: Dict) -> torch.Tensor:
        """Mean TD loss of a batch: obs_feats / next_feats ({'agv', 'picker',
        'loc'} of (B, ...)), actions and rewards (B, A), dones (B,) and
        gamma_eff (B,), gamma**m for an m-step return; for a GRU network
        also extras / next_extras, the hidden states (agv, picker) the
        online and the target network start from."""
        cfg, A = self.cfg, self.env_params.num_agvs
        g = graph_from_feats(self.env_params, batch["obs_feats"])
        q = self.q_values(params, g, batch.get("extras"))
        with torch.no_grad():
            gn = graph_from_feats(self.env_params, batch["next_feats"])
            qn = self.q_values(target_params, gn, batch.get("next_extras"))
            # The bootstrap max runs over valid next actions only.
            qn = torch.where(masks_of(self.env_params, batch["next_feats"]) > 0, qn, -1e9)
            B = batch["actions"].shape[0]
            gamma_eff = batch.get("gamma_eff")
            if gamma_eff is None:
                gamma_eff = torch.full((B,), cfg.gamma, device=q.device)
            done = batch["dones"].to(torch.float32)
            target = (batch["rewards"]
                      + gamma_eff[:, None] * qn.max(dim=-1).values * (1.0 - done[:, None]))
        q_taken = q.gather(-1, batch["actions"].long()[..., None])[..., 0]
        err = (q_taken - target) ** 2
        # Separate AGV and picker losses, summed (run_gnode.py:638-674).
        per = err.mean(-1) if self.env_params.num_pickers == 0 else (
            err[:, :A].mean(-1) + err[:, A:].mean(-1))
        return per.mean()

    def learn_with_grads(self, state: DQNState, batch: Dict):
        """One gradient step: (new state, {'loss', 'epsilon'}, grads by name)."""
        cfg = self.cfg
        loss, grads, params, opt_state = grads_and_update(
            lambda p: self.loss(p, state.target_params, batch), state.params,
            state.opt_state, cfg.grad_clip, cfg.lr)
        epsilon = torch.clamp(state.epsilon * cfg.epsilon_decay, min=cfg.epsilon_min)
        new = DQNState(params=params, target_params=state.target_params, opt_state=opt_state,
                       epsilon=epsilon, step=state.step + 1)
        return new, {"loss": loss, "epsilon": epsilon}, grads

    def learn(self, state: DQNState, batch: Dict):
        new, aux, _ = self.learn_with_grads(state, batch)
        return new, aux

    def sync_target(self, state: DQNState) -> DQNState:
        """Copy online -> target (reference run_gnode.py:564-566)."""
        return state.replace(target_params=state.params)
