"""COMA: counterfactual multi-agent policy gradient, over B samples.

Counterpart of `swarm_ode_tpu/rl/coma.py` (COMAConfig :28, COMAState :59,
COMAAgent :68: init :86, act :115, update :154; reference COMAAgent,
gru.py:407-511). The critic is trained on mean-Q TD targets; each agent's
policy gradient uses the counterfactual advantage (models/coma.py) or, as
an option, the reference's simplified A_i = Q_i - mean(Q). The graph
encoder trains with the actors' optimizer, as in JAX.

Three properties of the JAX update are kept on purpose:
  * the critic's target reads the critic at the next state with the SAME
    taken actions (`next_q = critic(old params, next_gs, actions)`), and
    its mean over agents;
  * the critic updates first, and the baseline and the advantage's Q then
    use the critic's old parameters, the state's, not the updated ones;
  * the entropy coefficient anneals as entropy_coef * entropy_decay**step,
    with step a float32.
Coordinated COMA samples through the claim auction and scores the taken
actions under `sequential_log_prob`, its exact density, with menus rebuilt
by `masks_from_feats` and busy flags from the features.

Like rl/dqn.IQLAgent the agent is functional: parameters are name ->
tensor dicts (`encoder.`, `agv.`, `picker.` for the actors; `Dense_k.` for
the critic) run through `torch.func.functional_call`, and `update` returns
a new state. optax's adam is utils/optim's `adamw_update` with no decay.
`act` takes its Gumbels in (jax.random.categorical and coordinated_sample
are both Gumbel-max over (A, num_actions) draws of the agent's key).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn
from torch.func import functional_call

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.graphs.hetero import HeteroGraph
from swarm_ode_tpu_torch.models.coma import COMAActor, COMACritic, counterfactual_q, softmax
from swarm_ode_tpu_torch.models.init import dense_init_
from swarm_ode_tpu_torch.rl import coordination
from swarm_ode_tpu_torch.rl.dqn import (
    adam_step,
    graph_from_feats,
    masks_of,
    module_params,
    value_and_grad,
)
from swarm_ode_tpu_torch.utils.optim import AdamWState, adamw_init


@dataclasses.dataclass
class COMAConfig:
    lr_actor: float = 1e-3
    lr_critic: float = 1e-3
    gamma: float = 0.99
    # The full counterfactual baseline; False = the reference's simplified
    # advantage Q_i - mean(Q).
    use_counterfactual: bool = True
    actor_hidden: int = 64
    critic_hidden: int = 128
    entropy_coef: float = 0.01  # entropy bonus on the masked policy
    entropy_decay: float = 1.0  # coef_t = entropy_coef * entropy_decay**step
    coordinated: bool = False  # claim-auction sampling, scored by sequential_log_prob


@dataclasses.dataclass
class COMAState:
    actor_params: Dict[str, torch.Tensor]  # encoder.*, agv.*, picker.*
    critic_params: Dict[str, torch.Tensor]
    actor_opt: AdamWState
    critic_opt: AdamWState
    step: torch.Tensor  # () int32

    def tree(self) -> dict:
        """The state as a nested dict (checkpoints)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


class COMAActors(nn.Module):
    """The graph encoder and the two actor heads: graph -> (B, A_total,
    action_size) logits, the AGVs' then the pickers'."""

    def __init__(self, encoder: nn.Module, hidden_dim: int, action_size: int,
                 actor_hidden: int = 64):
        super().__init__()
        self.encoder = encoder
        self.agv = COMAActor(hidden_dim, action_size, actor_hidden)
        self.picker = COMAActor(hidden_dim, action_size, actor_hidden)

    def forward(self, g: HeteroGraph) -> torch.Tensor:
        h_agv, h_pick, _ = self.encoder(g)
        return torch.cat([self.agv(h_agv), self.picker(h_pick)], dim=-2)


class COMAAgent:
    def __init__(self, encoder: nn.Module, env_params: EnvParams, action_size: int,
                 global_state_dim: int, hidden_dim: int = 64,
                 config: COMAConfig = COMAConfig()):
        """encoder: a module graph -> (agv_h, picker_h, loc_h) of width
        hidden_dim, on the device the agent runs on."""
        dev = next(encoder.parameters()).device
        self.env_params = env_params
        self.action_size = action_size
        self.global_state_dim = global_state_dim
        self.cfg = config
        self.actors = COMAActors(encoder, hidden_dim, action_size, config.actor_hidden).to(dev)
        self.critic = COMACritic(global_state_dim, env_params.num_agents, action_size,
                                 config.critic_hidden).to(dev)

    def init(self, generator: torch.Generator) -> COMAState:
        """Fresh parameters drawn as flax initialises them: the encoder, the
        AGV actor, the picker actor, the critic."""
        for m in (self.actors.encoder, self.actors.agv, self.actors.picker, self.critic):
            dense_init_(m, generator)
        actor_params, critic_params = module_params(self.actors), module_params(self.critic)
        dev = next(iter(critic_params.values())).device
        return COMAState(actor_params=actor_params, critic_params=critic_params,
                         actor_opt=adamw_init(list(actor_params.values())),
                         critic_opt=adamw_init(list(critic_params.values())),
                         step=torch.zeros((), dtype=torch.int32, device=dev))

    def logits(self, actor_params, graph: HeteroGraph) -> torch.Tensor:
        return functional_call(self.actors, actor_params, (graph,))

    def q(self, critic_params, global_state, actions) -> torch.Tensor:
        return functional_call(self.critic, critic_params, (global_state, actions))

    @torch.no_grad()
    def act(self, state: COMAState, graph: HeteroGraph, masks: torch.Tensor,
            gumbel: Optional[torch.Tensor], training: bool = True, active=None) -> torch.Tensor:
        """(B, A) int32: sampled from the masked policy with the standard
        Gumbels `gumbel` (B, A, n), or its argmax when not training or
        without draws (reference gru.py:420-430); through the claim auction
        with cfg.coordinated."""
        logits = self.logits(state.actor_params, graph)
        sample = training and gumbel is not None
        if self.cfg.coordinated:
            ep = self.env_params
            if sample:
                return coordination.coordinated_sample(logits, masks, ep.num_agvs,
                                                       1 + ep.num_goals, gumbel, active=active)
            return coordination.coordinated_argmax(logits, masks, ep.num_agvs, 1 + ep.num_goals,
                                                   active=active)
        logits = torch.where(masks > 0, logits, -1e9)
        if sample:
            logits = gumbel + logits
        return logits.argmax(dim=-1).to(torch.int32)

    def critic_grads(self, state: COMAState, batch: Dict):
        """The critic's TD loss on mean-Q targets, its gradient and its Q at
        the taken actions under the state's (old) parameters (reference
        gru.py:447-458): (loss, cur_q (B, A) detached, grads by name)."""
        cfg, gs, actions = self.cfg, batch["global_state"], batch["actions"]
        with torch.no_grad():
            next_q = self.q(state.critic_params, batch["next_global_state"], actions)
            td = batch["rewards"] + cfg.gamma * next_q.mean(1) * (
                1.0 - batch["dones"].to(torch.float32))

        def critic_loss(cp):
            cur = self.q(cp, gs, actions)
            return ((cur.mean(1) - td) ** 2).mean(), cur

        closs, cur_q, (cgrads,) = value_and_grad(critic_loss, state.critic_params, has_aux=True)
        return closs, cur_q, cgrads

    def advantage(self, state: COMAState, batch: Dict, cur_q: torch.Tensor) -> torch.Tensor:
        """(B, A) advantages of the taken actions under the state's (old)
        critic: counterfactual, or Q_i - mean(Q) (reference
        gru.py:360-404, 481-497)."""
        cfg, ep = self.cfg, self.env_params
        gs, actions, feats = batch["global_state"], batch["actions"], batch["obs_feats"]
        if cfg.use_counterfactual:
            # A_i = Q(s, u) - sum_a pi_i(a) Q(s, (u_-i, a)) under the old
            # critic; the independent softmax is a valid baseline under the
            # auction too (it never depends on agent i's taken action).
            with torch.no_grad():
                logits = self.logits(state.actor_params, graph_from_feats(ep, feats))
                probs = softmax(torch.where(masks_of(ep, feats) > 0, logits, -1e9))  # (B, A, n)
                baseline = torch.stack([
                    (probs[:, i, :].T * counterfactual_q(self.critic, state.critic_params, gs,
                                                         actions, i)).sum(dim=0)
                    for i in range(ep.num_agents)], dim=1)
            return cur_q - baseline
        return cur_q - cur_q.mean(dim=1, keepdim=True)

    def actor_grads(self, state: COMAState, batch: Dict, adv: torch.Tensor):
        """The actors' policy-gradient loss with the entropy bonus, and its
        gradient, at the advantages `adv` (reference gru.py:460-506):
        (loss, grads by name)."""
        cfg, ep = self.cfg, self.env_params
        actions, feats = batch["actions"], batch["obs_feats"]
        graph, masks = graph_from_feats(ep, feats), masks_of(ep, feats)
        ent_coef = cfg.entropy_coef * torch.pow(
            torch.tensor(cfg.entropy_decay, dtype=torch.float32, device=adv.device),
            state.step.to(torch.float32))

        def actor_loss(ap):
            logits = self.logits(ap, graph)
            if cfg.coordinated:
                taken, entropy = coordination.sequential_log_prob(
                    logits, masks, actions, ep.num_agvs, 1 + ep.num_goals,
                    active=~coordination.busy_from_feats(feats["agv"], feats["picker"]))
            else:
                logp = coordination.log_softmax(torch.where(masks > 0, logits, -1e9))
                taken = logp.gather(-1, actions.long()[..., None])[..., 0]
                entropy = coordination.entropy_of(logp)
            return (-(taken * adv).sum(-1) - ent_coef * entropy.sum(-1)).mean()

        aloss, _, (agrads,) = value_and_grad(actor_loss, state.actor_params)
        return aloss, agrads

    def update_with_grads(self, state: COMAState, batch: Dict):
        """One critic and one actor step. batch: obs_feats ({'agv', 'picker',
        'loc'} of (B, ...)), global_state (B, S), actions (B, A), rewards
        (B,), next_global_state (B, S), dones (B,). Returns (new state,
        {'critic_loss', 'actor_loss'}, {'critic': grads, 'actor': grads})
        (reference gru.py:432-511). The critic steps first; the advantages
        read its old parameters."""
        cfg = self.cfg
        closs, cur_q, cgrads = self.critic_grads(state, batch)
        critic_params, critic_opt = adam_step(state.critic_params, cgrads, state.critic_opt,
                                              cfg.lr_critic)
        aloss, agrads = self.actor_grads(state, batch, self.advantage(state, batch, cur_q))
        actor_params, actor_opt = adam_step(state.actor_params, agrads, state.actor_opt,
                                            cfg.lr_actor)
        new = COMAState(actor_params=actor_params, critic_params=critic_params,
                        actor_opt=actor_opt, critic_opt=critic_opt, step=state.step + 1)
        return new, {"critic_loss": closs, "actor_loss": aloss}, {"critic": cgrads,
                                                                   "actor": agrads}

    def update(self, state: COMAState, batch: Dict):
        new, aux, _ = self.update_with_grads(state, batch)
        return new, aux
