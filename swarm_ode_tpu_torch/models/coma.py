"""COMA actors, centralised critic and counterfactual advantage, over B samples.

Counterpart of `swarm_ode_tpu/models/coma.py` (COMAActor :15,
masked_action_probs :29, COMACritic :37, counterfactual_advantage :58;
reference gru.py:182-404). Module names follow the flax trees (`Dense_0`,
...), so `convert.flax_params_to_state_dict` carries them over. JAX's
counterfactual sweep is a `vmap` over the actions; here it is one critic
call over the (action_dim x B) counterfactual rows.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.func import functional_call

from swarm_ode_tpu_torch.models.init import dense_init_


class COMAActor(nn.Module):
    """embedding -> hidden -> hidden -> action logits (reference
    gru.py:182-203)."""

    def __init__(self, in_features: int, action_dim: int, hidden_dim: int = 64):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, action_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(torch.relu(self.Dense_1(torch.relu(self.Dense_0(obs)))))


def softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's form: exp(x - max) / sum, the max outside the
    gradient."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values.detach())
    return e / e.sum(dim=-1, keepdim=True)


def masked_action_probs(logits: torch.Tensor,
                        action_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax with invalid actions at -1e9 (reference gru.py:205-213)."""
    if action_mask is not None:
        logits = torch.where(action_mask > 0, logits, -1e9)
    return softmax(logits)


class COMACritic(nn.Module):
    """Centralised critic: (global state, every agent's one-hot action) ->
    per-agent Q (reference gru.py:224-266)."""

    def __init__(self, state_dim: int, n_agents: int, action_dim: int, hidden_dim: int = 128):
        super().__init__()
        self.action_dim = action_dim
        self.Dense_0 = nn.Linear(state_dim + n_agents * action_dim, hidden_dim)
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_2 = nn.Linear(hidden_dim, hidden_dim)
        self.Dense_3 = nn.Linear(hidden_dim, n_agents)

    def init_(self, generator: torch.Generator) -> "COMACritic":
        return dense_init_(self, generator)

    def forward(self, global_state: torch.Tensor, all_actions: torch.Tensor) -> torch.Tensor:
        """global_state (B, S), all_actions (B, N) int -> (B, N)."""
        onehot = nn.functional.one_hot(all_actions.long(), self.action_dim).to(global_state.dtype)
        h = torch.cat([global_state, onehot.reshape(all_actions.shape[0], -1)], dim=-1)
        h = torch.relu(self.Dense_0(h))
        h = torch.relu(self.Dense_1(h))
        h = torch.relu(self.Dense_2(h))
        return self.Dense_3(h)


def counterfactual_q(critic: COMACritic, critic_params, global_state: torch.Tensor,
                     all_actions: torch.Tensor, agent_idx: int) -> torch.Tensor:
    """(action_dim, B): agent `agent_idx`'s Q with its action swept over
    every action and the others' kept, in one critic call over the
    (action_dim x B) rows."""
    n, B = critic.action_dim, all_actions.shape[0]
    cf = all_actions.repeat(n, 1)
    cf[:, agent_idx] = torch.arange(n, dtype=all_actions.dtype,
                                    device=all_actions.device).repeat_interleave(B)
    q = functional_call(critic, critic_params, (global_state.repeat(n, 1), cf))
    return q[:, agent_idx].reshape(n, B)


def counterfactual_advantage(critic: COMACritic, critic_params, global_state: torch.Tensor,
                             all_actions: torch.Tensor, action_probs: torch.Tensor,
                             agent_idx: int) -> torch.Tensor:
    """COMA's counterfactual advantage of one agent (reference
    gru.py:360-404): A_i = Q(s, u) - sum_a pi_i(a) Q(s, (u_-i, a)).
    action_probs (B, action_dim) are agent i's; returns (B,)."""
    current_q = functional_call(critic, critic_params, (global_state, all_actions))[:, agent_idx]
    cf_q = counterfactual_q(critic, critic_params, global_state, all_actions, agent_idx)
    return current_q - (action_probs.T * cf_q).sum(dim=0)
