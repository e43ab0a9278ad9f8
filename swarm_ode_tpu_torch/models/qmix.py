"""QMIX mixing networks.

Counterpart of `swarm_ode_tpu/models/qmix.py`:
  * `QMixer` :15, the hypernetwork mixer with |W| monotonicity and an ELU
    hidden layer (reference graph.py:146-183);
  * `HeteroQMIXMixer` :37, the state-encoder variant QMIXAgent uses
    (reference run_gnode.py:934-1009), with the JAX module's E-wide
    `hyper_w2a/b` in place of the reference's scalar-then-reshape.
Layer names are the flax tree's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from swarm_ode_tpu_torch.models.init import dense_init_


class QMixer(nn.Module):
    """Q_tot = w2(s)^T elu(W1(s) q + b1(s)) + b2(s), weights through abs."""

    def __init__(self, num_agents: int, state_dim: int, mixing_embed_dim: int = 32):
        super().__init__()
        E, N = mixing_embed_dim, num_agents
        self.num_agents, self.embed = N, E
        self.hyper_w1 = nn.Linear(state_dim, E * N)
        self.hyper_b1 = nn.Linear(state_dim, E)
        self.hyper_w2 = nn.Linear(state_dim, E)
        self.hyper_b2 = nn.Linear(state_dim, 1)

    def init_(self, generator: torch.Generator) -> "QMixer":
        return dense_init_(self, generator)

    def forward(self, agent_qs: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
        """agent_qs (B, N), states (B, state_dim) -> (B, 1)."""
        B = agent_qs.shape[0]
        E, N = self.embed, self.num_agents
        w1 = self.hyper_w1(states).abs().reshape(B, N, E)
        b1 = self.hyper_b1(states).reshape(B, 1, E)
        hidden = F.elu(torch.einsum("bn,bne->be", agent_qs, w1)[:, None, :] + b1)
        w2 = self.hyper_w2(states).abs().reshape(B, E, 1)
        b2 = self.hyper_b2(states).reshape(B, 1, 1)
        return (torch.einsum("bie,bej->bij", hidden, w2) + b2).reshape(B, 1)


class HeteroQMIXMixer(nn.Module):
    """Encode the global state, then a two-layer monotonic mix of the taken
    Q-values (reference run_gnode.py:950-1009)."""

    def __init__(self, num_agents: int, state_dim: int, mixing_embed_dim: int = 32,
                 hypernet_embed: int = 64):
        super().__init__()
        E, H = mixing_embed_dim, hypernet_embed
        self.num_agents, self.embed = num_agents, E
        self.state_enc1 = nn.Linear(state_dim, H)
        self.state_enc2 = nn.Linear(H, H)
        self.hyper_w1 = nn.Linear(H, E * num_agents)
        self.hyper_b1 = nn.Linear(H, E)
        self.hyper_w2a = nn.Linear(H, E)
        self.hyper_w2b = nn.Linear(E, E)
        self.hyper_b2a = nn.Linear(H, E)
        self.hyper_b2b = nn.Linear(E, 1)

    def init_(self, generator: torch.Generator) -> "HeteroQMIXMixer":
        return dense_init_(self, generator)

    def forward(self, all_q_taken: torch.Tensor, global_state: torch.Tensor) -> torch.Tensor:
        """all_q_taken (B, N), global_state (B, S) -> (B,)."""
        B, N = all_q_taken.shape
        E = self.embed
        s = self.state_enc2(torch.relu(self.state_enc1(global_state)))
        w1 = torch.relu(self.hyper_w1(s)).abs()[:, :N * E].reshape(B, E, N)
        b1 = self.hyper_b1(s)
        hidden = F.elu(torch.einsum("ben,bn->be", w1, all_q_taken) + b1)
        w2 = self.hyper_w2b(torch.relu(self.hyper_w2a(s))).abs()  # (B, E)
        b2 = self.hyper_b2b(torch.relu(self.hyper_b2a(s)))  # (B, 1)
        return ((hidden * w2).sum(-1, keepdim=True) + b2).squeeze(-1)
