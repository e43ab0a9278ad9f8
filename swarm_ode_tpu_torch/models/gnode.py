"""Heterogeneous graph neural ODE Q-network, over B graphs.

Counterpart of `swarm_ode_tpu/models/gnode.py` (ODEFunction :20, CommRound
:34, HeteroGraphODENetwork :60; reference run_gnode.py:67-167): the
heterogeneous encoder, a neural ODE per agent type (a time-independent MLP
vector field integrated by ops/odeint.py, euler over [0, integration_time]
by default), an optional attention round over all agents, and per-type Q
heads. Location nodes have no dynamics. Submodule names are the JAX
parameter tree's keys (`encoder`, `ode_agv`, `ode_picker`, `agv_head`,
`picker_head`, `comm`).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from swarm_ode_tpu_torch.graphs.hetero import HeteroGraph
from swarm_ode_tpu_torch.models.hetero_gnn import HeteroGNNEncoder, QHead
from swarm_ode_tpu_torch.models.init import dense_init_
from swarm_ode_tpu_torch.ops.odeint import odeint


class ODEFunction(nn.Module):
    """dx/dt = MLP(x): hidden -> ode_hidden -> ode_hidden -> hidden with tanh
    (reference run_gnode.py:153-167)."""

    def __init__(self, hidden_dim: int, ode_hidden_dim: int = 32):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_dim, ode_hidden_dim)
        self.Dense_1 = nn.Linear(ode_hidden_dim, ode_hidden_dim)
        self.Dense_2 = nn.Linear(ode_hidden_dim, hidden_dim)

    def forward(self, t, x):
        h = torch.tanh(self.Dense_0(x))
        h = torch.tanh(self.Dense_1(h))
        return self.Dense_2(h)


class CommRound(nn.Module):
    """One message round over all agents (AGVs and pickers): single-head
    scaled dot-product attention with a residual connection (no reference
    counterpart; see the JAX module)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_dim, hidden_dim)  # query
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim)  # key
        self.Dense_2 = nn.Linear(hidden_dim, hidden_dim)  # value
        self.Dense_3 = nn.Linear(hidden_dim, hidden_dim)
        self.register_buffer("scale", torch.tensor(math.sqrt(hidden_dim), dtype=torch.float32),
                             persistent=False)

    def forward(self, h_all: torch.Tensor) -> torch.Tensor:  # (B, A, h)
        q, k, v = self.Dense_0(h_all), self.Dense_1(h_all), self.Dense_2(h_all)
        att = torch.softmax((q @ k.transpose(-1, -2)) / self.scale, dim=-1)
        return h_all + self.Dense_3(att @ v)


class HeteroGraphODENetwork(nn.Module):
    """Encoder + per-type ODE + Q heads (reference run_gnode.py:67-151);
    comm=True inserts one CommRound between the ODE and the heads."""

    def __init__(self, action_size: int, hidden_dim: int = 64, num_layers: int = 2,
                 ode_hidden_dim: int = 32, solver: str = "euler", coord_scale: float = 1.0,
                 comm: bool = False, integration_time: float = 1.0):
        super().__init__()
        self.action_size = action_size
        self.solver = solver
        self.use_comm = comm
        self.encoder = HeteroGNNEncoder(hidden_dim, num_layers, coord_scale)
        self.ode_agv = ODEFunction(hidden_dim, ode_hidden_dim)
        self.ode_picker = ODEFunction(hidden_dim, ode_hidden_dim)
        self.agv_head = QHead(hidden_dim, action_size)
        self.picker_head = QHead(hidden_dim, action_size)
        if comm:
            self.comm = CommRound(hidden_dim)
        # The time span lives on the module's device: building it per call
        # would copy from the host every forward.
        self.register_buffer("t_span", torch.tensor([0.0, integration_time]), persistent=False)

    def init_(self, generator: torch.Generator) -> "HeteroGraphODENetwork":
        return dense_init_(self, generator)

    def forward(self, g: HeteroGraph) -> Dict[str, torch.Tensor]:
        h_agv, h_pick, h_loc = self.encoder(g)
        evolved_agv = odeint(self.ode_agv, h_agv, self.t_span, method=self.solver)[-1]
        evolved_pick = odeint(self.ode_picker, h_pick, self.t_span, method=self.solver)[-1]
        if self.use_comm:
            n_agv = evolved_agv.shape[-2]
            h_all = self.comm(torch.cat([evolved_agv, evolved_pick], dim=-2))
            evolved_agv, evolved_pick = h_all[..., :n_agv, :], h_all[..., n_agv:, :]
        return {
            "agv_q_values": self.agv_head(evolved_agv),
            "picker_q_values": self.picker_head(evolved_pick),
            "agv_embeddings": evolved_agv,
            "picker_embeddings": evolved_pick,
            "location_embeddings": h_loc,
        }
