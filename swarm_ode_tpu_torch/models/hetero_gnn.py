"""Heterogeneous GNN encoder and the ODE-free Q-network, over B graphs.

Counterpart of `swarm_ode_tpu/models/hetero_gnn.py` (HeteroConvBlock :20,
HeteroGNNEncoder :55, QHead :93, HeteroGNNNetwork :105): per-type linear
embeddings, then `num_layers` HeteroConv blocks of six SAGEConv relations
with mean aggregation per destination type, ReLU after each block
(reference run_gnode.py:80-96, graph.py:74-143). Aggregation is the dense
masked mean of ops/sage.py, a batched matrix product, as in JAX (no kernel
of K1-K4 runs here). Module names follow the flax tree (`agv_embedding`,
`conv0.agv_targets_loc.lin_l`, `agv_head.Dense_0`, ...), so
`convert.qnet_params_from_numpy` carries flax parameters over as transposes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from swarm_ode_tpu_torch.graphs.hetero import AGV_FEATS, LOC_FEATS, PICKER_FEATS, HeteroGraph
from swarm_ode_tpu_torch.models.init import dense_init_
from swarm_ode_tpu_torch.ops.sage import DenseSAGEConv


class HeteroConvBlock(nn.Module):
    """One HeteroConv({six relations}, aggr='mean') layer (reference
    run_gnode.py:87-96)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        d = hidden_dim
        self.agv_targets_loc = DenseSAGEConv(d, d)
        self.loc_targeted_agv = DenseSAGEConv(d, d)
        self.agv_comm_agv = DenseSAGEConv(d, d)
        self.pick_manages_loc = DenseSAGEConv(d, d)
        self.agv_coop_pick = DenseSAGEConv(d, d)
        self.pick_helps_agv = DenseSAGEConv(d, d)
        # Per-destination means over relations divide by tensors: a CUDA
        # division by a Python scalar is a product with its reciprocal.
        self.register_buffer("three", torch.tensor(3.0), persistent=False)
        self.register_buffer("two", torch.tensor(2.0), persistent=False)

    def forward(self, h_agv, h_pick, h_loc, g: HeteroGraph):
        to_loc_from_agv = self.agv_targets_loc(h_agv, h_loc, g.agv2loc)
        to_agv_from_loc = self.loc_targeted_agv(h_loc, h_agv, g.loc2agv)
        to_agv_from_agv = self.agv_comm_agv(h_agv, h_agv, g.agv2agv)
        to_loc_from_pick = self.pick_manages_loc(h_pick, h_loc, g.pick2loc)
        to_pick_from_agv = self.agv_coop_pick(h_agv, h_pick, g.agv2pick)
        to_agv_from_pick = self.pick_helps_agv(h_pick, h_agv, g.pick2agv)
        new_agv = (to_agv_from_loc + to_agv_from_agv + to_agv_from_pick) / self.three
        new_loc = (to_loc_from_agv + to_loc_from_pick) / self.two
        return new_agv, to_pick_from_agv, new_loc


class HeteroGNNEncoder(nn.Module):
    """Type embeddings + stacked HeteroConv blocks with ReLU. `coord_scale`
    scales the raw grid coordinates (AGV columns 3:7, picker columns 0:4)
    before the embeddings, as the JAX encoder does."""

    def __init__(self, hidden_dim: int = 64, num_layers: int = 2, coord_scale: float = 1.0):
        super().__init__()
        self.coord_scale = coord_scale
        self.agv_embedding = nn.Linear(AGV_FEATS, hidden_dim)
        self.picker_embedding = nn.Linear(PICKER_FEATS, hidden_dim)
        self.location_embedding = nn.Linear(LOC_FEATS, hidden_dim)
        for i in range(num_layers):
            self.add_module(f"conv{i}", HeteroConvBlock(hidden_dim))
        self.num_layers = num_layers
        self.register_buffer(
            "agv_scale", torch.tensor([1.0, 1.0, 1.0] + [coord_scale] * 4), persistent=False)
        self.register_buffer("picker_scale", torch.tensor(coord_scale), persistent=False)

    def forward(self, g: HeteroGraph) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        agv_x, picker_x = g.agv_x, g.picker_x
        if self.coord_scale != 1.0:
            agv_x = agv_x * self.agv_scale
            picker_x = picker_x * self.picker_scale
        h_agv = self.agv_embedding(agv_x)
        h_pick = self.picker_embedding(picker_x)
        h_loc = self.location_embedding(g.loc_x)
        for i in range(self.num_layers):
            h_agv, h_pick, h_loc = getattr(self, f"conv{i}")(h_agv, h_pick, h_loc, g)
            h_agv, h_pick, h_loc = torch.relu(h_agv), torch.relu(h_pick), torch.relu(h_loc)
        return h_agv, h_pick, h_loc


class QHead(nn.Module):
    """hidden -> hidden//2 -> action_size (reference run_gnode.py:103-113)."""

    def __init__(self, hidden_dim: int, action_size: int):
        super().__init__()
        self.Dense_0 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.Dense_1 = nn.Linear(hidden_dim // 2, action_size)

    def forward(self, h):
        return self.Dense_1(torch.relu(self.Dense_0(h)))


class HeteroGNNNetwork(nn.Module):
    """ODE-free ablation: encoder -> Q heads (reference graph.py:74-143)."""

    def __init__(self, action_size: int, hidden_dim: int = 64, num_layers: int = 2,
                 coord_scale: float = 1.0):
        super().__init__()
        self.encoder = HeteroGNNEncoder(hidden_dim, num_layers, coord_scale)
        self.agv_head = QHead(hidden_dim, action_size)
        self.picker_head = QHead(hidden_dim, action_size)

    def init_(self, generator: torch.Generator) -> "HeteroGNNNetwork":
        return dense_init_(self, generator)

    def forward(self, g: HeteroGraph) -> Dict[str, torch.Tensor]:
        h_agv, h_pick, h_loc = self.encoder(g)
        return {
            "agv_q_values": self.agv_head(h_agv),
            "picker_q_values": self.picker_head(h_pick),
            "agv_embeddings": h_agv,
            "picker_embeddings": h_pick,
            "location_embeddings": h_loc,
        }
