"""Graph Neural ODE for trajectory prediction (reference train_gde.py:20-106).

Counterpart of `swarm_ode_tpu/models/gde.py`. `GraphODEFunc`
(three SAGE layers) and the position decoder are `nn.Module`s whose
parameter names follow the flax tree (`func.conv1.DenseSAGEConv_0.lin_l`,
`decoder.position_decoder`, ...), so `convert.gde_params_from_numpy` carries
trained flax parameters over as a list of transposes.

`GraphODE` keeps the JAX model's interface: `apply` on dense graphs (it
shadows `nn.Module.apply(fn)`), `apply_batched` on the structured batch
(differentiable on the structured path, which training takes; calling the
model runs it), and `predict_trajectory`. Unlike the JAX class it holds its
own parameters, which `init_` draws as flax initialises them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from swarm_ode_tpu_torch.graphs.temporal import BatchedTemporalGraph, TemporalGraph
from swarm_ode_tpu_torch.models.init import dense_init_
from swarm_ode_tpu_torch.ops.odeint import odeint
from swarm_ode_tpu_torch.ops.sage import HomoSAGE, edge_mean_aggregate, temporal_mean_aggregate
from swarm_ode_tpu_torch.ops.segment_pallas import segment_plan


class GraphODEFunc(nn.Module):
    """dx/dt = SAGE(node->hidden) -> ReLU -> SAGE -> ReLU -> SAGE(->node)
    (reference train_gde.py:20-45)."""

    def __init__(self, node_dim: int, hidden_dim: int = 64):
        super().__init__()
        self.conv1 = HomoSAGE(node_dim, hidden_dim)
        self.conv2 = HomoSAGE(hidden_dim, hidden_dim)
        self.conv3 = HomoSAGE(hidden_dim, node_dim)

    def forward(self, t, x, adj, node_mask=None):
        h = torch.relu(self.conv1(x, adj, node_mask))
        h = torch.relu(self.conv2(h, adj, node_mask))
        return self.conv3(h, adj, node_mask)


class _Decoder(nn.Module):
    def __init__(self, node_dim: int):
        super().__init__()
        self.position_decoder = nn.Linear(node_dim, 2)

    def forward(self, h):
        return self.position_decoder(h)


class GraphODE(nn.Module):
    """odeint(GraphODEFunc) + linear position decoder (reference
    train_gde.py:47-106)."""

    def __init__(self, node_dim: int, num_agvs: int = 0, num_pickers: int = 0,
                 hidden_dim: int = 64, ode_solver: str = "euler", rtol: float = 1e-3,
                 atol: float = 1e-4):
        super().__init__()
        self.node_dim = node_dim
        self.num_agvs = num_agvs
        self.num_pickers = num_pickers
        self.ode_solver = ode_solver
        self.rtol = rtol
        self.atol = atol
        self.func = GraphODEFunc(node_dim, hidden_dim)
        self.decoder = _Decoder(node_dim)

    def init_(self, generator: torch.Generator) -> "GraphODE":
        """Draws every parameter as flax initialises it
        (models/init.dense_init_). Returns the model."""
        return dense_init_(self, generator)

    def _solve(self, f, x, time_span, method):
        return odeint(f, x, time_span, method=method or self.ode_solver,
                      rtol=self.rtol, atol=self.atol)

    def apply(self, graph: TemporalGraph, time_span, method: Optional[str] = None
              ) -> Dict[str, torch.Tensor]:
        """Dense graphs (B, W*N, ...) -> trajectories (T, B, W*N, 2) and node
        features (T, B, W*N, D)."""
        def f(t, y):
            return self.func(t, y, graph.adj, graph.node_mask)

        sol = self._solve(f, graph.x, time_span, method)
        return {"trajectories": self.decoder(sol), "node_features": sol}

    def apply_batched(self, graph: BatchedTemporalGraph, time_span,
                      method: Optional[str] = None, edges=None) -> Dict[str, torch.Tensor]:
        """Structured batch (B, W, N, D) -> trajectories (T, B, W, N, 2) and
        node features (T, B, W, N, D): the same math as `apply` on each
        window's dense graph. Aggregation runs on the structured form, or,
        given `edges` from graphs/temporal.temporal_edges(graph), on that
        edge list through K4 (the serving path). The graph is fixed over
        the solve, so the edges are planned once (destination order, the
        sources as rows; the in-degrees are the plan's offsets), and each
        aggregation is one K4 launch."""
        if edges is None:
            def aggregate(h):
                return temporal_mean_aggregate(h, graph.spatial, graph.frame_valid)
        else:
            B, W, N, _ = graph.x.shape
            src, dst, valid = edges
            plan = segment_plan(dst, valid, B * W * N, rows=src, num_rows=B * W * N)

            def aggregate(h):
                return edge_mean_aggregate(h, edges, plan)

        def f(t, y):
            h = y
            for conv, act in ((self.func.conv1, True), (self.func.conv2, True),
                              (self.func.conv3, False)):
                h = conv.DenseSAGEConv_0.combine(aggregate(h), h)
                if act:
                    h = torch.relu(h)
            return h

        sol = self._solve(f, graph.x, time_span, method)
        return {"trajectories": self.decoder(sol), "node_features": sol}

    def forward(self, graph: BatchedTemporalGraph, time_span, method: Optional[str] = None,
                edges=None) -> Dict[str, torch.Tensor]:
        """Calling the model is `apply_batched` (so torch.func.functional_call
        runs it with other parameters)."""
        return self.apply_batched(graph, time_span, method, edges)

    def predict_trajectory(self, graph: TemporalGraph, num_steps: int) -> torch.Tensor:
        t = torch.arange(0, num_steps + 1, dtype=torch.float32, device=graph.x.device)
        return self.apply(graph, t)["trajectories"]
