"""Dynamic path planning around other agents, batched over envs.

Counterpart of `swarm_ode_tpu/env/pathfinding.py::replan_query`. Replaces
the reference's `find_path(..., care_for_agents=True)` calls
(warehouse.py:469 clash replan, :502 stuck replan): on unit-cost grids BFS
equals A*, and only the distance and next hop at each agent's own cell are
ever read, so the query returns just those.

The port always goes through the compacted batched query
(ops/bfs_pallas.bfs_query_occ_batched); the tensors' device decides between
the CUDA kernels and their plain versions.
"""
from __future__ import annotations

import torch

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.ops.bfs_bitpack import bitpack_query_call
from swarm_ode_tpu_torch.ops.bfs_pallas import INF, bfs_query_occ_batched, query_call

INF32 = INF

# The replan query each `EnvParams.bfs_kernel` value runs: K1 or K2.
QUERIES = {"bitpack32": bitpack_query_call, "int32": query_call}


def walled(grid: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H*(W+1)): append a False wall column to every row."""
    wall = torch.zeros(*grid.shape[:-1], 1, dtype=grid.dtype, device=grid.device)
    out = torch.cat([grid, wall], dim=-1)
    return out.reshape(*grid.shape[:-2], -1)


def replan_query(params: EnvParams, occupied, targets_yx, self_yx, classes, need=None):
    """Distance to target and next hop at each agent's own cell, with all
    agents as obstacles. Returns (d, nd, overflow).

    occupied: (B, H, W) bool; targets_yx, self_yx: (B, A, 2) int32 (y, x);
    classes: (A,) int32; need: (B, A) bool marks the rows the step consumes
    (None = all). Rows outside the compacted set return (INF, -1); overflow
    (B,) counts needed rows beyond the budget (replan_row_frac)."""
    W = params.grid_w
    Ws = W + 1
    B, A = targets_yx.shape[:2]
    if need is None:
        need = torch.ones(B, A, dtype=torch.bool, device=occupied.device)
    tgt_w = targets_yx[..., 0] * Ws + targets_yx[..., 1]
    pos_w = self_yx[..., 0] * Ws + self_yx[..., 1]
    return bfs_query_occ_batched(
        walled(occupied), tgt_w, pos_w, classes, need, walled(params.picker_passable),
        params.grid_h, W, params.dynamic_bfs_iters,
        row_frac=params.replan_row_frac, rows_per_block=128,
        query=QUERIES[params.bfs_kernel],
    )
