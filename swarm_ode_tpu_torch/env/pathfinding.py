"""Dynamic path planning around other agents, batched over envs.

Counterpart of `swarm_ode_tpu/env/pathfinding.py`. Replaces the reference's
`find_path(..., care_for_agents=True)` calls (warehouse.py:469 clash replan,
:502 stuck replan): on unit-cost grids BFS equals A*, and only the distance
and next hop at each agent's own cell are ever read.

`replan_query` has two branches, picked by `EnvParams.bfs_backend`:
  * "xla": the full field (`dynamic_fields`, K3 on the card), read at the
    own cell by `dist_nextdir_at`; every row runs, overflow is 0;
  * "auto" / "pallas": the compacted batched query
    (ops/bfs_pallas.bfs_query_occ_batched, K1 or K2 on the card), which
    runs only the rows the step consumes.
The tensors' device decides between the CUDA kernels and their plain
versions.
"""
from __future__ import annotations

import torch

from swarm_ode_tpu_torch.env.state import EnvParams
from swarm_ode_tpu_torch.ops.bfs_bitpack import bitpack_query_call
from swarm_ode_tpu_torch.ops.bfs_pallas import (
    INF,
    bfs_dist_call,
    bfs_query_occ_batched,
    query_call,
    select_next_hop,
)

INF32 = INF

# The replan query each `EnvParams.bfs_kernel` value runs: K1 or K2.
QUERIES = {"bitpack32": bitpack_query_call, "int32": query_call}


def walled(grid: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H*(W+1)): append a False wall column to every row."""
    wall = torch.zeros(*grid.shape[:-1], 1, dtype=grid.dtype, device=grid.device)
    out = torch.cat([grid, wall], dim=-1)
    return out.reshape(*grid.shape[:-2], -1)


def passable_grid(params: EnvParams, occupied, targets_yx, self_yx, classes):
    """(B, A, H, W) bool passable masks for per-agent replanning: the
    class's base grid (free, or highway-only for pickers) minus occupied
    cells, with the target and own cell freed, mirroring find_path's grid
    edits (warehouse.py:285,:303). (The JAX function also returns the
    target masks, which only its XLA relaxation reads.)

    occupied: (B, H, W) bool; targets_yx, self_yx: (B, A, 2) int32 (y, x);
    classes: (A,) int32 0 = free grid, 1 = picker."""
    H, W = params.grid_h, params.grid_w
    dev = occupied.device
    base = torch.stack([torch.ones(H, W, dtype=torch.bool, device=dev), params.picker_passable])
    pas = base[classes.long()][None] & ~occupied[:, None]  # (B, A, H, W)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]

    def at(yx):
        return (ys == yx[..., 0, None, None]) & (xs == yx[..., 1, None, None])

    return pas | at(targets_yx) | at(self_yx)


def dynamic_fields(params: EnvParams, occupied, targets_yx, self_yx, classes):
    """Per-agent BFS distance fields with agents as obstacles (K3 on the
    card). Mirrors find_path(care_for_agents=True) (warehouse.py:280-303):
    both agent layers are obstacles, the target and own cell are free, and
    pickers keep their highway-only restriction.

    Returns (dist, pas): (B, A, H, W) int32 (INF unreached) and bool."""
    pas = passable_grid(params, occupied, targets_yx, self_yx, classes)
    B, A, H, W = pas.shape
    tgt_flat = (targets_yx[..., 0] * W + targets_yx[..., 1]).to(torch.int32)
    dist = bfs_dist_call(pas.reshape(B * A, H, W), tgt_flat.reshape(B * A),
                         params.dynamic_bfs_iters)
    return dist.view(B, A, H, W), pas


def dist_nextdir_at(params: EnvParams, dist, pas, at_yx):
    """Distance and next-hop direction at one cell per agent: (B, A) int32
    each. dist, pas: (B, A, H, W) from dynamic_fields; at_yx: (B, A, 2)
    (y, x). Neighbours off the grid are unreached and impassable; the rule
    is `select_next_hop`'s (UP, DOWN, LEFT, RIGHT, first strict minimum;
    step-off from a blocked cell)."""
    B, A, H, W = dist.shape
    d_flat = dist.reshape(B, A, H * W)
    p_flat = pas.reshape(B, A, H * W)
    yq, xq = at_yx[..., 0], at_yx[..., 1]
    ds, oks = [], []
    for dy, dx in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        ny, nx = yq + dy, xq + dx
        in_b = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
        cell = (ny.clamp(0, H - 1) * W + nx.clamp(0, W - 1)).long()[..., None]
        ds.append(torch.where(in_b, d_flat.gather(2, cell)[..., 0], INF))
        oks.append(in_b & p_flat.gather(2, cell)[..., 0])
    return select_next_hop(ds, oks)


def replan_query(params: EnvParams, occupied, targets_yx, self_yx, classes, need=None):
    """Distance to target and next hop at each agent's own cell, with all
    agents as obstacles. Returns (d, nd, overflow).

    occupied: (B, H, W) bool; targets_yx, self_yx: (B, A, 2) int32 (y, x);
    classes: (A,) int32; need: (B, A) bool marks the rows the step consumes
    (None = all). With bfs_backend "xla" every row runs on the full field
    and overflow is 0. Otherwise rows outside the compacted set return
    (INF, -1), and overflow (B,) counts needed rows beyond the budget
    (replan_row_frac)."""
    W = params.grid_w
    Ws = W + 1
    B, A = targets_yx.shape[:2]
    if params.bfs_backend == "xla":
        dist, pas = dynamic_fields(params, occupied, targets_yx, self_yx, classes)
        d, nd = dist_nextdir_at(params, dist, pas, self_yx)
        return d, nd, torch.zeros(B, dtype=torch.int32, device=occupied.device)
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
