"""Occupancy queries: "which entity occupies cell c?".

Frozen copy, for the benchmark's reference, of the program's `env/queries.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

Counterpart of `swarm_ode_tpu/env/queries.py`. The JAX package answers each
query with an equality-mask reduction over all entities (scatter-free for the
TPU). Here each layer is one (B, H*W) id grid built by a scatter with "amax"
(highest id wins, the JAX package's convention), and a query is a gather
from it. Query cells must lie on the grid.
"""
from __future__ import annotations

import torch


def id_flags(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) bool: id k+1 occurs in the (B, M) 1-based `ids` (0 = none)."""
    flags = torch.zeros(ids.shape[0], n + 1, dtype=torch.bool, device=ids.device)
    return flags.scatter(1, ids.long(), True)[:, 1:]


def cell_max(xy: torch.Tensor, values: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W) int32: the largest of `values` (B, N) over the entities at each
    cell, 0 where there is none. xy: (B, N, 2) (x, y); values >= 0."""
    B = xy.shape[0]
    cell = (xy[..., 1] * W + xy[..., 0]).long()
    out = torch.zeros(B, H * W, dtype=torch.int32, device=xy.device)
    return out.scatter_reduce(1, cell, values.to(torch.int32), "amax")


def occupant_grid(xy: torch.Tensor, mask: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W) highest 1-based id of a masked entity at each cell (0 = none).
    mask: (N,) or (B, N) bool."""
    B, N = xy.shape[:2]
    ids = torch.arange(1, N + 1, dtype=torch.int32, device=xy.device)
    vals = torch.where(mask, ids, torch.zeros_like(ids)).expand(B, N)
    return cell_max(xy, vals, H, W)


def grid_lookup(grid: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor, W: int) -> torch.Tensor:
    """grid (B, H*W) at the (B, Q) query cells."""
    return torch.gather(grid, 1, (qy * W + qx).long())

