"""Small-table lookups as plain gathers.

Frozen copy, for the benchmark's reference, of the program's `ops/take.py`
(plain PyTorch and numpy; it imports nothing of the program). What
follows is the original's description.

Counterpart of `swarm_ode_tpu/ops/take.py`. The JAX package writes these as
one-hot masked reductions because gathers over small tables were slow on the
TPU; on the GPU a gather is the cheap form, so each helper is one
`gather` or one indexing op.
"""
from __future__ import annotations

import torch


def take_ids(arr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`arr[b, ids[b, m]]` for batched rows: arr (B, N), ids (B, M) -> (B, M)."""
    return torch.gather(arr, 1, ids.long())


def grid_at(table: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`table[y, x]` for one shared (H, W) table at query points of any shape."""
    W = table.shape[1]
    return table.reshape(-1)[(y * W + x).long()]


def take_many(ids: torch.Tensor, *arrays: torch.Tensor):
    """take_ids for several (B, N) tables sharing the same (B, M) ids."""
    idx = ids.long()
    return tuple(torch.gather(arr, 1, idx) for arr in arrays)
