"""Dynamic path planning around other agents: the replan query at each
agent's own cell, over every row in plain PyTorch.

A frozen copy of the program's `env/pathfinding.replan_query` on its default
branch (the compacted query, `bfs_backend` "auto" with the bit-packed row),
with the compaction's meaning spelled out: a row the step does not mark as
needed reads (INF, -1), a needed row its BFS answer. That is what the
program's compacted query gives an env whose rows all lie past the first K
rows of the batch (`bfs.compaction_rows`), when no needed row overflows the
budget: its needed rows run first and its other rows never run. An env
flagged in `params.every_row` has every row answered: what the compacted
query gives an env near the batch's start, whose rows all fall among the
first K once the batch's needed rows leave room for them (the K chosen rows
are the needed rows, then the other rows in batch order).
"""
from __future__ import annotations

import torch

from .bfs import INF, _passable_rows, bitpack_query_plain, walled_rows
from .state import EnvParams

INF32 = INF


def replan_query(params: EnvParams, occupied, targets_yx, self_yx, classes, need=None):
    """(d, nd, overflow): distance to target and next hop at each agent's
    own cell, with all agents as obstacles; (INF, -1) where `need` is False
    outside the `params.every_row` envs;
    overflow (B,) zeros. occupied: (B, H, W) bool; targets_yx, self_yx:
    (B, A, 2) int32 (y, x); classes: (A,) int32; need: (B, A) bool."""
    if params.bfs_backend not in ("auto", "pallas") or params.bfs_kernel != "bitpack32":
        raise ValueError("the reference answers the default replan query only")
    H, W = params.grid_h, params.grid_w
    Ws = W + 1
    B, A = targets_yx.shape[:2]
    dev = occupied.device
    if need is None:
        need = torch.ones(B, A, dtype=torch.bool, device=dev)
    if params.every_row is not None:
        need = need | params.every_row.to(dev)[:, None]
    tgt = (targets_yx[..., 0] * Ws + targets_yx[..., 1]).reshape(B * A).to(torch.int32)
    pos = (self_yx[..., 0] * Ws + self_yx[..., 1]).reshape(B * A).to(torch.int32)
    rows = need.reshape(B * A).nonzero()[:, 0]
    env = (rows // A).to(torch.int32)
    cls = classes.to(torch.int32)[rows % A]
    tgt, pos = tgt[rows], pos[rows]
    pas = _passable_rows(walled_rows(occupied), env, cls, params.replan_base, tgt, pos)
    dK, ndK = bitpack_query_plain(pas, tgt, pos, H, W, params.dynamic_bfs_iters)
    d = torch.full((B * A,), INF, dtype=torch.int32, device=dev).index_copy(0, rows, dK)
    nd = torch.full((B * A,), -1, dtype=torch.int32, device=dev).index_copy(0, rows, ndK)
    return d.view(B, A), nd.view(B, A), torch.zeros(B, dtype=torch.int32, device=dev)
