"""Replan BFS in the walled layout, plain PyTorch only: the replan query that
the program's K1 kernel answers, over every row.

A frozen copy of the plain parts of the program's `ops/bfs_pallas.py` and
`ops/bfs_bitpack.py` (no kernel, no compaction). The (H, W) grid flattens
with a wall column appended to every row (stride Ws = W+1): walls are never
passable, so the four neighbour offsets -1, +1, -Ws, +Ws need no edge masks.
"""
from __future__ import annotations

import torch

INF = 1 << 28

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def query_length(H: int, W: int) -> int:
    """HWp: the padded row of the int32 query, at least one wall row below
    the grid (`_query_walled_single` and `bfs_dist_pallas` in the JAX
    package)."""
    return _round_up(H * (W + 1) + W + 1, 128)


def walled_rows(grid: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., H*(W+1)) bool in the walled layout (a False
    wall column appended to every grid row). Each row starts on a 16-byte
    boundary of a zero-padded buffer, as the replan-query kernel reads its
    occupancy and base rows in 16-byte loads."""
    *lead, H, W = grid.shape
    n = H * (W + 1)
    buf = torch.zeros(*lead, _round_up(n, 16), dtype=torch.bool, device=grid.device)
    rows = buf[..., :n]
    rows.view(*lead, H, W + 1)[..., :W] = grid
    return rows


def class_base_rows(picker_passable: torch.Tensor) -> torch.Tensor:
    """(2, H*(W+1)) bool base rows of the replan query's classes, walled:
    0 = the free grid (AGVs), 1 = the picker-passable highway."""
    return walled_rows(torch.stack([torch.ones_like(picker_passable), picker_passable]))


def select_next_hop(d, ok):
    """(d_here, nd) from the distances `d` and passability `ok` of the own
    cell and its UP, DOWN, LEFT, RIGHT neighbours (five (K,) tensors each):
    the first neighbour with the strictly smallest passable distance; an
    agent on a blocked cell steps off (best + 1); nd = -1 at the target or
    when nothing is reachable. Same rule as bfs_pallas.py:92-124."""
    inf = torch.full_like(d[0], INF)
    best = inf
    nd = torch.full_like(d[0], -1)
    for code in range(4):
        c = torch.where(ok[code + 1], d[code + 1], inf)
        take = c < best
        nd = torch.where(take, code, nd)
        best = torch.where(take, c, best)
    d_here = torch.where(ok[0], d[0], torch.where(best < INF, best + 1, inf))
    nd = torch.where((d_here == 0) | (d_here >= INF), -1, nd)
    return d_here, nd


def _padded_sweep(ok, tgt, Ws: int, iters: int):
    """(K, L) int32 distances after `iters` min-plus sweeps over rows of L
    cells whose neighbours +-1 and +-Ws wrap modulo L, as the JAX kernels'
    padded rows do. ok: (K, L) bool passability; tgt: (K,) walled targets.
    A target in [0, L) starts at 0, passable or not; any other matches no
    cell."""
    L = ok.shape[1]
    col = torch.arange(L, dtype=torch.int32, device=ok.device)
    d = torch.where(col[None, :] == tgt.to(torch.int32)[:, None], 0, INF).to(torch.int32)
    for _ in range(iters):
        best = torch.minimum(
            torch.minimum(d.roll(-1, 1), d.roll(1, 1)),
            torch.minimum(d.roll(-Ws, 1), d.roll(Ws, 1)),
        )
        d = torch.where(ok, torch.minimum(d, best + 1), d)
    return d


def _query_plain(pas, tgt, pos, H: int, W: int, iters: int, L: int):
    """The replan query over rows padded to L cells: `_padded_sweep`, then
    the distance and next hop at the own cell (`select_next_hop`). Own cells
    lie in the grid, as every caller gives them; probes outside [0, n) are
    unreached and impassable, which is what the JAX kernels give there."""
    K, n = pas.shape
    Ws = W + 1
    if n != H * Ws:
        raise ValueError(f"pas has {n} cells per row, expected H*(W+1) = {H * Ws}")
    ok = torch.zeros(K, L, dtype=torch.bool, device=pas.device)
    ok[:, :n] = pas != 0
    d = _padded_sweep(ok, tgt, Ws, iters)
    rows = torch.arange(K, device=pas.device)
    ds, oks = [], []
    for delta in (0, -Ws, Ws, -1, 1):
        q = pos.long() + delta
        inside = (q >= 0) & (q < n)
        q = q.clamp(0, n - 1)
        ds.append(torch.where(inside, d[rows, q], INF))
        oks.append(inside & ok[rows, q])
    return select_next_hop(ds, oks)


def _passable_rows(occ, env, cls, base, tgt, pos):
    """(K, n) bool passable rows, the plain form of the row the query kernel
    builds: the class's base row minus its env's occupied cells, with the
    target and own cell always free (find_path's grid edits,
    warehouse.py:285,:303; JAX `_passable_rows`). Arguments in the query
    wrappers' order: occ (B, n) bool env occupancy; env, cls (K,) int;
    base (2, n) bool class base rows (`class_base_rows`); tgt, pos (K,)
    int. Class 1 reads the picker row, any other class the free grid; an
    env index outside [0, B) reads as an env whose every cell is
    occupied."""
    B, n = occ.shape
    dev = occ.device
    env = env.long()
    full = torch.ones(1, n, dtype=torch.bool, device=dev)
    occK = torch.cat([occ, full]).index_select(0, torch.where((env >= 0) & (env < B), env, B))
    rows = base.index_select(0, (cls == 1).long()) & ~occK
    col = torch.arange(n, device=dev)
    return rows | (col[None, :] == tgt[:, None].long()) | (col[None, :] == pos[:, None].long())


def bitpack_plan(H: int, W: int):
    """(Ws, n, words) of the bit-packed layout the default replan query pads
    its rows to (every predefined size has W+1 < 32)."""
    Ws = W + 1
    if Ws >= 32:
        raise ValueError(f"the bit-packed query needs W+1 < 32, got {Ws}")
    n = H * Ws
    return Ws, n, -(-(n + Ws) // 32)


def bitpack_query_plain(pas, tgt, pos, H: int, W: int, iters: int):
    """The default replan query: `_query_plain` over rows padded to
    32 * words cells, neighbours wrapping modulo that length."""
    _, _, words = bitpack_plan(H, W)
    return _query_plain(pas, tgt, pos, H, W, iters, 32 * words)


def compaction_rows(B: int, A: int, row_frac: float, rows_per_block: int = 128) -> int:
    """K, the rows the program's compacted query runs for B envs of A agents:
    round_up(int(B*A*row_frac), rows_per_block), or B*A when that is fewer."""
    return min(_round_up(max(int(B * A * row_frac), 1), rows_per_block), B * A)
