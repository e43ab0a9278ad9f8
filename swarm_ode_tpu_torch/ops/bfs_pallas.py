"""Replan BFS in the walled layout: the need-row compaction, the int32
min-plus kernels (K2, K3) and the plain PyTorch versions the kernels are held
to.

Counterpart of `swarm_ode_tpu/ops/bfs_pallas.py` (module name kept so that a
reader finds it). The (H, W) grid flattens with a wall column appended to
every row (stride Ws = W+1): walls are never passable, so the four neighbour
offsets -1, +1, -Ws, +Ws need no edge masks.

- `query_call` wraps K2, `csrc/bfs_query.cu`, which replaces the Pallas
  kernel `_bfs_query_kernel` (driven by `_pallas_query_call`).
- `query_plain` is the plain version of K2 and of K1
  (`ops/bfs_bitpack.bitpack_query_call`): the two kernels compute the same
  (distance, next hop) per row, which the JAX package pins bit for bit.
- `bfs_dist_call` wraps K3, `csrc/bfs_dist.cu`, which replaces the Pallas
  kernel `_bfs_kernel` (driven by `bfs_dist_pallas`): the whole (H, W)
  distance field out, from a bit-packed wavefront. `bfs_dist_plain` is its
  plain version: `bfs_dist_pallas`'s sweeps over the same padded row, with
  the same wrap, for any int32 target.
- `bfs_query_occ_batched` compacts the rows the env step consumes across the
  whole batch, builds their passable masks, runs the query it is given (K1
  or K2, picked by `env/pathfinding.replan_query`) and scatters the
  results back.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; nothing falls back.
"""
from __future__ import annotations

import torch

from swarm_ode_tpu_torch.ops import _build

INF = 1 << 28

# Launches of K2 (csrc/bfs_query.cu) in this process.
LAUNCHES = 0
# Launches of K3 (csrc/bfs_dist.cu) in this process.
DIST_LAUNCHES = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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


def _sweep(pas, tgt, H: int, W: int, iters: int):
    """`iters` int32 min-plus sweeps over each row's walled grid.

    pas: (K, n) bool or {0, 1} passable masks, n = H*(W+1); tgt: (K,)
    walled-flat targets. A target in [0, n + Ws) starts at 0: one in the
    margin row below the grid ([n, n + Ws), impassable) gives distance 1 to
    the cell above it, as the JAX kernels' padded layout does; any other
    target matches no cell. Returns (d, ok): (K, n + 2*Ws) int32 distances
    and bool passability with one row of impassable cells on either side of
    the grid (the one below is the margin row), so the grid proper is
    [:, Ws:Ws+n]."""
    K, n = pas.shape
    Ws = W + 1
    if n != H * Ws:
        raise ValueError(f"pas has {n} cells per row, expected H*(W+1) = {H * Ws}")
    dev = pas.device
    ok = torch.zeros(K, n + 2 * Ws, dtype=torch.bool, device=dev)
    ok[:, Ws:Ws + n] = pas != 0
    col = torch.arange(n + Ws, device=dev)
    d = torch.full((K, n + 2 * Ws), INF, dtype=torch.int32, device=dev)
    d[:, Ws:] = torch.where(col[None, :] == tgt[:, None].long(), 0, INF).to(torch.int32)
    inner = ok[:, Ws:Ws + n]
    for _ in range(iters):
        cur = d[:, Ws:Ws + n]
        best = torch.minimum(
            torch.minimum(d[:, Ws + 1:Ws + 1 + n], d[:, Ws - 1:Ws - 1 + n]),
            torch.minimum(d[:, 2 * Ws:2 * Ws + n], d[:, :n]),
        )
        d[:, Ws:Ws + n] = torch.where(inner, torch.minimum(cur, best + 1), cur)
    return d, ok


def query_plain(pas, tgt, pos, H: int, W: int, iters: int):
    """Plain PyTorch replan query: `iters` int32 min-plus sweeps over each
    row's walled grid, then the own-cell distance and next hop.

    pas: (K, n) bool or {0, 1} passable masks, n = H*(W+1); tgt, pos: (K,)
    walled-flat cells. Returns (d, nd), each (K,) int32.
    """
    K = pas.shape[0]
    Ws = W + 1
    d, ok = _sweep(pas, tgt, H, W, iters)
    rows = torch.arange(K, device=pas.device)
    base = pos.long() + Ws
    deltas = (0, -Ws, Ws, -1, 1)
    return select_next_hop(
        [d[rows, base + dl] for dl in deltas], [ok[rows, base + dl] for dl in deltas]
    )


def bfs_dist_plain(pas, tgt_flat, iters: int):
    """Plain PyTorch version of K3: (K, H, W) int32 BFS distances, INF where
    unreached. pas: (K, H, W) bool or {0, 1}; tgt_flat: (K,) int32 plain
    flat targets y*W + x.

    It mirrors `bfs_dist_pallas` for every int32 target: the walled target
    (t // W)*(W+1) + t % W (floor division, int32 arithmetic that wraps, as
    JAX computes it) starts at 0 wherever it lies in the padded row of
    HWp = round_up((H+1)*(W+1), 128) cells, passable or not, and a sweep
    reads the neighbours +-1 and +-(W+1) modulo HWp. So a target in the
    wall row below the grid, or in the last W+1 cells of the padding, gives
    1 to the grid cells next to it (row H-1, or row 0 across the wrap); any
    other target outside the grid reaches nothing."""
    K, H, W = pas.shape
    Ws = W + 1
    n = H * Ws
    HWp = _round_up(n + Ws, 128)
    dev = pas.device
    ok = torch.zeros(K, HWp, dtype=torch.bool, device=dev)
    ok[:, :n] = torch.cat([pas != 0, torch.zeros(K, H, 1, dtype=torch.bool, device=dev)],
                          2).reshape(K, n)
    t = tgt_flat.to(torch.int32)
    tgt_w = torch.div(t, W, rounding_mode="floor") * Ws + torch.remainder(t, W)
    col = torch.arange(HWp, dtype=torch.int32, device=dev)
    d = torch.where(col[None, :] == tgt_w[:, None], 0, INF).to(torch.int32)
    for _ in range(iters):
        best = torch.minimum(
            torch.minimum(d.roll(-1, 1), d.roll(1, 1)),
            torch.minimum(d.roll(-Ws, 1), d.roll(Ws, 1)),
        )
        d = torch.where(ok, torch.minimum(d, best + 1), d)
    return d[:, :n].reshape(K, H, Ws)[:, :, :W].contiguous()


def check_query_args(pas, tgt, pos, H: int, W: int) -> tuple[int, int]:
    """Validate a kernel call's inputs; returns (K, n)."""
    n = H * (W + 1)
    if pas.dim() != 2 or pas.shape[1] != n:
        raise ValueError(f"pas must be (K, {n}), got {tuple(pas.shape)}")
    K = pas.shape[0]
    if pas.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"pas must be bool or uint8, got {pas.dtype}")
    for name, t in (("tgt", tgt), ("pos", pos)):
        if t.shape != (K,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({K},) int32, got {tuple(t.shape)} {t.dtype}")
        if t.device != pas.device:
            raise ValueError(f"{name} is on {t.device}, pas on {pas.device}")
    if pas.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {pas.device}")
    if not (pas.is_contiguous() and tgt.is_contiguous() and pos.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    return K, n


def query_call(pas, tgt, pos, H: int, W: int, iters: int):
    """K2: the int32 min-plus query (`csrc/bfs_query.cu`) for CUDA tensors,
    `query_plain` for CPU tensors. Counterpart of `_pallas_query_call`, over
    unpadded (K, n) rows. Returns (d, nd), each (K,) int32."""
    global LAUNCHES
    if pas.device.type == "cpu":
        return query_plain(pas, tgt, pos, H, W, iters)
    K, n = check_query_args(pas, tgt, pos, H, W)
    d = torch.empty(K, dtype=torch.int32, device=pas.device)
    nd = torch.empty(K, dtype=torch.int32, device=pas.device)
    if K == 0:
        return d, nd
    lib = _build.library()
    if lib.swarm_bfs_query_smem_bytes(n, W + 1) > 227 * 1024:
        raise ValueError(f"a row of {n} cells does not fit one block's shared memory")
    with torch.cuda.device(pas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_bfs_query(
            pas.data_ptr(), tgt.data_ptr(), pos.data_ptr(), d.data_ptr(), nd.data_ptr(),
            K, n, W + 1, int(iters), stream,
        )
    _build.check(err, "swarm_bfs_query")
    LAUNCHES += 1
    return d, nd


def bfs_dist_call(pas, tgt_flat, iters: int):
    """K3: the full-field BFS (`csrc/bfs_dist.cu`, a bit-packed wavefront)
    for CUDA tensors, `bfs_dist_plain` for CPU tensors. Counterpart of
    `bfs_dist_pallas`, with its answer for every int32 target.

    pas: (K, H, W) bool or uint8 passable masks (targets and own cells
    already freed); tgt_flat: (K,) int32 flat targets y*W + x. Returns
    (K, H, W) int32 distances, INF where unreached. Raises ValueError for a
    grid whose row does not fit one block's shared memory."""
    global DIST_LAUNCHES
    if pas.device.type == "cpu":
        return bfs_dist_plain(pas, tgt_flat, iters)
    if pas.dim() != 3:
        raise ValueError(f"pas must be (K, H, W), got {tuple(pas.shape)}")
    K, H, W = pas.shape
    if pas.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"pas must be bool or uint8, got {pas.dtype}")
    if tgt_flat.shape != (K,) or tgt_flat.dtype != torch.int32:
        raise ValueError(
            f"tgt_flat must be ({K},) int32, got {tuple(tgt_flat.shape)} {tgt_flat.dtype}"
        )
    if pas.device.type != "cuda" or tgt_flat.device != pas.device:
        raise ValueError(f"kernel inputs must be CUDA tensors on one device, got "
                         f"{pas.device} and {tgt_flat.device}")
    if not (pas.is_contiguous() and tgt_flat.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    out = torch.empty(K, H, W, dtype=torch.int32, device=pas.device)
    if K * H * W == 0:
        return out
    lib = _build.library()
    if lib.swarm_bfs_dist_smem_bytes(H, W) > 227 * 1024:
        raise ValueError(f"an {H}x{W} grid does not fit one block's shared memory")
    with torch.cuda.device(pas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_bfs_dist(
            pas.data_ptr(), tgt_flat.data_ptr(), out.data_ptr(), K, H, W, int(iters), stream
        )
    _build.check(err, "swarm_bfs_dist")
    DIST_LAUNCHES += 1
    return out


def _passable_rows(occK, classK, tgtK, posK, pick_w, H: int, W: int):
    """(K, n) bool passable masks for K compacted rows: the class's base grid
    (free grid, or highway-only for pickers) minus occupied cells, with the
    target and own cell always free (find_path's grid edits,
    warehouse.py:285,:303). occK: (K, n) bool, classK: (K,) int,
    tgtK/posK: (K,) walled-flat cells, pick_w: (n,) bool."""
    n = H * (W + 1)
    dev = occK.device
    free_w = torch.ones(H, W + 1, dtype=torch.bool, device=dev)
    free_w[:, W] = False
    base = torch.where((classK == 1)[:, None], pick_w[None, :], free_w.reshape(1, n))
    col = torch.arange(n, device=dev)
    return (
        (base & ~occK)
        | (col[None, :] == tgtK[:, None].long())
        | (col[None, :] == posK[:, None].long())
    )


def compact_rows(occ_w, tgt_w, pos_w, classes, need, pick_w, H: int, W: int,
                 row_frac: float, rows_per_block: int):
    """Select the rows the kernel runs and build their inputs.

    Needed rows first, in batch order (a stable argsort of need-first
    priority), cut to K = round_up(int(B*A*row_frac), rows_per_block) rows;
    every row when K >= B*A. Returns (chosen (K,) int64 or None when every
    row runs, pasK (K, n) bool, tgtK, posK (K,) int32)."""
    B, n = occ_w.shape
    A = tgt_w.shape[1]
    BA = B * A
    K = _round_up(max(int(BA * row_frac), 1), rows_per_block)
    dev = occ_w.device
    tgt2 = tgt_w.reshape(BA).to(torch.int32)
    pos2 = pos_w.reshape(BA).to(torch.int32)
    if K >= BA:
        chosen = None
        occK = occ_w.repeat_interleave(A, dim=0)
        classK = classes.repeat(B)
        tgtK, posK = tgt2, pos2
    else:
        iota = torch.arange(BA, device=dev)
        prio = torch.where(need.reshape(BA), iota, iota + BA)
        chosen = torch.argsort(prio, stable=True)[:K]
        occK = occ_w.index_select(0, chosen // A)
        classK = classes.index_select(0, chosen % A)
        tgtK = tgt2.index_select(0, chosen)
        posK = pos2.index_select(0, chosen)
    pasK = _passable_rows(occK, classK, tgtK, posK, pick_w, H, W)
    return chosen, pasK, tgtK.contiguous(), posK.contiguous()


def bfs_query_occ_batched(
    occ_w: torch.Tensor,  # (B, n) bool: per-env walled-flat occupancy
    tgt_w: torch.Tensor,  # (B, A) int32 walled-flat target cell
    pos_w: torch.Tensor,  # (B, A) int32 walled-flat own cell
    classes: torch.Tensor,  # (A,) int32 0 = free grid, 1 = picker
    need: torch.Tensor,  # (B, A) bool: rows whose result the step consumes
    pick_w: torch.Tensor,  # (n,) bool: picker-passable base mask
    H: int,
    W: int,
    iters: int,
    row_frac: float,
    rows_per_block: int,
    query,  # (pas, tgt, pos, H, W, iters) -> (d, nd): query_call or bitpack_query_call
):
    """Compaction-first batched replan query. Returns (d, nd, overflow):
    (B, A) int32 distance and next hop at each agent's own cell, and the
    (B,) int32 count of needed rows beyond the compaction budget.

    Only the K chosen rows run; the others report (INF, -1). Results are
    exact for every row that ran."""
    B = occ_w.shape[0]
    A = tgt_w.shape[1]
    BA = B * A
    dev = occ_w.device
    chosen, pasK, tgtK, posK = compact_rows(
        occ_w, tgt_w, pos_w, classes, need, pick_w, H, W, row_frac, rows_per_block
    )
    dK, ndK = query(pasK, tgtK, posK, H, W, iters)
    if chosen is None:
        return dK.view(B, A), ndK.view(B, A), torch.zeros(B, dtype=torch.int32, device=dev)
    d = torch.full((BA,), INF, dtype=torch.int32, device=dev).index_copy(0, chosen, dK)
    nd = torch.full((BA,), -1, dtype=torch.int32, device=dev).index_copy(0, chosen, ndK)
    covered = torch.zeros(BA, dtype=torch.bool, device=dev).index_fill(0, chosen, True)
    overflow = (need.reshape(BA) & ~covered).view(B, A).sum(1, dtype=torch.int32)
    return d.view(B, A), nd.view(B, A), overflow
