"""Replan BFS in the walled layout: the need-row compaction, the replan
queries (K1, K2), the full-field BFS (K3) and the plain PyTorch versions the
kernels are held to.

Counterpart of `swarm_ode_tpu/ops/bfs_pallas.py` (module name kept so that a
reader finds it). The (H, W) grid flattens with a wall column appended to
every row (stride Ws = W+1): walls are never passable, so the four neighbour
offsets -1, +1, -Ws, +Ws need no edge masks.

- `query_call` wraps K2, `csrc/bfs_query.cu`, which replaces the Pallas
  kernel `_bfs_query_kernel` (driven by `_pallas_query_call`). The same
  kernel serves K1 (`ops/bfs_bitpack.bitpack_query_call`): the two JAX
  queries differ only in the length L of the padded row their neighbours
  wrap in, which is the kernel's argument. The kernel builds each row from
  its env's occupancy, its class's base row, the target and the own cell
  (`_passable_rows`' rule); no (K, n) mask is made on the card.
- `query_plain` is K2's plain version, over a row padded to
  HWp = round_up(n + Ws, 128) cells; `bitpack_query_plain` is K1's.
- `bfs_dist_call` wraps K3, `csrc/bfs_dist.cu`, which replaces the Pallas
  kernel `_bfs_kernel` (driven by `bfs_dist_pallas`): the whole (H, W)
  distance field out, from a bit-packed wavefront. `bfs_dist_plain` is its
  plain version. Both plain versions sweep a padded row (`_padded_sweep`).
- `bfs_query_occ_batched` compacts the rows the env step consumes across the
  whole batch, runs the query it is given (K1 or K2, picked by
  `env/pathfinding.replan_query`) and scatters the results back.

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; nothing falls back.
"""
from __future__ import annotations

import torch

from swarm_ode_tpu_torch.ops import _build

INF = 1 << 28

# Launches of K2 (csrc/bfs_query.cu with the int32 query's row length).
LAUNCHES = 0
# Launches of K3 (csrc/bfs_dist.cu) in this process.
DIST_LAUNCHES = 0


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


def query_plain(pas, tgt, pos, H: int, W: int, iters: int):
    """K2's plain version, `_bfs_query_kernel`'s answer: `iters` int32
    min-plus sweeps over each row padded to HWp cells, neighbours wrapping
    modulo HWp, then the own cell's distance and next hop.

    pas: (K, n) bool or {0, 1} passable masks, n = H*(W+1); tgt: (K,) walled
    targets, any int32 (one in [0, HWp) starts at 0); pos: (K,) walled own
    cells in [0, n). Returns (d, nd), each (K,) int32."""
    return _query_plain(pas, tgt, pos, H, W, iters, query_length(H, W))


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
    HWp = query_length(H, W)
    dev = pas.device
    ok = torch.zeros(K, HWp, dtype=torch.bool, device=dev)
    ok[:, :n] = torch.cat([pas != 0, torch.zeros(K, H, 1, dtype=torch.bool, device=dev)],
                          2).reshape(K, n)
    t = tgt_flat.to(torch.int32)
    tgt_w = torch.div(t, W, rounding_mode="floor") * Ws + torch.remainder(t, W)
    d = _padded_sweep(ok, tgt_w, Ws, iters)
    return d[:, :n].reshape(K, H, Ws)[:, :, :W].contiguous()


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


def _check_rows(name: str, t, rows, n: int) -> None:
    """A (rows, n) bool operand of the query kernel: 16-byte row starts and
    room for a 16-byte read up to round_up(n, 16) in every row (what
    `walled_rows` gives)."""
    if t.dim() != 2 or t.shape[1] != n or t.dtype != torch.bool or (
            rows is not None and t.shape[0] != rows):
        raise ValueError(f"{name} must be ({'rows' if rows is None else rows}, {n}) bool, "
                         f"got {tuple(t.shape)} {t.dtype}")
    end = t.storage_offset() + (t.shape[0] - 1) * t.stride(0) + _round_up(n, 16)
    if t.shape[0] and (t.stride(1) != 1 or t.stride(0) % 16 or t.data_ptr() % 16
                       or t.untyped_storage().nbytes() < end):
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries with room for "
                         f"round_up(n, 16) bytes each: build them with walled_rows")


def check_query_args(occ, env, cls, base, tgt, pos, H: int, W: int) -> int:
    """Validate a query kernel's inputs; returns K."""
    n = H * (W + 1)
    _check_rows("occ", occ, None, n)
    _check_rows("base", base, 2, n)
    K = env.shape[0] if env.dim() == 1 else -1
    for name, t in (("env", env), ("cls", cls), ("tgt", tgt), ("pos", pos)):
        if t.shape != (K,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({K},) int32, got {tuple(t.shape)} {t.dtype}")
    devices = {t.device for t in (occ, env, cls, base, tgt, pos)}
    if len(devices) != 1 or occ.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors on one device, got {devices}")
    if not all(t.is_contiguous() for t in (env, cls, tgt, pos)):
        raise ValueError("kernel inputs must be contiguous")
    return K


def launch_query(occ, env, cls, base, tgt, pos, H: int, W: int, iters: int, L: int):
    """One launch of `csrc/bfs_query.cu` over rows padded to L cells (the
    kernel of K1 and K2). Returns (d, nd), each (K,) int32. Raises
    ValueError for a row whose words do not fit a block's shared memory."""
    K = check_query_args(occ, env, cls, base, tgt, pos, H, W)
    n = H * (W + 1)
    d = torch.empty(K, dtype=torch.int32, device=occ.device)
    nd = torch.empty(K, dtype=torch.int32, device=occ.device)
    if K == 0:
        return d, nd
    lib = _build.library()
    if lib.swarm_bfs_query_smem_bytes(n, W + 1) > 227 * 1024:
        raise ValueError(f"a row of {n} cells does not fit one block's shared memory")
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_bfs_query(
            occ.data_ptr(), occ.stride(0), occ.shape[0], env.data_ptr(), cls.data_ptr(),
            base.data_ptr(), base.stride(0), tgt.data_ptr(), pos.data_ptr(), d.data_ptr(),
            nd.data_ptr(), K, n, W + 1, L, int(iters), stream,
        )
    _build.check(err, "swarm_bfs_query")
    return d, nd


def query_call(occ, env, cls, base, tgt, pos, H: int, W: int, iters: int):
    """K2, the int32 query: `csrc/bfs_query.cu` over rows padded to HWp for
    CUDA tensors, `_passable_rows` + `query_plain` for CPU tensors.
    Counterpart of `_pallas_query_call` on the rows `_passable_rows` builds.

    occ: (B, n) bool env occupancy, n = H*(W+1); env, cls, tgt, pos: (K,)
    int32 (env index, class, walled target, walled own cell in the grid);
    base: (2, n) bool class base rows. On the card occ and base come from
    `walled_rows` / `class_base_rows`. Returns (d, nd), each (K,) int32."""
    global LAUNCHES
    if occ.device.type == "cpu":
        pas = _passable_rows(occ, env, cls, base, tgt, pos)
        return query_plain(pas, tgt, pos, H, W, iters)
    out = launch_query(occ, env, cls, base, tgt, pos, H, W, iters, query_length(H, W))
    if env.shape[0]:
        LAUNCHES += 1
    return out


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


def compact_rows(tgt_w, pos_w, classes, need, row_frac: float, rows_per_block: int):
    """Select the rows the query runs.

    Needed rows first, in batch order (a stable argsort of need-first
    priority), cut to K = round_up(int(B*A*row_frac), rows_per_block) rows;
    every row when K >= B*A. Returns (chosen (K,) int64 or None when every
    row runs, and the rows' env index, class, target and own cell, (K,)
    int32 each)."""
    B, A = tgt_w.shape
    BA = B * A
    K = _round_up(max(int(BA * row_frac), 1), rows_per_block)
    dev = tgt_w.device
    tgt2 = tgt_w.reshape(BA).to(torch.int32)
    pos2 = pos_w.reshape(BA).to(torch.int32)
    classes = classes.to(torch.int32)
    if K >= BA:
        envK = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(A)
        return None, envK, classes.repeat(B), tgt2.contiguous(), pos2.contiguous()
    iota = torch.arange(BA, device=dev)
    prio = torch.where(need.reshape(BA), iota, iota + BA)
    chosen = torch.argsort(prio, stable=True)[:K]
    return (chosen, (chosen // A).to(torch.int32), classes.index_select(0, chosen % A),
            tgt2.index_select(0, chosen), pos2.index_select(0, chosen))


def bfs_query_occ_batched(
    occ_w: torch.Tensor,  # (B, n) bool: per-env walled-flat occupancy
    tgt_w: torch.Tensor,  # (B, A) int32 walled-flat target cell
    pos_w: torch.Tensor,  # (B, A) int32 walled-flat own cell
    classes: torch.Tensor,  # (A,) int32 0 = free grid, 1 = picker
    need: torch.Tensor,  # (B, A) bool: rows whose result the step consumes
    base_w: torch.Tensor,  # (2, n) bool: class base rows (class_base_rows)
    H: int,
    W: int,
    iters: int,
    row_frac: float,
    rows_per_block: int,
    query,  # query_call or bitpack_query_call
):
    """Compaction-first batched replan query. Returns (d, nd, overflow):
    (B, A) int32 distance and next hop at each agent's own cell, and the
    (B,) int32 count of needed rows beyond the compaction budget.

    Only the K chosen rows run; the others report (INF, -1). Results are
    exact for every row that ran."""
    B, A = tgt_w.shape
    BA = B * A
    dev = occ_w.device
    chosen, envK, classK, tgtK, posK = compact_rows(
        tgt_w, pos_w, classes, need, row_frac, rows_per_block
    )
    dK, ndK = query(occ_w, envK, classK, base_w, tgtK, posK, H, W, iters)
    if chosen is None:
        return dK.view(B, A), ndK.view(B, A), torch.zeros(B, dtype=torch.int32, device=dev)
    d = torch.full((BA,), INF, dtype=torch.int32, device=dev).index_copy(0, chosen, dK)
    nd = torch.full((BA,), -1, dtype=torch.int32, device=dev).index_copy(0, chosen, ndK)
    covered = torch.zeros(BA, dtype=torch.bool, device=dev).index_fill(0, chosen, True)
    overflow = (need.reshape(BA) & ~covered).view(B, A).sum(1, dtype=torch.int32)
    return d.view(B, A), nd.view(B, A), overflow
