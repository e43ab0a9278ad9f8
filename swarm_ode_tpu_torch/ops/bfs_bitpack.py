"""Bit-packed wavefront BFS (K1): 1 bit per cell of the walled grid.

Counterpart of `swarm_ode_tpu/ops/bfs_bitpack.py`. For unit edge weights
the replan BFS is pure reachability, `reached |= (neighbour shifts) &
passable`, one bit per cell: a query's grid packs into
words = ceil((H*(W+1) + W+1) / 32) uint32 words (medium: 19, extralarge: 45).
A cell at BFS distance d stays unset for exactly the first d sweeps, so the
number of sweeps that find it unset is its distance once the final mask shows
it reached.

`bitpack_query_call` launches `csrc/bfs_bitpack.cu` (one warp per query, the
words in registers, the next hop chosen in the kernel), which replaces the
Pallas kernel `_bitpack_kernel` and the host-side next-hop selection of the
JAX wrapper of the same name. Its plain version is
`ops/bfs_pallas.query_plain`: the bit-packed and the int32 kernels compute
the same (distance, next hop), so one plain version serves both.
"""
from __future__ import annotations

import torch

from swarm_ode_tpu_torch.ops import _build
from swarm_ode_tpu_torch.ops.bfs_pallas import check_query_args, query_plain

# Launches of K1 (csrc/bfs_bitpack.cu) in this process.
LAUNCHES = 0


def _plan(H: int, W: int):
    """(Ws, n, words) of the packed layout; raises where the kernel's
    one-word carry does not hold."""
    Ws = W + 1
    if Ws >= 32:
        # The cross-word neighbour carry uses `r << Ws` / `prev >> (32-Ws)`,
        # which assumes a +-Ws shift crosses at most one 32-bit word; wider
        # walled rows would silently mis-pathfind.
        raise ValueError(
            f"bitpack32 requires walled width W+1 < 32, got {Ws}; "
            "use bfs_kernel='int32' for this layout"
        )
    n = H * Ws
    words = -(-(n + Ws) // 32)  # ceil; >= one wall-row margin
    if words > 128:
        raise ValueError(f"grid too large for 32-bit packing: {words} words")
    return Ws, n, words


def bitpack_query_call(pas, tgt, pos, H: int, W: int, iters: int):
    """K1 replan query. pas: (K, n) bool passable rows, n = H*(W+1);
    tgt, pos: (K,) int32 walled-flat cells. Returns (d, nd), each (K,) int32,
    identical to `bfs_pallas.query_call`.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    global LAUNCHES
    Ws, n, words = _plan(H, W)
    if pas.device.type == "cpu":
        return query_plain(pas, tgt, pos, H, W, iters)
    K, _ = check_query_args(pas, tgt, pos, H, W)
    d = torch.empty(K, dtype=torch.int32, device=pas.device)
    nd = torch.empty(K, dtype=torch.int32, device=pas.device)
    if K == 0:
        return d, nd
    lib = _build.library()
    with torch.cuda.device(pas.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swarm_bitpack_query(
            pas.data_ptr(), tgt.data_ptr(), pos.data_ptr(), d.data_ptr(), nd.data_ptr(),
            K, n, Ws, words, int(iters), stream,
        )
    _build.check(err, "swarm_bitpack_query")
    LAUNCHES += 1
    return d, nd
