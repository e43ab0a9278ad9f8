"""Bit-packed replan query (K1): 1 bit per cell of the walled grid.

Counterpart of `swarm_ode_tpu/ops/bfs_bitpack.py`. For unit edge weights
the replan BFS is pure reachability, `reached |= (neighbour shifts) &
passable`, one bit per cell: the JAX kernel packs a query's grid into
words = ceil((H*(W+1) + W+1) / 32) uint32 words (medium: 19, extralarge: 45)
and its neighbour carries wrap modulo those M = 32*words bits.

`bitpack_query_call` launches `csrc/bfs_query.cu`, the kernel that also
serves the int32 query (K2, `ops/bfs_pallas.query_call`), over rows padded
to M cells: it replaces the Pallas kernel `_bitpack_kernel` and the
host-side next-hop selection of the JAX wrapper of the same name. Its plain
version is `bitpack_query_plain`.
"""
from __future__ import annotations

from swarm_ode_tpu_torch.ops import bfs_pallas

# Launches of K1 (csrc/bfs_query.cu with the bit-packed query's row length).
LAUNCHES = 0


def _plan(H: int, W: int):
    """(Ws, n, words) of the packed layout; raises where the JAX kernel's
    one-word carry does not hold."""
    Ws = W + 1
    if Ws >= 32:
        # The JAX kernel's cross-word neighbour carry uses `r << Ws` /
        # `prev >> (32-Ws)`, which assumes a +-Ws shift crosses at most one
        # 32-bit word; wider walled rows would silently mis-pathfind.
        raise ValueError(
            f"bitpack32 requires walled width W+1 < 32, got {Ws}; "
            "use bfs_kernel='int32' for this layout"
        )
    n = H * Ws
    words = -(-(n + Ws) // 32)  # ceil; >= one wall-row margin
    if words > 128:
        raise ValueError(f"grid too large for 32-bit packing: {words} words")
    return Ws, n, words


def bitpack_query_plain(pas, tgt, pos, H: int, W: int, iters: int):
    """K1's plain version, `_bitpack_kernel`'s answer: the replan query over
    each row padded to M = 32*words cells, neighbours wrapping modulo M.

    pas: (K, n) bool or {0, 1} passable masks, n = H*(W+1); tgt: (K,) walled
    targets, any int32 (one in [0, M) starts at 0); pos: (K,) walled own
    cells in [0, n). Returns (d, nd), each (K,) int32. Where t + W+1 < M
    (every target in the grid) it equals `bfs_pallas.query_plain`."""
    _, _, words = _plan(H, W)
    return bfs_pallas._query_plain(pas, tgt, pos, H, W, iters, 32 * words)


def bitpack_query_call(occ, env, cls, base, tgt, pos, H: int, W: int, iters: int):
    """K1 replan query: `csrc/bfs_query.cu` over rows padded to 32*words for
    CUDA tensors, `_passable_rows` + `bitpack_query_plain` for CPU tensors.
    Arguments as `bfs_pallas.query_call`'s. Returns (d, nd), each (K,)
    int32."""
    global LAUNCHES
    _, _, words = _plan(H, W)
    if occ.device.type == "cpu":
        pas = bfs_pallas._passable_rows(occ, env, cls, base, tgt, pos)
        return bitpack_query_plain(pas, tgt, pos, H, W, iters)
    out = bfs_pallas.launch_query(occ, env, cls, base, tgt, pos, H, W, iters, 32 * words)
    if env.shape[0]:
        LAUNCHES += 1
    return out
