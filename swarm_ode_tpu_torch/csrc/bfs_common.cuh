// Shared pieces of the BFS kernels (bfs_query.cu, bfs_dist.cu).
#pragma once

#include <cstdint>

namespace swarm_bfs {

// Distance of an unreached or blocked cell (ops/bfs_pallas.py INF).
constexpr int kInf = 1 << 28;

// Walled-flat offsets of the own cell and its neighbours, in the tie-break
// order of the next hop: own, UP, DOWN, LEFT, RIGHT.
__device__ __forceinline__ int probe_delta(int k, int Ws) {
  return k == 0 ? 0 : k == 1 ? -Ws : k == 2 ? Ws : k == 3 ? -1 : 1;
}

// Next-hop selection of the JAX kernel (_bfs_query_kernel): the first of
// UP, DOWN, LEFT, RIGHT with the strictly smallest distance among passable
// neighbours; an agent on a blocked cell "steps off" (best neighbour + 1);
// no move at the target or when nothing is reachable.
// d[k], ok[k]: distance and passability of probe k (own cell first).
__device__ __forceinline__ void select_next_hop(const int d[5], const bool ok[5],
                                                int* d_here_out, int* nd_out) {
  int best = kInf;
  int nd = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = ok[k + 1] ? d[k + 1] : kInf;
    if (c < best) {
      best = c;
      nd = k;
    }
  }
  int d_here = ok[0] ? d[0] : (best < kInf ? best + 1 : kInf);
  if (d_here == 0 || d_here >= kInf) nd = -1;
  *d_here_out = d_here;
  *nd_out = nd;
}

}  // namespace swarm_bfs
