// K1: bit-packed wavefront BFS with the at-position query fused in.
//
// Replaces the Pallas kernel swarm_ode_tpu/ops/bfs_bitpack.py::_bitpack_kernel
// (launched by bitpack_query_call) together with that wrapper's host-side
// next-hop selection.
//
// Each query is one agent's BFS on its own (H, W+1) walled grid, n = H*Ws
// cells, 1 bit per cell: `words` = ceil((n + Ws) / 32) uint32 words. One warp
// runs one query. Lane l holds words l, l+32, l+64, l+96 (SLOTS of them) in
// registers; a sweep is
//     r |= (r << 1) | (r >> 1) | (r << Ws) | (r >> Ws)   (with word carries)
//     r &= passable
// where the carries come from the neighbouring words over __shfl_*_sync.
// Ws < 32 keeps every +-Ws shift within one word boundary (the _plan guard in
// ops/bfs_bitpack.py). Words past the grid and the margin bits are never
// passable, so a carry into or out of them only moves zeros.
//
// Distances: a cell at BFS distance d stays unset for exactly the first d
// sweeps, so counting the sweeps that start with the bit unset gives d once
// the final mask shows the bit reached. Only 5 cells are asked for (the
// agent's own cell and its 4 neighbours): the lane owning each probe word
// counts it.
//
// What bounds it on the card: neither bandwidth nor arithmetic at the main
// path's shapes. A query reads n bytes of mask once (575 B on medium) and
// does ~40 integer/shuffle instructions per sweep; 32 sweeps. The TPU's
// 128-lane row packing, probe masks and rolls are gone: the warp is the row,
// the probe is read by index, the next hop is chosen in the same kernel, and
// the packed words are built with one __ballot_sync per word straight from
// the (K, n) byte mask.

#include <cuda_runtime.h>

#include <cstdint>

#include "bfs_common.cuh"

namespace {

using swarm_bfs::kInf;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int SLOTS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    bitpack_query_kernel(const uint8_t* __restrict__ pas, const int* __restrict__ tgt,
                         const int* __restrict__ pos, int* __restrict__ d_out,
                         int* __restrict__ nd_out, int K, int n, int Ws, int words,
                         int iters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= K) return;  // uniform across the warp
  const uint8_t* prow = pas + static_cast<size_t>(row) * n;

  // Passable words: word c = ballot of the 32 bytes of cells 32c .. 32c+31.
  uint32_t p[SLOTS];
  uint32_t r[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    p[s] = 0u;
    r[s] = 0u;
  }
  for (int c = 0; c < words; ++c) {
    const int idx = c * 32 + lane;
    const uint32_t w = __ballot_sync(kFull, idx < n && prow[idx] != 0);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (c == s * 32 + lane) p[s] = w;
  }

  // The wavefront starts at the target bit (not masked, as in the Pallas
  // kernel: the caller makes the target cell passable).
  const int t = tgt[row];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s)
    if ((t >> 5) == s * 32 + lane) r[s] = 1u << (t & 31);

  // Probes: own cell, UP, DOWN, LEFT, RIGHT. Off-grid probes are unreached.
  const int q0 = pos[row];
  int q[5], pslot[5], pbit[5];
  bool valid[5], mine[5];
  int cnt[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    q[k] = q0 + swarm_bfs::probe_delta(k, Ws);
    valid[k] = q[k] >= 0 && q[k] < n;
    const int wq = valid[k] ? (q[k] >> 5) : -1;
    pslot[k] = valid[k] ? (wq >> 5) : -1;
    pbit[k] = valid[k] ? (q[k] & 31) : 0;
    mine[k] = valid[k] && (wq & 31) == lane;
    cnt[k] = 0;
  }

  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      uint32_t v = 0u;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (s == pslot[k]) v = r[s];
      cnt[k] += (mine[k] && ((v >> pbit[k]) & 1u) == 0u) ? 1 : 0;
    }
    uint32_t prev[SLOTS], next[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const uint32_t up = __shfl_up_sync(kFull, r[s], 1);    // word - 1
      const uint32_t dn = __shfl_down_sync(kFull, r[s], 1);  // word + 1
      const uint32_t wrap_prev = s > 0 ? __shfl_sync(kFull, r[s > 0 ? s - 1 : 0], 31) : 0u;
      const uint32_t wrap_next =
          s + 1 < SLOTS ? __shfl_sync(kFull, r[s + 1 < SLOTS ? s + 1 : s], 0) : 0u;
      prev[s] = lane == 0 ? wrap_prev : up;
      next[s] = lane == 31 ? wrap_next : dn;
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const uint32_t x = r[s];
      const uint32_t grown = x | (x << 1) | (prev[s] >> 31) | (x >> 1) | (next[s] << 31) |
                             (x << Ws) | (prev[s] >> (32 - Ws)) | (x >> Ws) |
                             (next[s] << (32 - Ws));
      r[s] = grown & p[s];
    }
  }

  int d[5];
  bool ok[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    uint32_t v = 0u;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (s == pslot[k]) v = r[s];
    const int owner = valid[k] ? ((q[k] >> 5) & 31) : 0;
    const int c = __shfl_sync(kFull, cnt[k], owner);
    const uint32_t reached = __shfl_sync(kFull, (v >> pbit[k]) & 1u, owner);
    d[k] = (valid[k] && reached) ? c : kInf;
    ok[k] = valid[k] && prow[valid[k] ? q[k] : 0] != 0;
  }
  if (lane == 0) {
    int d_here, nd;
    swarm_bfs::select_next_hop(d, ok, &d_here, &nd);
    d_out[row] = d_here;
    nd_out[row] = nd;
  }
}

template <int SLOTS>
void launch(const uint8_t* pas, const int* tgt, const int* pos, int* d, int* nd, int K, int n,
            int Ws, int words, int iters, cudaStream_t stream) {
  const int blocks = (K + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bitpack_query_kernel<SLOTS><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      pas, tgt, pos, d, nd, K, n, Ws, words, iters);
}

}  // namespace

// pas: (K, n) bytes in {0, 1}; tgt, pos: (K,) walled-flat cells; d, nd: (K,)
// outputs. Requires 1 <= Ws < 32 and words <= 128. Returns cudaGetLastError().
extern "C" int swarm_bitpack_query(const void* pas, const void* tgt, const void* pos, void* d,
                                   void* nd, int K, int n, int Ws, int words, int iters,
                                   void* stream) {
  if (K <= 0 || Ws < 1 || Ws >= 32 || words < 1 || words > 128) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto P = static_cast<const uint8_t*>(pas);
  auto T = static_cast<const int*>(tgt);
  auto Q = static_cast<const int*>(pos);
  auto D = static_cast<int*>(d);
  auto N = static_cast<int*>(nd);
  if (words <= 32)
    launch<1>(P, T, Q, D, N, K, n, Ws, words, iters, s);
  else if (words <= 64)
    launch<2>(P, T, Q, D, N, K, n, Ws, words, iters, s);
  else
    launch<4>(P, T, Q, D, N, K, n, Ws, words, iters, s);
  return static_cast<int>(cudaGetLastError());
}
