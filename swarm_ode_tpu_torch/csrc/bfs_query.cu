// K1 and K2: the replan query, one bit-packed wavefront per row, the row
// built from the env's occupancy, stopping once its five cells are settled.
//
// Replaces the Pallas kernels swarm_ode_tpu/ops/bfs_bitpack.py::_bitpack_kernel
// (K1, launched by bitpack_query_call, with that wrapper's host-side next-hop
// selection) and swarm_ode_tpu/ops/bfs_pallas.py::_bfs_query_kernel (K2,
// launched by _pallas_query_call), and the (K, n) passable masks their
// callers build (_passable_rows).
//
// What it computes. A row is one agent's replan query on its env's walled grid
// (stride Ws = W+1, n = H*Ws cells): the BFS distance from the target, then
// the distance and next hop at the agent's own cell. The two JAX queries give
// the same answer on any target in the grid; they differ only in the length L
// of the padded row their neighbours wrap in (32*words for K1, HWp for K2),
// which is this kernel's argument. The first frontier is the target and its
// four neighbours modulo L, kept where passable (bfs_wavefront.cuh, `Seed`).
//
// The row is built here: the class's base row (the free grid, or the picker
// highway) minus the env's occupied cells, with the target and own cell
// forced passable, which is _passable_rows's rule. Both rows are read in
// 16-byte loads (the wrapper requires 16-byte row starts; walled_rows gives
// them), two lanes to a word, and about six rows share an env, so most of
// those reads hit L2. No (K, n) mask exists on the card.
//
// Five cells are read: the own cell and its UP, DOWN, LEFT, RIGHT neighbours.
// Lane k < 5 follows probe k: its distance is the sweep at which its bit turns
// on (read from the word's owner after each sweep). A warp vote ends the row
// when a sweep reaches no new cell or when every passable probe is reached:
// neither can change the output. Lane 0 then picks the next hop
// (bfs_common.cuh, `select_next_hop`). An impassable probe's distance is
// never read, so a target off the grid's passable cells needs no distance of
// its own.
//
// What bounds it on the card: neither bandwidth nor arithmetic at the main
// path's shapes (12,672 rows of 575 cells: 1.5 MB of occupancy, 24 B a row of
// indices in and results out). Each row is a dependent chain of sweeps, each
// a few shuffles and ~20 integer instructions per word, over as many sweeps
// as the own cell is far from the target, plus one; a launch's fixed cost is
// of the same order.

#include <cuda_runtime.h>

#include <cstdint>

#include "bfs_common.cuh"
#include "bfs_wavefront.cuh"

namespace {

using swarm_bfs::kFull;
using swarm_bfs::kInf;
using swarm_bfs::Seed;

constexpr int kMaxWarpsPerBlock = 4;
constexpr size_t kMaxSmem = 227 * 1024;

struct Rows {
  int n, Ws, words, L, iters, B, occ_stride, base_stride;
};

// Per-warp shared memory: the passable words, and two word buffers for the
// shared-memory form.
size_t warp_smem_bytes(int n, int Ws) {
  const size_t words = (static_cast<size_t>(n) + 31) / 32;
  return 4 * words * (Ws < 32 && words <= 64 ? 1 : 3);
}

// Bits 0..3 = bytes 0..3 of x, each 0 or 1.
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// pw[0, words): base & ~occ from 16 bytes a lane (two lanes to a word),
// bits past n cleared, the target and own cell set.
__device__ void load_row(const uint8_t* __restrict__ orow, const uint8_t* __restrict__ brow,
                         uint32_t* pw, const Rows& g, int t, int q0, int lane) {
  uint16_t* half = reinterpret_cast<uint16_t*>(pw);
  for (int j = lane; j < 2 * g.words; j += 32) {
    const int b = 16 * j;
    uint32_t h = 0u;
    if (b < g.n) {
      const uint4 bv = *reinterpret_cast<const uint4*>(brow + b);
      const uint4 ov = orow ? *reinterpret_cast<const uint4*>(orow + b) : make_uint4(~0u, ~0u, ~0u, ~0u);
      h = byte_bits(bv.x & ~ov.x) | byte_bits(bv.y & ~ov.y) << 4 |
          byte_bits(bv.z & ~ov.z) << 8 | byte_bits(bv.w & ~ov.w) << 12;
    }
    half[j] = static_cast<uint16_t>(h);
  }
  __syncwarp();
  if (lane == 0) {
    if (g.n & 31) pw[g.n >> 5] &= (1u << (g.n & 31)) - 1u;
    if (t >= 0 && t < g.n) pw[t >> 5] |= 1u << (t & 31);
    if (q0 >= 0 && q0 < g.n) pw[q0 >> 5] |= 1u << (q0 & 31);
  }
  __syncwarp();
}

// Word w of a register-form row, from its owner lane (every lane calls it).
template <int SLOTS>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&x)[SLOTS], int w) {
  uint32_t v = 0u;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const uint32_t y = __shfl_sync(kFull, x[s], w & 31);
    if (s == (w >> 5)) v = y;
  }
  return v;
}

// Whether another sweep can change the output: one found a new cell and a
// passable probe is still unreached.
__device__ __forceinline__ bool go_on(bool any, bool pending) {
  return __reduce_or_sync(kFull, (any ? 1u : 0u) | (pending ? 2u : 0u)) == 3u;
}

// SLOTS > 0: words in registers (Ws < 32, words <= 32*SLOTS). SLOTS == 0:
// words in shared memory (any width).
template <int SLOTS>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
    bfs_query_kernel(const uint8_t* __restrict__ occ, const int* __restrict__ env,
                     const int* __restrict__ cls, const uint8_t* __restrict__ base,
                     const int* __restrict__ tgt, const int* __restrict__ pos,
                     int* __restrict__ d_out, int* __restrict__ nd_out, int K, Rows g) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= K) return;  // uniform across the warp
  uint32_t* pw = smem + static_cast<size_t>(warp) * g.words * (SLOTS > 0 ? 1 : 3);
  const int e = env[row], t = tgt[row], q0 = pos[row];
  // An env outside [0, B) has every cell occupied.
  const uint8_t* orow = e >= 0 && e < g.B ? occ + static_cast<size_t>(e) * g.occ_stride : nullptr;
  load_row(orow, base + (cls[row] == 1 ? g.base_stride : 0), pw, g, t, q0, lane);

  // Lane k < 5 follows probe k; it is pending while passable and unreached.
  const int q = q0 + swarm_bfs::probe_delta(lane < 5 ? lane : 0, g.Ws);
  const bool valid = lane < 5 && q >= 0 && q < g.n;
  const int wq = valid ? q >> 5 : 0;
  const bool ok = valid && ((pw[wq] >> (q & 31)) & 1u);
  const Seed seed(t, g.n, g.Ws, g.L);
  bool pending = ok && q != seed.c[0];
  int dist = ok && q == seed.c[0] ? 0 : kInf;
  const auto settle = [&](uint32_t word, int it) {
    if (pending && ((word >> (q & 31)) & 1u)) {
      dist = it;
      pending = false;
    }
  };
  const auto none = [](int, uint32_t, int) {};

  if (g.iters > 0) {
    if constexpr (SLOTS > 0) {
      uint32_t p[SLOTS], r[SLOTS];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int w = lane + 32 * s;
        p[s] = w < g.words ? pw[w] : 0u;
      }
      bool any = swarm_bfs::seed_regs(r, p, seed, lane, none);
      settle(word_at(r, wq), 1);
      for (int it = 2; it <= g.iters && go_on(any, pending); ++it) {
        any = swarm_bfs::sweep_regs(r, p, g.Ws, lane, it, none);
        settle(word_at(r, wq), it);
      }
    } else {
      uint32_t* cur = pw + g.words;
      uint32_t* nxt = cur + g.words;
      bool any = swarm_bfs::seed_smem(cur, pw, g.words, seed, lane, none);
      __syncwarp();
      settle(cur[wq], 1);
      for (int it = 2; it <= g.iters && go_on(any, pending); ++it) {
        any = swarm_bfs::sweep_smem(cur, nxt, pw, g.words, g.Ws, lane, it, none);
        __syncwarp();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
        settle(cur[wq], it);
      }
    }
  }

  int d[5];
  bool okk[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    d[k] = __shfl_sync(kFull, dist, k);
    okk[k] = __shfl_sync(kFull, ok ? 1 : 0, k) != 0;
  }
  if (lane == 0) {
    int d_here, nd;
    swarm_bfs::select_next_hop(d, okk, &d_here, &nd);
    d_out[row] = d_here;
    nd_out[row] = nd;
  }
}

template <int SLOTS>
int launch(const uint8_t* occ, const int* env, const int* cls, const uint8_t* base,
           const int* tgt, const int* pos, int* d, int* nd, int K, const Rows& g,
           cudaStream_t stream) {
  const size_t per_warp = warp_smem_bytes(g.n, g.Ws);
  const int warps = static_cast<int>(
      per_warp * kMaxWarpsPerBlock <= kMaxSmem ? kMaxWarpsPerBlock : kMaxSmem / per_warp);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfs_query_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (K + warps - 1) / warps;
  bfs_query_kernel<SLOTS><<<blocks, warps * 32, smem, stream>>>(occ, env, cls, base, tgt, pos,
                                                                  d, nd, K, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one warp (one row) needs for a row of n cells, walled width
// Ws; a block needs at least one warp's. Saturates at INT32_MAX.
extern "C" int swarm_bfs_query_smem_bytes(int n, int Ws) {
  if (n <= 0 || Ws <= 0) return 0;
  const size_t bytes = warp_smem_bytes(n, Ws);
  return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// occ: (B, n) bool env occupancy, rows occ_stride bytes apart; env, cls, tgt,
// pos: (K,) int32 (env index, class, walled target, walled own cell); base:
// (2, n) bool class base rows, base_stride bytes apart. Row starts are 16-byte
// aligned and each row has round_up(n, 16) readable bytes. d, nd: (K,) int32
// out. The neighbours of the first frontier wrap modulo L >= n + Ws; iters <= 0
// runs no sweep. Returns cudaGetLastError() after the launch.
extern "C" int swarm_bfs_query(const void* occ, int occ_stride, int B, const void* env,
                               const void* cls, const void* base, int base_stride,
                               const void* tgt, const void* pos, void* d, void* nd, int K,
                               int n, int Ws, int L, int iters, void* stream) {
  if (K <= 0 || n <= 0 || Ws < 1 || L < n + Ws || B < 0 || occ_stride < n ||
      base_stride < n || occ_stride % 16 || base_stride % 16 ||
      warp_smem_bytes(n, Ws) > kMaxSmem)
    return cudaErrorInvalidValue;
  Rows g;
  g.n = n;
  g.Ws = Ws;
  g.words = (n + 31) / 32;
  g.L = L;
  g.iters = iters;
  g.B = B;
  g.occ_stride = occ_stride;
  g.base_stride = base_stride;
  auto O = static_cast<const uint8_t*>(occ);
  auto E = static_cast<const int*>(env);
  auto C = static_cast<const int*>(cls);
  auto P = static_cast<const uint8_t*>(base);
  auto T = static_cast<const int*>(tgt);
  auto Q = static_cast<const int*>(pos);
  auto D = static_cast<int*>(d);
  auto N = static_cast<int*>(nd);
  auto s = static_cast<cudaStream_t>(stream);
  if (Ws >= 32 || g.words > 64) return launch<0>(O, E, C, P, T, Q, D, N, K, g, s);
  if (g.words <= 32) return launch<1>(O, E, C, P, T, Q, D, N, K, g, s);
  return launch<2>(O, E, C, P, T, Q, D, N, K, g, s);
}
