// K3: full-field BFS as a bit-packed wavefront, one warp per row, each cell's
// distance written once.
//
// Replaces the Pallas kernel swarm_ode_tpu/ops/bfs_pallas.py::_bfs_kernel
// (launched by bfs_dist_pallas), the field behind
// env/pathfinding.dynamic_fields.
//
// What it computes. A row is one agent's (H, W) passable mask and flat target
// t. In the walled layout (a wall column appended to every grid row, stride
// Ws = W+1, n = H*Ws cells) the target sits at t_w = (t // W)*Ws + t % W
// (floor division, int32 arithmetic that wraps, as the JAX package computes
// it). The Pallas kernel pads the row to HWp = round_up(n + Ws, 128) cells,
// starts t_w at 0 when 0 <= t_w < HWp, passable or not, and runs `iters`
// min-plus sweeps whose neighbours +-1 and +-Ws wrap modulo HWp. Nothing
// outside the grid is passable, so only its first sweep can cross the wrap
// or the padding: it reaches the passable grid cells among t_w and its four
// neighbours (modulo HWp). From there on the wavefront stays in the grid,
// where no shift needs to wrap. This kernel seeds that first frontier
// directly, then grows it.
//
// The wavefront in bits (bfs_wavefront.cuh, shared with the replan queries
// K1/K2): a warp owns a row, one bit a walled cell, and a sweep grows the
// reached bits by +-1 and +-Ws with carries between words. A cell first
// reached at sweep s has distance s: the bits a sweep adds are written into
// a per-warp int32 staging row in shared memory, INF elsewhere, so each
// distance is written once and no int32 field is rewritten per sweep. A
// sweep that reaches no new cell (a warp vote) ends the row early: later
// sweeps would change nothing. The staging row then goes out unwalled in
// coalesced stores. The sweep runs in registers where Ws < 32 and the row
// has at most 64 words (every layout the env ships), in shared memory
// otherwise.
//
// The mask comes in as one coalesced pass over the row's H*W bytes into the
// staging row (walled), then one __ballot_sync per word packs it.
//
// What bounds it on the card: device memory. Per row it reads H*W mask bytes
// and writes 4*H*W bytes of field, each once (126 MB out for 57,344 medium
// rows); shared memory sees about three accesses per cell in all (mask byte,
// INF, read-out) plus one per reached cell, and a sweep is ~20 integer and
// shuffle instructions per word.

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

struct Grid {
  int H, W, Ws, n, hw, words, HWp, iters;
};

// Per-warp shared memory: the int32 staging row (n cells), the passable
// words, and two word buffers for the shared-memory form.
size_t warp_smem_bytes(int H, int W) {
  const size_t n = static_cast<size_t>(H) * (W + 1);
  return 4 * (n + 3 * ((n + 31) / 32));
}

// Lane l's first unwalled cell j = l and its grid row; stepping j by 32 moves
// the row by dq and the column by dr (with one carry).
struct RowWalk {
  int y, x, dq, dr;
  __device__ RowWalk(int lane, int W) : y(lane / W), x(lane % W), dq(32 / W), dr(32 % W) {}
  __device__ void step(int W) {
    y += dq;
    x += dr;
    if (x >= W) {
      x -= W;
      ++y;
    }
  }
};

// Reads the row's mask into the staging row (one byte a walled cell) and
// packs it into pw[words]. Leaves stage filled with kInf.
__device__ void load_mask(const uint8_t* __restrict__ prow, int* stage, uint32_t* pw,
                          const Grid& g, int lane) {
  uint8_t* bytes = reinterpret_cast<uint8_t*>(stage);
  for (int i = lane; i < (g.n + 3) / 4; i += 32) stage[i] = 0;
  __syncwarp();
  RowWalk rw(lane, g.W);
#pragma unroll 4
  for (int j = lane; j < g.hw; j += 32) {
    bytes[j + rw.y] = prow[j] != 0;  // walled index y*Ws + x = j + y
    rw.step(g.W);
  }
  __syncwarp();
  for (int c = 0; c < g.words; ++c) {
    const int i = c * 32 + lane;
    const uint32_t b = __ballot_sync(kFull, i < g.n && bytes[i] != 0);
    if (lane == 0) pw[c] = b;
  }
  __syncwarp();
  for (int i = lane; i < g.n; i += 32) stage[i] = kInf;
  __syncwarp();
}

// Writes distance s into the staging row for every bit of `fresh` (word w).
__device__ __forceinline__ void record(int* stage, uint32_t fresh, int w, int s) {
  while (fresh) {
    stage[w * 32 + __ffs(fresh) - 1] = s;
    fresh &= fresh - 1;
  }
}

// Out: the staging row written unwalled, neighbouring lanes on neighbouring
// addresses.
__device__ void store_row(const int* stage, int* __restrict__ orow, const Grid& g, int lane) {
  __syncwarp();
  RowWalk rw(lane, g.W);
#pragma unroll 4
  for (int j = lane; j < g.hw; j += 32) {
    orow[j] = stage[j + rw.y];
    rw.step(g.W);
  }
}

// SLOTS > 0: words in registers (Ws < 32, words <= 32*SLOTS). SLOTS == 0:
// words in shared memory (any width).
template <int SLOTS>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
    bfs_dist_kernel(const uint8_t* __restrict__ pas, const int* __restrict__ tgt,
                    int* __restrict__ out, int K, Grid g) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= K) return;  // uniform across the warp
  int* stage = smem + static_cast<size_t>(warp) * (g.n + 3 * g.words);
  uint32_t* pw = reinterpret_cast<uint32_t*>(stage + g.n);

  load_mask(pas + static_cast<size_t>(row) * g.hw, stage, pw, g, lane);
  const Seed seed(swarm_bfs::walled_index(tgt[row], g.W, g.Ws), g.n, g.Ws, g.HWp);
  if (lane == 0 && seed.c[0] >= 0) stage[seed.c[0]] = 0;  // even when impassable

  if (g.iters > 0) {
    const auto rec = [&](int w, uint32_t fresh, int it) { record(stage, fresh, w, it); };
    if constexpr (SLOTS > 0) {
      uint32_t p[SLOTS], r[SLOTS];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const int w = lane + 32 * s;
        p[s] = w < g.words ? pw[w] : 0u;
      }
      bool any = swarm_bfs::seed_regs(r, p, seed, lane, rec);
      for (int it = 2; it <= g.iters && __any_sync(kFull, any); ++it)
        any = swarm_bfs::sweep_regs(r, p, g.Ws, lane, it, rec);
    } else {
      uint32_t* cur = pw + g.words;
      uint32_t* nxt = cur + g.words;
      bool any = swarm_bfs::seed_smem(cur, pw, g.words, seed, lane, rec);
      __syncwarp();
      for (int it = 2; it <= g.iters && __any_sync(kFull, any); ++it) {
        any = swarm_bfs::sweep_smem(cur, nxt, pw, g.words, g.Ws, lane, it, rec);
        __syncwarp();
        uint32_t* tmp = cur;
        cur = nxt;
        nxt = tmp;
      }
    }
  }
  store_row(stage, out + static_cast<size_t>(row) * g.hw, g, lane);
}

template <int SLOTS>
int launch(const uint8_t* pas, const int* tgt, int* out, int K, const Grid& g,
           cudaStream_t stream) {
  const size_t per_warp = warp_smem_bytes(g.H, g.W);
  const int warps = static_cast<int>(
      per_warp * kMaxWarpsPerBlock <= kMaxSmem ? kMaxWarpsPerBlock : kMaxSmem / per_warp);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfs_dist_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (K + warps - 1) / warps;
  bfs_dist_kernel<SLOTS><<<blocks, warps * 32, smem, stream>>>(pas, tgt, out, K, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one warp (one row) needs for an (H, W) grid; a block needs at
// least one warp's. Saturates at INT32_MAX.
extern "C" int swarm_bfs_dist_smem_bytes(int H, int W) {
  if (H <= 0 || W <= 0) return 0;
  const size_t bytes = warp_smem_bytes(H, W);
  return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// pas: (K, H, W) bytes, nonzero = passable; tgt: (K,) int32 flat targets
// y*W+x; out: (K, H, W) int32. iters <= 0 runs no sweep. Returns
// cudaGetLastError() after the launch.
extern "C" int swarm_bfs_dist(const void* pas, const void* tgt, void* out, int K, int H,
                              int W, int iters, void* stream) {
  if (K <= 0 || H <= 0 || W <= 0 || warp_smem_bytes(H, W) > kMaxSmem)
    return cudaErrorInvalidValue;
  Grid g;
  g.H = H;
  g.W = W;
  g.Ws = W + 1;
  g.n = H * g.Ws;
  g.hw = H * W;
  g.words = (g.n + 31) / 32;
  g.HWp = (g.n + g.Ws + 127) / 128 * 128;
  g.iters = iters;
  auto P = static_cast<const uint8_t*>(pas);
  auto T = static_cast<const int*>(tgt);
  auto O = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (g.Ws >= 32 || g.words > 64) return launch<0>(P, T, O, K, g, s);
  if (g.words <= 32) return launch<1>(P, T, O, K, g, s);
  return launch<2>(P, T, O, K, g, s);
}
