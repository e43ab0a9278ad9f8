// K3: int32 min-plus BFS that writes the whole distance field.
//
// Replaces the Pallas kernel swarm_ode_tpu/ops/bfs_pallas.py::_bfs_kernel
// (launched by bfs_dist_pallas), the field behind
// env/pathfinding.dynamic_fields.
//
// One block runs one row (one agent's replan): it reads the row's (H, W)
// passable mask, lays it out in shared memory with a wall column appended to
// every grid row (stride Ws = W+1, as K2 does), and keeps the int32 distances
// there twice, so each of the `iters` Jacobi sweeps
//     d'[i] = passable[i] ? min(d[i], 1 + min(d[i-1], d[i+1], d[i-Ws], d[i+Ws])) : d[i]
// reads one buffer and writes the other with a single __syncthreads between
// sweeps. The wall column is never passable, so row ends need no masks, and
// cells outside [0, n) read as unreached. The target starts at 0 whether or
// not it is passable (env/pathfinding.passable_grid frees it anyway). At the
// end the walled row is written back unwalled as (H, W) int32, neighbouring
// threads on neighbouring addresses.
//
// What bounds it on the card: per sweep, 5 shared loads and 1 store per cell
// and one barrier; device memory sees one read of the mask (H*W bytes) and one
// write of the field (4*H*W bytes) per row, 126 MB for 57,344 medium rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "bfs_common.cuh"

namespace {

using swarm_bfs::kInf;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    bfs_dist_kernel(const uint8_t* __restrict__ pas, const int* __restrict__ tgt,
                    int* __restrict__ out, int H, int W, int iters) {
  extern __shared__ int smem[];
  const int Ws = W + 1;
  const int n = H * Ws;
  const int hw = H * W;
  int* cur = smem;
  int* nxt = smem + n;
  uint8_t* ps = reinterpret_cast<uint8_t*>(smem + 2 * n);

  const int row = blockIdx.x;
  const uint8_t* prow = pas + static_cast<size_t>(row) * hw;
  const int t = tgt[row];
  // A target outside the grid matches no cell: the field stays unreached.
  const int t_w = (t >= 0 && t < hw) ? (t / W) * Ws + t % W : -1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / Ws;
    const int x = i - y * Ws;
    cur[i] = i == t_w ? 0 : kInf;
    ps[i] = x < W ? (prow[y * W + x] != 0) : 0;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int v = cur[i];
      if (ps[i]) {
        const int left = i >= 1 ? cur[i - 1] : kInf;
        const int right = i + 1 < n ? cur[i + 1] : kInf;
        const int up = i >= Ws ? cur[i - Ws] : kInf;
        const int down = i + Ws < n ? cur[i + Ws] : kInf;
        v = min(v, min(min(right, left), min(down, up)) + 1);
      }
      nxt[i] = v;
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  int* orow = out + static_cast<size_t>(row) * hw;
  for (int j = threadIdx.x; j < hw; j += kThreads) {
    const int y = j / W;
    orow[j] = cur[j + y];  // walled index y*Ws + x = j + y
  }
}

}  // namespace

// Dynamic shared memory a block needs for an (H, W) grid.
extern "C" int swarm_bfs_dist_smem_bytes(int H, int W) {
  const size_t n = static_cast<size_t>(H) * (W + 1);
  return static_cast<int>((2 * n * sizeof(int) + n + 3) & ~size_t{3});
}

// pas: (K, H, W) bytes in {0, 1}; tgt: (K,) flat targets y*W+x; out: (K, H, W)
// int32. Returns cudaGetLastError() after the launch.
extern "C" int swarm_bfs_dist(const void* pas, const void* tgt, void* out, int K, int H,
                              int W, int iters, void* stream) {
  if (K <= 0 || H <= 0 || W <= 0 || iters < 0) return cudaErrorInvalidValue;
  const int smem = swarm_bfs_dist_smem_bytes(H, W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfs_dist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bfs_dist_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pas), static_cast<const int*>(tgt), static_cast<int*>(out),
      H, W, iters);
  return static_cast<int>(cudaGetLastError());
}
