// K2: int32 min-plus BFS with the at-position query fused in.
//
// Replaces the Pallas kernel swarm_ode_tpu/ops/bfs_pallas.py::_bfs_query_kernel
// (launched by _pallas_query_call).
//
// One block runs one query: the row's int32 distances (n = H*Ws cells of the
// walled grid and the margin row below it, 2.4 KB on medium) live in shared
// memory, twice, so each of the `iters` Jacobi sweeps
//     d'[i] = passable[i] ? min(d[i], 1 + min(d[i-1], d[i+1], d[i-Ws], d[i+Ws])) : d[i]
// reads one buffer and writes the other with a single __syncthreads between
// sweeps. The wall column at stride Ws = W+1 is never passable, so row ends
// need no masks. The margin row [n, n + Ws) is never passable either: it
// holds 0 where the target lies there (the Pallas kernel seeds it in its
// padded row), INF elsewhere, so the last grid row reads its lower
// neighbours without a bounds check. Cells above the grid read as unreached
// (the Pallas kernel's rolls wrap into its impassable margin instead).
// Thread 0 then reads the own cell and its 4 neighbours and picks the next
// hop exactly as bfs_pallas.py:92-124 does.
//
// What bounds it on the card: shared-memory traffic and the per-sweep
// barrier: 5 shared loads and 1 store per cell per sweep, no device-memory
// traffic beyond one read of the mask. It is the plain reference form of the
// replan BFS, ~16x the bit-packed kernel's work per query.

#include <cuda_runtime.h>

#include <cstdint>

#include "bfs_common.cuh"

namespace {

using swarm_bfs::kInf;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    bfs_query_kernel(const uint8_t* __restrict__ pas, const int* __restrict__ tgt,
                     const int* __restrict__ pos, int* __restrict__ d_out,
                     int* __restrict__ nd_out, int n, int Ws, int iters) {
  extern __shared__ int smem[];
  const int m = n + Ws;  // the grid and the margin row
  int* cur = smem;
  int* nxt = smem + m;
  uint8_t* ps = reinterpret_cast<uint8_t*>(smem + 2 * m);

  const int row = blockIdx.x;
  const uint8_t* prow = pas + static_cast<size_t>(row) * n;
  const int t = tgt[row];
  for (int i = threadIdx.x; i < m; i += kThreads) {
    cur[i] = i == t ? 0 : kInf;
    if (i < n)
      ps[i] = prow[i];
    else
      nxt[i] = cur[i];  // the margin row is never swept
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int v = cur[i];
      if (ps[i]) {
        const int left = i >= 1 ? cur[i - 1] : kInf;
        const int right = cur[i + 1];
        const int up = i >= Ws ? cur[i - Ws] : kInf;
        const int down = cur[i + Ws];
        v = min(v, min(min(right, left), min(down, up)) + 1);
      }
      nxt[i] = v;
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (threadIdx.x == 0) {
    const int q0 = pos[row];
    int d[5];
    bool ok[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int q = q0 + swarm_bfs::probe_delta(k, Ws);
      const bool valid = q >= 0 && q < n;
      d[k] = valid ? cur[q] : kInf;
      ok[k] = valid && ps[q] != 0;
    }
    int d_here, nd;
    swarm_bfs::select_next_hop(d, ok, &d_here, &nd);
    d_out[row] = d_here;
    nd_out[row] = nd;
  }
}

}  // namespace

// Dynamic shared memory a block needs for a row of n cells, walled width Ws.
extern "C" int swarm_bfs_query_smem_bytes(int n, int Ws) {
  const size_t m = static_cast<size_t>(n) + Ws;
  return static_cast<int>((2 * m * sizeof(int) + n + 3) & ~size_t{3});
}

// pas: (K, n) bytes in {0, 1}; tgt, pos: (K,) walled-flat cells; d, nd: (K,)
// outputs. Returns cudaGetLastError() after the launch.
extern "C" int swarm_bfs_query(const void* pas, const void* tgt, const void* pos, void* d,
                               void* nd, int K, int n, int Ws, int iters, void* stream) {
  if (K <= 0 || n <= 0 || Ws < 1) return cudaErrorInvalidValue;
  const int smem = swarm_bfs_query_smem_bytes(n, Ws);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfs_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bfs_query_kernel<<<K, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pas), static_cast<const int*>(tgt),
      static_cast<const int*>(pos), static_cast<int*>(d), static_cast<int*>(nd), n, Ws, iters);
  return static_cast<int>(cudaGetLastError());
}
