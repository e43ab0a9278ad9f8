// K4: f32 segment sum (or mean) in destination order, reading its rows
// through an index:
//
//   out[d, :] = sum over k in [offsets[d], offsets[d+1]) of data[row[k], :]
//
// divided by max(offsets[d+1] - offsets[d], 1) when `mean` is set.
//
// Replaces the Pallas kernel swarm_ode_tpu/ops/segment_pallas.py::_seg_kernel
// (launched by segment_sum_pallas), the reduction under the sparse SAGE path
// ops/segment.gather_scatter_mean. The TPU kernel builds one-hot tiles in
// VMEM and sums them on the matrix unit, because TPU scatters serialise.
//
// The plan (ops/segment_pallas.segment_plan) sorts the entries by their
// bucket, stably, and gives each bucket a range of `row`: the rows of `data`
// to add, in the entries' own order. With `row` the sort order this is the
// segment sum; with `row` the edges' sources it also gathers the messages,
// so the (edges, D) message matrix is never written. Entries at or beyond
// offsets[N] (the dropped ones) are never read.
//
// Design: one warp per destination row. Lanes take the features f = lane,
// lane + 32, ... and keep the partial sums in registers (F floats a lane: 14
// of the 16 are live at D = 435). Lane k loads the k-th row index of the
// segment and __shfl_sync broadcasts it. The loads of U rows are issued
// before the first of them is added, for memory-level parallelism (a served
// node has about 4.5 in-edges), and the adds go into one accumulator per
// feature in plan order. So a bucket is summed in the order index_add_ sums
// it on the CPU, and the result is the same bit for bit from run to run. No
// atomics and no memset: every output row is written once, an empty bucket
// with zeros. The mean divides (IEEE division; no fast math), as
// segment_mean does.
//
// Bound: bytes. It must read each gathered row once, the index and the
// offsets, and write the output once; the adds are far below the f32 rate.
// A served window's nodes are contiguous and so are its destinations, so the
// rows one window gathers again and again (243 KB of them at D = 435) stay
// in L2 while its destinations are summed, and device memory sees close to
// one read of each row. D = 435 is not a multiple of 4 (rows of 1,740 B), so
// the loads are scalar, a warp's 32 neighbouring floats at a time.
// Offsets into `data` and `out` are 64-bit: 2,048 served windows make 125M
// output elements at D = 435.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// F: features a lane keeps per pass over the segment (a pass covers 32 * F
// features; wider rows take several passes). U: rows loaded before they are
// added.
template <int F, int U>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ row,
                       const int* __restrict__ offsets, float* __restrict__ out, long long E,
                       int N, int D, int mean) {
  const long long d = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= N) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  // The plan's offsets are trusted to be ordered; clamped here so that a
  // bad range reads nothing outside `row`.
  long long lo = offsets[d], hi = offsets[d + 1];
  lo = lo < 0 ? 0 : (lo > E ? E : lo);
  hi = hi < lo ? lo : (hi > E ? E : hi);
  const float len = static_cast<float>(hi - lo > 1 ? hi - lo : 1);

  for (int f0 = 0; f0 < D; f0 += 32 * F) {
    float acc[F];
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = 0.0f;
    for (long long base = lo; base < hi; base += 32) {
      const int n = static_cast<int>(hi - base < 32 ? hi - base : 32);
      const int mine = lane < n ? row[base + lane] : 0;
      for (int j = 0; j < n; j += U) {
        float v[U][F];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = __shfl_sync(kFull, mine, (j + u) & 31);
          const float* p = data + static_cast<long long>(r) * D + f0 + lane;
#pragma unroll
          for (int i = 0; i < F; ++i)
            v[u][i] = (j + u < n && f0 + lane + 32 * i < D) ? __ldg(p + 32 * i) : 0.0f;
        }
        // In plan order, one accumulator per feature.
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < n) {
#pragma unroll
            for (int i = 0; i < F; ++i) acc[i] += v[u][i];
          }
        }
      }
    }
    float* o = out + d * D + f0 + lane;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      if (f0 + lane + 32 * i < D) o[32 * i] = mean ? acc[i] / len : acc[i];
    }
  }
}

template <int F, int U>
int launch(const void* data, const void* row, const void* offsets, void* out, long long E, int N,
           int D, int mean, cudaStream_t s) {
  const long long blocks = (static_cast<long long>(N) + kWarps - 1) / kWarps;
  segment_sum_kernel<F, U><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(data), static_cast<const int*>(row),
      static_cast<const int*>(offsets), static_cast<float*>(out), E, N, D, mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data: (R, D) f32; row: (E,) int32 rows of `data`, each in [0, R) within
// the ranges the offsets give; offsets: (N + 1,) int32 ordered ranges of
// `row`; out: (N, D) f32, every element written here. mean != 0 divides each
// bucket by its length (at least 1). Returns cudaGetLastError() after the
// launch.
extern "C" int swarm_segment_sum(const void* data, const void* row, const void* offsets,
                                 void* out, long long E, int N, int D, int mean, void* stream) {
  if (E < 0 || N < 0 || D <= 0) return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The served widths: the hidden width 64 in one pass, the observation
  // width 435 in one pass of 512; wider rows take several passes.
  if (D <= 64) return launch<2, 8>(data, row, offsets, out, E, N, D, mean, s);
  return launch<16, 2>(data, row, offsets, out, E, N, D, mean, s);
}
