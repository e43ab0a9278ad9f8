// K4: f32 segment sum of edge messages into node buckets.
//
// Replaces the Pallas kernel swarm_ode_tpu/ops/segment_pallas.py::_seg_kernel
// (launched by segment_sum_pallas), the reduction under the sparse SAGE path
// ops/segment.gather_scatter_mean.
//
// The TPU kernel builds one-hot tiles in VMEM and sums them on the matrix
// unit, because TPU scatters serialise. The card has native f32 atomics in
// L2, so the simple form is one thread per (edge, feature): it reads one
// message element and atomically adds it into out[id, feature]. Edges that are
// invalid, or whose id lies outside [0, N), are dropped. Neighbouring threads
// take neighbouring features of one edge, so both the loads and the atomics
// of a warp hit consecutive addresses.
//
// Its cost: one loop iteration per (edge slot, feature), padded or not; a
// message load and an atomic only for valid, in-range edges. With padded edge
// lists it moves far less than the bandwidth allows, so the atomics and the
// iterations over padding bound it, not device memory. Summation order
// follows the atomics and changes from run to run, so results agree with an
// ordered sum to rounding (a few ulp of the bucket's magnitude), not bit for
// bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                       const uint8_t* __restrict__ valid, float* __restrict__ out, long long E,
                       int D, int N) {
  const long long total = E * D;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; k < total;
       k += stride) {
    const long long e = k / D;
    const int f = static_cast<int>(k - e * D);
    const int s = ids[e];
    if (s < 0 || s >= N || (valid != nullptr && valid[e] == 0)) continue;
    atomicAdd(out + static_cast<long long>(s) * D + f, data[k]);
  }
}

}  // namespace

// data: (E, D) f32; ids: (E,) int32; valid: (E,) bytes in {0, 1} or null;
// out: (N, D) f32, zeroed here. Returns cudaGetLastError() after the launch.
extern "C" int swarm_segment_sum(const void* data, const void* ids, const void* valid, void* out,
                                 long long E, int D, int N, void* stream) {
  if (E < 0 || D <= 0 || N <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(N) * D * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (E == 0) return static_cast<int>(cudaGetLastError());
  const long long total = E * D;
  // Enough blocks to fill the card many times over; a grid-stride loop covers
  // the rest.
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132LL * 64 ? want : 132LL * 64);
  segment_sum_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(data), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), E, D, N);
  return static_cast<int>(cudaGetLastError());
}
