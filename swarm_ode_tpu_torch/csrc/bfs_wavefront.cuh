// The bit-packed BFS wavefront shared by the full-field BFS (K3,
// bfs_dist.cu) and the replan queries (K1 and K2, bfs_query.cu).
//
// A warp owns a row: one agent's walled grid (a wall column appended to every
// grid row, stride Ws = W+1, n = H*Ws cells), one bit a cell, in
// words = ceil(n / 32) uint32 words. A sweep is
//     fresh = ((r | r<<1 | r>>1 | r<<Ws | r>>Ws) & passable) & ~r;  r |= fresh
// with the carries between words, so a cell whose bit turns on at sweep s is
// at BFS distance s.
//
// The JAX kernels pad the row to L cells (HWp for the int32 kernels, 32*words
// for the bit-packed one), start the target at 0 when it lies in [0, L),
// passable or not, and wrap their neighbours modulo L. Nothing outside the
// grid is passable, so only their first sweep can cross the wrap or the
// padding: it reaches the passable grid cells among the target and its four
// neighbours modulo L (`Seed`). From there on the wavefront stays in the grid,
// where no shift needs to wrap, and the kernels here grow it with no padding.
//
// Two forms of the sweep:
// - registers (Ws < 32, words <= 32*SLOTS): lane l holds words l, l+32, ...
//   (SLOTS of them) and their passable masks; the carries come from the
//   neighbouring words over __shfl_*_sync. A +-Ws shift crosses at most one
//   word.
// - shared memory (any width): the words live in per-warp buffers; a +-Ws
//   shift reads words w -+ q and w -+ (q+1), q = Ws / 32, and shifts by
//   Ws % 32 bits (no shift at all when that is 0: a shift by 32 is
//   undefined).
// Each step calls on_fresh(word, fresh bits, sweep) for every word of the
// lane and returns whether the lane found a new cell.
#pragma once

#include <cstdint>

namespace swarm_bfs {

constexpr unsigned kFull = 0xffffffffu;

// The walled index of the flat target t = y*W + x: (t // W)*Ws + t % W with
// floor division and int32 arithmetic that wraps, as the JAX package
// computes it.
__device__ __forceinline__ int walled_index(int t, int W, int Ws) {
  int qd = t / W, rd = t % W;
  if (rd < 0) {
    rd += W;
    --qd;
  }
  return static_cast<int>(static_cast<unsigned>(qd) * static_cast<unsigned>(Ws) +
                          static_cast<unsigned>(rd));
}

// The walled target s and the cells of the first frontier in a row padded to
// L >= n + Ws cells: c[0] the target, c[1..4] its neighbours modulo L; -1
// where a cell is outside the grid or s is outside [0, L).
struct Seed {
  int c[5];
  __device__ Seed(int s, int n, int Ws, int L) {
    const bool seeded = s >= 0 && s < L;
    const int b = seeded ? s : 0;
    const int nb[5] = {b, b + 1 == L ? 0 : b + 1, b == 0 ? L - 1 : b - 1,
                       b + Ws >= L ? b + Ws - L : b + Ws, b - Ws < 0 ? b - Ws + L : b - Ws};
#pragma unroll
    for (int k = 0; k < 5; ++k) c[k] = seeded && nb[k] < n ? nb[k] : -1;
  }
  // Bits of word w among the first frontier (k >= 1) and the target (k = 0).
  __device__ uint32_t bits(int w, bool target) const {
    uint32_t b = 0u;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if ((k == 0) == target && c[k] >= 0 && (c[k] >> 5) == w) b |= 1u << (c[k] & 31);
    return b;
  }
};

// Register form, sweep 1: r = (target | first frontier) & p; the frontier's
// new cells (the target's own bit excluded) go to on_fresh at sweep 1.
template <int SLOTS, class F>
__device__ __forceinline__ bool seed_regs(uint32_t (&r)[SLOTS], const uint32_t (&p)[SLOTS],
                                          const Seed& seed, int lane, F&& on_fresh) {
  bool any = false;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int w = lane + 32 * s;
    const uint32_t t = seed.bits(w, true);
    r[s] = (seed.bits(w, false) | t) & p[s];
    const uint32_t fresh = r[s] & ~t;
    on_fresh(w, fresh, 1);
    any |= fresh != 0u;
  }
  return any;
}

// Register form, sweep `it` >= 2.
template <int SLOTS, class F>
__device__ __forceinline__ bool sweep_regs(uint32_t (&r)[SLOTS], const uint32_t (&p)[SLOTS],
                                           int Ws, int lane, int it, F&& on_fresh) {
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
  bool any = false;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const uint32_t x = r[s];
    const uint32_t grown = (x << 1) | (prev[s] >> 31) | (x >> 1) | (next[s] << 31) |
                           (x << Ws) | (prev[s] >> (32 - Ws)) | (x >> Ws) |
                           (next[s] << (32 - Ws));
    const uint32_t fresh = grown & p[s] & ~x;
    on_fresh(lane + 32 * s, fresh, it);
    any |= fresh != 0u;
    r[s] = x | fresh;
  }
  return any;
}

// Shared-memory form, sweep 1, into cur[words]. The caller syncs the warp
// before a lane reads another lane's words.
template <class F>
__device__ __forceinline__ bool seed_smem(uint32_t* cur, const uint32_t* pw, int words,
                                          const Seed& seed, int lane, F&& on_fresh) {
  bool any = false;
  for (int w = lane; w < words; w += 32) {
    const uint32_t t = seed.bits(w, true);
    const uint32_t r = (seed.bits(w, false) | t) & pw[w];
    cur[w] = r;
    const uint32_t fresh = r & ~t;
    on_fresh(w, fresh, 1);
    any |= fresh != 0u;
  }
  return any;
}

// Shared-memory form, sweep `it` >= 2: cur -> nxt. The caller syncs the warp
// and swaps the buffers.
template <class F>
__device__ __forceinline__ bool sweep_smem(const uint32_t* cur, uint32_t* nxt,
                                           const uint32_t* pw, int words, int Ws, int lane,
                                           int it, F&& on_fresh) {
  const int q = Ws >> 5, rr = Ws & 31;
  bool any = false;
  for (int w = lane; w < words; w += 32) {
    const uint32_t x = cur[w];
    const uint32_t a = w > 0 ? cur[w - 1] : 0u;
    const uint32_t b = w + 1 < words ? cur[w + 1] : 0u;
    const uint32_t c0 = w - q >= 0 ? cur[w - q] : 0u;
    const uint32_t c1 = w - q - 1 >= 0 ? cur[w - q - 1] : 0u;
    const uint32_t d0 = w + q < words ? cur[w + q] : 0u;
    const uint32_t d1 = w + q + 1 < words ? cur[w + q + 1] : 0u;
    const uint32_t from_up = rr ? (c0 << rr) | (c1 >> (32 - rr)) : c0;    // cell - Ws
    const uint32_t from_down = rr ? (d0 >> rr) | (d1 << (32 - rr)) : d0;  // cell + Ws
    const uint32_t grown = (x << 1) | (a >> 31) | (x >> 1) | (b << 31) | from_up | from_down;
    const uint32_t fresh = grown & pw[w] & ~x;
    nxt[w] = x | fresh;
    on_fresh(w, fresh, it);
    any |= fresh != 0u;
  }
  return any;
}

}  // namespace swarm_bfs
