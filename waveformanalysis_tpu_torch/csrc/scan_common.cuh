// Per-event peak-finding steps shared by the chain kernel (chain_scan.cu)
// and the find_peaks kernel (peaks_scan.cu).
//
// Each function is one piece of scipy.signal.find_peaks as the JAX package's
// ops/peaks.py (find_peaks_batch) defines it, written for one thread that
// owns one event. Slot tables are register arrays of a compile-time size KT:
// callers unroll every slot loop so slot indices are constants and the
// tables stay in registers.
//
// Exactness: build with --fmad=false and without fast-math; the products
// and quotients below use the _rn intrinsics so no contraction or
// approximate division can change a comparison.

#pragma once

#include <stdint.h>

namespace wfa {

constexpr float kNeg = -3.0e38f;  // below any float32 signal
constexpr float kInf = 3.0e38f;

// One step of plateau-aware local-maximum detection on the detection grid.
// `i` is the grid index of `cur_x`, `prev_x` the value at i - 1. The last
// nonzero difference's direction and index are carried in prev_rise /
// left_edge; a fall after a rise emits the plateau midpoint as a candidate
// (scipy: no peak at the first or last sample, value >= height). The first
// K candidates land in pos/val in order; `count` counts them all.
template <int KT>
__device__ __forceinline__ void candidate_step(int i, float cur_x, float prev_x,
                                               int det_len, int K, float height,
                                               int (&pos)[KT], float (&val)[KT],
                                               int& count, int& left_edge,
                                               bool& prev_rise) {
  const float d = cur_x - prev_x;
  const bool have = i >= 1;
  if (have && d < 0.0f && prev_rise && i <= det_len - 1) {
    // left_edge >= 0 and i - 1 >= 0: '/' is the floor division
    const int m_pt = (left_edge + i - 1) / 2;
    if (m_pt >= 1 && m_pt <= det_len - 2 && prev_x >= height) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k == count && k < K) {
          pos[k] = m_pt;
          val[k] = prev_x;
        }
      }
      ++count;
    }
  }
  if (have && d != 0.0f) {
    prev_rise = d > 0.0f;
    left_edge = i;
  }
}

// Bit k set for each of the first min(count, K) slots.
template <int KT>
__device__ __forceinline__ unsigned candidate_mask(int count, int K) {
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < KT; ++k)
    if (k < K && count > k) m |= 1u << k;
  return m;
}

// Greedy distance pruning by height priority (higher value first; of two
// equal values the higher slot, i.e. the later position, wins). Returns the
// surviving subset of cand_valid.
template <int KT>
__device__ __forceinline__ unsigned distance_prune(const int (&pos)[KT],
                                                   const float (&val)[KT],
                                                   unsigned cand_valid,
                                                   int distance) {
  if (distance <= 1 || !cand_valid) return cand_valid;
  int order[KT];
  int lpos[KT];
#pragma unroll
  for (int a = 0; a < KT; ++a) {
    int r = 0;
#pragma unroll
    for (int b = 0; b < KT; ++b)
      if (b != a) r += (val[b] > val[a]) || (val[b] == val[a] && b > a);
    order[r] = a;
    lpos[a] = pos[a];
  }
  unsigned keep = cand_valid;
  for (int r = 0; r < KT; ++r) {
    const int a = order[r];
    if (!((cand_valid & keep) >> a & 1u)) continue;
    for (int b = 0; b < KT; ++b)
      if (b != a && abs(lpos[b] - lpos[a]) < distance) keep &= ~(1u << b);
  }
  return cand_valid & keep;
}

// Evaluation height of the width: value - prominence * rel_height.
__device__ __forceinline__ float rel_height_level(float val, float prom,
                                                  float rel_height) {
  return __fsub_rn(val, __fmul_rn(prom, rel_height));
}

// Interpolated left ips from the last sample jl <= peak at or below hev
// (xl = x[jl], xl1 = x[jl + 1]); the left base when there is none (jl < 0).
__device__ __forceinline__ float left_ips(int jl, float xl, float xl1, float hev,
                                          int lbase) {
  if (jl < 0) return (float)lbase;
  const float dl = xl1 != xl ? xl1 - xl : 1.0f;
  return xl < hev ? (float)jl + __fdiv_rn(hev - xl, dl) : (float)jl;
}

// Interpolated right ips from the first sample jr >= peak at or below hev
// (xr = x[jr], xr1 = x[jr - 1]); the right base when there is none (jr = L).
__device__ __forceinline__ float right_ips(int jr, float xr, float xr1, float hev,
                                           int rbase, int L) {
  if (jr >= L) return (float)rbase;
  const float dr = xr1 != xr ? xr1 - xr : 1.0f;
  return xr < hev ? (float)jr - __fdiv_rn(hev - xr, dr) : (float)jr;
}

}  // namespace wfa
