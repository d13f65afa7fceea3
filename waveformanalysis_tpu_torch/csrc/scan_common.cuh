// Per-event peak-finding steps shared by the chain kernels (chain_scan.cu,
// chain_tile.cu) and the find_peaks kernel (peaks_scan.cu), all through
// warp_peaks.cuh, and the chain kernels' parameter and output structs.
//
// Each function is one piece of scipy.signal.find_peaks as the JAX package's
// ops/peaks.py (find_peaks_batch) defines it: the evaluation height of a
// width and the interpolated ips.
//
// Exactness: build with --fmad=false and without fast-math; the products
// and quotients below use the _rn intrinsics so no contraction or
// approximate division can change a comparison.

#pragma once

#include <stdint.h>

// The chain kernels' arguments, shared with the ctypes mirrors in
// ops/chain_scan_cuda.py (_Params, _Outs): keep the field order and types
// identical. Global scope: the extern "C" entries take them by pointer.
struct ChainParams {
  int n, L, K, K_hits;
  int height_start, height_end, area_start;
  int peak_distance, use_derivative;
  int left_extension, right_extension, height_ext, baseline_samples;
  float peak_height, peak_prominence, peak_width, rel_height;
  float hit_threshold, rise_low, rise_high, s1_width_max, s2_width_min;
};

struct ChainOut {
  float* height;
  float* amp;
  float* area;
  float* max_abs_diff;
  int32_t* peak_position;
  int32_t* n_peaks;
  int32_t* n_hits;
  float* hit_integral;
  float* rise_samples;
  float* fall_samples;
  float* width_samples;
  int8_t* label;
  // Two int32 counters, adjacent (n_hit_overflow == n_peak_overflow + 1):
  // the events with more candidate peaks than K and with more threshold runs
  // than K_hits. The C entries zero them; the kernel adds each event's flags.
  int32_t* n_peak_overflow;
  int32_t* n_hit_overflow;
};

// One event's overflow flags (ChainOut's counters), the same on every lane.
struct ChainOverflow {
  bool peaks;  // more candidate peaks than K
  bool hits;   // more threshold runs than K_hits
};

namespace wfa {

constexpr float kNeg = -3.0e38f;  // below any float32 signal
constexpr float kInf = 3.0e38f;

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
