// The fused per-event chain on one event's staged int16 row, one warp per
// event: features -> scipy-parity find_peaks -> threshold-hit runs -> 10-90%
// widths -> S1/S2 label. Shared by the chain kernel (chain_scan.cu, K1) and
// the tile chain kernel (chain_tile.cu, K7), which differ in their block
// shape and in the row they read the signal from.
//
// The warp holds its event's int16 row in shared memory and forms every
// float it needs from it: the signal sign * (w - bl) and the detection value
// (the signal, or sign * (w[t + 1] - w[t]) with use_derivative). With
// kFloatRow the features pass also writes the signal once into a float32 row
// beside the int16 one, and every later pass reads it from there (one load
// in place of a load, a conversion, a subtraction and a product); the values
// are the same floats either way. Every pass takes 32 samples a step, lane j
// on sample b + j (conflict-free reads), and is built from the warp parts
// the other kernels use:
//
//   features  min / max / sum / count / max |diff| in exact int32 by warp
//             reductions; the width baseline's f32 sum lane-strided, then a
//             butterfly (the order K1 and K7 share)
//   peaks     find_peaks on the detection grid (warp_peaks.cuh, the
//             find_peaks kernel's code): ballot candidate scan, warp
//             distance pruning, warp base and crossing searches per kept slot
//   hits      threshold runs (warp_hits.cuh, the hit kernel's code): ballot
//             run pass into a per-warp slot table, one warp sum per run's
//             extended window; hit_integral adds the runs in slot order
//   heights   max - min of the raw wave over each valid peak's rounded ips
//             window +- 4, by warp min / max
//   widths    the four first crossings around the dominant peak, 32 samples
//             a step by ballot (the width kernel's search); one lane
//             interpolates and labels
//
// Exactness. Positions, counts, validity and labels come from float32
// comparisons of interpolated values, so the build uses --fmad=false (no
// contraction of a product into a following add), IEEE division (no
// fast-math), and rounding half to even (__float2int_rn) like jnp.round /
// torch.round. The sentinels are +-3e38 as in the JAX package. `area` sums
// the valid samples in int32, exact for L < 65536.
//
// ops/chain_scan_cuda.py (CHAIN_SLOT_BYTES) and ops/chain_tile_cuda.py
// (event_smem_bytes) mirror the per-warp byte counts: keep them in step.

#pragma once

#include "warp_hits.cuh"
#include "warp_peaks.cuh"

namespace wfa {

// per warp: candidate position / value and run start / end tables
constexpr int kChainSlotBytes = 4 * 32 * 4;

// shared memory of one warp: the int16 row, the float32 signal row with
// kFloatRow, and the slot tables
__host__ __device__ __forceinline__ int chain_warp_bytes(int L, bool float_row) {
  return row_bytes(L, 2) + (float_row ? row_bytes(L, 4) : 0) + kChainSlotBytes;
}

// The chain of event `ev`, whose int16 row starts at `waves_row` in global
// memory, in the warp's `mine` bytes of shared memory (chain_warp_bytes).
// vec != 0: 16-byte aligned row copies. Lane 0 writes the per-event
// outputs; the event's overflow flags are returned (count_overflow adds them).
template <bool kFloatRow>
__device__ __forceinline__ ChainOverflow chain_event(const int16_t* __restrict__ waves_row,
                                                     int ev, int el_raw, float bl, int8_t pol,
                                                     const ChainOut& out, const ChainParams& P,
                                                     unsigned char* mine, int vec, int lane) {
  const int L = P.L;
  const int K = P.K;
  const int KH = P.K_hits;

  int16_t* row = reinterpret_cast<int16_t*>(mine);
  float* srow = reinterpret_cast<float*>(mine + row_bytes(L, 2));  // kFloatRow only
  int* cpos = reinterpret_cast<int*>(mine + row_bytes(L, 2) +
                                     (kFloatRow ? row_bytes(L, 4) : 0));
  float* cval = reinterpret_cast<float*>(cpos + 32);
  int* rs = reinterpret_cast<int*>(cval + 32);
  int* re = rs + 32;
  stage_row(row, waves_row, L, vec, lane);

  const int el = min(max(el_raw, 0), L);  // a length above L acts as L
  const float sign = pol > 0 ? 1.0f : -1.0f;  // polarity 0 -> -1
  const bool deriv = P.use_derivative != 0;
  const int det_len = deriv ? max(el - 1, 0) : el;
  const int det_cols = deriv ? L - 1 : L;  // columns of the detection grid

  auto wf = [&](int t) -> float { return (float)row[t]; };
  auto sig_of = [&](int t) -> float { return sign * (wf(t) - bl); };
  auto sig = [&](int t) -> float { return kFloatRow ? srow[t] : sig_of(t); };
  auto det = [&](int t) -> float { return deriv ? sign * (wf(t + 1) - wf(t)) : sig(t); };

  // ============================ features ===================================
  int min_h = 1 << 30, max_h = -(1 << 30), count_h = 0;
  int sum_a = 0, count_a = 0, mad = 0;  // exact ints (L < 65536)
  float bl_part = 0.0f;                 // width baseline: this lane's samples
  const int nb = min(P.baseline_samples, L);
  for (int t = lane; t < L; t += 32) {
    const int wt = row[t];
    if (t < el) {
      if (t >= P.height_start && t < P.height_end) {
        min_h = min(min_h, wt);
        max_h = max(max_h, wt);
        ++count_h;
      }
      if (t >= P.area_start) {
        sum_a += wt;
        ++count_a;
      }
      if (t >= 1) mad = max(mad, abs(wt - (int)row[t - 1]));
    }
    if (kFloatRow) {
      const float st = sig_of(t);
      srow[t] = st;
      if (t < nb) bl_part += st;
    } else if (t < nb) {
      bl_part += sig_of(t);
    }
  }
  if (kFloatRow) __syncwarp();
  min_h = __reduce_min_sync(kFull, min_h);
  max_h = __reduce_max_sync(kFull, max_h);
  count_h = __reduce_add_sync(kFull, count_h);
  sum_a = __reduce_add_sync(kFull, sum_a);
  count_a = __reduce_add_sync(kFull, count_a);
  mad = __reduce_max_sync(kFull, mad);

  const bool positive = sign > 0.0f;
  float height = 0.0f, amp = 0.0f, area = 0.0f;
  if (count_h > 0) {
    height = positive ? (float)max_h - bl : bl - (float)min_h;
    amp = (float)max_h - (float)min_h;
  }
  if (count_a > 0) {
    const float sa = (float)sum_a;
    const float cb = __fmul_rn((float)count_a, bl);
    area = positive ? __fsub_rn(sa, cb) : __fsub_rn(cb, sa);
  }

  // ============================ peaks ======================================
  const int n_cand = warp_candidates(det, det_len, K, P.peak_height, cpos, cval, lane);
  const int nc = min(n_cand, K);
  const bool cand = lane < nc;
  const int p = cand ? cpos[lane] : -1;
  const float v = cand ? cval[lane] : kNeg;
  const unsigned keep = warp_prune(p, v, cand, nc, P.peak_distance, lane);
  const PeakRule R{det_cols, P.peak_prominence, P.peak_width, P.rel_height};
  SlotResult res;
  for (unsigned todo = keep; todo; todo &= todo - 1) {
    const int s = __ffs(todo) - 1;
    const SlotResult r = walk_warp(det, __shfl_sync(kFull, p, s), __shfl_sync(kFull, v, s),
                                   det_len, R, lane);
    if (lane == s) res = r;
  }
  const unsigned final_valid = __ballot_sync(kFull, res.valid);
  const int n_peaks = __popc(final_valid);
  const bool has_peak = final_valid != 0u;

  // heights: max - min of the raw wave over the rounded ips window +- ext
  float ph = 0.0f;
  for (unsigned todo = final_valid; todo; todo &= todo - 1) {
    const int s = __ffs(todo) - 1;
    const float lip = __shfl_sync(kFull, res.lip, s);
    const float rip = __shfl_sync(kFull, res.rip, s);
    const int ws = max(min(max(__float2int_rn(lip), 0), L - 1) - P.height_ext, 0);
    const int we = min(min(max(__float2int_rn(rip), 0), L - 1) + P.height_ext, L);
    int mx = -(1 << 30), mn = 1 << 30;
    for (int t = ws + lane; t < we; t += 32) {
      const int wt = row[t];
      mx = max(mx, wt);
      mn = min(mn, wt);
    }
    mx = __reduce_max_sync(kFull, mx);
    mn = __reduce_min_sync(kFull, mn);
    if (lane == s && ws < we) ph = (float)(mx - mn);
  }
  // dominant peak: the largest height, the first slot among equals
  float best_v = res.valid ? ph : -kInf;
  int best_k = lane;
  warp_argmax(best_v, best_k);
  const int best_p = __shfl_sync(kFull, p, best_k);

  // ============================ threshold hits =============================
  const int n_runs = warp_runs(sig, P.hit_threshold, el, 0, rs, re, lane, true);
  const int nh = min(n_runs, KH);
  float hit_integral = 0.0f;
  for (int k = 0; k < nh; ++k) {  // the runs' extended windows, in slot order
    const int a = max(rs[k] - P.left_extension, 0);
    const int b = min(re[k] + P.right_extension, L);
    float hm;
    int hp;
    hit_integral += warp_segment<false>(sig, a, b, lane, hm, hp);
  }

  // ============================ widths + label =============================
  float rise_out = 0.0f, fall_out = 0.0f, width_samples = 0.0f;
  int8_t label = 0;
  if (has_peak) {
    const float bl_w = __fdiv_rn(warp_sum(bl_part), (float)nb);
    const int p_w = best_p;
    auto corr = [&](int t) -> float { return sig(t) - bl_w; };
    const float pv = corr(min(max(p_w, 0), L - 1));
    const bool valid_w = p_w >= 0 && p_w < L && pv > 0.0f;
    const float thr_lo = __fmul_rn(pv, P.rise_low);
    const float thr_hi = __fmul_rn(pv, P.rise_high);
    // first index in [0, p_w) with corr >= thr, first in [p_w, L) with
    // corr <= thr; L = not found
    int r_lo, r_hi, f_hi, f_lo;
    const int pe = max(p_w, 0);
    first_two(
        0, pe, lane, [&](int t) { return corr(t) >= thr_lo; },
        [&](int t) { return corr(t) >= thr_hi; }, r_lo, r_hi);
    if (r_lo == pe) r_lo = L;
    if (r_hi == pe) r_hi = L;
    first_two(
        pe, L, lane, [&](int t) { return corr(t) <= thr_hi; },
        [&](int t) { return corr(t) <= thr_lo; }, f_hi, f_lo);
    if (lane == 0) {
      // linear interpolation between samples idx-1 and idx
      auto cross = [&](int idx, float thr, bool may) -> float {
        const int is = min(max(idx, 1), L - 1);
        const float y0 = corr(is - 1);
        const float y1 = corr(is);
        const float denom = y1 - y0;
        const bool small = fabsf(denom) < 1e-10f;
        const float frac = small ? 0.0f : __fdiv_rn(thr - y0, denom);
        return (may && !small) ? (float)(is - 1) + frac : (float)idx;
      };
      const float rl = cross(r_lo, thr_lo, r_lo > 0);
      const float rh = cross(r_hi, thr_hi, r_hi > 0);
      const float fh = cross(f_hi, thr_hi, f_hi - p_w > 0);
      const float fl = cross(f_lo, thr_lo, f_lo - p_w > 0);
      if (r_lo < L && r_hi < L) rise_out = rh - rl;
      if (f_hi < L && f_lo < L) fall_out = fl - fh;
      if (valid_w && r_lo < L && f_lo < L) width_samples = fl - rl;
      if (width_samples > 0.0f) {
        if (width_samples <= P.s1_width_max) label = 1;
        else if (width_samples >= P.s2_width_min) label = 2;
      }
    }
  }

  if (lane == 0) {
    out.height[ev] = height;
    out.amp[ev] = amp;
    out.area[ev] = area;
    out.max_abs_diff[ev] = (float)mad;
    out.peak_position[ev] = has_peak ? best_p : -1;
    out.n_peaks[ev] = n_peaks;
    out.n_hits[ev] = nh;
    out.hit_integral[ev] = hit_integral;
    out.rise_samples[ev] = rise_out;
    out.fall_samples[ev] = fall_out;
    out.width_samples[ev] = width_samples;
    out.label[ev] = label;
  }
  return {n_cand > K, n_runs > KH};
}

// Lane 0 adds the event's overflow flags into ChainOut's counters: one
// atomic add a set flag (the benchmark's waves set 1 in 60 peak flags).
__device__ __forceinline__ void count_overflow(const ChainOut& out, ChainOverflow f, int lane) {
  if (lane == 0) {
    if (f.peaks) atomicAdd(out.n_peak_overflow, 1);
    if (f.hits) atomicAdd(out.n_hit_overflow, 1);
  }
}

// Zeroes ChainOut's two adjacent counters on `stream` (one memset) before
// the kernel counts into them; cudaErrorInvalidValue where they are not
// adjacent.
inline cudaError_t zero_overflow(const ChainOut* out, cudaStream_t stream) {
  if (out->n_hit_overflow != out->n_peak_overflow + 1) return cudaErrorInvalidValue;
  return cudaMemsetAsync(out->n_peak_overflow, 0, 2 * sizeof(int32_t), stream);
}

}  // namespace wfa
