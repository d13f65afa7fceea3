// Fused per-event chain on Hopper (sm_90a): features -> scipy-parity
// find_peaks -> threshold-hit runs -> 10-90% widths -> S1/S2 label.
// The candidate emission, distance pruning and ips interpolation are the
// shared steps of scan_common.cuh.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py
// (_chain_scan_kernel); its contract is models/full_chain.py
// (full_chain_step), whose PyTorch port is the plain version this kernel is
// tested against (ops/chain_scan_cuda.py).
//
// Design. One thread per event. The wrapper hands the wave matrix over
// time-major, (L, n) int16 (a waves.t().contiguous() copy on the device),
// so at each sample step the threads of a warp read neighbouring events:
// one 64-byte coalesced load per warp and step. Each thread walks its
// event's samples in a few passes and keeps its per-event carries and its
// K-slot tables (peak candidates, hit runs, prominence and crossing state)
// in registers: the slot count is a template parameter and every slot loop
// is unrolled, so slot indices are compile-time constants.
//
//   pass 1   features, threshold-run count, plateau peak-candidate emission
//   pass 1h  hit-run slots (extended-segment integrals)        [if any run]
//   pruning  greedy distance pruning by height priority        [per event]
//   pass 2   prominence bases                                  [if any peak]
//   pass 3   rel-height crossings for the interpolated ips     [if any peak]
//   heights  min/max of the raw wave over each rounded ips window +- 4
//   widths   10/90% crossings around the dominant peak, S1/S2 label
//
// What bounds it on this card: not HBM. At 65536 x 256 the input is 32 MB
// and stays in the 50 MB L2, so the later passes re-read it from L2; each
// pass is a serial, data-dependent carry chain of ~10-60 dependent
// operations per sample and slot, and the slot state of the deep passes
// (5K and 7K values) competes for registers. The design answers with
// independent events per thread (no cross-thread communication at all), an
// unrolled fixed-size slot state so it can live in registers, and skips
// where a thread's event has no run / no candidate (the TPU kernel's
// per-block pass gates, here per thread; outputs do not depend on them).
// Passes whose result depends on one index (the dominant peak's value, a
// height window, a crossing walk) read that index directly instead of
// scanning the whole wave, which the TPU kernel could not do.
//
// Exactness. Positions, counts, validity and labels come from float32
// comparisons of interpolated values, so the build uses --fmad=false (no
// contraction of a product into a following add), IEEE division (no
// fast-math), and rounding half to even (__float2int_rn) like jnp.round /
// torch.round. The sentinels are +-3e38 as in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using wfa::kInf;
using wfa::kNeg;

template <int KT>
__global__ void __launch_bounds__(128)
chain_scan_kernel(const int16_t* __restrict__ w, const int32_t* __restrict__ el_in,
                  const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                  ChainOut out, ChainParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;
  const int L = P.L;
  const int K = P.K;
  const int KH = P.K_hits;

  const int el = el_in[i];
  const float bl = bl_in[i];
  const float sign = pol_in[i] > 0 ? 1.0f : -1.0f;  // polarity 0 -> -1
  const bool deriv = P.use_derivative != 0;
  const int det_len = deriv ? max(el - 1, 0) : el;

  auto wv = [&](int t) -> float { return (float)w[(size_t)t * n + i]; };
  auto sig_at = [&](int t) -> float { return sign * (wv(t) - bl); };
  // detection value at det index t (NEG beyond det_len)
  auto x_at = [&](int t) -> float {
    if (t >= det_len) return kNeg;
    return deriv ? sign * (wv(min(t + 1, L - 1)) - wv(t)) : sig_at(t);
  };

  // ============================ pass 1 =====================================
  int min_h = 1 << 30, max_h = -(1 << 30), count_h = 0;
  int sum_a = 0, count_a = 0, mad = 0;  // exact ints (L < 65536)
  float bl_w_sum = 0.0f;
  const int nb = min(P.baseline_samples, L);
  bool prev_on = false, prev_rise = false;
  int n_runs = 0, left_edge = 0, cand_count = 0;
  int pos[KT];
  float val[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    pos[k] = -1;
    val[k] = kNeg;
  }
  int w_prev = w[i];
  for (int t = 0; t < L; ++t) {
    const int w_t = w[(size_t)t * n + i];
    const bool valid_t = t < el;
    const float sig_t = sign * ((float)w_t - bl);
    if (valid_t) {
      if (t >= P.height_start && t < P.height_end) {
        min_h = min(min_h, w_t);
        max_h = max(max_h, w_t);
        ++count_h;
      }
      if (t >= P.area_start) {
        sum_a += w_t;
        ++count_a;
      }
      if (t >= 1) mad = max(mad, abs(w_t - w_prev));
    }
    if (t < nb) bl_w_sum += sig_t;

    const bool on = valid_t && sig_t >= P.hit_threshold;
    n_runs += (on && !prev_on);
    prev_on = on;

    // plateau peak candidates on the detection grid
    const int i_det = deriv ? t - 1 : t;
    float cur_x, prev_xv;
    if (deriv) {
      cur_x = x_at(max(i_det, 0));
      prev_xv = x_at(max(i_det - 1, 0));
    } else {
      cur_x = t < det_len ? sig_t : kNeg;
      prev_xv = max(t - 1, 0) < det_len ? sign * ((float)w_prev - bl) : kNeg;
    }
    wfa::candidate_step<KT>(i_det, cur_x, prev_xv, det_len, K, P.peak_height, pos,
                            val, cand_count, left_edge, prev_rise);
    w_prev = w_t;
  }

  // ============================ pass 1h: hit-run slots =====================
  int n_hits = 0;
  float hit_integral = 0.0f;
  if (n_runs > 0) {
    int seg_s[KT], seg_e[KT];
    float acc[KT];
    unsigned started = 0u, ended = 0u;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      seg_s[k] = L + 16;
      seg_e[k] = L + 16;
      acc[k] = 0.0f;
    }
    bool prev_on_h = false;
    int run_idx = 0;
    for (int t = 0; t < L; ++t) {
      const float sig_t = sig_at(t);
      const float sp_t = fmaxf(sig_t, 0.0f);
      const bool on = (t < el) && sig_t >= P.hit_threshold;
      const bool is_start = on && !prev_on_h;
      const bool ended_prev = prev_on_h && !on;  // run's exclusive end = t
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const unsigned b = 1u << k;
        if (k < KH && ended_prev && (started & b) && !(ended & b) && run_idx == k + 1) {
          seg_e[k] = min(t + P.right_extension, L);
          ended |= b;
        }
      }
      if (is_start) {
        float retro = 0.0f;  // left-extension samples before the run
        for (int back = 1; back <= P.left_extension; ++back) {
          if (t - back >= 0) retro += fmaxf(sig_at(t - back), 0.0f);
        }
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          if (k < KH && run_idx == k) {
            seg_s[k] = max(t - P.left_extension, 0);
            started |= 1u << k;
            acc[k] += retro;
          }
        }
        if (run_idx < KH) ++run_idx;
      }
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const unsigned b = 1u << k;
        if ((started & b) && t >= seg_s[k] && (!(ended & b) || t < seg_e[k])) acc[k] += sp_t;
      }
      prev_on_h = on;
    }
    // a started run is always valid: closed during the walk or open to L
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (started & (1u << k)) {
        ++n_hits;
        hit_integral += acc[k];
      }
    }
  }

  // ============================ features combine ===========================
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

  // ============================ distance pruning ===========================
  const unsigned cand_valid = wfa::distance_prune<KT>(
      pos, val, wfa::candidate_mask<KT>(cand_count, K), P.peak_distance);

  // ============================ passes 2 + 3 ===============================
  float prom[KT], lip[KT], rip[KT];
  unsigned final_valid = 0u;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    prom[k] = 0.0f;
    lip[k] = 0.0f;
    rip[k] = 0.0f;
  }
  if (cand_valid) {
    // pass 2: left base = last minimum since the last higher sample before
    // the peak; right base = first minimum before the next higher sample
    float lmin[KT], rmin[KT];
    int lbase[KT], rbase[KT];
    unsigned nh = 0u;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      lmin[k] = kInf;
      rmin[k] = kInf;
      lbase[k] = 0;
      rbase[k] = L;
    }
    for (int t = 0; t < L; ++t) {
      const float x_t = x_at(t);
      const bool in_det = t < det_len;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (!(cand_valid >> k & 1u)) continue;
        const int p = pos[k];
        const float v = val[k];
        const bool before = t < p;
        if (before && x_t > v) {
          lmin[k] = kInf;
          lbase[k] = t + 1;
        }
        if ((before || t == p) && in_det && x_t <= lmin[k]) {
          lbase[k] = t;
          lmin[k] = x_t;
        }
        if (t > p && x_t > v) nh |= 1u << k;
        if (t >= p && !(nh >> k & 1u) && in_det && x_t < rmin[k]) {
          rbase[k] = t;
          rmin[k] = x_t;
        }
      }
    }

    // pass 3: rel-height crossings with the interpolation samples
    float h_eval[KT];
    int jl[KT], jr[KT];
    float xl[KT], xl1[KT], xr[KT], xr1[KT];
    unsigned arm = 0u;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      prom[k] = val[k] - fmaxf(lmin[k], rmin[k]);
      h_eval[k] = wfa::rel_height_level(val[k], prom[k], P.rel_height);
      jl[k] = -1;
      jr[k] = L;
      xl[k] = kNeg;
      xl1[k] = kNeg;
      xr[k] = kNeg;
      xr1[k] = kNeg;
    }
    float x_p = x_at(0);
    for (int t = 0; t < L; ++t) {
      const float x_t = x_at(t);
      const bool in_det = t < det_len;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (!(cand_valid >> k & 1u)) continue;
        const unsigned b = 1u << k;
        const int p = pos[k];
        if ((arm & b) && t == jl[k] + 1) {
          xl1[k] = x_t;
          arm &= ~b;
        }
        const bool below = x_t <= h_eval[k];
        if (below && t >= lbase[k] && t <= p && in_det) {
          jl[k] = t;
          xl[k] = x_t;
          arm |= b;
        }
        if (below && t >= p && t <= rbase[k] && in_det && jr[k] >= L) {
          jr[k] = t;
          xr[k] = x_t;
          xr1[k] = x_p;
        }
      }
      x_p = x_t;
    }

#pragma unroll
    for (int k = 0; k < KT; ++k) {
      if (!(cand_valid >> k & 1u)) {
        prom[k] = 0.0f;
        continue;
      }
      lip[k] = wfa::left_ips(jl[k], xl[k], xl1[k], h_eval[k], lbase[k]);
      rip[k] = wfa::right_ips(jr[k], xr[k], xr1[k], h_eval[k], rbase[k], L);
      if (prom[k] >= P.peak_prominence && rip[k] - lip[k] >= P.peak_width)
        final_valid |= 1u << k;
    }
  }
  const int n_peaks = __popc(final_valid);

  // ============================ peak heights + dominant peak ===============
  float best_v = -kInf;
  int best_p = pos[0];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (!(final_valid >> k & 1u)) continue;
    const int ws = max(min(max(__float2int_rn(lip[k]), 0), L - 1) - P.height_ext, 0);
    const int we = min(min(max(__float2int_rn(rip[k]), 0), L - 1) + P.height_ext, L);
    float ph = 0.0f;
    if (ws < we) {
      float mx = -kInf, mn = kInf;
      for (int t = ws; t < we; ++t) {
        const float v = wv(t);
        mx = fmaxf(mx, v);
        mn = fminf(mn, v);
      }
      ph = mx - mn;
    }
    if (ph > best_v) {
      best_v = ph;
      best_p = pos[k];
    }
  }
  const bool has_peak = final_valid != 0u;

  // ============================ widths + label =============================
  float rise_out = 0.0f, fall_out = 0.0f, width_samples = 0.0f;
  int8_t label = 0;
  if (has_peak) {
    const float bl_w = __fdiv_rn(bl_w_sum, (float)nb);
    const int p_w = best_p;
    auto corr = [&](int t) -> float { return sig_at(t) - bl_w; };
    const float pv = corr(min(max(p_w, 0), L - 1));
    const bool valid_w = p_w >= 0 && p_w < L && pv > 0.0f;
    const float thr_lo = __fmul_rn(pv, P.rise_low);
    const float thr_hi = __fmul_rn(pv, P.rise_high);

    // first index in [0, p_w) with corr >= thr, first in [p_w, L) with
    // corr <= thr; L = not found
    int r_lo = L, r_hi = L, f_hi = L, f_lo = L;
    for (int t = 0; t < p_w && r_lo == L; ++t) {
      if (corr(t) >= thr_lo) r_lo = t;
    }
    for (int t = 0; t < p_w && r_hi == L; ++t) {
      if (corr(t) >= thr_hi) r_hi = t;
    }
    for (int t = max(p_w, 0); t < L && f_hi == L; ++t) {
      if (corr(t) <= thr_hi) f_hi = t;
    }
    for (int t = max(p_w, 0); t < L && f_lo == L; ++t) {
      if (corr(t) <= thr_lo) f_lo = t;
    }
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

  out.height[i] = height;
  out.amp[i] = amp;
  out.area[i] = area;
  out.max_abs_diff[i] = (float)mad;
  out.peak_position[i] = has_peak ? best_p : -1;
  out.n_peaks[i] = n_peaks;
  out.n_hits[i] = n_hits;
  out.hit_integral[i] = hit_integral;
  out.rise_samples[i] = rise_out;
  out.fall_samples[i] = fall_out;
  out.width_samples[i] = width_samples;
  out.label[i] = label;
  out.n_candidates[i] = cand_count;
  out.n_runs[i] = n_runs;
}

}  // namespace

// Launches the chain on `stream` for P->n events of P->L samples.
// waves_t is the (L, n) time-major int16 matrix. Slot tables hold up to 32
// peaks and 32 runs. Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_chain_scan(const int16_t* waves_t, const int32_t* event_length,
                              const float* baselines, const int8_t* polarity_codes,
                              const ChainOut* out, const ChainParams* P, void* stream) {
  if (P->n <= 0) return 0;
  const int kt = max(P->K, P->K_hits);
  const dim3 block(128);
  const dim3 grid((P->n + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P->K < 1 || P->K_hits < 1 || kt > 32) return (int)cudaErrorInvalidValue;
  if (kt <= 8) {
    chain_scan_kernel<8><<<grid, block, 0, s>>>(waves_t, event_length, baselines,
                                                 polarity_codes, *out, *P);
  } else if (kt <= 16) {
    chain_scan_kernel<16><<<grid, block, 0, s>>>(waves_t, event_length, baselines,
                                                  polarity_codes, *out, *P);
  } else {
    chain_scan_kernel<32><<<grid, block, 0, s>>>(waves_t, event_length, baselines,
                                                  polarity_codes, *out, *P);
  }
  return (int)cudaGetLastError();
}
