// Fused per-event chain on Hopper (sm_90a), one warp per event on the
// event-major rows: features -> scipy-parity find_peaks -> threshold-hit
// runs -> 10-90% widths -> S1/S2 label.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_pallas.py:80
// (_chain_kernel, the tile-resident chain); its contract is
// models/full_chain.py (full_chain_step), whose PyTorch port is the plain
// version this kernel is tested against (ops/chain_tile_cuda.py).
//
// Design. The TPU kernel loads an (R, L) tile into VMEM once and computes
// the chain with log-depth shift scans along the sample axis and one-hot
// masked reductions (the TPU has no lane gather). Here one warp owns one
// event and a block holds `rows` events. The warp stages its event's row in
// shared memory once, read straight from the event-major (n, L) int16
// matrix (no transposing copy): one 16-byte load per lane where rows are
// 16-byte aligned (L % 8 == 0), else 2-byte loads, 64 contiguous bytes per
// warp and step either way. It keeps the row as float32 `w` and the float32
// detection signal `x` (8 L bytes per event; rows are skewed by one word
// per 32 so both the strided and the chunked access patterns below are free
// of bank conflicts). Then:
//
//   chunks   lane j owns samples [j C, (j + 1) C), C = ceil(L / 32)
//   scans    the packed last-nonzero-difference cummax and the candidate /
//            run ranks: each lane scans its chunk serially, lanes exchange
//            carries with __shfl_up_sync, a second walk applies them
//            (integers, exact in any order)
//   slots    the first K candidates and K_hits runs land in per-warp slot
//            tables in shared memory (the TPU's one-hot extracts become
//            plain loads); lane k owns candidate slot k and run slot k
//   pruning  greedy distance pruning on the K slots (wfa::distance_prune,
//            one lane; the same keep set as the TPU kernel's rank loop)
//   peaks    lane k walks the row for its slot's prominence bases,
//            rel-height crossings and raw-wave height window
//   widths   the four first crossings around the dominant peak by warp
//            min-reductions; one lane interpolates and labels, in the
//            order the TPU kernel writes it
//
// What bounds it on this card: by bytes, the row is read once (2 L bytes)
// and 53 bytes per event are written: 0.0112 ms at 65,536 x 256 and
// 0.180 ms at 1,048,576 x 256 at 3.35 TB/s. The design answers with one
// coalesced read of each row into shared memory, after which every pass
// and every walk reads shared memory only; the output is one 4-byte store
// per field and event. The slot walks are serial per lane and their length
// depends on the data (a tall peak's left base walk runs to the row start).
//
// Exactness. Built with --fmad=false and without fast-math; products and
// quotients that decide positions and labels use the _rn intrinsics,
// rounding is half to even (__float2int_rn, as jnp.round), and the
// sentinels are +-3e38 with the TPU kernel's arithmetic on them (NEG - NEG
// = 0, the 0.0 fill after the last sample). `area` sums the valid samples
// in int32, exact for L < 65536.
//
// Shared memory: event_bytes(L) per event (float32 w and x rows with the
// skew, plus four 32-entry slot tables); one event of up to L = 28,113
// samples fits the 227 KB a block can use. The wrapper lowers the events per
// block where `rows` events do not fit and raises beyond that L.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

namespace {

using wfa::kInf;
using wfa::kNeg;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use

// floats of one skewed row; sample t lives at t + t / 32
__host__ __device__ __forceinline__ int row_floats(int L) { return L + (L >> 5) + 1; }
__device__ __forceinline__ int sk(int t) { return t + (t >> 5); }
// one event: w row, x row, candidate pos / val and run start / end tables
__host__ __device__ __forceinline__ int event_bytes(int L) {
  return 4 * (2 * row_floats(L) + 4 * 32);
}

// exclusive prefix over lanes: max (identity -1) and sum (identity 0)
__device__ __forceinline__ int excl_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, u);
  }
  const int e = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? -1 : e;
}

__device__ __forceinline__ int excl_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  const int e = __shfl_up_sync(kFull, v, 1);
  return lane == 0 ? 0 : e;
}

// butterfly sum: every lane ends with the same value (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int KT>
__global__ void __launch_bounds__(1024)
chain_tile_kernel(const int16_t* __restrict__ waves, const int32_t* __restrict__ el_in,
                  const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                  ChainOut out, ChainParams P, int vec) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const int L = P.L;
  const int K = P.K;
  const int KH = P.K_hits;

  float* ws = smem + warp * (event_bytes(L) / 4);
  float* xs = ws + row_floats(L);
  int* cpos = reinterpret_cast<int*>(xs + row_floats(L));
  float* cval = reinterpret_cast<float*>(cpos + 32);
  int* rs = reinterpret_cast<int*>(cval + 32);
  int* re = rs + 32;

  const int el = el_in[ev];
  const float bl = bl_in[ev];
  const float sign = pol_in[ev] > 0 ? 1.0f : -1.0f;  // polarity 0 -> -1
  const bool deriv = P.use_derivative != 0;
  const int det_len = deriv ? max(el - 1, 0) : el;

  // ============================ stage the row ==============================
  const int16_t* row = waves + (size_t)ev * L;
  if (vec) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (int q = lane; q < (L >> 3); q += 32) {
      const int4 v = __ldg(row4 + q);
      const int16_t* h = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) ws[sk(8 * q + j)] = (float)h[j];
    }
  } else {
    for (int t = lane; t < L; t += 32) ws[sk(t)] = (float)__ldg(row + t);
  }
  __syncwarp();
  // x = sign * (w - bl), or sign * (w[t + 1] - w[t]) with a 0.0 fill after
  // the last sample; NEG beyond det_len
  for (int t = lane; t < L; t += 32) {
    float xv = kNeg;
    if (t < det_len) {
      const float wt = ws[sk(t)];
      const float wn = t + 1 < L ? ws[sk(t + 1)] : 0.0f;
      xv = deriv ? sign * (wn - wt) : sign * (wt - bl);
    }
    xs[sk(t)] = xv;
  }
  __syncwarp();

  auto sig = [&](int t) -> float { return sign * (ws[sk(t)] - bl); };
  auto hit_on = [&](int t) -> bool { return t < el && sig(t) >= P.hit_threshold; };
  // d2[i] = x[i + 1] - x[i] on i < L - 1 (the TPU kernel's on_diff)
  auto d2_at = [&](int i) -> float { return xs[sk(i + 1)] - xs[sk(i)]; };
  // plateau right edge at i given the packed code before i: candidate
  // midpoint, or -1
  auto peak_mid = [&](int i, int prev_ff, float d) -> int {
    if (!(d < 0.0f) || prev_ff < 0 || !(prev_ff & 1)) return -1;
    const int mid = ((prev_ff >> 1) + 1 + i) >> 1;
    if (mid > det_len - 2 || mid < 1 || i > det_len - 2) return -1;
    return xs[sk(i)] >= P.peak_height ? mid : -1;
  };

  const int C = (L + 31) >> 5;
  const int c0 = min(lane * C, L);
  const int c1 = min(c0 + C, L);
  const int cd1 = min(c1, L - 1);  // differences exist below L - 1

  // ============================ scan 1: packed cummax carry ================
  int last_pk = -1;  // the chunk's last nonzero difference, packed
  for (int i = cd1 - 1; i >= c0; --i) {
    const float d = d2_at(i);
    if (d != 0.0f) {
      last_pk = 2 * i + (d > 0.0f);
      break;
    }
  }
  const int ff_in = excl_max(last_pk, lane);

  // ============================ walk 1: features and counts ================
  int min_h = 1 << 30, max_h = -(1 << 30), count_h = 0;
  int sum_a = 0, count_a = 0, mad = 0;  // exact ints (L < 65536)
  int n_cand_l = 0, n_start_l = 0;
  {
    int ff = ff_in;
    for (int i = c0; i < c1; ++i) {
      const int wi = (int)ws[sk(i)];
      if (i < el) {
        if (i >= P.height_start && i < P.height_end) {
          min_h = min(min_h, wi);
          max_h = max(max_h, wi);
          ++count_h;
        }
        if (i >= P.area_start) {
          sum_a += wi;
          ++count_a;
        }
        if (i >= 1) mad = max(mad, abs(wi - (int)ws[sk(i - 1)]));
      }
      if (i < cd1) {
        const float d = d2_at(i);
        n_cand_l += peak_mid(i, ff, d) >= 0;
        if (d != 0.0f) ff = 2 * i + (d > 0.0f);
      }
      n_start_l += hit_on(i) && !(i > 0 && hit_on(i - 1));
    }
  }
  min_h = __reduce_min_sync(kFull, min_h);
  max_h = __reduce_max_sync(kFull, max_h);
  count_h = __reduce_add_sync(kFull, count_h);
  sum_a = __reduce_add_sync(kFull, sum_a);
  count_a = __reduce_add_sync(kFull, count_a);
  mad = __reduce_max_sync(kFull, mad);
  const int n_cand = __reduce_add_sync(kFull, n_cand_l);
  const int n_runs = __reduce_add_sync(kFull, n_start_l);

  // ============================ walk 2: slot tables ========================
  if (n_cand > 0 || n_runs > 0) {
    int rk = excl_sum(n_cand_l, lane);   // rank of the next candidate
    int rr = excl_sum(n_start_l, lane);  // runs started before it
    int ff = ff_in;
    for (int i = c0; i < c1; ++i) {
      if (i < cd1) {
        const float d = d2_at(i);
        const int mid = peak_mid(i, ff, d);
        if (mid >= 0) {
          if (rk < K) {
            cpos[rk] = mid;
            cval[rk] = xs[sk(i)];  // the plateau value at its right edge
          }
          ++rk;
        }
        if (d != 0.0f) ff = 2 * i + (d > 0.0f);
      }
      const bool on = hit_on(i);
      if (on && !(i > 0 && hit_on(i - 1))) {
        if (rr < KH) rs[rr] = i;
        ++rr;
      }
      // the end of a run belongs to the last run started at or before it
      if (on && !(i + 1 < L && hit_on(i + 1)) && rr - 1 < KH) re[rr - 1] = i + 1;
    }
  }
  __syncwarp();

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
  const int nc = min(n_cand, K);
  unsigned cand_valid = nc >= 32 ? kFull : (1u << nc) - 1u;
  if (P.peak_distance > 1 && nc > 0) {
    unsigned keep = 0u;
    if (lane == 0) {
      int pos[KT];
      float val[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        pos[k] = k < nc ? cpos[k] : -1;
        val[k] = k < nc ? cval[k] : kNeg;
      }
      keep = wfa::distance_prune<KT>(pos, val, cand_valid, P.peak_distance);
    }
    cand_valid = __shfl_sync(kFull, keep, 0);
  }

  // ============================ per-slot peak walks ========================
  // lane k: prominence bases, rel-height ips, raw-wave window height
  const int dl = min(det_len, L);
  int p = -1;
  float ph = 0.0f;
  bool fv = false;
  if (cand_valid >> lane & 1u) {
    p = cpos[lane];
    const float v = cval[lane];
    // left base: the last minimum since the last higher sample before p
    float lmin = kInf;
    int lbase = -1;
    for (int j = p; j >= 0; --j) {
      const float xj = xs[sk(j)];
      if (j < p && xj > v) break;
      if (xj < lmin) {
        lmin = xj;
        lbase = j;
      }
    }
    lbase = max(lbase, 0);
    // right base: the first minimum before the next higher sample
    float rmin = kInf;
    int rbase = L;
    for (int j = p; j < dl; ++j) {
      const float xj = xs[sk(j)];
      if (j > p && xj > v) break;
      if (xj < rmin) {
        rmin = xj;
        rbase = j;
      }
    }
    const float prom = v - fmaxf(lmin, rmin);
    const float hev = wfa::rel_height_level(v, prom, P.rel_height);
    int jl = -1;
    for (int j = p; j >= lbase; --j) {
      if (xs[sk(j)] <= hev) {
        jl = j;
        break;
      }
    }
    const int jls = min(max(jl, 0), L - 2);
    const float lip = wfa::left_ips(jl, xs[sk(jls)], xs[sk(jls + 1)], hev, lbase);
    int jr = L;
    for (int j = p; j <= min(rbase, dl - 1); ++j) {
      if (xs[sk(j)] <= hev) {
        jr = j;
        break;
      }
    }
    const int jrs = min(max(jr, 1), L - 1);
    const float rip = wfa::right_ips(jr, xs[sk(jrs)], xs[sk(jrs - 1)], hev, rbase, L);
    fv = prom >= P.peak_prominence && rip - lip >= P.peak_width;
    if (fv) {  // max - min of the raw wave over the rounded ips window +- ext
      const int ws0 = max(min(max(__float2int_rn(lip), 0), L - 1) - P.height_ext, 0);
      const int we0 = min(min(max(__float2int_rn(rip), 0), L - 1) + P.height_ext, L);
      if (ws0 < we0) {
        float mx = -kInf, mn = kInf;
        for (int t = ws0; t < we0; ++t) {
          const float wt = ws[sk(t)];
          mx = fmaxf(mx, wt);
          mn = fminf(mn, wt);
        }
        ph = mx - mn;
      }
    }
  }
  const unsigned final_valid = __ballot_sync(kFull, fv);
  const int n_peaks = __popc(final_valid);
  const bool has_peak = final_valid != 0u;

  // dominant peak: the largest height, the first slot among equals
  float best_v = fv ? ph : -kInf;
  int best_k = lane;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best_v, o);
    const int ok = __shfl_xor_sync(kFull, best_k, o);
    if (ov > best_v || (ov == best_v && ok < best_k)) {
      best_v = ov;
      best_k = ok;
    }
  }
  const int best_p = __shfl_sync(kFull, p, best_k);

  // ============================ threshold hits =============================
  // lane k integrates run k's extended window; lane 0 adds the runs in order
  const int nh = min(n_runs, KH);
  float integ = 0.0f;
  if (lane < nh) {
    const int a = max(rs[lane] - P.left_extension, 0);
    const int b = min(re[lane] + P.right_extension, L);
    for (int t = a; t < b; ++t) integ += fmaxf(sig(t), 0.0f);
  }
  float hit_integral = 0.0f;
  for (int k = 0; k < nh; ++k) hit_integral += __shfl_sync(kFull, integ, k);

  // ============================ widths + label =============================
  float rise_out = 0.0f, fall_out = 0.0f, width_samples = 0.0f;
  int8_t label = 0;
  if (has_peak) {
    const int nb = min(P.baseline_samples, L);
    float s = 0.0f;
    for (int t = lane; t < nb; t += 32) s += sig(t);
    const float bl_w = __fdiv_rn(warp_sum(s), (float)nb);
    const int p_w = best_p;
    auto corr = [&](int t) -> float { return sig(t) - bl_w; };
    const float pv = corr(min(max(p_w, 0), L - 1));
    const bool valid_w = p_w >= 0 && p_w < L && pv > 0.0f;
    const float thr_lo = __fmul_rn(pv, P.rise_low);
    const float thr_hi = __fmul_rn(pv, P.rise_high);
    // first index in [0, p_w) with corr >= thr, first in [p_w, L) with
    // corr <= thr; L = not found
    int r_lo = L, r_hi = L, f_hi = L, f_lo = L;
    for (int t = c0; t < c1; ++t) {
      const float c = corr(t);
      if (t < p_w) {
        if (r_lo == L && c >= thr_lo) r_lo = t;
        if (r_hi == L && c >= thr_hi) r_hi = t;
      } else {
        if (f_hi == L && c <= thr_hi) f_hi = t;
        if (f_lo == L && c <= thr_lo) f_lo = t;
      }
    }
    r_lo = __reduce_min_sync(kFull, r_lo);
    r_hi = __reduce_min_sync(kFull, r_hi);
    f_hi = __reduce_min_sync(kFull, f_hi);
    f_lo = __reduce_min_sync(kFull, f_lo);
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
    out.n_candidates[ev] = n_cand;
    out.n_runs[ev] = n_runs;
  }
}

template <int KT>
int launch(const int16_t* waves, const int32_t* el, const float* bl, const int8_t* pol,
           const ChainOut* out, const ChainParams* P, int rows, int vec, cudaStream_t s) {
  const int smem = rows * event_bytes(P->L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_tile_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  chain_tile_kernel<KT><<<grid, 32 * rows, smem, s>>>(waves, el, bl, pol, *out, *P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the chain on `stream` for P->n events of P->L samples, `rows`
// events (warps) per block. waves is the event-major (n, L) int16 matrix;
// vec != 0 promises 16-byte aligned rows (L % 8 == 0 and an aligned base).
// Slot tables hold up to 32 peaks and 32 runs; `rows` events must fit the
// block's shared memory (ops/chain_tile_cuda.py::rows_per_block mirrors
// event_bytes). Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_chain_tile(const int16_t* waves, const int32_t* event_length,
                              const float* baselines, const int8_t* polarity_codes,
                              const ChainOut* out, const ChainParams* P, int rows, int vec,
                              void* stream) {
  if (P->n <= 0) return 0;
  if (P->K < 1 || P->K_hits < 1 || P->K > 32 || P->K_hits > 32 || P->L < 2 || rows < 1 ||
      rows > 32 || rows * event_bytes(P->L) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P->K <= 8)
    return launch<8>(waves, event_length, baselines, polarity_codes, out, P, rows, vec, s);
  if (P->K <= 16)
    return launch<16>(waves, event_length, baselines, polarity_codes, out, P, rows, vec, s);
  return launch<32>(waves, event_length, baselines, polarity_codes, out, P, rows, vec, s);
}
