// Fused per-event chain on Hopper (sm_90a), one warp per event on the
// event-major int16 rows: features -> scipy-parity find_peaks ->
// threshold-hit runs -> 10-90% widths -> S1/S2 label.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py:90
// (_chain_scan_kernel); its contract is models/full_chain.py
// (full_chain_step), whose PyTorch port is the plain version this kernel is
// tested against (ops/chain_scan_cuda.py).
//
// What bounds it on this card: bytes. The int16 row is read once (2 L
// bytes) and 53 bytes per event are written: 0.0112 ms at 65,536 x 256 and
// 0.180 ms at 1,048,576 x 256 at 3.35 TB/s.
//
// Design. One warp owns one event, `rows` events a block. The warp stages
// its event's int16 row in shared memory once, read straight from the
// event-major (n, L) matrix (no transposing copy; 16-byte cp.async where
// rows are 16-byte aligned), and forms every float it needs from it at each
// read: the signal sign * (w - bl) and the detection value (the signal, or
// sign * (w[t + 1] - w[t]) with use_derivative). No float copy of the row is
// kept, so a warp holds 2 L + 512 bytes of shared memory. Every pass takes
// 32 samples a step, lane j on sample b + j (conflict-free reads), and is
// built from the warp parts the other kernels use:
//
//   features  min / max / sum / count / max |diff| in exact int32 by warp
//             reductions; the width baseline's f32 sum as the tile chain
//             kernel (chain_tile.cu) forms it (lane-strided, then a
//             butterfly)
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
// The earlier design (one thread per event on a time-major copy that the
// wrapper made, with the slot tables in registers: 128 of them at K = 8)
// spent almost as long on the copy as in the kernel at 1M events (PERF.md).
//
// Exactness. Positions, counts, validity and labels come from float32
// comparisons of interpolated values, so the build uses --fmad=false (no
// contraction of a product into a following add), IEEE division (no
// fast-math), and rounding half to even (__float2int_rn) like jnp.round /
// torch.round. The sentinels are +-3e38 as in the JAX package. `area` sums
// the valid samples in int32, exact for L < 65536.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_hits.cuh"
#include "warp_peaks.cuh"

namespace {

using wfa::kFull;
using wfa::kInf;
using wfa::kNeg;

// per warp: candidate position / value and run start / end tables
constexpr int kSlotBytes = 4 * 32 * 4;

__global__ void __launch_bounds__(256)
chain_warp_kernel(const int16_t* __restrict__ waves, const int32_t* __restrict__ el_in,
                  const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                  ChainOut out, ChainParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const int L = P.L;
  const int K = P.K;
  const int KH = P.K_hits;

  unsigned char* mine = smem + warp * wfa::warp_bytes(L, 2, 1, kSlotBytes);
  int16_t* row = reinterpret_cast<int16_t*>(mine);
  int* cpos = reinterpret_cast<int*>(mine + wfa::row_bytes(L, 2));
  float* cval = reinterpret_cast<float*>(cpos + 32);
  int* rs = reinterpret_cast<int*>(cval + 32);
  int* re = rs + 32;
  wfa::stage_row(row, waves + (size_t)ev * L, L, vec, lane);

  const int el = min(max(el_in[ev], 0), L);  // a length above L acts as L
  const float bl = bl_in[ev];
  const float sign = pol_in[ev] > 0 ? 1.0f : -1.0f;  // polarity 0 -> -1
  const bool deriv = P.use_derivative != 0;
  const int det_len = deriv ? max(el - 1, 0) : el;
  const int det_cols = deriv ? L - 1 : L;  // columns of the detection grid

  auto wf = [&](int t) -> float { return (float)row[t]; };
  auto sig = [&](int t) -> float { return sign * (wf(t) - bl); };
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
    if (t < nb) bl_part += sig(t);
  }
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
  const int n_cand = wfa::warp_candidates(det, det_len, K, P.peak_height, cpos, cval, lane);
  const int nc = min(n_cand, K);
  const bool cand = lane < nc;
  const int p = cand ? cpos[lane] : -1;
  const float v = cand ? cval[lane] : kNeg;
  const unsigned keep = wfa::warp_prune(p, v, cand, nc, P.peak_distance, lane);
  const wfa::PeakRule R{det_cols, P.peak_prominence, P.peak_width, P.rel_height};
  wfa::SlotResult res;
  for (unsigned todo = keep; todo; todo &= todo - 1) {
    const int s = __ffs(todo) - 1;
    const wfa::SlotResult r = wfa::walk_warp(det, __shfl_sync(kFull, p, s),
                                             __shfl_sync(kFull, v, s), det_len, R, lane);
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
  wfa::warp_argmax(best_v, best_k);
  const int best_p = __shfl_sync(kFull, p, best_k);

  // ============================ threshold hits =============================
  const int n_runs = wfa::warp_runs(sig, P.hit_threshold, el, 0, rs, re, lane, true);
  const int nh = min(n_runs, KH);
  float hit_integral = 0.0f;
  for (int k = 0; k < nh; ++k) {  // the runs' extended windows, in slot order
    const int a = max(rs[k] - P.left_extension, 0);
    const int b = min(re[k] + P.right_extension, L);
    float hm;
    int hp;
    hit_integral += wfa::warp_segment<false>(sig, a, b, lane, hm, hp);
  }

  // ============================ widths + label =============================
  float rise_out = 0.0f, fall_out = 0.0f, width_samples = 0.0f;
  int8_t label = 0;
  if (has_peak) {
    const float bl_w = __fdiv_rn(wfa::warp_sum(bl_part), (float)nb);
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
    wfa::first_two(
        0, pe, lane, [&](int t) { return corr(t) >= thr_lo; },
        [&](int t) { return corr(t) >= thr_hi; }, r_lo, r_hi);
    if (r_lo == pe) r_lo = L;
    if (r_hi == pe) r_hi = L;
    wfa::first_two(
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
    out.n_candidates[ev] = n_cand;
    out.n_runs[ev] = n_runs;
  }
}

}  // namespace

// Launches the chain on `stream` for P->n events of P->L samples, `rows`
// events (warps) per block. waves is the event-major (n, L) int16 matrix;
// vec != 0 promises 16-byte aligned rows (L % 8 == 0 and an aligned base).
// Slot tables hold up to 32 peaks and 32 runs; the rows always fit shared
// memory (L < 65536). ops/chain_scan_cuda.py::row_layout picks rows and vec.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_chain_scan(const int16_t* waves, const int32_t* event_length,
                              const float* baselines, const int8_t* polarity_codes,
                              const ChainOut* out, const ChainParams* P, int rows, int vec,
                              void* stream) {
  if (P->n <= 0) return 0;
  const int smem = rows * wfa::warp_bytes(P->L, 2, 1, kSlotBytes);
  if (P->K < 1 || P->K_hits < 1 || P->K > 32 || P->K_hits > 32 || P->L < 2 || rows < 1 ||
      rows > 8 || smem > wfa::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  chain_warp_kernel<<<grid, 32 * rows, smem, static_cast<cudaStream_t>(stream)>>>(
      waves, event_length, baselines, polarity_codes, *out, *P, vec);
  return (int)cudaGetLastError();
}
