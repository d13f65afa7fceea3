// The fused per-event chain with the event's row in the warp's registers,
// one warp per event, for rows of L <= 256 samples: features -> scipy-parity
// find_peaks -> threshold-hit runs -> 10-90% widths -> S1/S2 label. Used
// only by the chain kernel (chain_scan.cu, K1); the staged chain of
// warp_chain.cuh (K1's long rows, K7) and the find_peaks / hit kernels (K2,
// K3) keep their own passes.
//
// Why. The staged chain is bound by the instructions it issues, not by its
// bytes: every pass walks the row 32 samples a step, and each step loads a
// sample from shared memory, converts it and forms the signal again, then
// votes; each kept peak's six searches loop the same way. Here lane j holds
// the R = 1, 2, 4 or 8 contiguous samples [R j, R j + R) (R * 32 >= L),
// converted to the float32 signal sign * (w - bl) once. A pass over the row
// is straight-line work on a lane's R registers, then a fixed number of
// cross-lane steps, however far it reaches:
//
//   features  min / max / sum / max |diff| over the lane's samples in exact
//             int32 (the diff at the lane's first sample takes the previous
//             lane's last one by one shuffle), then one __reduce_*_sync
//             each; the two counts are arithmetic on the ranges
//   peaks     candidate scan: in-lane differences, the last nonzero
//             difference carried across lanes by one ballot and one
//             shuffle, a lane's falls after a rise found by one carry over
//             its zero differences and visited bit by bit, the ranks by an
//             exclusive popcount of the lanes' candidate counts
//             (bit-sliced ballots). Pruning is
//             warp_peaks.cuh's lane-per-slot warp_prune where one ballot
//             finds two candidates closer than the distance. Each kept slot's
//             walks are searches over the whole row in one step each: a
//             lane's R compares give a bit mask, masked by the search's
//             range, and one __reduce_max_sync / __reduce_min_sync gives
//             the nearest sample; the bases' arg-min takes the lane's
//             masked minimum, one reduction of its order-preserving int key
//             and one of the index among equal values (the tie-breaks of
//             walk_warp). A slot whose prominence falls short is left there:
//             its bases and crossings cannot make it valid. Where two or
//             more slots are kept, a slot below the highest kept one first
//             bounds its prominence by the samples between the two, read 32
//             at a time from the shared copy, and does not walk at all
//             where the bound falls short
//   hits      the on mask of the lane's samples; a run's start and end are
//             its edges, with the neighbours' edge bits by two ballots,
//             visited bit by bit; the ranks by an exclusive popcount as above
//   heights   max - min of the raw wave over each valid peak's window, the
//             lane's samples masked by the window, one reduction each
//   widths    the four first crossings around the dominant peak by four
//             masks and reductions; four lanes interpolate one each, one
//             labels
//
// Values at a runtime index (a candidate's x(t - 1), the screen's samples,
// the ips' x(jl), x(jl + 1), ..., the width crossings' neighbours) are read
// from a float32 copy of the signal (and of the detection values with
// use_derivative) that the load writes to shared memory once; nothing else
// reads shared memory but the 32-entry slot tables.
//
// Exactness: as warp_chain.cuh (--fmad=false, IEEE division, rounding half
// to even, the _rn intrinsics, the same float operations on the same
// values), with two sums in another order: each lane adds its contiguous
// samples, then a butterfly (the staged chain adds lane-strided samples).
// Both are float32 sums of the signal that the contract holds within a
// tolerance: the width baseline and hit_integral (whose runs' windows are
// also added per lane before the one butterfly). On integer-valued signals
// (an integer baseline) both are exact in any order.
//
// ops/chain_scan_cuda.py (reg_warp_bytes, chain_layout) mirrors the per-warp
// byte count: keep them in step.

#pragma once

#include "warp_peaks.cuh"

namespace wfa {

// per warp: candidate position / value and run start / end tables
constexpr int kRegSlotBytes = 4 * 32 * 4;

// shared memory of one warp in the register chain: the float32 signal row
// of 32 R samples, the detection row beside it with use_derivative, and the
// slot tables
__host__ __device__ __forceinline__ int reg_warp_bytes(int R, bool deriv) {
  return 32 * R * 4 * (deriv ? 2 : 1) + kRegSlotBytes;
}

// int key whose order is the float order of x (no NaN); -0 and +0 share it
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x + 0.0f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Bits i of a lane's R samples t = base + i with lo <= t < hi.
template <int R>
__device__ __forceinline__ unsigned span_bits(int base, int lo, int hi) {
  const int a = min(max(lo - base, 0), R);
  const int b = min(max(hi - base, 0), R);
  return ((1u << b) - 1u) & ~((1u << a) - 1u);
}

// Warp-wide nearest set sample: the largest (kLast) or smallest sample t =
// base + i of the set bits of every lane's mask; `none` where no lane has one.
template <bool kLast>
__device__ __forceinline__ int warp_nearest(unsigned m, int base, int none) {
  if (kLast) return __reduce_max_sync(kFull, m ? base + 31 - __clz(m) : none);
  return __reduce_min_sync(kFull, m ? base + __ffs(m) - 1 : none);
}

// Warp-wide minimum of x over the samples of the masks `in` (nonempty in
// some lane); every lane returns it.
template <int R>
__device__ __forceinline__ float warp_masked_min(const float (&x)[R], unsigned in) {
  float m = kInf;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (in >> i & 1u) m = fminf(m, x[i]);
  return key_value(__reduce_min_sync(kFull, order_key(m)));
}

// Warp-wide sample of value v among the samples of the masks `in`: the
// largest when kLast, else the smallest (the arg-min's tie-break when v is
// their minimum). Every lane returns it.
template <int R, bool kLast>
__device__ __forceinline__ int warp_sample_of(const float (&x)[R], unsigned in, int base,
                                              float v) {
  unsigned eq = 0u;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (x[i] == v) eq |= 1u << i;
  return warp_nearest<kLast>(eq & in, base, kLast ? -1 : 1 << 30);
}

// A lane's R floats to shared `dst` (R-float aligned), in vector stores.
template <int R>
__device__ __forceinline__ void store_lane(float* dst, const float (&v)[R]) {
  if constexpr (R >= 4) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      reinterpret_cast<float4*>(dst)[i / 4] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// Exclusive prefix over the lanes of a per-lane count below 2^kBits, and
// the total, by one ballot per bit.
template <int kBits>
__device__ __forceinline__ int lane_prefix(int c, int lane, int& total) {
  int before = 0;
  total = 0;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const unsigned m = __ballot_sync(kFull, c >> b & 1);
    before += __popc(m & lanes_below(lane)) << b;
    total += __popc(m) << b;
  }
  return before;
}

// bits that hold a lane's count of at most ceil(R / 2) candidates or runs
template <int R>
constexpr int kCountBits = R >= 8 ? 3 : R >= 4 ? 2 : 1;

// What chain_event_regs returns, the same on every lane: the event's
// overflow flags, and the kept slots the prominence screen took off the
// walks (the kernel drops the count; the warp emulator sums it).
struct RegChainResult {
  ChainOverflow overflow;
  int screened;
};

// The chain of event `ev`, whose int16 row of L <= 32 R samples starts at
// `waves_row` in global memory, with the warp's `mine` bytes of shared
// memory (reg_warp_bytes). vec != 0: the row and its base are 16-byte
// aligned and L % 8 == 0 (one vector load a lane). Lane 0 writes the
// per-event outputs; the event's overflow flags (the kernel counts them,
// warp_chain.cuh's count_overflow) and screened slots are returned.
template <int R, bool kDeriv>
__device__ __forceinline__ RegChainResult chain_event_regs(const int16_t* __restrict__ waves_row,
                                                           int ev, int el_raw, float bl,
                                                           int8_t pol, const ChainOut& out,
                                                           const ChainParams& P,
                                                           unsigned char* mine, int vec,
                                                           int lane) {
  const int L = P.L;
  const int K = P.K;
  const int KH = P.K_hits;
  const int base = lane * R;

  float* srow = reinterpret_cast<float*>(mine);           // the signal, 32 R
  float* drow = kDeriv ? srow + 32 * R : srow;            // the detection values
  int* cpos = reinterpret_cast<int*>(srow + 32 * R * (kDeriv ? 2 : 1));
  float* cval = reinterpret_cast<float*>(cpos + 32);
  int* rs = reinterpret_cast<int*>(cval + 32);
  int* re = rs + 32;

  // ============================ load =======================================
  int w[R];  // the raw samples; 0 past L
  if (vec) {  // L % 8 == 0: a lane's samples lie all before L or all past it
    const char* src = reinterpret_cast<const char*>(waves_row + base);
    unsigned q[(R + 1) / 2] = {};
    if (base < L) {
      if constexpr (R == 8) {
        const int4 v4 = __ldg(reinterpret_cast<const int4*>(src));
        q[0] = v4.x;
        q[1] = v4.y;
        q[2] = v4.z;
        q[3] = v4.w;
      } else if constexpr (R == 4) {
        const int2 v2 = __ldg(reinterpret_cast<const int2*>(src));
        q[0] = v2.x;
        q[1] = v2.y;
      } else if constexpr (R == 2) {
        q[0] = __ldg(reinterpret_cast<const int*>(src));
      } else {
        q[0] = (unsigned short)__ldg(waves_row + base);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = (int)(short)(q[i / 2] >> (16 * (i % 2)));
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = base + i < L ? (int)__ldg(waves_row + base + i) : 0;
  }

  const int el = min(max(el_raw, 0), L);  // a length above L acts as L
  const float sign = pol > 0 ? 1.0f : -1.0f;  // polarity 0 -> -1
  const int det_len = kDeriv ? max(el - 1, 0) : el;
  const int det_cols = kDeriv ? L - 1 : L;  // columns of the detection grid
  const int nb = min(P.baseline_samples, L);

  // ============================ features ===================================
  // the passes below take a range of samples as a bit mask of the lane's
  const int hs = max(P.height_start, 0);
  const int as = max(P.area_start, 0);
  const unsigned in_el = span_bits<R>(base, 0, el);
  const unsigned in_h = in_el & span_bits<R>(base, hs, P.height_end);
  const unsigned in_a = span_bits<R>(base, as, el);
  const unsigned in_d = in_el & (lane ? ~0u : ~1u);  // t >= 1
  int min_h = 1 << 30, max_h = -(1 << 30), sum_a = 0, mad = 0;  // exact ints
  {
    const int wprev = __shfl_up_sync(kFull, w[R - 1], 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (in_h >> i & 1u) {
        min_h = min(min_h, w[i]);
        max_h = max(max_h, w[i]);
      }
      if (in_a >> i & 1u) sum_a += w[i];
      if (in_d >> i & 1u) mad = max(mad, abs(w[i] - (i ? w[i - 1] : wprev)));
    }
  }
  min_h = __reduce_min_sync(kFull, min_h);
  max_h = __reduce_max_sync(kFull, max_h);
  sum_a = __reduce_add_sync(kFull, sum_a);
  mad = __reduce_max_sync(kFull, mad);
  const int count_h = max(min(P.height_end, el) - hs, 0);
  const int count_a = max(el - as, 0);

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

  // the signal (and detection values), once; the shared copies
  float s[R];
  float dv[R];
  float bl_part = 0.0f;  // width baseline: this lane's samples, in order
  {
    const int wnext = __shfl_down_sync(kFull, w[0], 1);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] = sign * ((float)w[i] - bl);
      if (base + i < nb) bl_part += s[i];
      if (kDeriv) dv[i] = sign * ((float)(i + 1 < R ? w[i + 1] : wnext) - (float)w[i]);
    }
  }
  const float(&x)[R] = kDeriv ? dv : s;  // the detection grid
  store_lane<R>(srow + base, s);
  if (kDeriv) store_lane<R>(drow + base, dv);
  __syncwarp();

  // ============================ peaks ======================================
  // candidate scan: plateau midpoints, the first K in order, the count uncapped
  int n_cand;
  {
    const float xprev = __shfl_up_sync(kFull, x[R - 1], 1);
    // difference d[t] = x[t] - x[t - 1] != 0, > 0, for 1 <= t < det_len
    const unsigned in_det = span_bits<R>(base, 1, det_len);
    unsigned nz = 0u, up = 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float d = x[i] - (i ? x[i - 1] : xprev);
      nz |= d != 0.0f ? 1u << i : 0u;
      up |= d > 0.0f ? 1u << i : 0u;
    }
    nz &= in_det;
    up &= in_det;
    // the last nonzero difference before this lane: 2 t + rise, or -2 (no
    // rise, as an even code)
    const int j = nz ? 31 - __clz(nz) : 0;
    const int enc = nz ? 2 * (base + j) + (int)(up >> j & 1u) : -2;
    const unsigned has = __ballot_sync(kFull, nz != 0u) & lanes_below(lane);
    const int from = __shfl_sync(kFull, enc, has ? 31 - __clz(has) : lane);
    const int carry = has ? from : -2;
    // The nonzero differences whose last nonzero difference before them
    // rises: a carry from each rise (and from a rising carry, at bit 0) runs
    // up the zero differences and stops at the next nonzero one. Of them the
    // falls end a plateau [rise, t - 1]: its midpoint is a candidate where
    // it lies in [1, det_len - 2] at or above the height. A lane has few,
    // so it visits them bit by bit, reading x[t - 1] from the shared copy.
    const unsigned after_rise =
        (((~nz & ((1u << R) - 1u)) + (up << 1) + (unsigned)(carry & 1)) & nz) & ~up;
    auto plateau_mid = [&](int i) -> int {
      const unsigned before = nz & ((1u << i) - 1u);
      const int rise = before ? base + 31 - __clz(before) : carry >> 1;
      return (rise + base + i - 1) >> 1;
    };
    unsigned em = 0u;
    for (unsigned m = after_rise; m; m &= m - 1u) {
      const int i = __ffs(m) - 1;
      const int mid = plateau_mid(i);
      if (mid >= 1 && mid <= det_len - 2 && drow[base + i - 1] >= P.peak_height) em |= 1u << i;
    }
    int r = lane_prefix<kCountBits<R>>(__popc(em), lane, n_cand);
    for (unsigned m = em; m && r < K; m &= m - 1u, ++r) {
      const int i = __ffs(m) - 1;
      cpos[r] = plateau_mid(i);
      cval[r] = drow[base + i - 1];
    }
  }
  __syncwarp();
  const int nc = min(n_cand, K);
  const bool cand = lane < nc;
  const int p = cand ? cpos[lane] : -1;
  const float v = cand ? cval[lane] : kNeg;
  // The candidates lie in ascending order, at least 2 samples apart: where
  // no two neighbours are closer than the distance, the greedy pruning keeps
  // them all, and only otherwise runs (always, at distance <= 2).
  const int p_next = __shfl_down_sync(kFull, p, 1);
  const unsigned keep = __ballot_sync(kFull, lane + 1 < nc && p_next - p < P.peak_distance)
                            ? warp_prune(p, v, cand, nc, P.peak_distance, lane)
                            : __ballot_sync(kFull, cand);
  const PeakRule PR{det_cols, P.peak_prominence, P.peak_width, P.rel_height};
  auto xat = [&](int t) -> float { return drow[t]; };
  // The prominence screen. Where two or more slots are kept (the branch is
  // warp-uniform), take v_max, the highest kept value, and p_m, the first
  // kept slot at it. A slot of value v < v_max has a higher sample at or
  // before p_m on p_m's side, so that side's minimum is at least g, the
  // minimum of x between p and p_m (both included), and its prominence at
  // most v - g (float subtraction is monotone). Where v - g is below the
  // prominence, that is where no sample s between them has v - x(s) at or
  // above it, the walk would leave at its prominence test: the slot does not
  // walk. The samples are read from the shared copy, 32 at a time from p
  // towards p_m, until one is low enough; the others walk as before.
  float v_max = kNeg;  // no slot lies below it where fewer than two are kept
  int pm = 0;
  if (keep & (keep - 1u)) {
    const bool kept = keep >> lane & 1u;
    const int vkey = __reduce_max_sync(kFull, order_key(kept ? v : kNeg));
    pm = __reduce_min_sync(kFull, kept && order_key(v) == vkey ? p : 1 << 30);
    v_max = key_value(vkey);
  }
  int screened = 0;
  SlotResult res;
  for (unsigned todo = keep; todo; todo &= todo - 1) {
    const int sl = __ffs(todo) - 1;
    const int ps = __shfl_sync(kFull, p, sl);
    const float vs = __shfl_sync(kFull, v, sl);
    if (vs < v_max) {
      const int dir = ps < pm ? 1 : -1;
      const int n = abs(pm - ps) + 1;  // samples from p to p_m
      bool low = false;
      for (int j = 0; !low && j < n; j += 32) {
        const int t = j + lane;
        low = __ballot_sync(kFull, t < n && vs - drow[ps + dir * t] >= PR.prominence) != 0u;
      }
      if (!low) {
        ++screened;
        continue;
      }
    }
    unsigned hi = 0u;  // samples above the peak
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (x[i] > vs) hi |= 1u << i;
    // nearest higher sample left of p (-1: none) and right (det_len: none)
    const int jhl = warp_nearest<true>(hi & span_bits<R>(base, 0, ps), base, -1);
    const int jhr =
        warp_nearest<false>(hi & span_bits<R>(base, ps + 1, det_len), base, det_len);
    // the minimum over (jhl, p] and over [p, jhr)
    const unsigned lspan = span_bits<R>(base, jhl + 1, ps + 1);
    const unsigned rspan = span_bits<R>(base, ps, jhr);
    const float lmin = warp_masked_min<R>(x, lspan);
    const float rmin = warp_masked_min<R>(x, rspan);
    // finish_slot's first test: a slot below the prominence is not valid, and
    // its bases and crossings are not needed (the branch is warp-uniform)
    if (!(vs - fmaxf(lmin, rmin) >= PR.prominence)) continue;
    // the bases: the left minimum closest to p among equals, the first right
    const int lbase = warp_sample_of<R, true>(x, lspan, base, lmin);
    const int rbase = warp_sample_of<R, false>(x, rspan, base, rmin);
    const float hev = rel_height_level(vs, vs - fmaxf(lmin, rmin), PR.rel_height);
    unsigned lo = 0u;  // samples at or below the evaluation height
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (x[i] <= hev) lo |= 1u << i;
    // the last sample <= hev in [lbase, p], the first in [p, rbase]
    const int jl = warp_nearest<true>(lo & span_bits<R>(base, lbase, ps + 1), base, -1);
    const int jr = warp_nearest<false>(lo & span_bits<R>(base, ps, rbase + 1), base, det_cols);
    const SlotResult rr = finish_slot(xat, vs, lmin, lbase, rmin, rbase, jl, jr, hev, PR);
    if (lane == sl) res = rr;
  }
  const unsigned final_valid = __ballot_sync(kFull, res.valid);
  const int n_peaks = __popc(final_valid);
  const bool has_peak = final_valid != 0u;

  // heights: max - min of the raw wave over the rounded ips window +- ext
  float ph = 0.0f;
  for (unsigned todo = final_valid; todo; todo &= todo - 1) {
    const int sl = __ffs(todo) - 1;
    const float lip = __shfl_sync(kFull, res.lip, sl);
    const float rip = __shfl_sync(kFull, res.rip, sl);
    const int ws = max(min(max(__float2int_rn(lip), 0), L - 1) - P.height_ext, 0);
    const int we = min(min(max(__float2int_rn(rip), 0), L - 1) + P.height_ext, L);
    const unsigned in = span_bits<R>(base, ws, we);
    int mx = -(1 << 30), mn = 1 << 30;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (in >> i & 1u) {
        mx = max(mx, w[i]);
        mn = min(mn, w[i]);
      }
    }
    mx = __reduce_max_sync(kFull, mx);
    mn = __reduce_min_sync(kFull, mn);
    if (lane == sl && ws < we) ph = (float)(mx - mn);
  }
  // dominant peak: the largest height, the first slot among equals
  const int hk = order_key(res.valid ? ph : -kInf);
  const int hmax = __reduce_max_sync(kFull, hk);
  const int best_k = __reduce_min_sync(kFull, hk == hmax ? lane : 32);
  const int best_p = __shfl_sync(kFull, p, best_k);

  // ============================ threshold hits =============================
  int n_runs;
  {
    unsigned on = 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) on |= s[i] >= P.hit_threshold ? 1u << i : 0u;
    on &= in_el;
    const unsigned lasts = __ballot_sync(kFull, on >> (R - 1) & 1u);
    const unsigned firsts = __ballot_sync(kFull, on & 1u);
    const unsigned before_on = lane ? (lasts >> (lane - 1)) & 1u : 0u;
    const unsigned after_on = lane < 31 ? (firsts >> (lane + 1)) & 1u : 0u;
    const unsigned starts = on & ~((on << 1) | before_on);
    const unsigned ends = on & ~((on >> 1) | (after_on << (R - 1)));  // run ends after t
    const int r0 = lane_prefix<kCountBits<R>>(__popc(starts), lane, n_runs);
    for (unsigned m = starts; m; m &= m - 1u) {
      const int k = r0 + __popc(starts & ((1u << (__ffs(m) - 1)) - 1u));
      if (k < KH) rs[k] = base + __ffs(m) - 1;
    }
    for (unsigned m = ends; m; m &= m - 1u) {
      // the run started last, at or before t, ends at t + 1 (exclusive)
      const int i = __ffs(m) - 1;
      const int k = r0 + __popc(starts & ((2u << i) - 1u)) - 1;
      if (k < KH) re[k] = base + i + 1;
    }
  }
  __syncwarp();
  const int nh = min(n_runs, KH);
  // the runs' extended windows in slot order, each lane's samples added in
  // order, then one butterfly
  float hit_acc = 0.0f;
  for (int k = 0; k < nh; ++k) {
    const int a = max(rs[k] - P.left_extension, 0);
    const int b = min(re[k] + P.right_extension, L);
    const unsigned in = span_bits<R>(base, a, b);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (in >> i & 1u) hit_acc += fmaxf(s[i], 0.0f);
  }
  const float hit_integral = warp_sum(hit_acc);

  // ============================ widths + label =============================
  float rise_out = 0.0f, fall_out = 0.0f, width_samples = 0.0f;
  int8_t label = 0;
  if (has_peak) {
    const float bl_w = __fdiv_rn(warp_sum(bl_part), (float)nb);
    const int p_w = best_p;
    auto corr = [&](int t) -> float { return srow[t] - bl_w; };
    const float pv = corr(min(max(p_w, 0), L - 1));
    const bool valid_w = p_w >= 0 && p_w < L && pv > 0.0f;
    const float thr_lo = __fmul_rn(pv, P.rise_low);
    const float thr_hi = __fmul_rn(pv, P.rise_high);
    // first index in [0, p_w) with corr >= thr, first in [p_w, L) with
    // corr <= thr; L = not found
    const int pe = max(p_w, 0);
    unsigned ge_lo = 0u, ge_hi = 0u, le_hi = 0u, le_lo = 0u;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float c = s[i] - bl_w;
      if (c >= thr_lo) ge_lo |= 1u << i;
      if (c >= thr_hi) ge_hi |= 1u << i;
      if (c <= thr_hi) le_hi |= 1u << i;
      if (c <= thr_lo) le_lo |= 1u << i;
    }
    const unsigned rise = span_bits<R>(base, 0, pe);
    const unsigned fall = span_bits<R>(base, pe, L);
    const int r_lo = warp_nearest<false>(ge_lo & rise, base, L);
    const int r_hi = warp_nearest<false>(ge_hi & rise, base, L);
    const int f_hi = warp_nearest<false>(le_hi & fall, base, L);
    const int f_lo = warp_nearest<false>(le_lo & fall, base, L);
    // the four crossings, one a lane (lanes 0-3 in the order rise low, rise
    // high, fall high, fall low): linear interpolation between samples
    // idx - 1 and idx
    const int q = lane & 3;
    const int idx = q == 0 ? r_lo : q == 1 ? r_hi : q == 2 ? f_hi : f_lo;
    const float thr = q == 0 || q == 3 ? thr_lo : thr_hi;
    const bool may = q < 2 ? idx > 0 : idx - p_w > 0;
    const int is = min(max(idx, 1), L - 1);
    const float y0 = corr(is - 1);
    const float y1 = corr(is);
    const float denom = y1 - y0;
    const bool small = fabsf(denom) < 1e-10f;
    const float frac = small ? 0.0f : __fdiv_rn(thr - y0, denom);
    const float c = (may && !small) ? (float)(is - 1) + frac : (float)idx;
    const float rl = __shfl_sync(kFull, c, 0);
    const float rh = __shfl_sync(kFull, c, 1);
    const float fh = __shfl_sync(kFull, c, 2);
    const float fl = __shfl_sync(kFull, c, 3);
    if (lane == 0) {
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
  return {{n_cand > K, n_runs > KH}, screened};
}

}  // namespace wfa
