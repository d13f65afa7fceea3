// scipy-parity find_peaks on one event's row, one warp per event: the
// candidate scan, the distance pruning and the prominence / rel-height
// walks of the find_peaks kernel (peaks_scan.cu), shared with the chain
// kernels (warp_chain.cuh), which run them on their detection signal.
//
// Each pass takes the row as an accessor `x(t)` (a float from shared or
// global memory, or a value formed from the staged int16 wave at each read)
// and the event's valid length `det_len`: samples at or past it are never
// read as signal. The arithmetic is find_peaks_batch's (ops/peaks.py), with
// the shared steps of scan_common.cuh; build with --fmad=false.
//
//   candidates  32 samples a step, lane j on sample t = b + j: the
//               difference d[t] = x[t] - x[t - 1], two ballots (d != 0,
//               d > 0) give each lane the last nonzero difference before t
//               (its index and direction, which the TPU kernel carries in a
//               packed cummax), a third the plateau right edges; their
//               exclusive popcount is the candidate rank. The first K
//               plateau midpoints land in a per-warp slot table, in order;
//               the count is not capped.
//   pruning     lane k owns slot k (K <= 32). Each lane ranks its slot by
//               priority (value descending, the higher slot first among
//               equals); the warp walks the ranks in order, the owner
//               broadcasts its position if it is still kept and the lanes
//               within `distance` drop themselves: the keep set of the
//               greedy one-thread O(K^2) loop, without that loop.
//   walks       the left and right bases (nearest higher sample, then the
//               minimum since it) and the rel-height crossings: the warp
//               searches one kept slot at a time, 32 samples a step (a
//               ballot for the nearest higher sample or the crossing, a warp
//               min-reduction with an index tie-break for the base). Lane k
//               walking slot k serially was 46 % slower on the H100
//               (PERF.md): a tall peak's left-base walk runs to the row
//               start while the other lanes idle.
//
// Ties (the int16 waves make equal samples common): the left base is the
// minimum closest to the peak, the right base the first minimum, both walks
// stop at the first sample strictly higher than the peak, the left crossing
// is the last sample <= the evaluation height in [lbase, p], the right one
// the first in [p, rbase].

#pragma once

#include "scan_common.cuh"
#include "warp_rows.cuh"

namespace wfa {

// The find_peaks criteria a walk needs; L is the row's length (the
// detection grid's, which the right ips falls back to).
struct PeakRule {
  int L;
  float prominence, width, rel_height;
};

// One slot's prominence bases, rel-height ips and validity.
struct SlotResult {
  float prom = 0.0f, lip = 0.0f, rip = 0.0f;
  int lbase = 0, rbase = 0;
  bool valid = false;
};

// Candidate scan over [0, det_len): the first K plateau midpoints (position,
// value at the plateau's right edge) land in cpos / cval in order; returns
// the uncapped count. The whole warp calls it; the tables are visible to
// every lane on return.
template <typename X>
__device__ __forceinline__ int warp_candidates(X x, int det_len, int K, float height, int* cpos,
                                               float* cval, int lane) {
  int count = 0;   // candidates so far (uncapped)
  int carry = -1;  // the last nonzero difference before this step: 2 t + rise
  for (int b = 0; b < det_len; b += 32) {
    const int t = b + lane;
    const bool in = t >= 1 && t < det_len;
    const float prev = in ? x(t - 1) : 0.0f;
    const float d = in ? x(t) - prev : 0.0f;
    const unsigned nz = __ballot_sync(kFull, in && d != 0.0f);
    const unsigned up = __ballot_sync(kFull, in && d > 0.0f);
    int ff = carry;
    const unsigned before = nz & lanes_below(lane);
    if (before) {
      const int j = 31 - __clz(before);
      ff = 2 * (b + j) + (int)(up >> j & 1u);
    }
    // a fall after a rise: the plateau [ff / 2, t - 1] ends at t - 1
    int mid = 0;
    bool emit = false;
    if (in && d < 0.0f && ff >= 0 && (ff & 1)) {
      mid = ((ff >> 1) + t - 1) / 2;
      emit = mid >= 1 && mid <= det_len - 2 && prev >= height;
    }
    const unsigned em = __ballot_sync(kFull, emit);
    if (emit) {
      const int r = count + __popc(em & lanes_below(lane));
      if (r < K) {
        cpos[r] = mid;
        cval[r] = prev;
      }
    }
    count += __popc(em);
    if (nz) {
      const int j = 31 - __clz(nz);
      carry = 2 * (b + j) + (int)(up >> j & 1u);
    }
  }
  __syncwarp();
  return count;
}

// Greedy distance pruning by priority; lane k holds slot k (position p,
// value v, `cand` for the first nc slots). Returns the kept slots' mask.
__device__ __forceinline__ unsigned warp_prune(int p, float v, bool cand, int nc, int distance,
                                               int lane) {
  unsigned keep = __ballot_sync(kFull, cand);
  if (distance > 1 && nc > 1) {
    // rank: slots of higher priority (a larger value; the higher slot
    // among equal values)
    int rank = 0;
    for (int b = 0; b < nc; ++b) {
      const float vb = __shfl_sync(kFull, v, b);
      rank += (vb > v) || (vb == v && b > lane);
    }
    bool kept = cand;
    for (int r = 0; r < nc; ++r) {
      const unsigned owner = __ballot_sync(kFull, cand && rank == r);
      if (!owner) continue;
      const int o = __ffs(owner) - 1;
      const bool o_kept = __shfl_sync(kFull, (int)kept, o) != 0;
      const int po = __shfl_sync(kFull, p, o);
      if (o_kept && lane != o && abs(p - po) < distance) kept = false;
    }
    keep = __ballot_sync(kFull, kept);
  }
  return keep;
}

// ips and validity from the walks' results (the slot owner's arithmetic)
template <typename X>
__device__ __forceinline__ SlotResult finish_slot(X x, float v, float lmin, int lbase, float rmin,
                                                  int rbase, int jl, int jr, float hev,
                                                  const PeakRule& R) {
  SlotResult r;
  r.prom = v - fmaxf(lmin, rmin);
  r.lbase = lbase;
  r.rbase = rbase;
  r.lip = jl >= 0 ? left_ips(jl, x(jl), x(jl + 1), hev, lbase) : (float)lbase;
  r.rip = jr < R.L ? right_ips(jr, x(jr), x(jr - 1), hev, rbase, R.L) : (float)rbase;
  r.valid = r.prom >= R.prominence && r.rip - r.lip >= R.width;
  return r;
}

// Warp walks: slot (p, v) searched by the whole warp, 32 samples a step;
// every lane returns the same result.
template <typename X>
__device__ __forceinline__ SlotResult walk_warp(X x, int p, float v, int det_len,
                                                const PeakRule& R, int lane) {
  // nearest higher sample left of p (-1: none), then the minimum over
  // (jh, p], the one closest to p among equals
  int jh = -1;
  for (int hi = p - 1; hi >= 0; hi -= 32) {
    const int t = hi - lane;
    const unsigned m = __ballot_sync(kFull, t >= 0 && x(t) > v);
    if (m) {
      jh = hi - (__ffs(m) - 1);
      break;
    }
  }
  float lmin = kInf;
  int lbase = -1;
  for (int t = jh + 1 + lane; t <= p; t += 32) {
    const float xt = x(t);
    if (xt <= lmin) {  // t rises: the later sample wins a tie
      lmin = xt;
      lbase = t;
    }
  }
  warp_argmin(lmin, lbase, true);
  // nearest higher sample right of p (det_len: none), then the minimum over
  // [p, jh), the first among equals
  jh = det_len;
  for (int lo = p + 1; lo < det_len; lo += 32) {
    const int t = lo + lane;
    const unsigned m = __ballot_sync(kFull, t < det_len && x(t) > v);
    if (m) {
      jh = lo + __ffs(m) - 1;
      break;
    }
  }
  float rmin = kInf;
  int rbase = 1 << 30;
  for (int t = p + lane; t < jh; t += 32) {
    const float xt = x(t);
    if (xt < rmin) {
      rmin = xt;
      rbase = t;
    }
  }
  warp_argmin(rmin, rbase, false);
  const float hev = rel_height_level(v, v - fmaxf(lmin, rmin), R.rel_height);
  int jl = -1;
  for (int hi = p; hi >= lbase; hi -= 32) {
    const int t = hi - lane;
    const unsigned m = __ballot_sync(kFull, t >= lbase && x(t) <= hev);
    if (m) {
      jl = hi - (__ffs(m) - 1);
      break;
    }
  }
  int jr = R.L;
  for (int lo = p; lo <= rbase; lo += 32) {
    const int t = lo + lane;
    const unsigned m = __ballot_sync(kFull, t <= rbase && x(t) <= hev);
    if (m) {
      jr = lo + __ffs(m) - 1;
      break;
    }
  }
  return finish_slot(x, v, lmin, lbase, rmin, rbase, jl, jr, hev, R);
}

}  // namespace wfa
