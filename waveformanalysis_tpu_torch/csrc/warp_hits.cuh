// Threshold runs on one event's row, one warp per event: the run pass and
// the segment pass of the threshold-hit kernel (hits_scan.cu), shared with
// the chain kernels (warp_chain.cuh), which run them on their polarity-
// normalised signal.
//
// A run is a maximal stretch of samples t < el with x(t) >= thr; its
// segment extends it by the caller's extensions, clipped to [0, L).
//
//   runs      32 samples a step, lane j on sample t = b + j: one ballot of
//             the on mask; run starts and ends are its on-edges, with the
//             previous step's last bit carried in; their exclusive popcount
//             plus the running count is the run's rank. The bounds of the
//             runs ranked [k0, k0 + 32) land in a per-warp slot table; the
//             count is not capped. No serial walk.
//   segments  one slot at a time, the warp reads the segment 32 samples a
//             step: the first maximum by a warp arg-max with an index
//             tie-break (the smallest index wins, as np.argmax) and the
//             integral of max(x, 0) by a warp sum. A run can cover the whole
//             row (dense noise, a long S2), so no lane walks a slot alone.
//
// The integral's order of summation is the warp's (each lane in sample
// order, then a butterfly), not the serial order of the plain version's
// torch.sum: f32 values agree within rounding.

#pragma once

#include "scan_common.cuh"
#include "warp_rows.cuh"

namespace wfa {

// Run pass over [0, el): the starts and exclusive ends of the runs ranked
// [k0, k0 + 32) land in rs / re (slot r - k0). Returns the number of runs,
// all of them when `count_all`, else at least until run k0 + 31 has ended
// (the pass stops there). The whole warp calls it; the tables are visible
// to every lane on return.
template <typename X>
__device__ __forceinline__ int warp_runs(X x, float thr, int el, int k0, int* rs, int* re,
                                         int lane, bool count_all) {
  const int k1 = k0 + 32;
  int count = 0;
  unsigned carry = 0u;  // 1: the sample before this step was on
  for (int b = 0; b < el; b += 32) {
    const int t = b + lane;
    const unsigned on = __ballot_sync(kFull, t < el && x(t) >= thr);
    const unsigned prev = (on << 1) | carry;  // bit j: sample t - 1 on
    const unsigned starts = on & ~prev;
    const int below = count + __popc(starts & lanes_below(lane));
    if (starts >> lane & 1u) {
      if (below >= k0 && below < k1) rs[below - k0] = t;
    }
    if ((~on & prev) >> lane & 1u) {  // the run before t ends at t (exclusive)
      // the last run started at or before t - 1
      if (below - 1 >= k0 && below - 1 < k1) re[below - 1 - k0] = t;
    }
    count += __popc(starts);
    carry = on >> 31;
    if (!count_all && (count > k1 || (count == k1 && !carry))) break;
  }
  if (carry && lane == 0 && count - 1 >= k0 && count - 1 < k1)
    re[count - 1 - k0] = el;  // a run still open at the valid length
  __syncwarp();
  return count;
}

// Segment [a, b): the integral of max(x, 0) and, with kArgmax, the first
// maximum and its position. Every lane returns the same values.
template <bool kArgmax, typename X>
__device__ __forceinline__ float warp_segment(X x, int a, int b, int lane, float& hmax,
                                              int& hpos) {
  float acc = 0.0f, hm = -kInf;
  int hp = b;
  for (int t = a + lane; t < b; t += 32) {
    const float v = x(t);
    acc += fmaxf(v, 0.0f);
    if (kArgmax && v > hm) {  // t rises: each lane keeps its first maximum
      hm = v;
      hp = t;
    }
  }
  if (kArgmax) {
    warp_argmax(hm, hp);
    hmax = hm;
    hpos = hp;
  }
  return warp_sum(acc);
}

}  // namespace wfa
