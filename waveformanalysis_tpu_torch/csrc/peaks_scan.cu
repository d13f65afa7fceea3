// scipy-parity find_peaks over a batch of events on Hopper (sm_90a), one
// warp per event on the event-major rows.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py:920
// (_peaks_scan_kernel, behind find_peaks_scan) with its contract: nine
// (n, K) slot tables (position, valid, peak value, prominence, left/right
// ips, widths, left/right bases) and the uncapped per-event candidate count.
// Its plain PyTorch version is ops/peaks.py (find_peaks_batch without a
// neighbour threshold); ops/chain_scan_cuda.py holds the two against each
// other.
//
// What bounds it on this card: bytes. The f32 signal is read once (4 L
// bytes per event) and 33 bytes per slot and 4 per event are written: at
// 1,048,576 x 256 with K = 32, 1.07 GB in and 1.11 GB out, 0.654 ms at
// 3.35 TB/s. The comparisons per sample are few next to that.
//
// Design (warp_rows.cuh). One warp per event reads the event-major (n, L)
// float32 signal as the caller forms it, with no transposing copy: the row
// lands in shared memory by cp.async (16 bytes a lane where rows are
// 16-byte aligned). Then:
//
//   candidates  32 samples a step, lane j on sample t = base + j: the
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
//               within `distance` drop themselves: the keep set of
//               wfa::distance_prune without its one-thread O(K^2) loop.
//   walks       the left and right bases (nearest higher sample, then the
//               minimum since it) and the rel-height crossings, in shared
//               memory: the warp searches one kept slot at a time, 32
//               samples a step (a ballot for the nearest higher sample or
//               the crossing, a warp min-reduction with an index tie-break
//               for the base). Lane k walking slot k serially (K7's walks)
//               was 46 % slower on the H100 (bench.py's waves, K = 32,
//               PERF.md): a tall peak's left-base walk runs to the row
//               start while the other lanes idle.
//   stores      lane k writes slot k of each table: one coalesced 128-byte
//               store per table and event at K = 32.
//
// Ties (the int16 waves make equal samples common): the left base is the
// minimum closest to the peak, the right base the first minimum, both walks
// stop at the first sample strictly higher than the peak, the left crossing
// is the last sample <= the evaluation height in [lbase, p], the right one
// the first in [p, rbase]. Samples at or past the event's valid length are
// never read as signal.
//
// Rows longer than shared memory holds (ops/chain_scan_cuda.py row_layout)
// run the same code with the row read from global memory.
//
// Exactness: positions, counts and validity come from float32 comparisons
// of interpolated values, so the build uses --fmad=false, IEEE division and
// the shared steps of scan_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "warp_rows.cuh"

// Mirrored by _PeaksParams / _PeaksOut in ops/chain_scan_cuda.py: keep the
// field order and types identical.
struct PeaksParams {
  int n, L, K, distance;
  float height, prominence, width, rel_height;
};

struct PeaksOut {
  int32_t* position;
  uint8_t* valid;  // torch.bool storage
  float* peak_value;
  float* prominence;
  float* left_ips;
  float* right_ips;
  float* widths;
  int32_t* left_bases;
  int32_t* right_bases;
  int32_t* n_candidates;  // per event, uncapped
};

namespace {

using wfa::kFull;
using wfa::kInf;
using wfa::kNeg;
using wfa::lanes_below;

constexpr int kSlotBytes = 2 * 32 * 4;  // candidate position and value tables

// One slot's prominence bases, rel-height ips and validity.
struct SlotResult {
  float prom = 0.0f, lip = 0.0f, rip = 0.0f;
  int lbase = 0, rbase = 0;
  bool valid = false;
};

// ips and validity from the walks' results (the slot owner's arithmetic)
template <typename X>
__device__ __forceinline__ SlotResult finish_slot(X x, float v, float lmin, int lbase, float rmin,
                                                  int rbase, int jl, int jr, float hev,
                                                  const PeaksParams& P) {
  SlotResult r;
  r.prom = v - fmaxf(lmin, rmin);
  r.lbase = lbase;
  r.rbase = rbase;
  r.lip = jl >= 0 ? wfa::left_ips(jl, x(jl), x(jl + 1), hev, lbase) : (float)lbase;
  r.rip = jr < P.L ? wfa::right_ips(jr, x(jr), x(jr - 1), hev, rbase, P.L) : (float)rbase;
  r.valid = r.prom >= P.prominence && r.rip - r.lip >= P.width;
  return r;
}

// warp walks: slot (p, v) searched by the whole warp, 32 samples a step;
// every lane returns the same result
template <typename X>
__device__ __forceinline__ SlotResult walk_warp(X x, int p, float v, int det_len,
                                                const PeaksParams& P, int lane) {
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
  wfa::warp_argmin(lmin, lbase, true);
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
  wfa::warp_argmin(rmin, rbase, false);
  const float hev = wfa::rel_height_level(v, v - fmaxf(lmin, rmin), P.rel_height);
  int jl = -1;
  for (int hi = p; hi >= lbase; hi -= 32) {
    const int t = hi - lane;
    const unsigned m = __ballot_sync(kFull, t >= lbase && x(t) <= hev);
    if (m) {
      jl = hi - (__ffs(m) - 1);
      break;
    }
  }
  int jr = P.L;
  for (int lo = p; lo <= rbase; lo += 32) {
    const int t = lo + lane;
    const unsigned m = __ballot_sync(kFull, t <= rbase && x(t) <= hev);
    if (m) {
      jr = lo + __ffs(m) - 1;
      break;
    }
  }
  return finish_slot(x, v, lmin, lbase, rmin, rbase, jl, jr, hev, P);
}

template <bool kStaged>
__global__ void __launch_bounds__(256)
peaks_warp_kernel(const float* __restrict__ x, const int32_t* __restrict__ vlen_in,
                  PeaksOut out, PeaksParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const int L = P.L;
  const int K = P.K;
  unsigned char* mine = smem + warp * wfa::warp_bytes(L, 4, kStaged, kSlotBytes);
  int* cpos = reinterpret_cast<int*>(mine + wfa::warp_bytes(L, 4, kStaged, 0));
  float* cval = reinterpret_cast<float*>(cpos + 32);
  const float* row = x + (size_t)ev * L;
  if (kStaged) {
    wfa::stage_row(reinterpret_cast<float*>(mine), row, L, vec, lane);
    row = reinterpret_cast<const float*>(mine);
  }
  auto xs = [&](int t) -> float { return row[t]; };
  const int det_len = min(max(vlen_in[ev], 0), L);  // a length above L acts as L

  // ---- candidates: plateau midpoints, the first K kept -----------------
  int count = 0;   // candidates so far (uncapped)
  int carry = -1;  // the last nonzero difference before this step: 2 t + rise
  for (int b = 0; b < det_len; b += 32) {
    const int t = b + lane;
    const bool in = t >= 1 && t < det_len;
    const float prev = in ? xs(t - 1) : 0.0f;
    const float d = in ? xs(t) - prev : 0.0f;
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
      emit = mid >= 1 && mid <= det_len - 2 && prev >= P.height;
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

  // ---- lane k owns slot k; greedy distance pruning by priority --------
  const int nc = min(count, K);
  const bool cand = lane < nc;
  const int p = cand ? cpos[lane] : -1;
  const float v = cand ? cval[lane] : kNeg;
  unsigned keep = __ballot_sync(kFull, cand);
  if (P.distance > 1 && nc > 1) {
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
      if (o_kept && lane != o && abs(p - po) < P.distance) kept = false;
    }
    keep = __ballot_sync(kFull, kept);
  }

  // ---- per kept slot: bases, evaluation height, interpolated ips -------
  SlotResult res;
  for (unsigned todo = keep; todo; todo &= todo - 1) {
    const int s = __ffs(todo) - 1;
    const SlotResult r = walk_warp(xs, __shfl_sync(kFull, p, s), __shfl_sync(kFull, v, s),
                                   det_len, P, lane);
    if (lane == s) res = r;
  }

  // ---- lane k writes slot k of every table ----------------------------
  if (lane < K) {
    const size_t o = (size_t)ev * K + lane;
    out.position[o] = res.valid ? p : -1;
    out.valid[o] = res.valid ? 1 : 0;
    out.peak_value[o] = v;
    out.prominence[o] = res.prom;
    out.left_ips[o] = res.lip;
    out.right_ips[o] = res.rip;
    out.widths[o] = res.rip - res.lip;
    out.left_bases[o] = res.lbase;
    out.right_bases[o] = res.rbase;
  }
  if (lane == 0) out.n_candidates[ev] = count;
}

template <bool kStaged>
int launch(const float* x, const int32_t* vlen, const PeaksOut* out, const PeaksParams* P,
           int rows, int vec, cudaStream_t s) {
  const int smem = rows * wfa::warp_bytes(P->L, 4, kStaged, kSlotBytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        peaks_warp_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  peaks_warp_kernel<kStaged><<<grid, 32 * rows, smem, s>>>(x, vlen, *out, *P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// find_peaks on `stream` for P->n events of P->L detection samples. x is
// the event-major (n, L) float32 signal, vlen the per-event valid length;
// slot tables hold 1..32 peaks. `rows` events (warps) per block; staged =
// 0 reads rows from global memory (rows longer than shared memory holds);
// vec != 0 promises 16-byte aligned rows (L % 4 == 0 and an aligned base).
// ops/chain_scan_cuda.py::row_layout picks rows / staged / vec. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int wfa_peaks_scan(const float* x, const int32_t* vlen, const PeaksOut* out,
                              const PeaksParams* P, int rows, int staged, int vec,
                              void* stream) {
  if (P->n <= 0) return 0;
  if (P->K < 1 || P->K > 32 || rows < 1 || rows > 8 ||
      rows * wfa::warp_bytes(P->L, 4, staged, kSlotBytes) > wfa::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return staged ? launch<true>(x, vlen, out, P, rows, vec, s)
                : launch<false>(x, vlen, out, P, rows, 0, s);
}
