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
// Design (warp_rows.cuh, warp_peaks.cuh). One warp per event reads the
// event-major (n, L) float32 signal as the caller forms it, with no
// transposing copy: the row lands in shared memory by cp.async (16 bytes a
// lane where rows are 16-byte aligned). Then the passes of warp_peaks.cuh,
// which the chain kernel (chain_scan.cu) shares: the ballot candidate scan
// into a per-warp slot table, warp distance pruning (lane k owns slot k),
// and warp-cooperative base and crossing searches, one kept slot at a time.
// Lane k then writes slot k of each table: one coalesced 128-byte store per
// table and event at K = 32.
//
// warp_peaks.cuh states the tie rules. Samples at or past the event's valid
// length are never read as signal.
//
// Rows longer than shared memory holds (ops/chain_scan_cuda.py row_layout)
// run the same code with the row read from global memory.
//
// Exactness: positions, counts and validity come from float32 comparisons
// of interpolated values, so the build uses --fmad=false, IEEE division and
// the shared steps of scan_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_peaks.cuh"

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
using wfa::kNeg;

constexpr int kSlotBytes = 2 * 32 * 4;  // candidate position and value tables

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
  const int count = wfa::warp_candidates(xs, det_len, K, P.height, cpos, cval, lane);

  // ---- lane k owns slot k; greedy distance pruning by priority --------
  const int nc = min(count, K);
  const bool cand = lane < nc;
  const int p = cand ? cpos[lane] : -1;
  const float v = cand ? cval[lane] : kNeg;
  const unsigned keep = wfa::warp_prune(p, v, cand, nc, P.distance, lane);

  // ---- per kept slot: bases, evaluation height, interpolated ips -------
  const wfa::PeakRule R{L, P.prominence, P.width, P.rel_height};
  wfa::SlotResult res;
  for (unsigned todo = keep; todo; todo &= todo - 1) {
    const int s = __ffs(todo) - 1;
    const wfa::SlotResult r = wfa::walk_warp(xs, __shfl_sync(kFull, p, s),
                                             __shfl_sync(kFull, v, s), det_len, R, lane);
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
