// Threshold-run hit finding over a batch of events on Hopper (sm_90a), one
// warp per event on the event-major rows.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py:1238
// (_hits_scan_kernel, behind threshold_hits_scan) with its contract: eight
// (n, K) slot tables (valid, argmax position, height, integral, extended
// segment bounds, run bounds) and the uncapped per-event run count. A run is
// a maximal stretch of samples at or above the event's threshold inside its
// valid length; its segment extends left_extension samples before and
// right_extension samples after it, clipped to [0, L). Position and height
// are the segment's first maximum, the integral the float32 sum of
// max(signal, 0) over the segment. Its plain PyTorch version is ops/hits.py
// (threshold_hits_batch).
//
// What bounds it on this card: bytes. The f32 signal is read once (4 L
// bytes per event) and 29 bytes per slot and 4 per event are written: at
// 1,048,576 x 256 with K = 32, 1.08 GB in and 0.98 GB out, 0.615 ms at
// 3.35 TB/s.
//
// Design (warp_rows.cuh, warp_hits.cuh). One warp per event reads the
// event-major (n, L) float32 signal as the caller forms it, with no
// transposing copy: the row lands in shared memory by cp.async (16 bytes a
// lane where rows are 16-byte aligned), or is read from global memory where
// it is too long for shared memory (a template parameter). The run pass
// takes 32 samples a step by ballot and puts the first 32 runs' bounds in a
// per-warp slot table; the segment pass reads each slot's segment with the
// whole warp; lane k then writes slot k of every table, one coalesced store
// per table and 32 slots. K above 32 runs in chunks of 32 slots, each with
// a run pass of its own that stops once its last run has ended.
//
// The earlier design (one thread per event on a time-major copy that the
// wrapper made) spent more time on the copy than in the kernel at 1M events
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_hits.cuh"

// Mirrored by _HitsParams / _HitsOut in ops/chain_scan_cuda.py.
struct HitsParams {
  int n, L, K, left_extension, right_extension;
};

struct HitsOut {
  uint8_t* valid;  // torch.bool storage
  int32_t* position;
  float* height;
  float* integral;
  int32_t* seg_start;
  int32_t* seg_end;
  int32_t* run_start;
  int32_t* run_end;
  int32_t* n_runs;  // per event, uncapped
};

namespace {

constexpr int kSlotBytes = 2 * 32 * 4;  // run start and end tables

template <bool kStaged>
__global__ void __launch_bounds__(256)
hits_warp_kernel(const float* __restrict__ x, const float* __restrict__ thr_in,
                 const int32_t* __restrict__ vlen_in, HitsOut out, HitsParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const int L = P.L;
  const int K = P.K;
  unsigned char* mine = smem + warp * wfa::warp_bytes(L, 4, kStaged, kSlotBytes);
  int* rs = reinterpret_cast<int*>(mine + wfa::warp_bytes(L, 4, kStaged, 0));
  int* re = rs + 32;
  const float* row = x + (size_t)ev * L;
  if (kStaged) {
    wfa::stage_row(reinterpret_cast<float*>(mine), row, L, vec, lane);
    row = reinterpret_cast<const float*>(mine);
  }
  auto xs = [&](int t) -> float { return row[t]; };
  const float thr = thr_in[ev];
  const int el = min(max(vlen_in[ev], 0), L);  // a length above L acts as L

  int n_runs = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    // ---- run pass: bounds of the runs ranked [k0, k0 + 32) --------------
    const int found = wfa::warp_runs(xs, thr, el, k0, rs, re, lane, k0 == 0);
    if (k0 == 0) n_runs = found;
    const int ns = max(min(min(n_runs, K) - k0, 32), 0);

    // ---- segment pass: one slot at a time, the whole warp ---------------
    int pos = 0, s0 = 0, s1 = 0;
    float height = 0.0f, integral = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const int a = max(rs[s] - P.left_extension, 0);
      const int b = min(re[s] + P.right_extension, L);
      float hm;
      int hp;
      const float sum = wfa::warp_segment<true>(xs, a, b, lane, hm, hp);
      if (lane == s) {
        pos = hp;
        height = hm;
        integral = sum;
        s0 = a;
        s1 = b;
      }
    }

    // ---- lane k writes slot k0 + k of every table -------------------------
    const int k = k0 + lane;
    if (k < K) {
      const size_t o = (size_t)ev * K + k;
      const bool ok = lane < ns;
      out.valid[o] = ok ? 1 : 0;
      out.position[o] = pos;
      out.height[o] = height;
      out.integral[o] = integral;
      out.seg_start[o] = s0;
      out.seg_end[o] = s1;
      out.run_start[o] = ok ? rs[lane] : 0;
      out.run_end[o] = ok ? re[lane] : 0;
    }
    __syncwarp();  // the next chunk's run pass rewrites the tables
  }
  if (lane == 0) out.n_runs[ev] = n_runs;
}

template <bool kStaged>
int launch(const float* x, const float* thr, const int32_t* vlen, const HitsOut* out,
           const HitsParams* P, int rows, int vec, cudaStream_t s) {
  const int smem = rows * wfa::warp_bytes(P->L, 4, kStaged, kSlotBytes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hits_warp_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  hits_warp_kernel<kStaged><<<grid, 32 * rows, smem, s>>>(x, thr, vlen, *out, *P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Threshold runs on `stream` for P->n events of P->L samples. x is the
// event-major (n, L) float32 signal, thr the per-event threshold, vlen the
// per-event valid length; any K >= 1. `rows` events (warps) per block;
// staged = 0 reads rows from global memory (rows longer than shared memory
// holds); vec != 0 promises 16-byte aligned rows (L % 4 == 0 and an aligned
// base). ops/chain_scan_cuda.py::row_layout picks rows / staged / vec.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_hits_scan(const float* x, const float* thr, const int32_t* vlen,
                             const HitsOut* out, const HitsParams* P, int rows, int staged,
                             int vec, void* stream) {
  if (P->n <= 0) return 0;
  if (P->K < 1 || rows < 1 || rows > 8 ||
      rows * wfa::warp_bytes(P->L, 4, staged, kSlotBytes) > wfa::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return staged ? launch<true>(x, thr, vlen, out, P, rows, vec, s)
                : launch<false>(x, thr, vlen, out, P, rows, 0, s);
}
