// 10-90 % width crossings for K peak slots per event on Hopper (sm_90a),
// one warp per event on the event-major rows.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/width_scan_pallas.py:59
// (_width_scan_kernel, behind width_crossings_scan). Per slot with position
// p: the corrected peak value pv = wave[p] - baseline, and for the four
// thresholds pv * {rise_low, rise_high, fall_high, fall_low} the first
// rising crossing in [0, p) (corr >= thr) or the first falling crossing in
// [p, L) (corr <= thr), reported as L when not found, with the two samples
// corr[t - 1] (corr[0] at t = 0) and corr[t] at the crossing for the
// interpolation the caller does. An empty slot (p < 0 or p >= L) captures
// no peak value and searches nothing: pv 0, indices L, samples 0. The
// baseline comes from the caller. Its plain PyTorch version is
// ops/width_scan_cuda.py (width_crossings_plain).
//
// What bounds it on this card: bytes. The waves are read once (2 L bytes per
// event for int16) with the positions and baseline, and 13 values of 4
// bytes per slot are written: at 1,048,576 x 256 with K = 32, 0.69 GB in
// and 1.74 GB out, 0.722 ms at 3.35 TB/s. The outputs dominate.
//
// Design (warp_rows.cuh). One warp per event reads the event-major (n, L)
// int16 or float32 waves as they are, with no transposing copy: the raw row
// lands in shared memory by cp.async (16 bytes a lane where rows are
// 16-byte aligned), and corr[t] = float(w[t]) - baseline is formed at each
// read (one subtraction, the plain version's). Lane k reads slot k's position in one coalesced load.
// A ballot of the occupied slots drives the search: for each occupied slot
// the warp reads 32 samples a step, one ballot per threshold pair (both
// rising thresholds on [0, p), both falling ones on [p, L)), __ffs gives the
// first crossing, and the search stops when both are found. A pulse's
// crossings lie next to it, so a search takes a few steps, and empty slots
// do no work. Lane k then reads its capture samples and writes slot k of
// the 13 tables, empty slots included: one coalesced store per table and
// event at K = 32. K above 32 runs in chunks of 32 slots.
//
// Rows longer than shared memory holds (ops/chain_scan_cuda.py row_layout)
// run the same code with the row read from global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

// Mirrored by _WidthParams / _WidthOut in ops/width_scan_cuda.py.
struct WidthParams {
  int n, L, K, interpolation;
  float rise_low, rise_high, fall_high, fall_low;
};

struct WidthOut {
  int32_t* idx[4];  // r_low, r_high, f_high, f_low
  float* y[8];      // (y0, y1) for each of the four, in that order
  float* peak_value;
};

namespace {

using wfa::first_two;
using wfa::kFull;

template <typename T, bool kStaged>
__global__ void __launch_bounds__(256)
width_warp_kernel(const T* __restrict__ w, const float* __restrict__ bl_in,
                  const int32_t* __restrict__ pos_in, WidthOut out, WidthParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const int L = P.L;
  const int K = P.K;
  const float frac[4] = {P.rise_low, P.rise_high, P.fall_high, P.fall_low};
  const T* row = w + (size_t)ev * L;
  if (kStaged) {
    T* buf = reinterpret_cast<T*>(smem + warp * wfa::warp_bytes(L, (int)sizeof(T), 1, 0));
    wfa::stage_row(buf, row, L, vec, lane);
    row = buf;
  }
  const float bl = bl_in[ev];
  auto corr = [&](int t) -> float { return (float)row[t] - bl; };
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const size_t o = (size_t)ev * K + k;
    const int p = k < K ? pos_in[o] : -1;
    const bool occ = k < K && p >= 0 && p < L;
    int idx[4] = {L, L, L, L};
    float pv = 0.0f;
    for (unsigned todo = __ballot_sync(kFull, occ); todo; todo &= todo - 1) {
      const int s = __ffs(todo) - 1;
      const int ps = __shfl_sync(kFull, p, s);
      const float pvs = corr(ps);
      float thr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) thr[j] = __fmul_rn(pvs, frac[j]);
      int f[4];
      first_two(
          0, ps, lane, [&](int t) { return corr(t) >= thr[0]; },
          [&](int t) { return corr(t) >= thr[1]; }, f[0], f[1]);
      first_two(
          ps, L, lane, [&](int t) { return corr(t) <= thr[2]; },
          [&](int t) { return corr(t) <= thr[3]; }, f[2], f[3]);
      if (lane == s) {
        pv = pvs;
        idx[0] = f[0] < ps ? f[0] : L;  // [0, p): not found is L
        idx[1] = f[1] < ps ? f[1] : L;
        idx[2] = f[2];
        idx[3] = f[3];
      }
    }
    if (k < K) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float y0 = 0.0f, y1 = 0.0f;
        if (P.interpolation && idx[j] < L) {
          y0 = corr(max(idx[j] - 1, 0));
          y1 = corr(idx[j]);
        }
        out.idx[j][o] = idx[j];
        out.y[2 * j][o] = y0;
        out.y[2 * j + 1][o] = y1;
      }
      out.peak_value[o] = pv;
    }
  }
}

template <typename T, bool kStaged>
int launch(const void* w, const float* baseline, const int32_t* positions, const WidthOut* out,
           const WidthParams* P, int rows, int vec, cudaStream_t s) {
  const int smem = rows * wfa::warp_bytes(P->L, (int)sizeof(T), kStaged, 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        width_warp_kernel<T, kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  width_warp_kernel<T, kStaged><<<grid, 32 * rows, smem, s>>>(
      static_cast<const T*>(w), baseline, positions, *out, *P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Width crossings on `stream` for P->n events of P->L samples and P->K
// slots. w is the event-major (n, L) wave matrix (int16 when is_float is
// 0, float32 otherwise), baseline (n,) float32, positions (n, K) int32.
// `rows` events (warps) per block; staged = 0 reads rows from global
// memory; vec != 0 promises 16-byte aligned rows
// (ops/chain_scan_cuda.py::row_layout picks them). Returns the cudaError_t
// of the launch.
extern "C" int wfa_width_scan(const void* w, int is_float, const float* baseline,
                              const int32_t* positions, const WidthOut* out,
                              const WidthParams* P, int rows, int staged, int vec,
                              void* stream) {
  if (P->n <= 0 || P->K <= 0) return 0;
  if (rows < 1 || rows > 8 ||
      rows * wfa::warp_bytes(P->L, is_float ? 4 : 2, staged, 0) > wfa::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    return staged ? launch<float, true>(w, baseline, positions, out, P, rows, vec, s)
                  : launch<float, false>(w, baseline, positions, out, P, rows, 0, s);
  return staged ? launch<int16_t, true>(w, baseline, positions, out, P, rows, vec, s)
                : launch<int16_t, false>(w, baseline, positions, out, P, rows, 0, s);
}
