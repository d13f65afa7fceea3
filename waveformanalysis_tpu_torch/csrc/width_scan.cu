// 10-90 % width crossings for K peak slots per event on Hopper (sm_90a).
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/width_scan_pallas.py
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
// Design. One thread per event; the wrapper hands the waves over
// time-major, (L, n) int16 or float32, as for the other scan kernels. Each
// occupied slot reads its peak sample, then walks forward from 0 until both
// rising crossings are found (or p is reached) and forward from p until both
// falling crossings are found: a pulse's crossings lie next to it, so a walk
// stops long before L. The TPU kernel swept all L samples for every slot in
// two passes because its lanes cannot stop early. The slot loop is not
// unrolled and holds no slot table: each slot's results go straight out.
//
// What bounds it on this card: the reads are short, data-dependent walks,
// uncoalesced across a warp (each thread is at its own sample), mostly
// served from L2 right after the peak kernel read the same events; the
// outputs (13 values per slot) are the largest byte count it moves.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void __launch_bounds__(128)
width_scan_kernel(const T* __restrict__ w, const float* __restrict__ bl_in,
                  const int32_t* __restrict__ pos_in, WidthOut out, WidthParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;
  const int L = P.L;
  const float bl = bl_in[i];
  auto corr = [&](int t) -> float { return (float)w[(size_t)t * n + i] - bl; };
  const float frac[4] = {P.rise_low, P.rise_high, P.fall_high, P.fall_low};

  for (int k = 0; k < P.K; ++k) {
    const size_t o = (size_t)i * P.K + k;
    const int p = pos_in[o];
    int idx[4] = {L, L, L, L};
    float y0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float y1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float pv = 0.0f;
    if (p >= 0 && p < L) {
      pv = corr(p);
      float thr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) thr[j] = __fmul_rn(pv, frac[j]);
      // rising (j = 0, 1): first t in [0, p) with corr >= thr
      float c_prev = corr(0);
      for (int t = 0; t < p && (idx[0] == L || idx[1] == L); ++t) {
        const float c = corr(t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (idx[j] == L && c >= thr[j]) {
            idx[j] = t;
            y0[j] = c_prev;
            y1[j] = c;
          }
        }
        c_prev = c;
      }
      // falling (j = 2, 3): first t in [p, L) with corr <= thr
      c_prev = corr(max(p - 1, 0));
      for (int t = p; t < L && (idx[2] == L || idx[3] == L); ++t) {
        const float c = corr(t);
#pragma unroll
        for (int j = 2; j < 4; ++j) {
          if (idx[j] == L && c <= thr[j]) {
            idx[j] = t;
            y0[j] = c_prev;
            y1[j] = c;
          }
        }
        c_prev = c;
      }
      if (!P.interpolation) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y0[j] = y1[j] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out.idx[j][o] = idx[j];
      out.y[2 * j][o] = y0[j];
      out.y[2 * j + 1][o] = y1[j];
    }
    out.peak_value[o] = pv;
  }
}

}  // namespace

// Width crossings on `stream` for P->n events of P->L samples and P->K
// slots. w_t is the (L, n) time-major wave matrix (int16 when is_float is
// 0, float32 otherwise), baseline (n,) float32, positions (n, K) int32.
// Returns the cudaError_t of the launch.
extern "C" int wfa_width_scan(const void* w_t, int is_float, const float* baseline,
                              const int32_t* positions, const WidthOut* out,
                              const WidthParams* P, void* stream) {
  if (P->n <= 0 || P->K <= 0) return 0;
  const dim3 block(128);
  const dim3 grid((P->n + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float) {
    width_scan_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(w_t), baseline, positions, *out, *P);
  } else {
    width_scan_kernel<int16_t><<<grid, block, 0, s>>>(
        static_cast<const int16_t*>(w_t), baseline, positions, *out, *P);
  }
  return (int)cudaGetLastError();
}
