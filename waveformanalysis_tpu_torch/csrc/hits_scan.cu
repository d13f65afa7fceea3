// Threshold-run hit finding over a batch of events on Hopper (sm_90a).
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py
// (_hits_scan_kernel, behind threshold_hits_scan) with its contract: eight
// (n, K) slot tables (valid, argmax position, height, integral, extended
// segment bounds, run bounds) and the uncapped per-event run count. A run is
// a maximal stretch of samples at or above the event's threshold inside its
// valid length; its segment extends left_extension samples before and
// right_extension samples after it, clipped to [0, L). Position and height
// are the segment's first maximum, the integral the float32 sum of
// max(signal, 0) over the segment in sample order. Its plain PyTorch
// version is ops/hits.py (threshold_hits_batch).
//
// Design. One thread per event; the wrapper hands the signal over
// time-major, (L, n) float32, so the run pass reads one coalesced 128-byte
// line per warp and step. The run pass only finds run boundaries and writes
// each of the first K runs' bounds straight to the output tables: it keeps
// no slot state, so K costs no registers and is not limited. A second pass
// then walks each found segment alone for its maximum and integral. The TPU
// kernel kept all K slots' accumulators live through one sweep (7K + 2K
// values per event) because its lanes cannot branch per event; here each
// segment is read once, and the samples outside every segment are read
// once, by the run pass.
//
// What bounds it on this card: the run pass streams the f32 signal from HBM
// once (67 MB at 65536 x 256); the segment pass reads only segment samples.
// Both are a serial chain per event, covered by 65536 threads in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

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

__global__ void __launch_bounds__(128)
hits_scan_kernel(const float* __restrict__ x, const float* __restrict__ thr_in,
                 const int32_t* __restrict__ vlen_in, HitsOut out, HitsParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;
  const int L = P.L;
  const int K = P.K;
  const float thr = thr_in[i];
  const int el = min(max(vlen_in[i], 0), L);  // a length above L acts as L
  auto xs = [&](int t) -> float { return x[(size_t)t * n + i]; };
  const size_t row = (size_t)i * K;

  // ---- run pass: bounds of the first K runs -------------------------------
  int n_runs = 0;
  bool prev_on = false;
  for (int t = 0; t < el; ++t) {
    const bool on = xs(t) >= thr;
    if (on && !prev_on) {
      if (n_runs < K) {
        out.run_start[row + n_runs] = t;
        out.seg_start[row + n_runs] = max(t - P.left_extension, 0);
      }
      ++n_runs;
    } else if (!on && prev_on && n_runs <= K) {
      out.run_end[row + n_runs - 1] = t;  // exclusive
      out.seg_end[row + n_runs - 1] = min(t + P.right_extension, L);
    }
    prev_on = on;
  }
  if (prev_on && n_runs <= K) {  // a run still open at the valid length
    out.run_end[row + n_runs - 1] = el;
    out.seg_end[row + n_runs - 1] = min(el + P.right_extension, L);
  }

  // ---- segment pass: first maximum and integral of each run's segment -----
  const int n_slots = min(n_runs, K);
  for (int k = 0; k < n_slots; ++k) {
    const int s = out.seg_start[row + k];
    const int e = out.seg_end[row + k];
    float acc = 0.0f, hmax = -wfa::kInf;
    int hpos = 0;
    for (int t = s; t < e; ++t) {
      const float v = xs(t);
      acc += fmaxf(v, 0.0f);
      if (v > hmax) {
        hmax = v;
        hpos = t;
      }
    }
    out.valid[row + k] = 1;
    out.position[row + k] = hpos;
    out.height[row + k] = hmax;
    out.integral[row + k] = acc;
  }
  for (int k = n_slots; k < K; ++k) {
    out.valid[row + k] = 0;
    out.position[row + k] = 0;
    out.height[row + k] = 0.0f;
    out.integral[row + k] = 0.0f;
    out.seg_start[row + k] = 0;
    out.seg_end[row + k] = 0;
    out.run_start[row + k] = 0;
    out.run_end[row + k] = 0;
  }
  out.n_runs[i] = n_runs;
}

}  // namespace

// Threshold runs on `stream` for P->n events of P->L samples. x_t is the
// (L, n) time-major float32 signal, thr the per-event threshold, vlen the
// per-event valid length. Returns the cudaError_t of the launch.
extern "C" int wfa_hits_scan(const float* x_t, const float* thr, const int32_t* vlen,
                             const HitsOut* out, const HitsParams* P, void* stream) {
  if (P->n <= 0) return 0;
  if (P->K < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((P->n + 127) / 128);
  hits_scan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x_t, thr, vlen, *out, *P);
  return (int)cudaGetLastError();
}
