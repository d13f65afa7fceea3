// scipy-parity find_peaks over a batch of events on Hopper (sm_90a).
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py
// (_peaks_scan_kernel, behind find_peaks_scan) with its contract: nine
// (n, K) slot tables (position, valid, peak value, prominence, left/right
// ips, widths, left/right bases) and the uncapped per-event candidate count.
// Its plain PyTorch version is ops/peaks.py (find_peaks_batch without a
// neighbour threshold); ops/chain_scan_cuda.py holds the two against each
// other.
//
// Design. One thread per event; the wrapper hands the detection signal over
// time-major, (L, n) float32, so the candidate pass reads one coalesced
// 128-byte line per warp and step. The candidate pass keeps the first K
// plateau midpoints in registers (K a template parameter, every slot loop
// unrolled) and stops at the event's valid length. Greedy distance pruning
// runs on those registers. Then each surviving candidate walks outward from
// its position, the way scipy itself computes prominence and width: left and
// right to the nearest higher sample for the bases, then from the peak
// toward each base to the first sample at or below the evaluation height.
// The TPU kernel instead swept the whole wave once per pass with 5K and 7K
// state values per event, because a TPU vector lane cannot stop early; here
// the walks touch only the samples scipy reads, and the slot state never
// leaves registers.
//
// What bounds it on this card: at 65536 x 256 the f32 input is 67 MB, more
// than the 50 MB L2, so the candidate pass streams it from HBM once; the
// walks then read a few samples each, uncoalesced but mostly from L2. The
// serial, data-dependent chain of comparisons per sample limits a thread
// more than bandwidth does; enough events run in parallel (65536 threads)
// to cover that latency.
//
// Exactness: positions, counts and validity come from float32 comparisons
// of interpolated values, so the build uses --fmad=false, IEEE division and
// the shared steps of scan_common.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"

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

using wfa::kNeg;

template <int KT>
__global__ void __launch_bounds__(128)
peaks_scan_kernel(const float* __restrict__ x, const int32_t* __restrict__ vlen_in,
                  PeaksOut out, PeaksParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;
  const int L = P.L;
  const int K = P.K;
  const int det_len = min(max(vlen_in[i], 0), L);  // a length above L acts as L
  auto xs = [&](int t) -> float { return x[(size_t)t * n + i]; };

  // ---- candidates: plateau midpoints, first K kept ------------------------
  int pos[KT];
  float val[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    pos[k] = -1;
    val[k] = kNeg;
  }
  int count = 0, left_edge = 0;
  bool prev_rise = false;
  // no candidate is emitted at or past det_len, so the walk stops there
  float prev = det_len > 0 ? xs(0) : kNeg;
  for (int t = 0; t < det_len; ++t) {
    const float cur = xs(t);
    wfa::candidate_step<KT>(t, cur, prev, det_len, K, P.height, pos, val, count,
                            left_edge, prev_rise);
    prev = cur;
  }
  const unsigned cand_valid = wfa::distance_prune<KT>(
      pos, val, wfa::candidate_mask<KT>(count, K), P.distance);

  // ---- per candidate: bases, evaluation height, interpolated ips ----------
  const size_t row = (size_t)i * K;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k >= K) continue;
    float prom = 0.0f, lip = 0.0f, rip = 0.0f;
    int lbase = 0, rbase = 0;
    bool fv = false;
    if (cand_valid >> k & 1u) {
      const int p = pos[k];  // 1 <= p <= det_len - 2
      const float v = val[k];
      // left base: the last minimum since the last higher sample before p
      float lmin = v;
      lbase = p;
      for (int t = p - 1; t >= 0; --t) {
        const float xt = xs(t);
        if (xt > v) break;
        if (xt < lmin) {
          lmin = xt;
          lbase = t;
        }
      }
      // right base: the first minimum before the next higher sample
      float rmin = v;
      rbase = p;
      for (int t = p + 1; t < det_len; ++t) {
        const float xt = xs(t);
        if (xt > v) break;
        if (xt < rmin) {
          rmin = xt;
          rbase = t;
        }
      }
      prom = v - fmaxf(lmin, rmin);
      const float hev = wfa::rel_height_level(v, prom, P.rel_height);
      // last sample in [lbase, p] at or below hev; first in [p, rbase]
      int jl = -1;
      for (int t = p; t >= lbase; --t) {
        if (xs(t) <= hev) {
          jl = t;
          break;
        }
      }
      int jr = L;
      for (int t = p; t <= rbase; ++t) {
        if (xs(t) <= hev) {
          jr = t;
          break;
        }
      }
      lip = jl >= 0 ? wfa::left_ips(jl, xs(jl), xs(jl + 1), hev, lbase) : (float)lbase;
      rip = jr < L ? wfa::right_ips(jr, xs(jr), xs(jr - 1), hev, rbase, L) : (float)rbase;
      fv = prom >= P.prominence && rip - lip >= P.width;
    }
    out.position[row + k] = fv ? pos[k] : -1;
    out.valid[row + k] = fv ? 1 : 0;
    out.peak_value[row + k] = val[k];
    out.prominence[row + k] = prom;
    out.left_ips[row + k] = lip;
    out.right_ips[row + k] = rip;
    out.widths[row + k] = rip - lip;
    out.left_bases[row + k] = lbase;
    out.right_bases[row + k] = rbase;
  }
  out.n_candidates[i] = count;
}

}  // namespace

// find_peaks on `stream` for P->n events of P->L detection samples.
// x_t is the (L, n) time-major float32 signal, vlen the per-event valid
// length. Slot tables hold 1..32 peaks. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int wfa_peaks_scan(const float* x_t, const int32_t* vlen,
                              const PeaksOut* out, const PeaksParams* P, void* stream) {
  if (P->n <= 0) return 0;
  if (P->K < 1 || P->K > 32) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((P->n + 127) / 128);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P->K <= 8) {
    peaks_scan_kernel<8><<<grid, block, 0, s>>>(x_t, vlen, *out, *P);
  } else if (P->K <= 16) {
    peaks_scan_kernel<16><<<grid, block, 0, s>>>(x_t, vlen, *out, *P);
  } else {
    peaks_scan_kernel<32><<<grid, block, 0, s>>>(x_t, vlen, *out, *P);
  }
  return (int)cudaGetLastError();
}
