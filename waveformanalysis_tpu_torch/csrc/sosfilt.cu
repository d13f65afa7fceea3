// Zero-phase IIR filtering (cascaded second-order sections) on Hopper (sm_90a).
//
// Replaces two TPU kernels of waveformanalysis_tpu/ops/filter_pallas.py:
//
// - wfa_sosfiltfilt (K5) replaces _sosfiltfilt_fused_kernel (:125): scipy's
//   sosfiltfilt of a mean-removed float32 batch in one launch. scipy's odd
//   reflection by index arithmetic (Lp = L + 2*padlen):
//     ext[t] = 2*x[0] - x[padlen - t]                 for t < padlen,
//     ext[t] = x[t - padlen]                          in the middle,
//     ext[t] = 2*x[L-1] - x[2*(L-1) + padlen - t]     for t >= padlen + L;
//   the forward cascade over ext from z = zi * ext[0], the backward cascade
//   over the forward output in reverse from z = zi * y_fwd[Lp-1]; only the
//   central L samples are kept.
// - wfa_sosfilt (K6) replaces _sosfilt_kernel (:50): one cascade in one
//   direction over a time-major input with a per-event initial state.
//
// Arithmetic. Per sample and section, direct form II transposed, in this
// order: y = b0*x + z0; z0 = (b1*x - a1*y) + z1; z1 = b2*x - a2*y; the
// section's y feeds the next section. Built with --fmad=false, every product
// and sum rounds once, as in the plain PyTorch version
// (ops/filtering.py: sosfilt_plain, sosfiltfilt_plain), so the two agree bit
// for bit. Coefficients come as float32 rows (b0, b1, b2, a1, a2, zi0, zi1),
// normalised by a0 and rounded once on the host.
//
// Design. One thread per event over the time-major (L, n) layout the wrapper
// makes, so a warp reads and writes one coalesced 128-byte line per step.
// The sections run in chunks of up to four, templated and unrolled, their
// 2 * 4 state values and coefficients in registers. A cascade of more than
// four sections runs its chunks one after another over the whole sequence,
// in place; that is the same operations on the same values, so every section
// count runs. K5 keeps the forward output's central samples in the output
// array and its 2*padlen reflected ends in a small (2*padlen, n) scratch; the
// backward pass reads them in reverse and overwrites the centre in place
// (each thread owns its column). No padding of n: the last block masks its
// ragged tail.
//
// What bounds it on this card. Bytes: one read of the input and one write of
// the output (plus the ends scratch, 2*padlen/L of that). Operations: 9
// float32 operations per section and sample in each direction, 2*Lp*S*9 per
// event; with contraction off a multiply and an add each take an issue slot,
// so they run at half the 67 TFLOP/s FMA rate. The two are of the same size
// at S = 4 (both about 0.65 ms at 1M x 256). What the design does not hide:
// each step is a serial chain of 2*S dependent operations per thread, so the
// kernel needs many events in flight; 65536 events give each SM about 500
// threads, and the chain's latency shows there.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored by _SosParams in ops/filter_cuda.py.
struct SosParams {
  int n;       // events
  int L;       // samples per event (K6: steps of the time-major input)
  int S;       // second-order sections
  int padlen;  // reflected samples at each end (K5 only)
};

namespace {

constexpr int kChunk = 4;  // sections per unrolled pass
constexpr int kCoef = 7;   // b0, b1, b2, a1, a2, zi0, zi1

// Sections [s0, s0 + NS) over `steps` samples of one event: src(k) is the
// k-th input sample, dst(k, y) stores the k-th output, init(s, j) is the
// initial z_j of section s.
template <int NS, typename Src, typename Dst, typename Init>
__device__ __forceinline__ void run_sections(const float* __restrict__ coef, int s0,
                                             int steps, Src src, Dst dst, Init init) {
  float b0[NS], b1[NS], b2[NS], a1[NS], a2[NS], z0[NS], z1[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const float* c = coef + (s0 + s) * kCoef;
    b0[s] = c[0];
    b1[s] = c[1];
    b2[s] = c[2];
    a1[s] = c[3];
    a2[s] = c[4];
    z0[s] = init(s0 + s, 0);
    z1[s] = init(s0 + s, 1);
  }
  for (int k = 0; k < steps; ++k) {
    float x = src(k);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float y = b0[s] * x + z0[s];
      z0[s] = (b1[s] * x - a1[s] * y) + z1[s];
      z1[s] = b2[s] * x - a2[s] * y;
      x = y;
    }
    dst(k, x);
  }
}

// One chunk of up to kChunk sections, starting at section s0 of S.
template <typename Src, typename Dst, typename Init>
__device__ __forceinline__ void run_chunk(const float* __restrict__ coef, int s0, int S,
                                          int steps, Src src, Dst dst, Init init) {
  switch (min(S - s0, kChunk)) {
    case 1: run_sections<1>(coef, s0, steps, src, dst, init); break;
    case 2: run_sections<2>(coef, s0, steps, src, dst, init); break;
    case 3: run_sections<3>(coef, s0, steps, src, dst, init); break;
    default: run_sections<4>(coef, s0, steps, src, dst, init); break;
  }
}

// K6: y_t[t, i] = cascade over x_t[:, i] from zi[:, i].
__global__ void __launch_bounds__(128)
sosfilt_kernel(const float* x_t, const float* zi, const float* __restrict__ coef,
               float* y_t, SosParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const size_t n = P.n;
  auto init = [&](int s, int j) { return zi[(size_t)(2 * s + j) * n + i]; };
  auto store = [&](int k, float v) { y_t[(size_t)k * n + i] = v; };
  for (int s0 = 0; s0 < P.S; s0 += kChunk) {
    const float* in = s0 == 0 ? x_t : y_t;  // later chunks run in place
    run_chunk(coef, s0, P.S, P.L, [&](int k) { return in[(size_t)k * n + i]; },
              store, init);
  }
}

// K5: out_t[:, i] = sosfiltfilt of x_t[:, i]; ends is (2*padlen, n) scratch.
__global__ void __launch_bounds__(128)
sosfiltfilt_kernel(const float* __restrict__ x_t, const float* __restrict__ coef,
                   float* out_t, float* ends, SosParams P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const size_t n = P.n;
  const int L = P.L;
  const int p = P.padlen;
  const int Lp = L + 2 * p;
  auto X = [&](int t) { return x_t[(size_t)t * n + i]; };
  const float x0 = X(0);
  const float xl = X(L - 1);
  auto ext = [&](int t) -> float {
    if (t < p) return 2.0f * x0 - X(p - t);
    if (t >= p + L) return 2.0f * xl - X(2 * (L - 1) + p - t);
    return X(t - p);
  };
  // where the forward output's sample t lives: the left end in ends rows
  // [0, p), the right end in rows [p, 2p), the centre in out_t
  auto at = [&](int t) -> float* {
    if (t < p) return ends + (size_t)t * n + i;
    if (t >= p + L) return ends + (size_t)(t - L) * n + i;
    return out_t + (size_t)(t - p) * n + i;
  };
  auto store = [&](int k, float v) { *at(k) = v; };

  // forward, over ext (first chunk) or in place (later chunks)
  const float first = ext(0);
  auto init_f = [&](int s, int j) { return coef[s * kCoef + 5 + j] * first; };
  run_chunk(coef, 0, P.S, Lp, ext, store, init_f);
  for (int s0 = kChunk; s0 < P.S; s0 += kChunk)
    run_chunk(coef, s0, P.S, Lp, [&](int k) { return *at(k); }, store, init_f);

  // backward, over the forward output in reverse, in place; the last chunk
  // stores only the central samples
  const float first_b = *at(Lp - 1);
  auto init_b = [&](int s, int j) { return coef[s * kCoef + 5 + j] * first_b; };
  auto load_b = [&](int k) { return *at(Lp - 1 - k); };
  for (int s0 = 0; s0 < P.S; s0 += kChunk) {
    if (s0 + kChunk < P.S) {
      run_chunk(coef, s0, P.S, Lp, load_b,
                [&](int k, float v) { *at(Lp - 1 - k) = v; }, init_b);
    } else {
      run_chunk(coef, s0, P.S, Lp, load_b, [&](int k, float v) {
        const int t = Lp - 1 - k;
        if (t >= p && t < p + L) out_t[(size_t)(t - p) * n + i] = v;
      }, init_b);
    }
  }
}

bool bad_params(const SosParams* P) { return P->S < 1 || P->L < 1 || P->padlen < 0; }

}  // namespace

// K5 on `stream` for P->n events of P->L samples: x_t is the (L, n)
// time-major mean-removed input, coef the (S, 7) float32 rows, out_t the
// (L, n) output, ends a (2*padlen, n) scratch. Returns the launch's
// cudaError_t.
extern "C" int wfa_sosfiltfilt(const float* x_t, const float* coef, float* out_t, float* ends,
                               const SosParams* P, void* stream) {
  if (P->n <= 0) return 0;
  if (bad_params(P) || P->L <= P->padlen) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((P->n + 127) / 128);
  sosfiltfilt_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x_t, coef, out_t, ends, *P);
  return (int)cudaGetLastError();
}

// K6 on `stream`: x_t and y_t are (P->L, n) time-major, zi is (2S, n) (rows
// z0, z1 of section 0, then section 1, ...), coef the (S, 7) rows.
extern "C" int wfa_sosfilt(const float* x_t, const float* zi, const float* coef, float* y_t,
                           const SosParams* P, void* stream) {
  if (P->n <= 0 || P->L <= 0) return 0;
  if (bad_params(P)) return (int)cudaErrorInvalidValue;
  const dim3 block(128);
  const dim3 grid((P->n + 127) / 128);
  sosfilt_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x_t, zi, coef, y_t, *P);
  return (int)cudaGetLastError();
}
