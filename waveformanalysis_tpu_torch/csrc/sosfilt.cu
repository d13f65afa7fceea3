// IIR filtering (cascaded second-order sections) on Hopper (sm_90a).
//
// Replaces two TPU kernels of waveformanalysis_tpu/ops/filter_pallas.py:
//
// - wfa_sosfiltfilt (K5) replaces _sosfiltfilt_fused_kernel (:125): scipy's
//   sosfiltfilt of a float32 batch in one launch, with the Pallas path's
//   conditioning: the per-wave mean is subtracted as a row is staged and
//   the DC response mean * H(1)^2 added as it is stored (the wrapper's
//   ops/filtering.py::condition computes both columns). scipy's odd
//   reflection by index arithmetic (Lp = L + 2*padlen), the forward cascade
//   over it from z = zi * ext[0], the backward cascade over the forward
//   output in reverse from z = zi * y_fwd[Lp-1]; only the central L samples
//   are kept.
// - wfa_sosfilt (K6) replaces _sosfilt_kernel (:50): one cascade in one
//   direction over the event-major (n, T) rows with a per-event initial
//   state; `reverse` runs it from the last sample to the first and stores
//   each output in place of its input (sosfilt of the flipped rows, flipped
//   back, with no flip).
//
// Arithmetic. Per sample and section, direct form II transposed, in this
// order: y = b0*x + z0; z0 = (b1*x - a1*y) + z1; z1 = b2*x - a2*y; the
// section's y feeds the next section. Built with --fmad=false, every product
// and sum rounds once, as in the plain PyTorch version
// (ops/filtering.py: sosfilt_plain, sosfiltfilt_plain), so the two agree bit
// for bit. Coefficients come as float32 rows (b0, b1, b2, a1, a2, zi0, zi1),
// normalised by a0 and rounded once on the host. The sections run in groups
// of up to four, templated and unrolled, their 2 * 4 state values and
// coefficients in registers; a group's pass over samples that an earlier
// group has filtered does the same operations on the same values, so every
// section count runs and stays bit-equal.
//
// K5's design. The recursion is serial per event (a parallel scan would not
// be bit-equal to the plain version), so one thread filters one event. A
// block is one warp and 32 events, whose event-major rows lie back to back
// in the (n, L) input: the warp copies them with cp.async, 32 consecutive
// samples of one row a step, into a shared-memory tile of 32 rows of Lp
// words plus one where Lp is even (an odd row stride, so 32 threads at the
// same sample of their own rows hit 32 different banks). Each thread then
// removes its row's mean, writes the reflected ends beside it, runs the
// forward cascade in place over the tile row and the backward cascade in
// place down to the first central sample (the steps below it feed only
// outputs that are dropped), and the warp stores the centres plus the DC
// response row by row, 128 coalesced bytes a step. No transposing copy, no
// global scratch. At L = 256 and route B's padlen 27 a block takes 39,808
// bytes, so five blocks (160 events) fit an SM. Rows too long for a
// 32-row tile (kStaged false) run the same passes on a global (n, Lp)
// scratch row per thread.
//
// What bounds K5 on this card. Bytes: one read of the input and one write of
// the output, 8 L bytes per event. Operations: 9 float32 operations per
// section and sample, over Lp samples forward and L + p backward, plus the
// mean removal and DC addition (2 L) and the reflection (4 p):
// (2 L + 3 p) * S * 9 + 2 L + 4 p per event; with contraction off a
// multiply and an add each take an issue slot, so they run at half the
// 67 TFLOP/s FMA rate of the H100 SXM: 0.69 ms at 1M x 256 with S = 4,
// against 0.64 ms for the bytes. What the design does not hide: each step
// is a serial chain of dependent operations per thread, and the tile holds
// five warps an SM. A tile that left the left reflected end out (six warps
// an SM) was no faster on the H100 (PERF.md), so the block count is not
// what holds it; the per-step work is.
//
// K6's design. One thread per event again; a block is one warp and 32
// events. The warp walks its 32 rows in chunks of kSosChunk = 128 samples
// through two shared-memory buffers: it copies the next chunk of all 32
// rows with 4-byte cp.async (each row's 512 bytes as 4 coalesced steps of
// 128; rows of kSosStride = 129 words, odd, so the copies, the per-thread
// steps and the stores each hit 32 banks) while it filters the current
// one, each thread running its row's samples through all S sections in
// place in the buffer, and then stores the chunk as coalesced row
// segments. With S <= 4 the sections' state stays in registers from the
// first chunk to the last; with S > 4 the groups of four take turns over
// each chunk and park their state in shared memory between chunks. Nothing
// is read twice from device memory. A warp holds 33,024 bytes (plus 256 S
// for S > 4) whatever T is, so rows of any length take the one path and six
// warps fit an SM (ops/filter_cuda.py::sosfilt_layout mirrors the sizes).
// The direction is a template parameter: `reverse` walks the chunks from
// the row's end, the ragged chunk last, and each chunk from its last
// sample.
//
// What bounds K6 on this card. Bytes: each input read once and each output
// written once, n T 8 + 2 S n 4 bytes, over 3.35 TB/s: 0.049 ms at 65,536
// x 310 (route B's reflected rows), 0.786 ms at 1M. Operations: 9 S per
// sample, T S 9 n, at the non-FMA 33.5 TFLOP/s: 0.022 and 0.35 ms at S = 4.
// So it is bound by bytes, and what decides how close it comes is how
// device memory serves the copies: the time followed the length of the
// row segment a warp copies at a time, far more than the bytes it has in
// flight. Chunks of 32 samples (128-byte segments, 24 warps an SM) ran
// slower than the time-major kernel this one replaced; chunks of 128
// (512-byte segments) reach about two thirds of the bound at 1M (PERF.md).
// Longer chunks cost warps an SM, and with fewer than about six the serial
// cascades no longer hide behind the copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

// Mirrored by _SosParams in ops/filter_cuda.py.
struct SosParams {
  int n;       // events
  int L;       // samples per event
  int S;       // second-order sections
  int padlen;  // reflected samples at each end (K5 only)
};

namespace {

constexpr int kChunk = 4;      // sections per unrolled pass
constexpr int kCoef = 7;       // b0, b1, b2, a1, a2, zi0, zi1
constexpr int kTileRows = 32;  // K5: events (threads) a block, one warp
constexpr int kSosChunk = 128;  // K6: samples of a row a warp holds at a time
constexpr int kSosStride = kSosChunk + 1;  // K6: words a buffer row (odd)

// NS consecutive sections: their coefficients and state in registers.
template <int NS>
struct Sections {
  float b0[NS], b1[NS], b2[NS], a1[NS], a2[NS], z0[NS], z1[NS];

  __device__ __forceinline__ void load(const float* __restrict__ coef, int s0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float* c = coef + (s0 + s) * kCoef;
      b0[s] = c[0];
      b1[s] = c[1];
      b2[s] = c[2];
      a1[s] = c[3];
      a2[s] = c[4];
    }
  }

  // one sample through the NS sections
  __device__ __forceinline__ float step(float x) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float y = b0[s] * x + z0[s];
      z0[s] = (b1[s] * x - a1[s] * y) + z1[s];
      z1[s] = b2[s] * x - a2[s] * y;
      x = y;
    }
    return x;
  }
};

// Sections [s0, s0 + NS) over `steps` samples of one event: src(k) is the
// k-th input sample, dst(k, y) stores the k-th output, init(s, j) is the
// initial z_j of section s.
template <int NS, typename Src, typename Dst, typename Init>
__device__ __forceinline__ void run_sections(const float* __restrict__ coef, int s0,
                                             int steps, Src src, Dst dst, Init init) {
  Sections<NS> g;
  g.load(coef, s0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    g.z0[s] = init(s0 + s, 0);
    g.z1[s] = init(s0 + s, 1);
  }
#pragma unroll 4
  for (int k = 0; k < steps; ++k) dst(k, g.step(src(k)));
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

// K6's shared-memory words (one warp a block): two buffers of 32 rows of
// kSosStride words and, for S > kChunk, the state of every section between
// chunks (2 S words a lane)
__host__ __device__ __forceinline__ int sosfilt_words(int S) {
  return 2 * 32 * kSosStride + (S > kChunk ? 2 * S * 32 : 0);
}

// K6, sections [s0, s0 + NS) of S > kChunk over `len` samples of a buffer
// row from p in steps of D, their state read from and written back to the
// warp's state words (word (2 s + j) * 32 + lane holds z_j of section s).
template <int NS, int D>
__device__ __forceinline__ void group_pass(const float* __restrict__ coef, int s0, float* state,
                                           int lane, float* p, int len) {
  Sections<NS> g;
  g.load(coef, s0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    g.z0[s] = state[(2 * (s0 + s)) * 32 + lane];
    g.z1[s] = state[(2 * (s0 + s) + 1) * 32 + lane];
  }
#pragma unroll 4
  for (int k = 0; k < len; ++k, p += D) *p = g.step(*p);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    state[(2 * (s0 + s)) * 32 + lane] = g.z0[s];
    state[(2 * (s0 + s) + 1) * 32 + lane] = g.z1[s];
  }
}

// K6: y[i, :] = the cascade over x[i, :] from zi[:, i], forward or (kRev)
// from the last sample to the first. NS = S for S <= kChunk (the state in
// registers throughout), 0 for S > kChunk (groups of kChunk sections, the
// state in shared memory between chunks). A block is one warp and 32
// events, walked in chunks of kSosChunk samples through two buffers.
template <int NS, bool kRev>
__global__ void __launch_bounds__(32)
sosfilt_kernel(const float* __restrict__ x, const float* __restrict__ zi,
               const float* __restrict__ coef, float* __restrict__ y, SosParams P) {
  constexpr int D = kRev ? -1 : 1;  // the walk's step through a buffer row
  extern __shared__ float bufs[];
  float* state = bufs + 2 * 32 * kSosStride;
  const int lane = threadIdx.x;
  const int ev0 = blockIdx.x * 32;
  const int rows = min(32, P.n - ev0);
  const int T = P.L;
  const int S = P.S;
  const size_t n = P.n;
  const float* src = x + (size_t)ev0 * T;
  float* dst = y + (size_t)ev0 * T;
  const int chunks = (T + kSosChunk - 1) / kSosChunk;
  // chunk c in walk order: its first sample and its length; the ragged
  // chunk is the last one walked (at the row's end forward, at its start in
  // reverse)
  auto span = [&](int c, int& t0, int& len) {
    if (kRev) {
      const int end = T - c * kSosChunk;
      t0 = max(0, end - kSosChunk);
      len = end - t0;
    } else {
      t0 = c * kSosChunk;
      len = min(kSosChunk, T - t0);
    }
  };
  // chunk c of the warp's rows into buffer c % 2, row by row, 32
  // consecutive samples a step (128 coalesced bytes); one commit group a
  // chunk, empty past the last chunk, so that group c is chunk c's
  auto fetch = [&](int c) {
    if (c < chunks) {
      int t0, len;
      span(c, t0, len);
      const unsigned base =
          (unsigned)__cvta_generic_to_shared(bufs + (c & 1) * 32 * kSosStride);
      for (int j = 0; j < rows; ++j) {
        const float* row = src + (size_t)j * T + t0;
#pragma unroll
        for (int q = 0; q < kSosChunk / 32; ++q) {
          const int t = lane + 32 * q;
          if (t < len)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                             base + 4u * (unsigned)(j * kSosStride + t)),
                         "l"(row + t)
                         : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // lanes past the last event filter whatever their buffer rows hold;
  // those rows are never stored
  const bool live = lane < rows;
  const int i = ev0 + lane;
  Sections<(NS > 0 ? NS : 1)> g;
  if constexpr (NS > 0) {
    g.load(coef, 0);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      g.z0[s] = live ? zi[(size_t)(2 * s) * n + i] : 0.0f;
      g.z1[s] = live ? zi[(size_t)(2 * s + 1) * n + i] : 0.0f;
    }
  } else {
    for (int q = 0; q < 2 * S; ++q) state[q * 32 + lane] = live ? zi[(size_t)q * n + i] : 0.0f;
  }

  fetch(0);
  for (int c = 0; c < chunks; ++c) {
    fetch(c + 1);  // in flight while chunk c is filtered
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk c is in
    __syncwarp();
    int t0, len;
    span(c, t0, len);
    float* buf = bufs + (c & 1) * 32 * kSosStride;
    float* p = buf + lane * kSosStride + (kRev ? len - 1 : 0);
    if constexpr (NS > 0) {
      if (len == kSosChunk) {
#pragma unroll 4
        for (int k = 0; k < kSosChunk; ++k, p += D) *p = g.step(*p);
      } else {
#pragma unroll 4
        for (int k = 0; k < len; ++k, p += D) *p = g.step(*p);
      }
    } else {
      for (int s0 = 0; s0 < S; s0 += kChunk) {
        switch (min(S - s0, kChunk)) {
          case 1: group_pass<1, D>(coef, s0, state, lane, p, len); break;
          case 2: group_pass<2, D>(coef, s0, state, lane, p, len); break;
          case 3: group_pass<3, D>(coef, s0, state, lane, p, len); break;
          default: group_pass<4, D>(coef, s0, state, lane, p, len); break;
        }
      }
    }
    __syncwarp();
    for (int j = 0; j < rows; ++j) {
      float* row = dst + (size_t)j * T + t0;
#pragma unroll
      for (int q = 0; q < kSosChunk / 32; ++q) {
        const int t = lane + 32 * q;
        if (t < len) row[t] = buf[j * kSosStride + t];
      }
    }
    __syncwarp();  // this buffer is refilled by the next iteration's fetch
  }
}

// K5, one thread per event: out[i, :] = sosfiltfilt of x[i, :] with the
// mean removed and the DC response added back. kStaged: the block's 32
// rows lie in the shared-memory tile (row stride `stride` words, odd, so 32
// threads on the same sample of their own rows hit 32 banks); else each
// thread works on its row of the (n, Lp) global scratch.
template <bool kStaged>
__global__ void __launch_bounds__(kTileRows)
sosfiltfilt_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ dc, const float* __restrict__ coef, float* out,
                   float* scratch, SosParams P, int stride) {
  extern __shared__ float tile[];
  const int lane = threadIdx.x;
  const int ev0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, P.n - ev0);
  const int L = P.L;
  const int p = P.padlen;
  const int Lp = L + 2 * p;
  if (kStaged) {
    // the block's rows lie back to back in x: 32 lanes copy consecutive
    // samples of one row at a time (128 coalesced bytes a step), every copy
    // in flight at once; sample t of row j lands at j * stride + p + t
    const float* src = x + (size_t)ev0 * L;
    const unsigned base = (unsigned)__cvta_generic_to_shared(tile);
    for (int j = 0; j < rows; ++j)
      for (int t = lane; t < L; t += 32)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         base + 4u * (unsigned)(j * stride + p + t)),
                     "l"(src + (size_t)j * L + t)
                     : "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
  }
  if (lane < rows) {
    const int i = ev0 + lane;
    float* r = kStaged ? tile + lane * stride : scratch + (size_t)i * Lp;
    // the centre minus the mean (x - mean in f32, as the plain version),
    // then scipy's odd extension at both ends (Lp = L + 2p):
    //   ext[t] = 2*xc[0] - xc[p - t]              for t < p,
    //   ext[t] = 2*xc[L-1] - xc[2*(L-1) + p - t]  for t >= p + L
    const float m = mean[i];
    for (int t = 0; t < L; ++t) r[p + t] = (kStaged ? r[p + t] : x[(size_t)i * L + t]) - m;
    const float x0 = r[p];
    const float xl = r[p + L - 1];
    for (int t = 0; t < p; ++t) {
      r[t] = 2.0f * x0 - r[2 * p - t];
      r[p + L + t] = 2.0f * xl - r[p + L - 2 - t];
    }
    // forward over the whole extension, in place, from zi * ext[0]
    const float first = r[0];
    auto init_f = [&](int s, int j) { return coef[s * kCoef + 5 + j] * first; };
    auto load_f = [&](int k) { return r[k]; };
    auto store_f = [&](int k, float v) { r[k] = v; };
    for (int s0 = 0; s0 < P.S; s0 += kChunk) run_chunk(coef, s0, P.S, Lp, load_f, store_f, init_f);
    // backward in place from zi * y_fwd[Lp-1], down to the first central
    // sample: the steps below it only feed outputs that are dropped
    const float first_b = r[Lp - 1];
    auto init_b = [&](int s, int j) { return coef[s * kCoef + 5 + j] * first_b; };
    auto load_b = [&](int k) { return r[Lp - 1 - k]; };
    auto store_b = [&](int k, float v) { r[Lp - 1 - k] = v; };
    for (int s0 = 0; s0 < P.S; s0 += kChunk)
      run_chunk(coef, s0, P.S, L + p, load_b, store_b, init_b);
    if (!kStaged) {
      const float d = dc[i];
      for (int t = 0; t < L; ++t) out[(size_t)i * L + t] = r[p + t] + d;
    }
  }
  if (kStaged) {
    // the centres plus the DC response, stored as they were read
    __syncwarp();
    for (int j = 0; j < rows; ++j) {
      const float d = dc[ev0 + j];
      for (int t = lane; t < L; t += 32)
        out[(size_t)(ev0 + j) * L + t] = tile[j * stride + p + t] + d;
    }
  }
}

template <int NS, bool kRev>
int launch_sosfilt(const float* x, const float* zi, const float* coef, float* y,
                   const SosParams& P, int smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sosfilt_kernel<NS, kRev>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  sosfilt_kernel<NS, kRev><<<(P.n + 31) / 32, 32, smem, s>>>(x, zi, coef, y, P);
  return (int)cudaGetLastError();
}

template <bool kRev>
int dispatch_sosfilt(const float* x, const float* zi, const float* coef, float* y,
                     const SosParams& P, int smem, cudaStream_t s) {
  switch (P.S) {
    case 1: return launch_sosfilt<1, kRev>(x, zi, coef, y, P, smem, s);
    case 2: return launch_sosfilt<2, kRev>(x, zi, coef, y, P, smem, s);
    case 3: return launch_sosfilt<3, kRev>(x, zi, coef, y, P, smem, s);
    case 4: return launch_sosfilt<4, kRev>(x, zi, coef, y, P, smem, s);
    default: return launch_sosfilt<0, kRev>(x, zi, coef, y, P, smem, s);
  }
}

bool bad_params(const SosParams* P) { return P->S < 1 || P->L < 1 || P->padlen < 0; }

}  // namespace

// K5 on `stream` for P->n events of P->L samples: x the event-major (n, L)
// float32 input, mean and dc its (n,) conditioning columns, coef the (S, 7)
// float32 rows, out the (n, L) output. stride > 0: the rows are filtered
// in a shared-memory tile of kTileRows events a block, rows of `stride`
// words (at least L + 2*padlen), 4 * kTileRows * stride bytes; stride 0:
// in `scratch`, an (n, L + 2*padlen) float32 buffer the caller allocates.
// ops/filter_cuda.py::filter_layout picks the mode and the stride. Returns
// the launch's cudaError_t.
extern "C" int wfa_sosfiltfilt(const float* x, const float* mean, const float* dc,
                               const float* coef, float* out, float* scratch,
                               const SosParams* P, int stride, void* stream) {
  if (P->n <= 0) return 0;
  if (bad_params(P) || P->L <= P->padlen || stride < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((P->n + kTileRows - 1) / kTileRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 0) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    sosfiltfilt_kernel<false><<<grid, kTileRows, 0, s>>>(x, mean, dc, coef, out, scratch, *P, 0);
    return (int)cudaGetLastError();
  }
  const long long smem = 4LL * kTileRows * stride;
  if (stride < P->L + 2 * P->padlen || smem > wfa::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sosfiltfilt_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sosfiltfilt_kernel<true><<<grid, kTileRows, (int)smem, s>>>(x, mean, dc, coef, out, nullptr,
                                                              *P, stride);
  return (int)cudaGetLastError();
}

// K6 on `stream`: x and y are the event-major (P->n, P->L) float32 rows, zi
// the (2S, n) initial state (rows z0, z1 of section 0, then section 1, ...),
// coef the (S, 7) rows; reverse != 0 runs each row from its last sample to
// its first. A block is one warp of 32 events with 4 * sosfilt_words(S)
// bytes of shared memory (ops/filter_cuda.py::sosfilt_layout mirrors it).
// Returns the launch's cudaError_t.
extern "C" int wfa_sosfilt(const float* x, const float* zi, const float* coef, float* y,
                           const SosParams* P, int reverse, void* stream) {
  if (P->n <= 0 || P->L <= 0) return 0;
  if (bad_params(P)) return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * sosfilt_words(P->S);
  if (smem > wfa::kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return reverse ? dispatch_sosfilt<true>(x, zi, coef, y, *P, (int)smem, s)
                 : dispatch_sosfilt<false>(x, zi, coef, y, *P, (int)smem, s);
}
