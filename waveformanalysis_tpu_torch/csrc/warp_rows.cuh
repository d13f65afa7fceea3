// One warp per event on the event-major (n, L) rows: the row staging and
// warp helpers shared by the warp-per-event kernels: the chains
// (chain_scan.cu, chain_tile.cu), find_peaks (peaks_scan.cu), threshold hits
// (hits_scan.cu) and width crossings (width_scan.cu). warp_peaks.cuh,
// warp_hits.cuh and warp_chain.cuh build their passes from these.
//
// A block holds `rows` warps, one event each. A warp copies its event's row
// into its own shared-memory buffer with cp.async, 16 bytes a lane where
// the rows are 16-byte aligned, else with plain element loads, and works on
// it there. Rows too long for shared memory are read from global memory
// instead (`staged` = 0): the kernels take the row source as a template
// parameter. A double-buffered copy of the next event's row, tried on the
// H100, bought nothing that the other resident warps did not already give
// (PERF.md), so each warp holds one buffer.
//
// ops/chain_scan_cuda.py (row_layout) mirrors row_bytes and the per-warp
// byte counts: keep the two in step.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wfa {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use (H100)

// bytes of one staged row of L elements of `elem` bytes, padded to 16
__host__ __device__ __forceinline__ int row_bytes(int L, int elem) {
  return (L * elem + 15) / 16 * 16;
}

// shared memory of one warp: its row buffer (none for long rows) and
// `slot_bytes` of per-warp tables
__host__ __device__ __forceinline__ int warp_bytes(int L, int elem, int staged,
                                                   int slot_bytes) {
  return (staged ? row_bytes(L, elem) : 0) + slot_bytes;
}

// Copy row `src` (L elements of T) into shared `dst`: 16-byte cp.async
// copies when `vec` (row and base 16-byte aligned), else plain loads. The
// whole warp calls it; the row is visible to every lane on return.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* __restrict__ src, int L, int vec,
                                          int lane) {
  if (vec) {
    const int nq = L * (int)sizeof(T) / 16;
    const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
    const char* s = reinterpret_cast<const char*>(src);
    for (int q = lane; q < nq; q += 32)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16 * q),
                   "l"(s + 16 * (size_t)q)
                   : "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int t = lane; t < L; t += 32) dst[t] = __ldg(src + t);
  }
  __syncwarp();
}

// set bits below `lane`
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Warp-wide minimum of (v, i) with an index tie-break: of equal values the
// larger index wins when `later`, else the smaller. Every lane ends with the
// result (the order is total, so the butterfly agrees everywhere).
__device__ __forceinline__ void warp_argmin(float& v, int& i, bool later) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov < v || (ov == v && (later ? oi > i : oi < i))) {
      v = ov;
      i = oi;
    }
  }
}

// Warp-wide maximum of (v, i); of equal values the smaller index wins (the
// first maximum, as np.argmax). Every lane ends with the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// Butterfly sum: every lane ends with the same value (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// First t in [lo, hi) with cond(t) for two conditions at once, 32 samples a
// step; `hi` = not found. Warp-uniform results.
template <typename C0, typename C1>
__device__ __forceinline__ void first_two(int lo, int hi, int lane, C0 c0, C1 c1, int& f0,
                                          int& f1) {
  f0 = f1 = hi;
  for (int b = lo; b < hi; b += 32) {
    const int t = b + lane;
    bool a0 = false, a1 = false;
    if (t < hi) {
      a0 = c0(t);
      a1 = c1(t);
    }
    const unsigned m0 = __ballot_sync(kFull, a0);
    const unsigned m1 = __ballot_sync(kFull, a1);
    if (f0 == hi && m0) f0 = b + __ffs(m0) - 1;
    if (f1 == hi && m1) f1 = b + __ffs(m1) - 1;
    if (f0 < hi && f1 < hi) break;
  }
}

}  // namespace wfa
