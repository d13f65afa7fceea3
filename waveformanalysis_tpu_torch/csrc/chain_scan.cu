// Fused per-event chain on Hopper (sm_90a), one warp per event on the
// event-major int16 rows: features -> scipy-parity find_peaks ->
// threshold-hit runs -> 10-90% widths -> S1/S2 label.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py:90
// (_chain_scan_kernel); its contract is models/full_chain.py
// (full_chain_step), whose PyTorch port is the plain version this kernel is
// tested against (ops/chain_scan_cuda.py).
//
// What bounds it on this card: bytes. The int16 row is read once (2 L
// bytes) and 53 bytes per event are written: 0.0112 ms at 65,536 x 256 and
// 0.180 ms at 1,048,576 x 256 at 3.35 TB/s.
//
// Design. One warp owns one event, `rows` events a block. The warp stages
// its event's int16 row in shared memory once, read straight from the
// event-major (n, L) matrix (no transposing copy; 16-byte cp.async where
// rows are 16-byte aligned), and forms every float it needs from it at each
// read: no float copy of the row is kept, so a warp holds 2 L + 512 bytes of
// shared memory. The passes (features, the find_peaks kernel's candidate
// scan, pruning and walks, the hit kernel's run and segment passes, the
// raw-wave heights and the width search) are warp_chain.cuh's, which the
// tile chain kernel (chain_tile.cu) runs too.
//
// The earlier design (one thread per event on a time-major copy that the
// wrapper made, with the slot tables in registers: 128 of them at K = 8)
// spent almost as long on the copy as in the kernel at 1M events (PERF.md).
//
// Exactness: see warp_chain.cuh (--fmad=false, IEEE division, rounding half
// to even, exact int32 sums for L < 65536).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_chain.cuh"

namespace {

__global__ void __launch_bounds__(256)
chain_warp_kernel(const int16_t* __restrict__ waves, const int32_t* __restrict__ el_in,
                  const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                  ChainOut out, ChainParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  wfa::chain_event<false>(waves + (size_t)ev * P.L, ev, el_in[ev], bl_in[ev], pol_in[ev], out,
                          P, smem + warp * wfa::chain_warp_bytes(P.L, false), vec, lane);
}

}  // namespace

// Launches the chain on `stream` for P->n events of P->L samples, `rows`
// events (warps) per block. waves is the event-major (n, L) int16 matrix;
// vec != 0 promises 16-byte aligned rows (L % 8 == 0 and an aligned base).
// Slot tables hold up to 32 peaks and 32 runs; the rows always fit shared
// memory (L < 65536). ops/chain_scan_cuda.py::row_layout picks rows and vec.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_chain_scan(const int16_t* waves, const int32_t* event_length,
                              const float* baselines, const int8_t* polarity_codes,
                              const ChainOut* out, const ChainParams* P, int rows, int vec,
                              void* stream) {
  if (P->n <= 0) return 0;
  const int smem = rows * wfa::chain_warp_bytes(P->L, false);
  if (P->K < 1 || P->K_hits < 1 || P->K > 32 || P->K_hits > 32 || P->L < 2 || rows < 1 ||
      rows > 8 || smem > wfa::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  chain_warp_kernel<<<grid, 32 * rows, smem, static_cast<cudaStream_t>(stream)>>>(
      waves, event_length, baselines, polarity_codes, *out, *P, vec);
  return (int)cudaGetLastError();
}
