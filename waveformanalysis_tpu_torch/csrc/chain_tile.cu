// Fused per-event chain on Hopper (sm_90a), one warp per event on the
// event-major rows, `tile_rows` events a block: features -> scipy-parity
// find_peaks -> threshold-hit runs -> 10-90% widths -> S1/S2 label.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_pallas.py:80
// (_chain_kernel, the tile-resident chain); its contract is
// models/full_chain.py (full_chain_step), whose PyTorch port is the plain
// version this kernel is tested against (ops/chain_tile_cuda.py).
//
// Design. The TPU kernel loads an (R, L) tile into VMEM once and computes
// the chain with log-depth shift scans along the sample axis and one-hot
// masked reductions (the TPU has no lane gather). Here the tile is a block
// of `tile_rows` warps, one event each: the warp stages its event's int16
// row in shared memory once, read straight from the event-major (n, L)
// matrix (no transposing copy; 16-byte cp.async where rows are 16-byte
// aligned), and runs the chain's warp passes on it (warp_chain.cuh, shared
// with the chain kernel chain_scan.cu): the ballot candidate scan, warp
// distance pruning, warp base and crossing searches 32 samples a step, the
// ballot run pass and warp segment sums, the width search by ballot. No
// lane walks a slot alone, so a tall peak's walk to the row start no longer
// holds 31 idle lanes.
//
// The row it reads the signal from: with kFloatRow the features pass writes
// the signal once into a float32 row beside the int16 one (6 L + 512 bytes
// a warp) and every later pass reads it from there, one shared load in
// place of a load, a conversion, a subtraction and a product; without it
// (the long-row mode) only the int16 row is kept and the signal formed at
// each read, as the chain kernel does, so every L < 65536 runs. The wrapper
// keeps the float row where it leaves as many warps on an SM as the int16
// row (L <= 1,108 at 8 warps a block). At 1,048,576 x 256 it made the
// kernel 17 % faster than the int16 row alone on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md, scripts/scan_kernel_turns.py).
//
// What bounds it on this card: bytes. The inputs are read once (2 L + 9
// bytes an event) and 45 bytes an event are written, with 8 bytes of
// counters a batch: 0.0111 ms at 65,536 x 256 and 0.177 ms at 1,048,576 x
// 256 at 3.35 TB/s.
//
// Shared memory: wfa::chain_warp_bytes(L, float_row) a warp
// (ops/chain_tile_cuda.py::tile_layout mirrors it and picks the row by the
// warps an SM holds). The wrapper lowers the events per block where
// `tile_rows` rows do not fit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_chain.cuh"

namespace {

template <bool kFloatRow>
__global__ void __launch_bounds__(1024)
chain_tile_kernel(const int16_t* __restrict__ waves, const int32_t* __restrict__ el_in,
                  const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                  ChainOut out, ChainParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const ChainOverflow f = wfa::chain_event<kFloatRow>(
      waves + (size_t)ev * P.L, ev, el_in[ev], bl_in[ev], pol_in[ev], out, P,
      smem + warp * wfa::chain_warp_bytes(P.L, kFloatRow), vec, lane);
  wfa::count_overflow(out, f, lane);
}

template <bool kFloatRow>
int launch(const int16_t* waves, const int32_t* el, const float* bl, const int8_t* pol,
           const ChainOut* out, const ChainParams* P, int rows, int vec, int smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chain_tile_kernel<kFloatRow>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P->n + rows - 1) / rows);
  chain_tile_kernel<kFloatRow><<<grid, 32 * rows, smem, s>>>(waves, el, bl, pol, *out, *P, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the chain on `stream` for P->n events of P->L samples, `rows`
// events (warps) per block. waves is the event-major (n, L) int16 matrix;
// vec != 0 promises 16-byte aligned rows (L % 8 == 0 and an aligned base);
// float_row != 0 keeps the float32 signal row beside the int16 one. Slot
// tables hold up to 32 peaks and 32 runs; `rows` events must fit the
// block's shared memory (ops/chain_tile_cuda.py::tile_layout). The overflow
// counters are zeroed first, also for an empty batch, which launches nothing
// else. Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_chain_tile(const int16_t* waves, const int32_t* event_length,
                              const float* baselines, const int8_t* polarity_codes,
                              const ChainOut* out, const ChainParams* P, int rows, int vec,
                              int float_row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t z = wfa::zero_overflow(out, s);
  if (z != cudaSuccess || P->n <= 0) return (int)z;
  const int smem = rows * wfa::chain_warp_bytes(P->L, float_row != 0);
  if (P->K < 1 || P->K_hits < 1 || P->K > 32 || P->K_hits > 32 || P->L < 2 || rows < 1 ||
      rows > 32 || smem > wfa::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (float_row)
    return launch<true>(waves, event_length, baselines, polarity_codes, out, P, rows, vec, smem, s);
  return launch<false>(waves, event_length, baselines, polarity_codes, out, P, rows, vec, smem, s);
}
