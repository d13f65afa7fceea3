// Fused per-event chain on Hopper (sm_90a), one warp per event on the
// event-major int16 rows: features -> scipy-parity find_peaks ->
// threshold-hit runs -> 10-90% widths -> S1/S2 label.
//
// Replaces the TPU kernel waveformanalysis_tpu/ops/chain_scan_pallas.py:90
// (_chain_scan_kernel); its contract is models/full_chain.py
// (full_chain_step), whose PyTorch port is the plain version this kernel is
// tested against (ops/chain_scan_cuda.py).
//
// Its byte bound: the inputs are read once (2 L + 9 bytes an event) and 45
// bytes an event are written, with 8 bytes of counters a batch: 0.0111 ms
// at 65,536 x 256 and 0.177 ms at 1,048,576 x 256 at 3.35 TB/s. What holds
// it is not its bytes but the instructions it issues and the chains of
// dependent ones (ballots, shuffles, reductions): the staged design below
// took 5.09 ms at 1,048,576 x 256, 3.5 % of that bound (PERF.md).
//
// Two paths, which the wrapper picks by L (ops/chain_scan_cuda.py::
// chain_layout):
//
// - L <= 256, the register path (chain_reg_kernel, warp_chain_regs.cuh): the
//   event's row lives in the warp's registers, R = 1, 2, 4 or 8 contiguous
//   samples a lane (a template parameter), loaded by one vector load a lane
//   where rows are 16-byte aligned and converted to the float signal once.
//   Every pass is straight-line work on a lane's R registers and a fixed
//   number of ballots, shuffles and __reduce_*_sync steps, however far it
//   reaches: no loop over the row 32 samples a step, no per-slot walk of up
//   to 8 steps a search. A float32 copy of the signal in shared memory
//   serves the few reads at a runtime index.
// - Longer rows, the staged path (chain_warp_kernel, warp_chain.cuh's
//   chain_event<false>): the warp stages its event's int16 row in shared
//   memory once (16-byte cp.async where rows are 16-byte aligned) and forms
//   every float it needs from it at each read (2 L + 512 bytes a warp); the
//   passes are the ones the tile chain kernel (chain_tile.cu) runs too.
//
// The register path at R = 8 (L = 256, no derivative): ptxas -v 57 registers
// a thread, no spills, 32 warps an SM at 4 warps a block (the staged kernel:
// 48 registers, 40 warps). At 1,048,576 x 256 with the benchmark's config it
// took 2.399 / 2.402 ms against the staged kernel's 5.152 / 5.126 ms, in
// turns on an NVIDIA H100 80GB HBM3 at 700 W (scripts/scan_kernel_turns.py;
// PERF.md, §6): still bound by the instructions it issues, most of them in
// the candidate scan and the walks of the kept peaks (about 110 a slot
// before the prominence test). The prominence screen (warp_chain_regs.cuh)
// spares the walks of the kept slots that cannot reach the prominence, 4.2
// of the 5.4 on the benchmark's wide pulses: 2.403 / 2.384 -> 2.167 / 2.152
// ms in turns, the outputs bit for bit; on rows where it runs and spares
// none (two narrow pulses a row) 2.493 / 2.481 -> 2.543 / 2.542 ms.
//
// A step is one memset and one launch: the C entries zero ChainOut's two
// overflow counters on the stream, and lane 0 of each event's warp adds the
// event's flags into them (warp_chain.cuh's count_overflow), where the
// wrapper summed per-event counts in four launches of its own. An atomic add
// a set flag: on a batch where every event sets both, K1 at 1,048,576 x 256
// took 0.8 % longer than the kernel that wrote the per-event counts, on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, §6).
//
// The earlier design (one thread per event on a time-major copy that the
// wrapper made, with the slot tables in registers: 128 of them at K = 8)
// spent almost as long on the copy as in the kernel at 1M events (PERF.md).
//
// Exactness: see warp_chain.cuh and warp_chain_regs.cuh (--fmad=false, IEEE
// division, rounding half to even, exact int32 sums for L < 65536).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_chain.cuh"
#include "warp_chain_regs.cuh"

namespace {

// the register chain of rows of L <= 32 R samples (warp_chain_regs.cuh)
template <int R, bool kDeriv>
__global__ void __launch_bounds__(256)
chain_reg_kernel(const int16_t* __restrict__ waves, const int32_t* __restrict__ el_in,
                 const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                 ChainOut out, ChainParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const wfa::RegChainResult r = wfa::chain_event_regs<R, kDeriv>(
      waves + (size_t)ev * P.L, ev, el_in[ev], bl_in[ev], pol_in[ev], out, P,
      smem + warp * wfa::reg_warp_bytes(R, kDeriv), vec, lane);
  wfa::count_overflow(out, r.overflow, lane);  // r.screened dropped: no count in the timed kernel
}

using ChainKernel = void (*)(const int16_t*, const int32_t*, const float*, const int8_t*,
                             ChainOut, ChainParams, int);

// the register kernel for R samples a lane (1, 2, 4 or 8), or null
ChainKernel reg_kernel(int R, bool deriv) {
  switch (R) {
    case 1: return deriv ? chain_reg_kernel<1, true> : chain_reg_kernel<1, false>;
    case 2: return deriv ? chain_reg_kernel<2, true> : chain_reg_kernel<2, false>;
    case 4: return deriv ? chain_reg_kernel<4, true> : chain_reg_kernel<4, false>;
    case 8: return deriv ? chain_reg_kernel<8, true> : chain_reg_kernel<8, false>;
    default: return nullptr;
  }
}

__global__ void __launch_bounds__(256)
chain_warp_kernel(const int16_t* __restrict__ waves, const int32_t* __restrict__ el_in,
                  const float* __restrict__ bl_in, const int8_t* __restrict__ pol_in,
                  ChainOut out, ChainParams P, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ev = blockIdx.x * (blockDim.x >> 5) + warp;
  if (ev >= P.n) return;  // the ragged last block: the whole warp leaves
  const ChainOverflow f = wfa::chain_event<false>(
      waves + (size_t)ev * P.L, ev, el_in[ev], bl_in[ev], pol_in[ev], out, P,
      smem + warp * wfa::chain_warp_bytes(P.L, false), vec, lane);
  wfa::count_overflow(out, f, lane);
}

}  // namespace

// Launches the chain on `stream` for P->n events of P->L samples, `rows`
// events (warps) per block. waves is the event-major (n, L) int16 matrix;
// vec != 0 promises 16-byte aligned rows (L % 8 == 0 and an aligned base).
// Slot tables hold up to 32 peaks and 32 runs; the rows always fit shared
// memory (L < 65536). ops/chain_scan_cuda.py::row_layout picks rows and vec.
// The overflow counters are zeroed first, also for an empty batch, which
// launches nothing else. Returns the cudaError_t of the launch (0 = success).
extern "C" int wfa_chain_scan(const int16_t* waves, const int32_t* event_length,
                              const float* baselines, const int8_t* polarity_codes,
                              const ChainOut* out, const ChainParams* P, int rows, int vec,
                              void* stream) {
  const cudaError_t z = wfa::zero_overflow(out, static_cast<cudaStream_t>(stream));
  if (z != cudaSuccess || P->n <= 0) return (int)z;
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

// Launches the register chain (warp_chain_regs.cuh) on `stream` for P->n
// events of P->L <= 32 R samples, `rows` events (warps) per block, R = 1, 2,
// 4 or 8 samples a lane. smem must be rows * wfa::reg_warp_bytes(R,
// use_derivative), the bytes ops/chain_scan_cuda.py::chain_layout gives;
// vec != 0 promises 16-byte aligned rows with L % 8 == 0. The overflow
// counters are zeroed first, as in wfa_chain_scan. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int wfa_chain_scan_regs(const int16_t* waves, const int32_t* event_length,
                                   const float* baselines, const int8_t* polarity_codes,
                                   const ChainOut* out, const ChainParams* P, int rows, int R,
                                   int vec, int smem, void* stream) {
  const cudaError_t z = wfa::zero_overflow(out, static_cast<cudaStream_t>(stream));
  if (z != cudaSuccess || P->n <= 0) return (int)z;
  const bool deriv = P->use_derivative != 0;
  const ChainKernel k = reg_kernel(R, deriv);
  if (k == nullptr || P->K < 1 || P->K_hits < 1 || P->K > 32 || P->K_hits > 32 || P->L < 2 ||
      P->L > 32 * R || rows < 1 || rows > 8 || smem != rows * wfa::reg_warp_bytes(R, deriv) ||
      (vec && P->L % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P->n + rows - 1) / rows);
  k<<<grid, 32 * rows, smem, static_cast<cudaStream_t>(stream)>>>(
      waves, event_length, baselines, polarity_codes, *out, *P, vec);
  return (int)cudaGetLastError();
}

// Warps of the chain kernel an SM holds at `rows` warps and `smem` bytes of
// dynamic shared memory a block (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// the register kernel for R = 1, 2, 4 or 8, the staged one for R = 0. A
// negative value is a cudaError_t.
extern "C" int wfa_chain_scan_warps_per_sm(int R, int deriv, int rows, int smem) {
  const void* k = R == 0 ? reinterpret_cast<const void*>(chain_warp_kernel)
                         : reinterpret_cast<const void*>(reg_kernel(R, deriv != 0));
  if (k == nullptr) return -(int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, 32 * rows, smem);
  return e == cudaSuccess ? blocks * rows : -(int)e;
}
