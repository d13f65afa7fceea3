// Host emulation of the CUDA pieces the register chain's headers use
// (csrc/warp_chain_regs.cuh and what it includes), for the CPU tests: one
// warp is 32 std::threads that meet at a barrier in every warp intrinsic
// (shuffles, ballots, __reduce_*_sync, __syncwarp), so code in which every
// lane calls each intrinsic runs as it does on the card. Float arithmetic
// is the host's IEEE single precision; build with -ffp-contract=off, as the
// card's build uses --fmad=false. Included before the headers
// (g++ -include cuda_runtime.h), which also take it for <cuda_runtime.h>.
#pragma once
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>

#define __host__
#define __device__
#define __forceinline__ inline
#define __global__
#define __restrict__

struct int4 { int x, y, z, w; };
struct int2 { int x, y; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// all 32 lanes meet here: the last to arrive opens the next phase; the
// others yield until it does (a futex barrier costs far more per phase)
struct LaneBarrier {
  std::atomic<int> arrived{0};
  std::atomic<int> phase{0};
  void arrive_and_wait() {
    const int ph = phase.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) == 31) {
      arrived.store(0, std::memory_order_relaxed);
      phase.fetch_add(1, std::memory_order_release);
    } else {
      while (phase.load(std::memory_order_acquire) == ph) std::this_thread::yield();
    }
  }
};

struct WarpEmu {
  LaneBarrier bar;
  uint32_t box[32];
};
extern WarpEmu* g_warp;
extern thread_local int g_lane;

inline uint32_t exch(uint32_t v, int src) {
  g_warp->box[g_lane] = v;
  g_warp->bar.arrive_and_wait();
  const uint32_t r = g_warp->box[src];
  g_warp->bar.arrive_and_wait();
  return r;
}
template <class T> inline T shfl_from(T v, int src) {
  static_assert(sizeof(T) == 4);
  uint32_t b;
  std::memcpy(&b, &v, 4);
  b = exch(b, src);
  T o;
  std::memcpy(&o, &b, 4);
  return o;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return shfl_from(v, src & 31); }
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int s = g_lane - (int)d;
  return shfl_from(v, s < 0 ? g_lane : s);
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  const int s = g_lane + (int)d;
  return shfl_from(v, s > 31 ? g_lane : s);
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return shfl_from(v, g_lane ^ m); }

template <class F> inline uint32_t all_lanes(uint32_t v, F f) {
  g_warp->box[g_lane] = v;
  g_warp->bar.arrive_and_wait();
  uint32_t r = f(g_warp->box);
  g_warp->bar.arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return all_lanes(pred != 0, [](uint32_t* b) {
    uint32_t m = 0;
    for (int i = 0; i < 32; ++i) m |= (b[i] ? 1u : 0u) << i;
    return m;
  });
}
inline int __reduce_min_sync(unsigned, int v) {
  return (int)all_lanes((uint32_t)v, [](uint32_t* b) {
    int m = (int)b[0];
    for (int i = 1; i < 32; ++i) m = std::min(m, (int)b[i]);
    return (uint32_t)m;
  });
}
inline int __reduce_max_sync(unsigned, int v) {
  return (int)all_lanes((uint32_t)v, [](uint32_t* b) {
    int m = (int)b[0];
    for (int i = 1; i < 32; ++i) m = std::max(m, (int)b[i]);
    return (uint32_t)m;
  });
}
inline int __reduce_add_sync(unsigned, int v) {
  return (int)all_lanes((uint32_t)v, [](uint32_t* b) {
    uint32_t m = 0;
    for (int i = 0; i < 32; ++i) m += b[i];
    return m;
  });
}
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar.arrive_and_wait(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __float2int_rn(float x) { return (int)std::nearbyintf(x); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
