// Host emulation of the CUDA pieces the register chain's headers use
// (csrc/warp_chain_regs.cuh and what it includes), for the CPU tests: one
// warp is 32 fibers (ucontext) of one thread, each lane on its own stack.
// Every warp intrinsic (shuffles, ballots, __reduce_*_sync, __syncwarp)
// hands over to the next lane in lane order, so when lane 0 resumes, all 32
// lanes have arrived: code in which every lane calls each intrinsic runs as
// it does on the card, at the cost of its work whatever else the host runs.
// A lane that returns while lane 0 waits at an intrinsic, or that calls
// another intrinsic than lane 0 (or one after lane 0 returned), is a
// divergent warp: the emulator names the lane and exits with status 3.
// Float arithmetic is the host's IEEE single precision; build with
// -ffp-contract=off, as the card's build uses --fmad=false. Included before
// the headers (g++ -include cuda_runtime.h), which also take it for
// <cuda_runtime.h>.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>

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

inline int g_lane;  // the lane that runs

namespace warp_emu {
constexpr size_t kStackBytes = 1 << 20;  // a lane's stack, far more than its frames take
inline ucontext_t main_ctx, lane_ctx[32];
inline uint32_t box[32];  // each lane's value at the intrinsic in progress
inline const char* at;    // lane 0's intrinsic in this round; nullptr once it returned
inline long calls;        // lane 0's handovers so far

[[noreturn]] inline void diverged(const char* what) {
  std::fprintf(stderr, "divergent warp: lane %d %s%s while lane 0 %s%s (lane 0's handover %ld)\n",
               g_lane, what ? "calls " : "returned", what ? what : "",
               at ? "waits at " : "has returned", at ? at : "", calls);
  std::exit(3);
}

// lane g_lane arrives at intrinsic `what` (nullptr: the lane returned) and
// the next lane runs; lane 31 hands over to lane 0, or to main once every
// lane returned
inline void handover(const char* what) {
  const int me = g_lane;
  if (me == 0) {
    at = what;
    ++calls;
  } else if (what != at && !(what && at && !std::strcmp(what, at))) {
    diverged(what);
  }
  g_lane = (me + 1) & 31;
  if (!what) setcontext(me == 31 ? &main_ctx : &lane_ctx[g_lane]);
  swapcontext(&lane_ctx[me], &lane_ctx[g_lane]);
}

// runs body(lane) as the 32 lanes of one warp, until every lane returned
template <class F> void run_warp(F body) {
  static F* the;
  the = &body;
  std::unique_ptr<char[]> stacks(new char[32 * kStackBytes]);
  for (int lane = 0; lane < 32; ++lane) {
    getcontext(&lane_ctx[lane]);
    lane_ctx[lane].uc_stack.ss_sp = stacks.get() + lane * kStackBytes;
    lane_ctx[lane].uc_stack.ss_size = kStackBytes;
    lane_ctx[lane].uc_link = nullptr;
    void (*entry)(int) = [](int l) {
      (*the)(l);
      handover(nullptr);
    };
    makecontext(&lane_ctx[lane], reinterpret_cast<void (*)()>(entry), 1, lane);
  }
  g_lane = 0;
  at = nullptr;
  calls = 0;
  swapcontext(&main_ctx, &lane_ctx[0]);
}

// every lane puts v in the box; once all have, each reads the box, and the
// second handover keeps lane 0 from writing the next value before lane 31
// read this one
template <class F> inline uint32_t all_lanes(uint32_t v, const char* what, F f) {
  box[g_lane] = v;
  handover(what);
  const uint32_t r = f(box);
  handover(what);
  return r;
}
}  // namespace warp_emu

template <class T> inline T shfl_from(T v, int src, const char* what) {
  static_assert(sizeof(T) == 4);
  uint32_t b;
  std::memcpy(&b, &v, 4);
  b = warp_emu::all_lanes(b, what, [src](const uint32_t* box) { return box[src]; });
  T o;
  std::memcpy(&o, &b, 4);
  return o;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  return shfl_from(v, src & 31, "__shfl_sync");
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int s = g_lane - (int)d;
  return shfl_from(v, s < 0 ? g_lane : s, "__shfl_up_sync");
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  const int s = g_lane + (int)d;
  return shfl_from(v, s > 31 ? g_lane : s, "__shfl_down_sync");
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return shfl_from(v, g_lane ^ m, "__shfl_xor_sync");
}

inline unsigned __ballot_sync(unsigned, int pred) {
  return warp_emu::all_lanes(pred != 0, "__ballot_sync", [](const uint32_t* b) {
    uint32_t m = 0;
    for (int i = 0; i < 32; ++i) m |= (b[i] ? 1u : 0u) << i;
    return m;
  });
}
inline int __reduce_min_sync(unsigned, int v) {
  return (int)warp_emu::all_lanes((uint32_t)v, "__reduce_min_sync", [](const uint32_t* b) {
    int m = (int)b[0];
    for (int i = 1; i < 32; ++i) m = std::min(m, (int)b[i]);
    return (uint32_t)m;
  });
}
inline int __reduce_max_sync(unsigned, int v) {
  return (int)warp_emu::all_lanes((uint32_t)v, "__reduce_max_sync", [](const uint32_t* b) {
    int m = (int)b[0];
    for (int i = 1; i < 32; ++i) m = std::max(m, (int)b[i]);
    return (uint32_t)m;
  });
}
inline int __reduce_add_sync(unsigned, int v) {
  return (int)warp_emu::all_lanes((uint32_t)v, "__reduce_add_sync", [](const uint32_t* b) {
    uint32_t m = 0;
    for (int i = 0; i < 32; ++i) m += b[i];
    return m;
  });
}
inline void __syncwarp(unsigned = 0xffffffffu) { warp_emu::handover("__syncwarp"); }
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
