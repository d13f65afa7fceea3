// Runs the register chain wfa::chain_event_regs<R, deriv> on the host, one
// std::thread per lane (cuda_runtime.h in this directory), for the CPU tests
// (tests/test_torch_chain_regs_emu.py).
//
//   chain_regs_emu <in> <out> <R>
//
// <in>: int32 n, L; the ChainParams struct; int16 waves[n][L]; int32
// event_length[n]; float32 baselines[n]; int8 polarity_codes[n]. <out>: the
// 12 per-event outputs, each an array of n, in ChainOut's field order, then
// the two int32 counts of lane 0's returned overflow flags (peaks, hits), as
// the kernel's atomic adds count them. The rows are 16-byte aligned, so L %
// 8 == 0 takes the vector loads.
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#include "warp_chain_regs.cuh"

WarpEmu* g_warp;
thread_local int g_lane;

template <int R, bool D>
void run(int n, const ChainParams& P, const int16_t* w, const int32_t* el, const float* bl,
         const int8_t* pol, const ChainOut& out, int32_t* counts) {
  std::vector<int4> smem((wfa::reg_warp_bytes(R, D) + 15) / 16);
  unsigned char* mine = reinterpret_cast<unsigned char*>(smem.data());
  const int vec = P.L % 8 == 0;
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < 32; ++lane)
    lanes.emplace_back([&, lane] {
      g_lane = lane;
      for (int ev = 0; ev < n; ++ev) {
        const ChainOverflow f = wfa::chain_event_regs<R, D>(w + (size_t)ev * P.L, ev, el[ev],
                                                             bl[ev], pol[ev], out, P, mine, vec,
                                                             lane);
        if (lane == 0) {
          counts[0] += f.peaks;
          counts[1] += f.hits;
        }
        g_warp->bar.arrive_and_wait();  // the warp's shared memory is free again
      }
    });
  for (auto& t : lanes) t.join();
}

template <bool D>
void run_r(int R, int n, const ChainParams& P, const int16_t* w, const int32_t* el,
           const float* bl, const int8_t* pol, const ChainOut& out, int32_t* counts) {
  switch (R) {
    case 1: return run<1, D>(n, P, w, el, bl, pol, out, counts);
    case 2: return run<2, D>(n, P, w, el, bl, pol, out, counts);
    case 4: return run<4, D>(n, P, w, el, bl, pol, out, counts);
    case 8: return run<8, D>(n, P, w, el, bl, pol, out, counts);
    default: std::fprintf(stderr, "R must be 1, 2, 4 or 8\n"); std::exit(2);
  }
}

template <class T>
void read(FILE* f, T* p, size_t count) {
  if (std::fread(p, sizeof(T), count, f) != count) {
    std::fprintf(stderr, "short input\n");
    std::exit(2);
  }
}

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: chain_regs_emu <in> <out> <R>\n");
    return 2;
  }
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) return 2;
  int hdr[2];
  ChainParams P;
  read(f, hdr, 2);
  read(f, &P, 1);
  const int n = hdr[0], L = hdr[1];
  std::vector<int4> wbuf(((size_t)n * L * 2 + 15) / 16 + 1);  // 16-byte aligned rows
  int16_t* w = reinterpret_cast<int16_t*>(wbuf.data());
  std::vector<int32_t> el(n);
  std::vector<float> bl(n);
  std::vector<int8_t> pol(n);
  read(f, w, (size_t)n * L);
  read(f, el.data(), n);
  read(f, bl.data(), n);
  read(f, pol.data(), n);
  std::fclose(f);

  std::vector<float> fo[7];
  std::vector<int32_t> io[3];
  std::vector<int8_t> label(n);
  for (auto& v : fo) v.resize(n);
  for (auto& v : io) v.resize(n);
  std::vector<float> hit_integral(n), max_abs_diff(n);
  const ChainOut out{fo[0].data(), fo[1].data(), fo[2].data(), max_abs_diff.data(),
                     io[0].data(), io[1].data(), io[2].data(), hit_integral.data(),
                     fo[3].data(), fo[4].data(), fo[5].data(), label.data(), nullptr,
                     nullptr};  // the kernel's counters: counts below
  int32_t counts[2] = {0, 0};
  WarpEmu warp;
  g_warp = &warp;
  const int R = std::atoi(argv[3]);
  if (P.use_derivative) run_r<true>(R, n, P, w, el.data(), bl.data(), pol.data(), out, counts);
  else run_r<false>(R, n, P, w, el.data(), bl.data(), pol.data(), out, counts);

  FILE* g = std::fopen(argv[2], "wb");
  if (!g) return 2;
  const void* cols[12] = {out.height, out.amp, out.area, out.max_abs_diff, out.peak_position,
                          out.n_peaks, out.n_hits, out.hit_integral, out.rise_samples,
                          out.fall_samples, out.width_samples, out.label};
  for (int c = 0; c < 12; ++c) std::fwrite(cols[c], c == 11 ? 1 : 4, n, g);
  std::fwrite(counts, 4, 2, g);
  std::fclose(g);
  return 0;
}
