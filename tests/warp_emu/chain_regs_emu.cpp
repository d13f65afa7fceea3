// Runs the register chain wfa::chain_event_regs<R, deriv> on the host, one
// warp of 32 fibers (cuda_runtime.h in this directory), for the CPU tests
// (tests/test_torch_chain_regs_emu.py).
//
//   chain_regs_emu <in> <out> <R>
//   chain_regs_emu --selftest <name>
//
// <in>: int32 n, L; the ChainParams struct; int16 waves[n][L]; int32
// event_length[n]; float32 baselines[n]; int8 polarity_codes[n]. <out>: the
// 12 per-event outputs, each an array of n, in ChainOut's field order, then
// the two int32 counts of lane 0's returned overflow flags (peaks, hits), as
// the kernel's atomic adds count them, then the int32 sum of the kept slots
// the prominence screen took off the walks. The rows are 16-byte aligned, so
// L % 8 == 0 takes the vector loads.
//
// --selftest runs one intrinsic group on known lane values (shfl, shfl_up,
// shfl_down, shfl_xor, ballot, reduce_min, reduce_max, reduce_add) and
// prints a line per call: a label and the 32 lanes' results as int32; or a
// divergent warp (divergent_return, divergent_extra), which must exit
// non-zero with the lane named.
#include <climits>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "warp_chain_regs.cuh"

template <int R, bool D>
void run(int n, const ChainParams& P, const int16_t* w, const int32_t* el, const float* bl,
         const int8_t* pol, const ChainOut& out, int32_t* counts) {
  std::vector<int4> smem((wfa::reg_warp_bytes(R, D) + 15) / 16);
  unsigned char* mine = reinterpret_cast<unsigned char*>(smem.data());
  const int vec = P.L % 8 == 0;
  warp_emu::run_warp([&](int lane) {
    for (int ev = 0; ev < n; ++ev) {
      const wfa::RegChainResult r = wfa::chain_event_regs<R, D>(
          w + (size_t)ev * P.L, ev, el[ev], bl[ev], pol[ev], out, P, mine, vec, lane);
      if (lane == 0) {
        counts[0] += r.overflow.peaks;
        counts[1] += r.overflow.hits;
        counts[2] += r.screened;
      }
      __syncwarp();  // the warp's shared memory is free again
    }
  });
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

// one warp computes f(lane) in every lane; prints the label and the results
template <class F> void print_lanes(const std::string& label, F f) {
  int r[32];
  warp_emu::run_warp([&](int lane) { r[lane] = (int)f(lane); });
  std::printf("%s", label.c_str());
  for (int x : r) std::printf(" %d", x);
  std::printf("\n");
}

int selftest(const std::string& name) {
  constexpr unsigned all = 0xffffffffu;
  const auto v = [](int lane) { return lane * 37 % 64 - 20; };  // distinct, of both signs
  if (name == "shfl") {
    for (int s : {0, 31, 33, -1})
      print_lanes("src=" + std::to_string(s), [&](int l) { return __shfl_sync(all, v(l), s); });
    print_lanes("src=7l+3", [&](int l) { return __shfl_sync(all, v(l), 7 * l + 3); });
  } else if (name == "shfl_up" || name == "shfl_down") {
    for (unsigned d : {0u, 1u, 5u, 31u, 32u})
      print_lanes("delta=" + std::to_string(d), [&](int l) {
        return name == "shfl_up" ? __shfl_up_sync(all, v(l), d) : __shfl_down_sync(all, v(l), d);
      });
  } else if (name == "shfl_xor") {
    for (int m : {0, 1, 5, 16, 31})
      print_lanes("mask=" + std::to_string(m), [&](int l) { return __shfl_xor_sync(all, v(l), m); });
    // a float's bits cross as they are: a NaN's payload, -0
    print_lanes("float_bits", [&](int l) {
      const int bits = l == 0 ? 0x7fc00001 : l == 1 ? INT_MIN : l * 0x01010101;
      return __float_as_int(__shfl_xor_sync(all, __int_as_float(bits), 1));
    });
  } else if (name == "ballot") {
    print_lanes("l%3==0", [&](int l) { return __ballot_sync(all, l % 3 == 0); });
    print_lanes("none", [&](int) { return __ballot_sync(all, 0); });
    print_lanes("every", [&](int l) { return __ballot_sync(all, l + 1); });
    print_lanes("l==31", [&](int l) { return __ballot_sync(all, l == 31); });
  } else if (name == "reduce_min" || name == "reduce_max" || name == "reduce_add") {
    const auto red = [&](int x) {
      return name == "reduce_min" ? __reduce_min_sync(all, x)
             : name == "reduce_max" ? __reduce_max_sync(all, x) : __reduce_add_sync(all, x);
    };
    print_lanes("v", [&](int l) { return red(v(l)); });
    print_lanes("extremes", [&](int l) { return red(l == 7 ? INT_MIN : l == 20 ? INT_MAX : l); });
  } else if (name == "divergent_return") {  // lane 5 leaves before the shuffle
    print_lanes("x", [&](int l) { return l == 5 ? 0 : __shfl_sync(all, l, 0); });
  } else if (name == "divergent_extra") {  // lane 9 shuffles once more than lane 0
    print_lanes("x", [&](int l) {
      const int x = __shfl_sync(all, l, 0);
      return l == 9 ? __shfl_sync(all, x, 1) : x;
    });
  } else {
    std::fprintf(stderr, "unknown self-test %s\n", name.c_str());
    return 2;
  }
  return 0;
}

int main(int argc, char** argv) {
  if (argc == 3 && std::string(argv[1]) == "--selftest") return selftest(argv[2]);
  if (argc != 4) {
    std::fprintf(stderr, "usage: chain_regs_emu <in> <out> <R> | --selftest <name>\n");
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
  int32_t counts[3] = {0, 0, 0};
  const int R = std::atoi(argv[3]);
  if (P.use_derivative) run_r<true>(R, n, P, w, el.data(), bl.data(), pol.data(), out, counts);
  else run_r<false>(R, n, P, w, el.data(), bl.data(), pol.data(), out, counts);

  FILE* g = std::fopen(argv[2], "wb");
  if (!g) return 2;
  const void* cols[12] = {out.height, out.amp, out.area, out.max_abs_diff, out.peak_position,
                          out.n_peaks, out.n_hits, out.hit_integral, out.rise_samples,
                          out.fall_samples, out.width_samples, out.label};
  for (int c = 0; c < 12; ++c) std::fwrite(cols[c], c == 11 ? 1 : 4, n, g);
  std::fwrite(counts, 4, 3, g);
  std::fclose(g);
  return 0;
}
