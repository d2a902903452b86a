// Host harness for the warp code of the wide window kernel,
// scrooge_tpu_torch/csrc/genasm_windows_wide.cu, built by
// tests/test_torch_wide_host.py with g++ under AddressSanitizer and UBSan
// (g++ -I scrooge_tpu_torch/csrc).
//
// tests/warp_host.h stands in for the card's warp primitives
// (csrc/warp_lanes.cuh), and the shim below for the wide kernel's own
// (shfl_up within groups of G, the rows of a pass), so the 32 threads of
// a warp run in lockstep. The R and forefront scratch start
// filled with a garbage pattern, and counts with -7, so that a read of a
// word the kernel did not write, or a count it did not write, shows in the
// output.
//
// stdin: int32 W, K, O, max_windows, B, early_termination (0 or 1);
// int64 text_words_n, pattern_stride; then text_words (text_words_n
// uint32), text_base (B int64), text_len (B int32), pattern_words (B *
// pattern_stride uint32), pattern_len (B int32). stdout: ed (B int32),
// failed (B int32), entries (max_windows * (2(W-O)+2) * B int16,
// lane-minor), counts (max_windows * B int32).

#include <cstdint>
#include <cstdio>
#include <vector>

#include "warp_host.h"

// __shfl_up_sync(mask, x, 1, G): thread t gets thread t-1's x within its
// group of G, the group's first thread its own
template <int G>
inline U32Lanes shfl_up(const HostWarp&, const U32Lanes& x) {
  U32Lanes r;
  for (int t = 0; t < 32; ++t) r[t] = x[t % G ? t - 1 : t];
  return r;
}

inline uint32_t load_ro(const uint32_t* p) { return *p; }
inline void store_r(uint64_t* p, uint64_t v) { *p = v; }

inline uint64_t brev64(uint64_t x) {
  uint64_t r = 0;
  for (int k = 0; k < 64; ++k) r |= ((x >> k) & 1ull) << (63 - k);
  return r;
}

inline uint32_t funnel_r(uint32_t lo, uint32_t hi, unsigned sh) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (sh & 31u));
}

#include "warp_lanes.cuh"
#include "genasm_windows_wide.cu"

static_assert(WARP == 32, "the shim emulates 32-thread warps");

namespace {

template <class T>
bool read_all(std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

template <class T>
void write_all(const std::vector<T>& v) {
  std::fwrite(v.data(), sizeof(T), v.size(), stdout);
}

// the kernel's warps, one pair each, one after the other
template <int G>
void run(const Params& P, bool et) {
  for (int b = 0; b < P.B; ++b) {
    if (et) wide_warp<G, true>(HostWarp{0, WARP}, P, (size_t)b);
    else wide_warp<G, false>(HostWarp{0, WARP}, P, (size_t)b);
  }
}

}  // namespace

int main() {
  int32_t head[6];
  int64_t head64[2];
  if (std::fread(head, sizeof(int32_t), 6, stdin) != 6 ||
      std::fread(head64, sizeof(int64_t), 2, stdin) != 2)
    return 2;
  const int W = head[0], K = head[1], O = head[2], maxw = head[3],
            B = head[4];
  const bool et = head[5] != 0;
  const int64_t tw_n = head64[0], pstride = head64[1];
  const int NW = (W + 63) / 64;
  if (NW < MIN_NW || NW > MAX_NW || O < 0 || O >= W || K < 1 || maxw < 0 ||
      B < 1 || tw_n < 1 || pstride < 1)
    return 2;
  std::vector<uint32_t> text_words(tw_n), pattern_words(B * pstride);
  std::vector<int64_t> text_base(B);
  std::vector<int32_t> text_len(B), pattern_len(B);
  if (!read_all(text_words) || !read_all(text_base) || !read_all(text_len) ||
      !read_all(pattern_words) || !read_all(pattern_len))
    return 2;
  const int COLS = W - O + 1, NE = 2 * (W - O) + 2;
  const int NWS = NW - (O - 1 > 0 ? O - 1 : 0) / 64;
  std::vector<uint64_t> R((size_t)(K + 1) * NWS * (COLS + NWS - 1) * B,
                          0x5a5aa5a55a5aa5a5ull);
  std::vector<uint64_t> ff((size_t)(FF_PAD + W + NW + 1) * NW * B,
                           0xa5a55a5aa5a55a5aull);
  std::vector<int32_t> ed(B), failed(B), counts((size_t)maxw * B, -7);
  std::vector<int16_t> entries((size_t)maxw * NE * B, 0);
  const Params P{text_words.data(), tw_n,          text_base.data(),
                 text_len.data(),   pattern_words.data(), pstride,
                 pattern_len.data(), B,            W,
                 K,                 O,             maxw,
                 R.data(),          ff.data(),     ed.data(),
                 failed.data(),     entries.data(), counts.data()};
  if (NW <= 4) run<4>(P, et);
  else if (NW <= 8) run<8>(P, et);
  else if (NW <= 16) run<16>(P, et);
  else run<32>(P, et);
  write_all(ed);
  write_all(failed);
  write_all(entries);
  write_all(counts);
  return 0;
}
