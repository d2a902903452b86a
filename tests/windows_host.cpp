// Host harness for the window kernels of one to three words,
// scrooge_tpu_torch/csrc/genasm_windows1.cu (one word, W <= 64, a warp a
// pair) and scrooge_tpu_torch/csrc/genasm_windows.cu (two and three words,
// a thread a pair), built by tests/test_torch_windows_host.py with g++
// under AddressSanitizer and UBSan (g++ -I scrooge_tpu_torch/csrc).
//
// The shim below defines the CUDA keywords as nothing and the intrinsics
// the kernels use as plain C++. For the one-word kernel tests/warp_host.h
// stands in for the card's warp primitives (csrc/warp_lanes.cuh), so the
// 32 threads of a warp run in lockstep; each warp gets its own shared
// memory (smem_words). For the multiword kernel, blockIdx, blockDim and
// threadIdx are globals that run() sets before it calls the kernel's body
// for each thread of the grid in turn (a thread is a pair, and threads
// share nothing). The two sources define the same names, so each is
// included in a namespace of its own, after their shared header. The
// shared memory, the R and forefront scratch start filled with a garbage
// pattern and counts with -7, so that a read of a word the kernel did not
// write, or a count it did not write, shows in the output.
//
// stdin: int32 W, K, O, max_windows, B, early_termination (0 or 1);
// int64 text_words_n, pattern_stride; then text_words (text_words_n
// uint32), text_base (B int64), text_len (B int32), pattern_words
// (B * pattern_stride uint32), pattern_len (B int32). stdout: ed (B
// int32), failed (B int32), entries (max_windows * (2(W-O)+2) * B int16,
// lane-minor), counts (max_windows * B int32), and for one word the two
// row counters (2 int64: row slots, row work).

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct HostDim3 {
  unsigned x;
};
static HostDim3 blockIdx, blockDim, threadIdx;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline uint32_t __ldg(const uint32_t* p) { return *p; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }

// the low 32 bits of (hi:lo) >> (sh mod 32)
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned sh) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (sh & 31u));
}

inline uint64_t __brevll(uint64_t x) {
  uint64_t r = 0;
  for (int k = 0; k < 64; ++k) r |= ((x >> k) & 1ull) << (63 - k);
  return r;
}

inline void count_add(int64_t* p, long long v) { *p += v; }

#include "genasm_windows_common.cuh"
#include "warp_host.h"
#include "warp_lanes.cuh"

namespace one {
#include "genasm_windows1.cu"
}

namespace multi {
#include "genasm_windows.cu"
}

static_assert(one::WARP == 32, "the shim emulates 32-thread warps");

namespace {

template <class T>
bool read_all(std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

template <class T>
void write_all(const std::vector<T>& v) {
  std::fwrite(v.data(), sizeof(T), v.size(), stdout);
}

// the multiword kernel's grid of THREADS-thread blocks, one thread after
// the other
template <class Body>
void run(int B, Body body) {
  constexpr unsigned threads = multi::THREADS;
  blockDim.x = threads;
  for (unsigned blk = 0; blk * threads < (unsigned)B; ++blk)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx.x = blk;
      threadIdx.x = t;
      body();
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
  if (W < 2 || NW > 3 || O < 0 || O >= W || K < 1 || maxw < 0 || B < 1 ||
      tw_n < 1 || pstride < 1)
    return 2;
  std::vector<uint32_t> text_words(tw_n), pattern_words(B * pstride);
  std::vector<int64_t> text_base(B);
  std::vector<int32_t> text_len(B), pattern_len(B);
  if (!read_all(text_words) || !read_all(text_base) || !read_all(text_len) ||
      !read_all(pattern_words) || !read_all(pattern_len))
    return 2;
  // the multiword kernel's scratch (engine.scratch_words): R rows d <=
  // K+1 of the stored words of columns < COLS, in blocks of 32 lanes; the
  // forefront of W+17 columns of NW words
  const int COLS = W - O + 1, NE = 2 * (W - O) + 2;
  const size_t lanes = (size_t)(B + 31) / 32 * 32;
  const int stored = NW - (O - 1 > 0 ? O - 1 : 0) / 64;
  std::vector<int32_t> ed(B), failed(B), counts((size_t)maxw * B, -7);
  std::vector<int16_t> entries((size_t)maxw * NE * B, 0);
  std::vector<int64_t> rows(2, 0);
  const uint32_t* tw = text_words.data();
  const uint32_t* pw = pattern_words.data();
  const int64_t* tb = text_base.data();
  const int32_t *tl = text_len.data(), *pl = pattern_len.data();
  if (NW == 1) {
    // a warp a pair, one after the other, each with its shared memory
    const one::Params P{tw, tw_n, tb, tl, pw, pstride, pl, B, W, K, O, maxw,
                        one::r_pitch(COLS), rows.data(), ed.data(),
                        failed.data(), entries.data(), counts.data()};
    std::vector<uint64_t> smem((size_t)one::smem_words(W, K, O));
    for (int b = 0; b < B; ++b) {
      std::fill(smem.begin(), smem.end(), 0x5a5aa5a55a5aa5a5ull);
      if (et) one::windows1_warp<true>(HostWarp{0, 32}, P, (size_t)b,
                                       smem.data());
      else one::windows1_warp<false>(HostWarp{0, 32}, P, (size_t)b,
                                     smem.data());
    }
  } else {
    std::vector<uint64_t> R((size_t)(K + 2) * stored * COLS * lanes,
                            0x5a5aa5a55a5aa5a5ull);
    std::vector<uint64_t> ff((size_t)(W + 17) * NW * lanes,
                             0xa5a55a5aa5a55a5aull);
    auto* const kernel =
        NW == 2 ? (et ? &multi::genasm_windows_kernel<2, true>
                      : &multi::genasm_windows_kernel<2, false>)
                : (et ? &multi::genasm_windows_kernel<3, true>
                      : &multi::genasm_windows_kernel<3, false>);
    run(B, [&] {
      kernel(tw, tw_n, tb, tl, pw, pstride, pl, B, W, K, O, maxw, R.data(),
             ff.data(), ed.data(), failed.data(), entries.data(),
             counts.data());
    });
  }
  write_all(ed);
  write_all(failed);
  write_all(entries);
  write_all(counts);
  if (NW == 1) write_all(rows);
  return 0;
}
