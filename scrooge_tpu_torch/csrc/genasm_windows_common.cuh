// Helpers of the window kernels of one word, genasm_windows1.cu (a warp
// a pair), and of two and three words, genasm_windows.cu (a thread a
// pair): bit masks and the window set-up from packed 2-bit characters (16
// a 32-bit word, char k of a word in bits [2k, 2k+2)).
//
// Device code; tests/windows_host.cpp defines __device__, __forceinline__,
// __ldg and __funnelshift_r for the host before it includes the kernels.

#pragma once

#include <cstdint>

namespace {

// bits [0, k), for any k: empty for k <= 0, all for k >= 64
__device__ __forceinline__ uint64_t low_bits(int k) {
  return k <= 0 ? 0ull : k >= 64 ? ~0ull : (1ull << k) - 1ull;
}

// 32 TW chars from char g of a packed buffer of nwords >= 1 words, 32 a
// 64-bit register: char k in bits [2(k % 32), +2) of t[k / 32]. Only the
// words that cover the first nchars chars are loaded; a word past the
// buffer's end reads as its last word, and the chars it would give are
// never used.
template <int TW>
__device__ __forceinline__ void load_chars(const uint32_t* __restrict__ words,
                                           int64_t nwords, int64_t g,
                                           int nchars, uint64_t (&t)[TW]) {
  const int64_t w0 = g >> 4;
  const unsigned sh = (unsigned)(g & 15) * 2u;  // < 32
  const int nload = (nchars + 15) / 16 + 1;
  uint32_t x[2 * TW + 1];
#pragma unroll
  for (int k = 0; k <= 2 * TW; ++k) {
    const int64_t at = w0 + k < nwords ? w0 + k : nwords - 1;
    x[k] = k < nload ? __ldg(words + at) : 0u;
  }
#pragma unroll
  for (int q = 0; q < TW; ++q)
    t[q] = (uint64_t)__funnelshift_r(x[2 * q], x[2 * q + 1], sh) |
           ((uint64_t)__funnelshift_r(x[2 * q + 1], x[2 * q + 2], sh) << 32);
}

// bit k of the result = bit 2k of x
__device__ __forceinline__ uint64_t even_bits(uint64_t x) {
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0f0f0f0f0f0f0f0full;
  x = (x | (x >> 4)) & 0x00ff00ff00ff00ffull;
  x = (x | (x >> 8)) & 0x0000ffff0000ffffull;
  return (x | (x >> 16)) & 0x00000000ffffffffull;
}

}  // namespace
