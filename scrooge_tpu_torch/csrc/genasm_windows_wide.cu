// GenASM windowed alignment for bitvectors of five to 32 64-bit words
// (W = 257..2048), a group of G threads per pair, for Hopper (sm_90a).
//
// Counterpart of the JAX package's XLA engine at the widths its Pallas
// kernel cannot hold: scrooge_tpu/ops/engine_xla.py:105 (_window_step,
// one window of a lane batch: pattern masks, DP fill, traceback) and
// :395-443 (_align_scan / align_batch / align_batch_mapped, the loop over
// windows), which scrooge_tpu/api.py:_resolve_backend picks for every
// W > 256. No pallas_call is replaced. One launch runs every window of
// every pair; genasm_windows1.cu and genasm_windows.cu do the same for
// one and for two to four words, with one thread per pair and every
// bitvector in registers, which cannot grow to 32 words (they already
// take 224-236 registers at four).
//
// What bounds it on this card: each DP cell depends on the cell to its
// right, so a row is a chain of W+1 dependent steps, and a pair's windows
// run one after the other; the cells' INT32 work is small against the
// latency of that chain. The design:
//
// (a) a group of G threads per pair (G = 8, 16, 32, the power of two
//     >= NW), thread t of the group holding word t of every bitvector,
//     MSB-aligned as in genasm_windows.cu: pattern position j sits at bit
//     W-1-j, a window's values live in bits [s, W) with s = W - m, start
//     columns are ones in [s+d, W), and the full-match probe is bit W-1,
//     in word NW-1. Threads t >= NW hold zeros and store nothing. A warp
//     holds 32/G pairs;
// (b) GenASM's recurrence has shifts by one and ANDs, no additions, so a
//     shift across words needs only bit 63 of word t-1: one
//     __shfl_up_sync a column carries that bit of both the cell to the
//     right (on the chain) and of the row above (loaded ahead);
// (c) the row above (the forefront, W+1 columns of NW words a pair, 33 KB
//     at W=512) lives in device memory, each pair's own, laid out
//     [column][word] so that a group's loads and stores are contiguous;
//     a thread reads and overwrites only its own word of it, in place:
//     column i+1 of row d-1 is replaced by row d's once column i of row
//     d is computed;
// (d) R stores only the words FTW = max(O-1, 0)/64 .. NW-1 that the
//     traceback reads, rows d <= K, columns i < COLS = W-O+1, laid out
//     per pair [row][column][stored word]: a group's store of one cell is
//     contiguous;
// (e) the traceback is genasm_windows.cu's closed-form level traceback
//     (engine_pallas.py level_body :675, run_tb :770) with word indices
//     known at run time. Every thread of the group runs it on the same
//     words (the loads of a group coalesce into one), so that the pair's
//     state needs no broadcast; thread 0 of the group writes the runs.
//
// Every shuffle, ballot and loop around one takes the whole warp with a
// constant mask: pairs that are done, or past the batch, compute on with
// their warp and store nothing. A pair past the batch reads the last
// pair's inputs.
//
// Conventions (those of genasm_windows.cu): 2-bit codes, 16 a 32-bit
// word, char k of a word in bits [2k, 2k+2); text char k of pair b is
// global char text_base[b] + k (64-bit) of a buffer of text_words_n
// words; pattern char k is char b*pattern_stride*16 + k of a buffer of
// B*pattern_stride words; entries[w][e][b] = op << 12 | count, counts[w][b]
// runs in window w.
//
// The warp's code (wide_warp) also compiles as host C++:
// tests/wide_host.cpp defines the warp primitives for the host, where the
// 32 threads of a warp run in lockstep over an array, and checks it under
// AddressSanitizer and UBSan.

#include <cstddef>
#include <cstdint>

namespace {

constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_NONE = 4;
constexpr int FAIL_TB = 1, FAIL_STALL = 2, FAIL_INCOMPLETE = 8;
constexpr int THREADS = 128;
constexpr int WARP = 32;
constexpr int MIN_NW = 5, MAX_NW = 32;
constexpr int TB_CH = 8;  // traceback offsets a batch of R loads

struct Params {
  const uint32_t* text_words;
  int64_t text_words_n;
  const int64_t* text_base;
  const int32_t* text_len;
  const uint32_t* pattern_words;
  int64_t pattern_stride;
  const int32_t* pattern_len;
  int B, W, K, O, max_windows;
  uint64_t* R;
  uint64_t* ff;
  int32_t* ed_out;
  int32_t* failed_out;
  int16_t* entries;
  int32_t* counts;
};

}  // namespace

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define LANE_FN __device__ __forceinline__

namespace {

// A value of each thread of the warp: on the card every thread holds its
// own, and FOR_THREADS runs its body once, for the thread's own t.
template <class T>
struct Lanes {
  T v;
  __device__ T& operator[](int) { return v; }
  __device__ const T& operator[](int) const { return v; }
};

struct Warp {
  int t_lo, t_hi;  // the threads this code runs: [t, t+1), t the lane id
};

// thread t gets thread t-1's x, within each group of G (its first thread
// its own)
template <int G>
__device__ __forceinline__ Lanes<unsigned> shfl_up(const Warp&,
                                                   const Lanes<unsigned>& x) {
  return {__shfl_up_sync(0xffffffffu, x.v, 1, G)};
}

// every thread gets thread src of its group's x
template <int G>
__device__ __forceinline__ Lanes<unsigned> shfl_from(const Warp&,
                                                     const Lanes<unsigned>& x,
                                                     int src) {
  return {__shfl_sync(0xffffffffu, x.v, src, G)};
}

__device__ __forceinline__ bool warp_any(const Warp&, const Lanes<bool>& p) {
  return __any_sync(0xffffffffu, p.v);
}

__device__ __forceinline__ void warp_sync(const Warp&) { __syncwarp(); }

__device__ __forceinline__ uint32_t load_ro(const uint32_t* p) {
  return __ldg(p);
}

__device__ __forceinline__ int first_set(unsigned x) { return __ffs((int)x); }

__device__ __forceinline__ uint64_t brev64(uint64_t x) { return __brevll(x); }

// the low 32 bits of (hi:lo) >> sh, sh < 32
__device__ __forceinline__ uint32_t funnel_r(uint32_t lo, uint32_t hi,
                                             unsigned sh) {
  return __funnelshift_r(lo, hi, sh);
}

}  // namespace
#else
// Compiled by the host harness, which defines HostLanes, HostWarp,
// shfl_up, shfl_from, warp_any, warp_sync, load_ro, first_set, brev64
// and funnel_r before it includes this file.
template <class T>
using Lanes = HostLanes<T, WARP>;
using Warp = HostWarp;
#define LANE_FN inline
#endif

#define FOR_THREADS(w, t) for (int t = (w).t_lo; t < (w).t_hi; ++t)

namespace {

LANE_FN int imin(int a, int b) { return a < b ? a : b; }
LANE_FN int imax(int a, int b) { return a > b ? a : b; }

// bits [0, k), for any k: empty for k <= 0, all for k >= 64
LANE_FN uint64_t low_bits(int k) {
  return k <= 0 ? 0ull : k >= 64 ? ~0ull : (1ull << k) - 1ull;
}
LANE_FN unsigned low_bits32(int k) {
  return k <= 0 ? 0u : k >= 32 ? ~0u : (1u << k) - 1u;
}

// word t of ones in bits [lo, W); empty for lo >= W
LANE_FN uint64_t ones_from(int lo, int W, int t) {
  return low_bits(W - 64 * t) & ~low_bits(lo - 64 * t);
}

// 64 chars from char g (g may be negative: those chars are read from
// word 0 and never used) of a packed buffer of nwords >= 1 words: char k
// in bits [2(k % 32), +2) of c[k / 32]. A word past the buffer's end
// reads as its last word.
LANE_FN void load_chars64(const uint32_t* __restrict__ words, int64_t nwords,
                          int64_t g, uint64_t (&c)[2]) {
  const int64_t w0 = g >> 4;                    // floor(g / 16)
  const unsigned sh = (unsigned)(g & 15) * 2u;  // < 32
  uint32_t x[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int64_t at = w0 + k < 0 ? 0 : w0 + k < nwords ? w0 + k : nwords - 1;
    x[k] = load_ro(words + at);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    c[q] = (uint64_t)funnel_r(x[2 * q], x[2 * q + 1], sh) |
           ((uint64_t)funnel_r(x[2 * q + 1], x[2 * q + 2], sh) << 32);
}

// bit k of the result = bit 2k of x
LANE_FN uint64_t even_bits(uint64_t x) {
  x &= 0x5555555555555555ull;
  x = (x | (x >> 1)) & 0x3333333333333333ull;
  x = (x | (x >> 2)) & 0x0f0f0f0f0f0f0f0full;
  x = (x | (x >> 4)) & 0x00ff00ff00ff00ffull;
  x = (x | (x >> 8)) & 0x0000ffff0000ffffull;
  return (x | (x >> 16)) & 0x00000000ffffffffull;
}

struct Masks {
  uint64_t c[4];  // word t of PM[c]
};

// Word t of the four pattern masks, MSB-aligned: zero at bit W-1-j where
// pattern[j] == c for j < m, ones elsewhere in [s, W). Word t holds
// pattern chars j0 .. j0+63, j0 = W - 64t - 64, char j0+k at bit 63-k.
LANE_FN Masks pattern_masks(const uint32_t* __restrict__ words,
                            int64_t nwords, int64_t pbase, int m, int W,
                            int t) {
  const int j0 = W - 64 * t - 64;
  uint64_t p[2];
  load_chars64(words, nwords, pbase + j0, p);
  const uint64_t b0 = even_bits(p[0]) | (even_bits(p[1]) << 32);
  const uint64_t b1 = even_bits(p[0] >> 1) | (even_bits(p[1] >> 1) << 32);
  const uint64_t in = low_bits(m - j0) & ~low_bits(-j0);
  const uint64_t eq[4] = {~b0 & ~b1 & in, b0 & ~b1 & in, ~b0 & b1 & in,
                          b0 & b1 & in};
  const uint64_t lane = ones_from(W - m, W, t);
  Masks pm;
#pragma unroll
  for (int c = 0; c < 4; ++c) pm.c[c] = lane & ~brev64(eq[c]);
  return pm;
}

// Every window of the warp's 32/G pairs. Thread t works for pair b[t]
// (live[t] false past the batch: such a pair computes on a clamped b and
// stores nothing) as word t % G.
template <int G>
LANE_FN void wide_warp(const Warp& w, const Params& P, const Lanes<size_t>& b,
                       const Lanes<bool>& live) {
  const int W = P.W, K = P.K, O = P.O;
  const int NW = (W + 63) / 64;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  const int FTW = imax(O - 1, 0) / 64;  // first stored word
  const int NWS = NW - FTW;
  const int probe = (W - 1) & 63;  // bit W-1, in word NW-1
  const size_t nb = (size_t)P.B;
  const size_t rrow = (size_t)COLS * NWS;  // R words a row
  const int64_t pattern_words_n = (int64_t)P.B * P.pattern_stride;

  Lanes<int> ref_idx, read_idx, ed, failed;
  Lanes<bool> done;
  Lanes<uint64_t*> rl, fl;  // the pair's R and forefront
  FOR_THREADS(w, t) {
    ref_idx[t] = read_idx[t] = ed[t] = failed[t] = 0;
    // an empty read is done before its first window
    done[t] = !live[t] || P.pattern_len[b[t]] <= 0;
    rl[t] = P.R + b[t] * (size_t)(K + 1) * rrow;
    fl[t] = P.ff + b[t] * (size_t)(W + 1) * NW;
  }

  for (int win = 0; win < P.max_windows; ++win) {
    // the last window's traceback has read R
    warp_sync(w);
    // ---- window set-up, each thread its word ----
    Lanes<int> m, n, s, wed;
    Lanes<int64_t> tbase;
    Lanes<Masks> pm;
    Lanes<bool> todo;  // the pair searches row d
    FOR_THREADS(w, t) {
      const int gt = t % G;
      todo[t] = !done[t];
      wed[t] = -1;
      m[t] = n[t] = s[t] = 0;
      tbase[t] = 0;
      pm[t] = Masks{{0, 0, 0, 0}};
      if (done[t]) continue;
      m[t] = imin(W, P.pattern_len[b[t]] - read_idx[t]);  // >= 1
      // text may run out before the read does: n can reach 0
      n[t] = imax(0, imin(W, P.text_len[b[t]] - ref_idx[t]));
      s[t] = W - m[t];
      tbase[t] = P.text_base[b[t]] + ref_idx[t];
      if (gt < NW)
        pm[t] = pattern_masks(
            P.pattern_words, pattern_words_n,
            (int64_t)b[t] * P.pattern_stride * 16 + read_idx[t], m[t], W, gt);
    }

    // ---- DP fill (pyref.genasm_dc), one row a pass ----
    // The warp runs until its last pair has hit or passed K.
    for (int d = 0; warp_any(w, todo); ++d) {
      // right: the row's cell to the right; f1, sf1: the row above at
      // column i+1 and its shl1; tw: the text word in hand
      Lanes<uint64_t> right, f1, sf1, f0;
      Lanes<uint32_t> tw;
      Lanes<unsigned> bits;
      FOR_THREADS(w, t) {
        const int gt = t % G;
        right[t] = ones_from(s[t] + d, W, gt);  // column W: a start column
        // at O = 0 the traceback reads column W (COLS = W+1)
        if (todo[t] && W < COLS && gt >= FTW && gt < NW)
          rl[t][(size_t)d * rrow + (size_t)W * NWS + (gt - FTW)] = right[t];
        f1[t] = todo[t] && d > 0 && gt < NW ? fl[t][(size_t)W * NW + gt] : 0;
        bits[t] = (unsigned)(f1[t] >> 63);
        tw[t] = 0;
      }
      Lanes<unsigned> up = shfl_up<G>(w, bits);
      FOR_THREADS(w, t) {
        sf1[t] = (f1[t] << 1) | (t % G ? up[t] : 0u);
      }
      for (int i = W - 1; i >= 0; --i) {
        FOR_THREADS(w, t) {
          const int gt = t % G;
          f0[t] = todo[t] && d > 0 && gt < NW ? fl[t][(size_t)i * NW + gt] : 0;
          bits[t] = (unsigned)(right[t] >> 63) | ((unsigned)(f0[t] >> 63) << 1);
        }
        up = shfl_up<G>(w, bits);
        FOR_THREADS(w, t) {
          const int gt = t % G;
          const unsigned carry = gt ? up[t] : 0u;
          const uint64_t sf0 = (f0[t] << 1) | ((carry >> 1) & 1u);
          uint64_t v;
          if (i >= n[t]) {
            v = ones_from(s[t] + d, W, gt);  // a start column
          } else {
            const int64_t gi = tbase[t] + i;
            if (i == n[t] - 1 || (gi & 15) == 15) {
              const int64_t at = gi >> 4;
              tw[t] = load_ro(P.text_words + (at < P.text_words_n
                                                  ? at
                                                  : P.text_words_n - 1));
            }
            const unsigned ch = (tw[t] >> (2 * (unsigned)(gi & 15))) & 3u;
            // a select, not an index: the masks stay in registers
            const uint64_t pmi =
                ch & 2u ? (ch & 1u ? pm[t].c[3] : pm[t].c[2])
                        : (ch & 1u ? pm[t].c[1] : pm[t].c[0]);
            v = (right[t] << 1) | (carry & 1u) | pmi;
            if (d > 0) v &= sf1[t] & sf0 & f1[t];
          }
          if (todo[t] && gt < NW) {
            // column i+1 of the row above is read no more
            fl[t][(size_t)(i + 1) * NW + gt] = right[t];
            if (i < COLS && gt >= FTW)
              rl[t][(size_t)d * rrow + (size_t)i * NWS + (gt - FTW)] = v;
          }
          right[t] = v;
          f1[t] = f0[t];
          sf1[t] = sf0;
        }
      }
      FOR_THREADS(w, t) {
        const int gt = t % G;
        if (todo[t] && gt < NW) fl[t][gt] = right[t];
        bits[t] = (unsigned)(right[t] >> probe) & 1u;
      }
      const Lanes<unsigned> top = shfl_from<G>(w, bits, NW - 1);
      FOR_THREADS(w, t) {
        if (!todo[t]) continue;
        if (top[t] == 0) {
          wed[t] = d;
          todo[t] = false;
        } else if (d == K) {
          todo[t] = false;  // no alignment within K edits
        }
      }
    }
    // R's rows, stored by every thread of the group, are read by each
    warp_sync(w);

    // ---- level traceback (engine_pallas.py level_body) ----
    FOR_THREADS(w, t) {
      const bool writer = t % G == 0 && live[t];
      int nrun = 0;
      if (!done[t] && wed[t] < 0) {
        failed[t] |= FAIL_TB;
        done[t] = true;
      } else if (!done[t]) {
        const int mm = m[t], nn = n[t];
        int16_t* __restrict__ ent = P.entries + (size_t)win * NE * nb + b[t];
        int i = 0, j = 0, dd = wed[t], pend_op = OP_NONE, pend_cnt = 0;
        bool fin = false;
        while (!fin && dd > 0) {
          // steps run while j < m, i < TB and j < TB (pyref.genasm_tb)
          const int t_term = imax(imin(imin(mm - j, TB - i), TB - j), 0);
          int run = t_term, op = OP_NONE;
          const uint64_t* __restrict__ row = rl[t] + (size_t)(dd - 1) * rrow;
          const int tj = mm - 1 - j;  // the offset where j+t == m-1
          for (int base = 0; base < t_term; base += TB_CH) {
            // column i+base+k gives bits p, p+1, p+2 (p = W-2-j-base-k):
            // the insertion bit of offset base+k, and the substitution
            // and deletion bits of offset base+k-1. Offsets t < t_term
            // read bits in [O-1, W) of columns < COLS; the others are
            // decided by the j == m-1 bit and t_term alone. A word below
            // FTW reads as 0: only bit p of such a column can lie there,
            // and that bit is not used
            uint64_t x[TB_CH + 1];
#pragma unroll
            for (int k = 0; k <= TB_CH; ++k) {
              const int p = W - 2 - j - base - k;  // >= -TB_CH-1
              const int wl = p >> 6;                // floor: the word of p
              const unsigned sh = (unsigned)p & 63u;
              const uint64_t* __restrict__ cp =
                  row + (size_t)imin(i + base + k, COLS - 1) * NWS;
              const uint64_t lo = wl >= FTW ? cp[wl - FTW] : 0ull;
              const uint64_t hi =
                  sh >= 62 && wl + 1 >= FTW && wl + 1 < NW ? cp[wl + 1 - FTW]
                                                           : 0ull;
              x[k] = sh == 0 ? lo : (lo >> sh) | (hi << (64 - sh));
            }
            unsigned ci = 0, cd = 0, cs = 0;
#pragma unroll
            for (int k = 0; k < TB_CH; ++k) {
              ci |= (unsigned)(~x[k] & 1ull) << k;
              cs |= (unsigned)((~x[k + 1] >> 1) & 1ull) << k;
              cd |= (unsigned)((~x[k + 1] >> 2) & 1ull) << k;
            }
            // priority I > D > X; the j == m-1 step may insert or
            // substitute, never delete; offsets with i+t >= n neither
            // delete nor substitute
            const int tjb = tj - base;
            const unsigned jb = tjb >= 0 && tjb < TB_CH ? 1u << tjb : 0u;
            const unsigned below = low_bits32(nn - i - base);
            const unsigned m_ins = ci | jb;
            const unsigned m_del = cd & ~jb & below;
            const unsigned m_sub = (cs | jb) & below;
            const unsigned stop = (m_ins | m_del | m_sub) &
                                  low_bits32(imin(TB_CH, t_term - base));
            if (stop != 0) {
              const int r = first_set(stop) - 1;
              const unsigned at = 1u << r;
              run = base + r;
              op = (m_ins & at) ? OP_I : (m_del & at) ? OP_D : OP_X;
              break;
            }
          }
          // emission with a pending-edit run: an edit right after an edit
          // of the same kind (no '=' between) extends it
          const bool edit = op != OP_NONE;
          const bool ext = run == 0 && edit && op == pend_op && pend_cnt > 0;
          if (pend_cnt > 0 && !ext) {
            if (writer)
              ent[(size_t)nrun * nb] = (int16_t)((pend_op << 12) | pend_cnt);
            ++nrun;
          }
          if (run > 0) {
            if (writer) ent[(size_t)nrun * nb] = (int16_t)((OP_EQ << 12) | run);
            ++nrun;
          }
          pend_cnt = ext ? pend_cnt + 1 : (edit ? 1 : 0);
          pend_op = op;
          i += run + (edit && op != OP_I);
          j += run + (edit && op != OP_D);
          dd -= edit;
          fin = !edit;
        }
        // the d == 0 phase: flush the pending edit run, then the final
        // '=' run (no edit is possible without a row above)
        if (pend_cnt > 0) {
          if (writer)
            ent[(size_t)nrun * nb] = (int16_t)((pend_op << 12) | pend_cnt);
          ++nrun;
        }
        if (!fin) {
          const int run = imax(imin(imin(mm - j, TB - i), TB - j), 0);
          if (run > 0) {
            if (writer) ent[(size_t)nrun * nb] = (int16_t)((OP_EQ << 12) | run);
            ++nrun;
          }
          i += run;
          j += run;
        }
        // ---- carry update (engine_xla.py:339-350) ----
        if (i == 0 && j == 0) {
          failed[t] |= FAIL_STALL;  // would loop forever in the reference
          done[t] = true;
          nrun = 0;
        } else {
          ed[t] += wed[t] - dd;  // trailing deletes are not traced back
          ref_idx[t] += i;
          read_idx[t] += j;
          done[t] = read_idx[t] >= P.pattern_len[b[t]];
        }
      }
      if (writer) P.counts[(size_t)win * nb + b[t]] = nrun;
    }
  }
  FOR_THREADS(w, t) {
    if (t % G != 0 || !live[t]) continue;
    if (failed[t] == 0 && read_idx[t] < P.pattern_len[b[t]])
      failed[t] |= FAIL_INCOMPLETE;
    P.ed_out[b[t]] = ed[t];
    P.failed_out[b[t]] = failed[t];
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

// one block an SM at least, nothing more asked: with the block size
// alone, ptxas held the kernel to 64 registers and spilled at G = 32
template <int G>
__global__ void __launch_bounds__(THREADS, 1)
    genasm_windows_wide_kernel(const Params P) {
  const int t = threadIdx.x % WARP;
  const long long pair = ((long long)blockIdx.x * THREADS + threadIdx.x) / G;
  if (pair - t / G >= P.B) return;  // the warp's first pair: the whole warp
  const Lanes<size_t> b{(size_t)(pair < P.B ? pair : P.B - 1)};
  const Lanes<bool> live{pair < P.B};
  wide_warp<G>(Warp{t, t + 1}, P, b, live);
}

template <int G>
int launch(const Params& P, cudaStream_t stream) {
  const long long threads = (long long)P.B * G;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  genasm_windows_wide_kernel<G><<<grid, THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// nw must be ceil(W/64), 5..32 (genasm_windows1.cu and genasm_windows.cu
// take fewer); R scratch (K+1) * (NW - max(O-1,0)/64) * (W-O+1) words a
// pair, forefront scratch (W+1) * NW words a pair. Returns -1 for
// arguments the kernel does not take, else the launch's
// cudaGetLastError().
extern "C" int genasm_windows_wide_launch(
    int nw, const void* text_words, int64_t text_words_n,
    const void* text_base, const void* text_len, const void* pattern_words,
    int64_t pattern_stride, const void* pattern_len, int B, int W, int K,
    int O, int max_windows, void* R, void* ff, void* ed, void* failed,
    void* entries, void* counts, void* stream) {
  if (nw < MIN_NW || nw > MAX_NW || nw != (W + 63) / 64 || O < 0 ||
      O >= W || K < 1 || text_words_n < 1 || pattern_stride < 1 ||
      max_windows < 0)
    return -1;
  if (B <= 0) return 0;
  const Params P{(const uint32_t*)text_words, text_words_n,
                 (const int64_t*)text_base,   (const int32_t*)text_len,
                 (const uint32_t*)pattern_words, pattern_stride,
                 (const int32_t*)pattern_len, B, W, K, O, max_windows,
                 (uint64_t*)R,                (uint64_t*)ff,
                 (int32_t*)ed,                (int32_t*)failed,
                 (int16_t*)entries,           (int32_t*)counts};
  const cudaStream_t s = (cudaStream_t)stream;
  if (nw <= 8) return launch<8>(P, s);
  if (nw <= 16) return launch<16>(P, s);
  return launch<32>(P, s);
}
#endif
