// GenASM windowed alignment for bitvectors of four to 32 64-bit words
// (W = 193..2048), one warp per pair, for Hopper (sm_90a).
//
// Counterpart of the JAX package's XLA engine at the widths its Pallas
// kernel cannot hold: scrooge_tpu/ops/engine_xla.py:105 (_window_step,
// one window of a lane batch: pattern masks, DP fill, traceback) and
// :395-443 (_align_scan / align_batch / align_batch_mapped, the loop over
// windows), which scrooge_tpu/api.py:_resolve_backend picks for every
// W > 256, and at four words (W = 193..256) the Pallas kernel
// scrooge_tpu/ops/engine_pallas.py:901 (slab_step_kernel), which the JAX
// package runs up to W = 256. One launch runs every window of every
// pair; genasm_windows1.cu and genasm_windows.cu do the same for one and
// for two or three words, with one thread per pair and every bitvector
// in registers, which cannot grow to 32 words. (At four words that
// design made a tile of 1,024 pairs 32 warps: most SMs idle, and every
// dependent step's latency exposed.)
//
// What bounds it on this card: each DP cell depends on the cell to its
// right, so a row is a chain of W+1 dependent steps, and a pair's windows
// run one after the other; the cells' INT32 work is small against the
// latency of that chain, so the design keeps every load and every
// shuffle off it and puts the whole card on the rows:
//
// (a) a warp per pair, as RP = 32/G sub-groups of G threads (G = 4, 8,
//     16, 32, the power of two >= NW: eight rows a pass at NW = 4, four
//     at NW = 5..8; RP at most MAX_ROWS). Thread t of a sub-group holds
//     word t of every bitvector, MSB-aligned as in genasm_windows.cu:
//     pattern position j sits at bit W-1-j, a window's
//     values live in bits [s, W) with s = W - m, start columns are ones in
//     [s+d, W), and the full-match probe is bit W-1, in word NW-1. Threads
//     t >= NW compute words nothing reads and store nothing. At 1,024
//     pairs that is 1,024 warps in blocks of THREADS, on every SM;
// (b) rows in flight: a pass of RP rows from d0, sub-group r computing row
//     d0+r LAG = 2 columns behind sub-group r-1, whose cell two steps old
//     comes down by __shfl_up_sync (delta G) a step ahead of its use.
//     Sub-group 0 reads row d0-1 (the forefront, in device memory, each
//     pair's own) UNROLL steps ahead into a ring of registers indexed at
//     compile time, from an address clamped into the scratch, so that no
//     instruction waits for a load before the step that uses it (a select
//     on the loaded value made every step wait out a round trip to L2);
//     sub-group RP-1 overwrites it in place with row d0+RP-1, a column's
//     read leading its write (the stored cell depends on the value read).
//     The forefront is read and written once a pass;
// (c) the word group is skewed: word t runs one column behind word t-1,
//     so the bit 63 of word t-1 that a shift by one carries into word t
//     (of the cell to the right and of the row above) was computed a step
//     before it is needed, and one __shfl_up_sync (width G) a step moves
//     both bits off the chain. A thread's chain is its own word's shift
//     and LOP3: v = (shl1(right) & A) | C, where A (the row above's terms,
//     zero in a start column) and C ((PM[text] & A) | start) wait for no
//     cell of the row;
// (d) text chars come UNROLL at a time from three 32-bit loads made a
//     block ahead; the pattern masks are kept as the pattern's two bit planes,
//     PM[c] = (P0 ^ c0) | (P1 ^ c1), which are garbage outside [s, W): A
//     is zero there, because the row above row 0 is taken as ones in
//     [s-1, W) (row 0's cell is then the reference's, bits >= W aside,
//     which no later bit reads);
// (e) R stores the words FTW = max(O-1, 0)/64 .. NW-1 that the traceback
//     reads, rows d <= K, columns i < COLS = W-O+1, laid out along the
//     skew: per pair [row][i + NW-1-word][word - FTW], so that a
//     sub-group's store at a step is one contiguous run (one sector at
//     NWS = 4), with a streaming hint (st.global.cs) so that R's traffic
//     does not push the forefront and the text out of L2. The forefront
//     is laid out the same way, [i + NW-1-word][word], W+NW slots, with
//     FF_PAD slots below them that the ring's last loads read and a slot
//     above them that holds the row above row 0;
// (f) the traceback is genasm_windows.cu's closed-form level traceback
//     (engine_pallas.py level_body :675, run_tb :770) with word indices
//     known at run time. The pair's state is the same in every thread of
//     the warp, so each runs it on the same words (the loads coalesce into
//     one) and thread 0 writes the runs.
//
// Early termination is the template parameter ET, as in the other two
// window kernels: with it a pair's passes stop at the pass that holds its
// first hit; without it they run on until row K, and wed stays the first
// row that hits (a later pass's hits do not move it).
//
// Every shuffle and ballot takes the whole warp with a constant mask, and
// a step has no branch: a thread computes at every step, inside its row
// or not, and its stores are predicated on the column. A warp past the
// batch returns as a whole.
//
// Conventions (those of genasm_windows.cu): 2-bit codes, 16 a 32-bit
// word, char k of a word in bits [2k, 2k+2); text char k of pair b is
// global char text_base[b] + k (64-bit) of a buffer of text_words_n
// words; pattern char k is char b*pattern_stride*16 + k of a buffer of
// B*pattern_stride words; entries[w][e][b] = op << 12 | count, counts[w][b]
// runs in window w.
//
// The warp's code (wide_warp) also compiles as host C++, with the warp
// primitives of warp_lanes.cuh: tests/wide_host.cpp runs the 32 threads
// of a warp in lockstep over an array, and checks it under
// AddressSanitizer and UBSan.

#include <cstddef>
#include <cstdint>

namespace {

constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_NONE = 4;
constexpr int FAIL_TB = 1, FAIL_STALL = 2, FAIL_INCOMPLETE = 8;
constexpr int THREADS = 32;  // a block: one warp, one pair
constexpr int WARP = 32;
constexpr int MIN_NW = 4, MAX_NW = 32;
constexpr int MAX_ROWS = 8;  // rows a pass at most
constexpr int UNROLL = 16;   // steps a block: the forefront ring's depth
constexpr int LAG = 2;       // columns a row runs behind the row above
constexpr int TB_CH = 8;     // traceback offsets a batch of R loads
constexpr int ET_OFF = 1 << 8;  // the key's flag: no early termination
// forefront slots below column 0: the ring's loads run past the row by up
// to (rows a pass - 1) * LAG + 2 * UNROLL steps (engine.WIDE_FF_PAD)
constexpr int FF_PAD = 72;
static_assert(UNROLL >= 2 && UNROLL <= 32,
              "a block's text chars come from three 32-bit words");
static_assert(FF_PAD >= (MAX_ROWS - 1) * LAG + 2 * UNROLL,
              "the ring's last loads stay inside the forefront's padding");

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

#include "warp_lanes.cuh"

#ifdef __CUDACC__
namespace {

// thread t gets thread t-1's x, within each group of G (its first thread
// its own)
template <int G>
__device__ __forceinline__ Lanes<unsigned> shfl_up(const Warp&,
                                                   const Lanes<unsigned>& x) {
  return {__shfl_up_sync(0xffffffffu, x.v, 1, G)};
}

__device__ __forceinline__ uint32_t load_ro(const uint32_t* p) {
  return __ldg(p);
}

// a store of R: streamed, not kept in L2 ahead of other lines
__device__ __forceinline__ void store_r(uint64_t* p, uint64_t v) {
  __stcs((unsigned long long*)p, (unsigned long long)v);
}

__device__ __forceinline__ uint64_t brev64(uint64_t x) { return __brevll(x); }

// the low 32 bits of (hi:lo) >> sh, sh < 32
__device__ __forceinline__ uint32_t funnel_r(uint32_t lo, uint32_t hi,
                                             unsigned sh) {
  return __funnelshift_r(lo, hi, sh);
}

}  // namespace
#else
// Compiled by the host harness, which defines shfl_up, load_ro, store_r,
// brev64 and funnel_r before it includes this file.
#endif

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

// a 32-bit mask in both halves of a 64-bit one
LANE_FN uint64_t spread(uint32_t m) { return ((uint64_t)m << 32) | m; }

// all ones when x < 0, else zero
LANE_FN uint32_t neg_mask(int x) { return (uint32_t)(x >> 31); }

// all ones when bit b (0..63, known at compile time) of x is set
LANE_FN uint32_t bit_mask(uint64_t x, int b) {
  return neg_mask((int32_t)((uint32_t)(x >> (b & 32)) << (31 - (b & 31))));
}

// word t of ones in bits [lo, W); empty for lo >= W
LANE_FN uint64_t ones_from(int lo, int W, int t) {
  return low_bits(W - 64 * t) & ~low_bits(lo - 64 * t);
}

// the 32-bit word at index at of a buffer of nwords >= 1 words, at
// clamped into it
LANE_FN uint32_t load_word(const uint32_t* __restrict__ words, int64_t nwords,
                           int64_t at) {
  return load_ro(words + (at < 0 ? 0 : at < nwords ? at : nwords - 1));
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
  for (int k = 0; k < 5; ++k) x[k] = load_word(words, nwords, w0 + k);
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

// Word t of the pattern's two bit planes, MSB-aligned: bit W-1-j holds
// bit 0 (p0) and bit 1 (p1) of pattern char j. Word t holds chars j0 ..
// j0+63, j0 = W - 64t - 64, char j0+k at bit 63-k; chars outside the
// window (bits outside [s, W)) are whatever the buffer holds there.
LANE_FN void pattern_planes(const uint32_t* __restrict__ words,
                            int64_t nwords, int64_t pbase, int W, int t,
                            uint64_t& p0, uint64_t& p1) {
  uint64_t p[2];
  load_chars64(words, nwords, pbase + W - 64 * t - 64, p);
  p0 = brev64(even_bits(p[0]) | (even_bits(p[1]) << 32));
  p1 = brev64(even_bits(p[0] >> 1) | (even_bits(p[1] >> 1) << 32));
}

// Every window of pair b, on the warp's 32 threads: rows of a pass by
// sub-group (t / G), words by thread (t % G).
template <int G, bool ET>
LANE_FN void wide_warp(const Warp& w, const Params& P, size_t b) {
  constexpr int RP = WARP / G < MAX_ROWS ? WARP / G : MAX_ROWS;
  const int W = P.W, K = P.K, O = P.O;
  const int NW = (W + 63) / 64;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  const int FTW = imax(O - 1, 0) / 64;  // first stored word
  const int NWS = NW - FTW;
  const int probe = (W - 1) & 63;  // bit W-1, in word NW-1
  const size_t nb = (size_t)P.B;
  const size_t rrow = (size_t)(COLS + NWS - 1) * NWS;  // R words a row
  const int64_t pattern_words_n = (int64_t)P.B * P.pattern_stride;
  // steps a pass: row d0+RP-1's word NW-1 reaches column 0 last
  const int steps = W + NW + (RP - 1) * LAG;
  const int nblocks = (steps + UNROLL - 1) / UNROLL;
  uint64_t* const rl = P.R + b * (size_t)(K + 1) * rrow;  // the pair's R
  // and forefront: slot 0 (column NW-1-word) at fl, FF_PAD slots below
  // it and slot W+NW, which holds the row above row 0, at its top
  uint64_t* const fl =
      P.ff + (b * (size_t)(FF_PAD + W + NW + 1) + FF_PAD) * NW;
  const bool writer = w.t_lo == 0;
  const int plen = P.pattern_len[b], tlen = P.text_len[b];

  Lanes<int> gt, rr;  // the thread's word, and its row of a pass
  FOR_THREADS(w, t) {
    gt[t] = t % G;
    rr[t] = t / G;
  }
  int ref_idx = 0, read_idx = 0, ed = 0, failed = 0;
  bool done = plen <= 0;  // an empty read is done before its first window

  for (int win = 0; win < P.max_windows; ++win) {
    if (done) {
      if (writer) P.counts[(size_t)win * nb + b] = 0;
      continue;
    }
    // the last window's traceback has read R
    warp_sync(w);
    // ---- window set-up, each thread its word ----
    const int m = imin(W, plen - read_idx);  // >= 1
    // text may run out before the read does: n can reach 0
    const int n = imax(0, imin(W, tlen - ref_idx));
    const int s = W - m;
    const int64_t tbase = P.text_base[b] + ref_idx;
    Lanes<uint64_t> p0, p1;
    FOR_THREADS(w, t) {
      pattern_planes(P.pattern_words, pattern_words_n,
                     (int64_t)b * P.pattern_stride * 16 + read_idx, W, gt[t],
                     p0[t], p1[t]);
      // the row above row 0: ones in [s-1, W), read by sub-group 0 of the
      // first pass from the slot past the forefront's columns
      if (rr[t] == 0 && gt[t] < NW)
        fl[(size_t)(W + NW) * NW + gt[t]] = ones_from(s - 1, W, gt[t]);
    }

    // ---- DP fill (pyref.genasm_dc), RP rows a pass ----
    int wed = -1;
    for (int d0 = 0; d0 <= K && (!ET || wed < 0); d0 += RP) {
      // this pass's row of each thread: c0 its column at step 0, the
      // start column's value, where its cells go, and the carry into its
      // word 0 (ones below bit 0 in the row above row 0 when s = 0).
      // Sub-group 0 reads the row above at step k from slot ftop - k *
      // fstep: the forefront's slot W+NW-1-k (word g of column W-k+g), or
      // in the first pass the row above row 0. Every thread loads, from a
      // slot in the scratch (past column 0, the padding), and no
      // instruction but the step that takes the value waits for it
      const int ftop = d0 > 0 ? W + NW - 1 : W + NW;
      const int fstep = d0 > 0 ? 1 : 0;
      const size_t fstride = (size_t)fstep * NW;
      Lanes<int> c0;
      Lanes<int64_t> rbase, fbase;
      Lanes<bool> st_r, st_f;
      Lanes<unsigned> low, tmask, nbc, txs;
      Lanes<uint32_t> tx0, tx1, tx2;
      Lanes<uint64_t> stv, right, f0, q1, col0;
      Lanes<const uint64_t*> lp;  // the slot of step k+1+UNROLL
      Lanes<uint64_t> ring[UNROLL];
      FOR_THREADS(w, t) {
        const int r = rr[t], g = gt[t], d = d0 + r;
        c0[t] = W + g + r * LAG;
        stv[t] = ones_from(s + d, W, g);
        low[t] = g == 0 && d == 0 && s == 0 ? 2u : 0u;
        tmask[t] = g ? 3u : 0u;
        st_r[t] = r < RP && d <= K && g >= FTW && g < NW;
        st_f[t] = r == RP - 1 && g < NW;
        rbase[t] = (int64_t)imin(d, K) * (int64_t)rrow +
                   (int64_t)(NW - 1 - g) * NWS + (g - FTW);
        fbase[t] = (int64_t)(NW - 1 - g) * NW + g;
        const uint64_t* const fr = fl + (size_t)ftop * NW + imin(g, NW - 1);
        right[t] = q1[t] = 0;
        col0[t] = ~0ull;
        nbc[t] = 0;
        // the ring holds the row above for steps k+1 .. k+UNROLL at step
        // k, step k' in slot k' % UNROLL
        f0[t] = fr[0];
#pragma unroll
        for (int i = 1; i <= UNROLL; ++i)
          ring[i % UNROLL][t] = fr[-(ptrdiff_t)(i * fstride)];
        lp[t] = fr - (UNROLL + 1) * fstride;
        // block 0's text words
        const int64_t glo = tbase + c0[t] - 31;
        txs[t] = ((unsigned)glo & 15u) * 2u;
        tx0[t] = load_word(P.text_words, P.text_words_n, glo >> 4);
        tx1[t] = load_word(P.text_words, P.text_words_n, (glo >> 4) + 1);
        tx2[t] = load_word(P.text_words, P.text_words_n, (glo >> 4) + 2);
      }
      for (int blk = 0; blk < nblocks; ++blk) {
        const int k0 = blk * UNROLL;
        // this block's 32 text chars from glo (char glo+31-j at step j,
        // in bits 2(31-j) and 2(31-j)+1), then the next block's words
        Lanes<uint64_t> X;
        FOR_THREADS(w, t) {
          X[t] = funnel_r(tx0[t], tx1[t], txs[t]) |
                 ((uint64_t)funnel_r(tx1[t], tx2[t], txs[t]) << 32);
          const int64_t glo = tbase + c0[t] - k0 - UNROLL - 31;
          txs[t] = ((unsigned)glo & 15u) * 2u;
          tx0[t] = load_word(P.text_words, P.text_words_n, glo >> 4);
          tx1[t] = load_word(P.text_words, P.text_words_n, (glo >> 4) + 1);
          tx2[t] = load_word(P.text_words, P.text_words_n, (glo >> 4) + 2);
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const int k = k0 + j;
          // for step k+1: the row above from the sub-group above (its cell
          // of step k-1), and the bits 63 of word t-1 (the cell to the
          // right, of step k-1, and the row above at this step)
          Lanes<uint64_t> up = right;
          if (RP > 1) up = shfl_up64<G>(w, right);
          Lanes<unsigned> bits;
          FOR_THREADS(w, t) {
            bits[t] =
                (unsigned)(right[t] >> 63) | ((unsigned)(f0[t] >> 63) << 1);
          }
          const Lanes<unsigned> nbn = shfl_up<G>(w, bits);
          FOR_THREADS(w, t) {
            const int c = c0[t] - k;  // the column of step k
            const unsigned cin = (nbc[t] & tmask[t]) | low[t];
            const uint64_t sf0 = (f0[t] << 1) | (cin >> 1);
            // all ones where the column has text (c < n), zero in a start
            // column; the text char's bits as all-ones or zero masks
            const uint64_t text = spread(neg_mask(c - n));
            const uint64_t A = q1[t] & sf0 & text;
            const uint64_t m0 = spread(bit_mask(X[t], 2 * (31 - j)));
            const uint64_t m1 = spread(bit_mask(X[t], 2 * (31 - j) + 1));
            const uint64_t pmi = (p0[t] ^ m0) | (p1[t] ^ m1);
            const uint64_t C = (pmi & A) | (stv[t] & ~text);
            const uint64_t v = (((right[t] << 1) | (cin & 1u)) & A) | C;
            q1[t] = sf0 & f0[t];
            if (st_r[t] && (unsigned)c < (unsigned)COLS)
              store_r(rl + rbase[t] + (int64_t)c * NWS, v);
            if (st_f[t] && (unsigned)c <= (unsigned)W)
              fl[fbase[t] + (int64_t)c * NW] = v;
            col0[t] = c == 0 ? v : col0[t];
            right[t] = v;
            nbc[t] = nbn[t];
            const int nx = (j + 1) % UNROLL;
            f0[t] = rr[t] ? up[t] : ring[nx][t];
            ring[nx][t] = *lp[t];
            lp[t] -= fstride;
          }
        }
      }
      // the first row of the pass whose column 0 has bit W-1 clear
      Lanes<bool> hit;
      FOR_THREADS(w, t) {
        hit[t] = rr[t] < RP && gt[t] == NW - 1 && d0 + rr[t] <= K &&
                 ((col0[t] >> probe) & 1ull) == 0;
      }
      const unsigned hits = ballot(w, hit);
      if (hits && (ET || wed < 0)) wed = d0 + (first_set(hits) - 1) / G;
      // the next pass reads the forefront this one wrote; the traceback
      // reads R
      warp_sync(w);
    }

    // ---- level traceback (engine_pallas.py level_body) ----
    int nrun = 0;
    if (wed < 0) {
      failed |= FAIL_TB;
      done = true;
    } else {
      const int mm = m, nn = n;
      int16_t* __restrict__ ent = P.entries + (size_t)win * NE * nb + b;
      int i = 0, j = 0, dd = wed, pend_op = OP_NONE, pend_cnt = 0;
      bool fin = false;
      while (!fin && dd > 0) {
        // steps run while j < m, i < TB and j < TB (pyref.genasm_tb)
        const int t_term = imax(imin(imin(mm - j, TB - i), TB - j), 0);
        int run = t_term, op = OP_NONE;
        const uint64_t* __restrict__ row = rl + (size_t)(dd - 1) * rrow;
        const int tj = mm - 1 - j;  // the offset where j+t == m-1
        for (int base = 0; base < t_term; base += TB_CH) {
          // column i+base+k gives bits p, p+1, p+2 (p = W-2-j-base-k):
          // the insertion bit of offset base+k, and the substitution
          // and deletion bits of offset base+k-1. Offsets t < t_term
          // read bits in [O-1, W) of columns < COLS; the others are
          // decided by the j == m-1 bit and t_term alone. A word below
          // FTW reads as 0: only bit p of such a column can lie there,
          // and that bit is not used. Word q of column c is at slot
          // c + NW-1-q of the row
          uint64_t x[TB_CH + 1];
#pragma unroll
          for (int k = 0; k <= TB_CH; ++k) {
            const int p = W - 2 - j - base - k;  // >= -TB_CH-1
            const int wl = p >> 6;                // floor: the word of p
            const unsigned sh = (unsigned)p & 63u;
            const int col = imin(i + base + k, COLS - 1);
            const uint64_t lo =
                wl >= FTW ? row[(size_t)(col + NW - 1 - wl) * NWS + (wl - FTW)]
                          : 0ull;
            const uint64_t hi =
                sh >= 62 && wl + 1 >= FTW && wl + 1 < NW
                    ? row[(size_t)(col + NW - 2 - wl) * NWS + (wl + 1 - FTW)]
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
        failed |= FAIL_STALL;  // would loop forever in the reference
        done = true;
        nrun = 0;
      } else {
        ed += wed - dd;  // trailing deletes are not traced back
        ref_idx += i;
        read_idx += j;
        done = read_idx >= plen;
      }
    }
    if (writer) P.counts[(size_t)win * nb + b] = nrun;
  }
  if (writer) {
    if (failed == 0 && read_idx < plen) failed |= FAIL_INCOMPLETE;
    P.ed_out[b] = ed;
    P.failed_out[b] = failed;
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

// one block an SM at least, nothing more asked: with the block size
// alone, ptxas may cap the registers and spill
template <int G, bool ET>
__global__ void __launch_bounds__(THREADS, 1)
    genasm_windows_wide_kernel(const Params P) {
  const long long pair = ((long long)blockIdx.x * THREADS + threadIdx.x) / WARP;
  if (pair >= P.B) return;  // the whole warp
  const int t = threadIdx.x % WARP;
  wide_warp<G, ET>(Warp{t, t + 1}, P, (size_t)pair);
}

template <int G, bool ET>
int launch(const Params& P, cudaStream_t stream) {
  const long long threads = (long long)P.B * WARP;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  genasm_windows_wide_kernel<G, ET><<<grid, THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// key: the words per bitvector, ceil(W/64) in 4..32 (genasm_windows1.cu
// and genasm_windows.cu take fewer), with ET_OFF set for the
// instantiation without early termination; R scratch (K+1) * NWS *
// (W-O+NWS) words a pair, NWS = NW - max(O-1,0)/64, forefront scratch
// (FF_PAD+W+NW+1) * NW words a pair. Returns -1 for arguments the kernel
// does not take, else the launch's cudaGetLastError().
extern "C" int genasm_windows_wide_launch(
    int key, const void* text_words, int64_t text_words_n,
    const void* text_base, const void* text_len, const void* pattern_words,
    int64_t pattern_stride, const void* pattern_len, int B, int W, int K,
    int O, int max_windows, void* R, void* ff, void* ed, void* failed,
    void* entries, void* counts, void* stream) {
  const int nw = key & ~ET_OFF;
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
  const bool et = !(key & ET_OFF);
  auto* const fn = nw <= 4 ? (et ? &launch<4, true> : &launch<4, false>)
                 : nw <= 8 ? (et ? &launch<8, true> : &launch<8, false>)
                 : nw <= 16 ? (et ? &launch<16, true> : &launch<16, false>)
                            : (et ? &launch<32, true> : &launch<32, false>);
  return fn(P, (cudaStream_t)stream);
}
#endif
