// GenASM windowed alignment for bitvectors of two and three 64-bit words
// (W = 65..192), one thread per pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel scrooge_tpu/ops/engine_pallas.py:901
// (slab_step_kernel, body _multi_window_kernel :367-836, with its multiword
// helpers _shl1_u32, _ones_shifted_u32 and _mw_* :241-334) at two and
// three words, with the slab loop around it (_align_scan :919-1056) and
// the per-pair genome segment copy. One launch runs every window of every
// pair; genasm_windows1.cu does the same for one word (W <= 64) and
// genasm_windows_wide.cu, a warp a pair, for four words and more.
//
// What bounds it on this card: one thread per pair gives B threads (16384
// at the bench tile, ~4 warps an SM), so each scheduler holds about one
// warp and no latency is hidden: every dependent step of a thread costs
// its full latency. Under that, each DP cell is ~8 INT32 instructions a
// word, and R is the largest memory traffic. The forefront row (W+1
// columns of NW words: 516 32-bit registers at two words) does not fit in
// registers as it does at one word, and in shared memory it would take
// 2 KB a pair, so that the bench tile would need two waves. The design:
//
// (a) MSB alignment, as the TPU kernel has it: pattern position j sits at
//     bit W-1-j, every value of a window is masked to bits [W-m, W), start
//     columns are that mask << d, and the full-match probe is the fixed
//     bit W-1 of the top word. The traceback reads bits [O-1, W) only, so
//     R keeps just the 64-bit words FTW = max(O-1, 0) / 64 .. NW-1
//     (engine_pallas.py first_tb_word): one word of two at W=128 O=65;
// (b) window set-up from packed words: the <= 4 NW + 1 words that cover a
//     window's chars are loaded at once and funnel-shifted into 2 NW
//     64-bit registers of 32 chars; the four equality masks are formed
//     from the low-bit and high-bit planes 64 chars at a time and
//     bit-reversed into their MSB position (engine_pallas.py build_pm);
// (c) the fill runs rows d and d+1 in one wavefront (engine_pallas.py
//     _pair_body :541): the step at column i computes row d at i and row
//     d+1 at i+1, shares the shifts between them, and reads and writes the
//     forefront once per row pair;
// (d) the forefront stays in device memory (lane-minor, L2-resident:
//     ~36 MB at the bench tile), walked in batches of CHF = 8 and 4
//     columns (NW = 2, 3) aligned to CHF: a batch picks its text word
//     once, so its characters are compile-time shifts, and it loads the
//     next batch's forefront words into registers before it stores its
//     own, so no load waits behind a store and a batch's arithmetic covers
//     the next batch's latency. Kept in shared memory instead (the
//     window lab's ffsmem variant), it needs 74 KB a 32-lane block at
//     W=128 and two waves for the bench tile, and runs slower there;
// (e) the TPU kernel's closed-form level traceback (engine_pallas.py
//     level_body :675, run_tb :770): at level L = dd-1 a '=' run along the
//     diagonal, then at most one edit, with a pending-edit run carried so
//     each emitted run is maximal. Offset t needs bit W-2-j-t of
//     R[L][i+t] (insertion) and bits W-1-j-t, W-2-j-t of R[L][i+t+1]
//     (deletion, substitution); a column's three bits are funnel-shifted
//     out of the stored word that holds them (and the next one when they
//     straddle a word), CH offsets a batch of independent loads, until a
//     batch shows a stop bit; the run length is a find-first-set.
//
// Conventions (shared with genasm_windows1.cu; the plain version in
// ops/engine.py is LSB-aligned, and only outputs are compared): word k of
// a vector holds bits [64k, 64k+64); 2-bit codes, 16 a 32-bit word, char k
// of a word in bits [2k, 2k+2); text char k of pair b is global char
// text_base[b] + k (64-bit) of a buffer of text_words_n words; pattern
// char k is char b*pattern_stride*16 + k of a buffer of B*pattern_stride
// words; R holds rows d <= K+1 (the pair at d = K computes row K+1),
// stored words ws = k - FTW < NWS = NW - FTW and columns i < COLS = W-O+1,
// laid out [lane / 32][row][ws][col][lane % 32]; the forefront holds
// ff_cols(W) columns of NW words, [lane / 32][col][word][lane % 32]; a
// warp's 32 lanes store one value as 256 contiguous bytes;
// entries[w][e][b] = op << 12 | count, counts[w][b] runs in window w.
//
// Early termination is the template parameter ET, as in
// genasm_windows1.cu: without it every window fills rows 0..K (and K+1
// when K is even) and wed stays the first row that hits.
//
// The kernel also compiles as host C++ (tests/windows_host.cpp, under
// AddressSanitizer and UBSan), as genasm_windows1.cu does.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "genasm_windows_common.cuh"

namespace {

constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_NONE = 4;
constexpr int FAIL_TB = 1, FAIL_STALL = 2, FAIL_INCOMPLETE = 8;
constexpr int THREADS = 64;
constexpr int LB = 32;  // lanes of an R or forefront block
constexpr int ET_OFF = 1 << 8;  // the key's flag: no early termination

// forefront columns per fill batch: the batch in hand and the prefetched
// one take 2 CHF NW registers of 64 bits, so CHF shrinks as NW grows
template <int NW>
__host__ __device__ constexpr int fill_batch() {
  return NW == 2 ? 8 : 4;
}

// traceback offsets per batch of R loads: 4 at two words, where a
// level's '=' runs are short against a batch of 8 (the window lab's tb8
// variant times 8 on the W=128 bench tile), 8 at three words
template <int NW>
__host__ __device__ constexpr int tb_batch() {
  return NW == 2 ? 4 : 8;
}

// forefront columns: 0..W, and the top fill batch's columns above W
__host__ __device__ constexpr int ff_cols(int W) { return W + 17; }

// bits [0, k) of 32, for any k: empty for k <= 0, all for k >= 32
__device__ __forceinline__ unsigned low_bits32(int k) {
  return k <= 0 ? 0u : k >= 32 ? ~0u : (1u << k) - 1u;
}

// ones in bits [lo, W) of an NW-word vector; empty for lo >= W
template <int NW>
__device__ __forceinline__ void ones_from(int lo, int W, uint64_t (&out)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    out[k] = low_bits(W - 64 * k) & ~low_bits(lo - 64 * k);
}

// v << 1 across the words. Bits at W and above are never masked: a shift
// only moves them further up, and nothing reads a bit >= W
template <int NW>
__device__ __forceinline__ void shl1(const uint64_t (&v)[NW],
                                     uint64_t (&out)[NW]) {
#pragma unroll
  for (int k = NW - 1; k > 0; --k) out[k] = (v[k] << 1) | (v[k - 1] >> 63);
  out[0] = v[0] << 1;
}

// word k of a register array, k known only at run time: a select chain,
// so the array stays in registers
template <int N>
__device__ __forceinline__ uint64_t pick(const uint64_t (&v)[N], int k) {
  uint64_t x = v[0];
#pragma unroll
  for (int q = 1; q < N; ++q) x = q == k ? v[q] : x;
  return x;
}

// pattern masks, MSB-aligned: zero at bit W-1-j where pattern[j] == c for
// j < m, ones elsewhere in lane (bits [W-m, W)); p[2q], p[2q+1] hold the
// chars 64q..64q+63
template <int NW>
__device__ __forceinline__ void pattern_masks(const uint64_t (&p)[2 * NW],
                                              int m, int W,
                                              const uint64_t (&lane)[NW],
                                              uint64_t (&pm)[4][NW]) {
  const int r = W - 64 * (NW - 1);  // bits of the top word, 1..64
  uint64_t acc[4][NW];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < NW; ++k) acc[c][k] = 0;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const uint64_t lo = p[2 * q], hi = p[2 * q + 1];
    const uint64_t b0 = even_bits(lo) | (even_bits(hi) << 32);
    const uint64_t b1 = even_bits(lo >> 1) | (even_bits(hi >> 1) << 32);
    const uint64_t in = low_bits(m - 64 * q);
    const uint64_t eq[4] = {~b0 & ~b1 & in, b0 & ~b1 & in, ~b0 & b1 & in,
                            b0 & b1 & in};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // char 64q+k at bit 63-k; its place is global bit
      // W-1-64q-k = (63-k) + r + 64 (NW-2-q)
      const uint64_t v = __brevll(eq[c]);
      acc[c][NW - 1 - q] |= r >= 64 ? v : v >> (64 - r);
      if (NW - 2 - q >= 0) acc[c][NW - 2 - q] |= r >= 64 ? 0ull : v << r;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < NW; ++k) pm[c][k] = lane[k] & ~acc[c][k];
}

// Rows d (A) and d+1 (B) in one wavefront: the step at column i computes
// A at i and B at i+1, from A at i+1 and i+2, B at i+2 and row d-1 (the
// forefront, not read when ZERO, i.e. d == 0, whose row matches only) at
// i and i+1; B at i+1 then replaces row d-1 there. Columns i >= n hold
// the start value. Stores rows d and d+1 of R (ra, rb: column 0 of
// stored word 0) and returns the top words of A and B at column 0.
template <int NW, bool ZERO>
__device__ __forceinline__ void fill_pair(
    uint64_t* __restrict__ fl, const uint64_t (&t)[2 * NW],
    const uint64_t (&pm)[4][NW], int W, int s, int n, int d, int COLS,
    int FTW, uint64_t* __restrict__ ra, uint64_t* __restrict__ rb,
    uint64_t& a0, uint64_t& b0) {
  constexpr int C = fill_batch<NW>();
  uint64_t startA[NW], startB[NW];
  ones_from<NW>(s + d, W, startA);
  ones_from<NW>(s + d + 1, W, startB);
  // A at i+1 and i+2 with their shifts, B at i+2, PM at i+1, row d-1 at
  // i+1 with its shift
  uint64_t a1[NW], a2[NW], sa2[NW], bp[NW], pm1[NW], fn[NW], sfn[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)
    a1[k] = a2[k] = sa2[k] = bp[k] = pm1[k] = fn[k] = sfn[k] = 0;
  uint64_t fc[C][NW], fx[C][NW];  // row d-1: this batch, the next one
  const int top = W / C;          // the batch that holds column W
  if (!ZERO) {
    const uint64_t* __restrict__ src = fl + (size_t)top * C * NW * LB;
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int w = 0; w < NW; ++w) fc[k][w] = src[(k * NW + w) * LB];
  }
#pragma unroll 1
  for (int cb = top; cb >= 0; --cb) {
    const int c0 = cb * C;
    if (!ZERO && cb > 0) {  // loads before this batch's stores
      const uint64_t* __restrict__ src = fl + (size_t)(c0 - C) * NW * LB;
#pragma unroll
      for (int k = 0; k < C; ++k)
#pragma unroll
        for (int w = 0; w < NW; ++w) fx[k][w] = src[(k * NW + w) * LB];
    }
    // a batch never straddles a 32-char text word (32 % C == 0)
    const uint64_t tw = pick<2 * NW>(t, c0 >> 5) >> (2 * (c0 & 31));
    uint64_t* __restrict__ fb = fl + (size_t)(c0 + 1) * NW * LB;
    uint64_t* __restrict__ pa = ra + (size_t)c0 * LB;
    uint64_t* __restrict__ pb = rb + (size_t)(c0 + 1) * LB;
    const size_t wstride = (size_t)COLS * LB;  // between stored words
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
      const int i = c0 + k;
      const unsigned ch = (unsigned)(tw >> (2 * k)) & 3u;
      uint64_t pmi[NW], sa[NW], a[NW], b[NW], sb[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w)
        pmi[w] = (ch & 2u) ? ((ch & 1u) ? pm[3][w] : pm[2][w])
                           : ((ch & 1u) ? pm[1][w] : pm[0][w]);
      shl1<NW>(a1, sa);  // shl1(A(i+1)): A's right and B's top
      if (ZERO) {
#pragma unroll
        for (int w = 0; w < NW; ++w) a[w] = sa[w] | pmi[w];
      } else {
        uint64_t sf[NW];
        shl1<NW>(fc[k], sf);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          a[w] = (sa[w] | pmi[w]) & sfn[w] & sf[w] & fn[w];
          fn[w] = fc[k][w];
          sfn[w] = sf[w];
        }
      }
      shl1<NW>(bp, sb);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        a[w] = i >= n ? startA[w] : a[w];
        // top = A(i+1), topright = A(i+2), right = B(i+2)
        b[w] = i + 1 >= n ? startB[w]
                          : (sb[w] | pm1[w]) & sa2[w] & sa[w] & a2[w];
        fb[(k * NW + w) * LB] = b[w];
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w >= FTW) {
          if (i < COLS) pa[(w - FTW) * wstride + k * LB] = a[w];
          if (i + 1 < COLS) pb[(w - FTW) * wstride + k * LB] = b[w];
        }
        a2[w] = a1[w];
        sa2[w] = sa[w];
        a1[w] = a[w];
        bp[w] = b[w];
        pm1[w] = pmi[w];
      }
    }
    if (!ZERO) {
#pragma unroll
      for (int k = 0; k < C; ++k)
#pragma unroll
        for (int w = 0; w < NW; ++w) fc[k][w] = fx[k][w];
    }
  }
  // the step at i = -1: B at column 0
  uint64_t sa[NW], sb[NW], b[NW];
  shl1<NW>(a1, sa);
  shl1<NW>(bp, sb);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    b[w] = 0 >= n ? startB[w] : (sb[w] | pm1[w]) & sa2[w] & sa[w] & a2[w];
    fl[w * LB] = b[w];
    if (w >= FTW) rb[(w - FTW) * (size_t)COLS * LB] = b[w];
  }
  a0 = a1[NW - 1];
  b0 = b[NW - 1];
}

template <int NW, bool ET>
__global__ void __launch_bounds__(THREADS) genasm_windows_kernel(
    const uint32_t* __restrict__ text_words, int64_t text_words_n,
    const int64_t* __restrict__ text_base,
    const int32_t* __restrict__ text_len,
    const uint32_t* __restrict__ pattern_words, int64_t pattern_stride,
    const int32_t* __restrict__ pattern_len, int B, int W, int K, int O,
    int max_windows, uint64_t* __restrict__ R, uint64_t* __restrict__ ff,
    int32_t* __restrict__ ed_out, int32_t* __restrict__ failed_out,
    int16_t* __restrict__ entries, int32_t* __restrict__ counts) {
  constexpr int TW = 2 * NW;  // 64-bit registers of window chars
  constexpr int CH = tb_batch<NW>();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t nb = (size_t)B;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  const int FTW = max(O - 1, 0) / 64;  // first stored word
  const int NWS = NW - FTW;
  const int probe = (W - 1) & 63;  // bit W-1, in the top word
  const int64_t tbase = text_base[b];
  const int64_t pbase = (int64_t)b * pattern_stride * 16;
  const int64_t pattern_words_n = (int64_t)B * pattern_stride;
  const int tlen = text_len[b];
  const int plen = pattern_len[b];
  const size_t row_stride = (size_t)NWS * COLS * LB;
  const size_t fpitch = (size_t)ff_cols(W) * NW * LB;
  uint64_t* __restrict__ rl =
      R + (size_t)(b / LB) * (K + 2) * row_stride + b % LB;
  uint64_t* __restrict__ fl = ff + (size_t)(b / LB) * fpitch + b % LB;

  int ref_idx = 0, read_idx = 0, ed = 0, failed = 0;
  bool done = plen <= 0;  // an empty read is done before its first window

  for (int w = 0; w < max_windows; ++w) {
    int nrun = 0;
    if (!done) {
      const int m = min(W, plen - read_idx);  // >= 1 while not done
      // text may run out before the read does: n can reach 0
      const int n = max(0, min(W, tlen - ref_idx));
      const int s = W - m;  // the window's values live in bits [s, W)

      // ---- (a) window set-up from packed words ----
      uint64_t p[TW], t[TW];
#pragma unroll
      for (int k = 0; k < TW; ++k) t[k] = 0;
      load_chars<TW>(pattern_words, pattern_words_n, pbase + read_idx, m, p);
      if (n > 0)
        load_chars<TW>(text_words, text_words_n, tbase + ref_idx, n, t);
      uint64_t lane[NW], pm[4][NW];
      ones_from<NW>(s, W, lane);
      pattern_masks<NW>(p, m, W, lane, pm);

      // ---- (b) DP fill (pyref.genasm_dc), two rows a pass ----
      int wed = -1;
      uint64_t a0, b0;
      fill_pair<NW, true>(fl, t, pm, W, s, n, 0, COLS, FTW, rl,
                          rl + row_stride, a0, b0);
      if (((a0 >> probe) & 1ull) == 0) wed = 0;
      else if (((b0 >> probe) & 1ull) == 0) wed = 1;  // K >= 1
      // without ET the rows after the first hit are filled all the same
      for (int d = 2; (!ET || wed < 0) && d <= K; d += 2) {
        uint64_t* __restrict__ ra = rl + (size_t)d * row_stride;
        fill_pair<NW, false>(fl, t, pm, W, s, n, d, COLS, FTW, ra,
                             ra + row_stride, a0, b0);
        if (ET || wed < 0) {
          if (((a0 >> probe) & 1ull) == 0) wed = d;
          else if (d + 1 <= K && ((b0 >> probe) & 1ull) == 0) wed = d + 1;
        }
      }

      if (wed < 0) {
        failed |= FAIL_TB;  // no alignment within K edits
        done = true;
      } else {
        // ---- (c) level traceback (engine_pallas.py level_body) ----
        int16_t* __restrict__ ent = entries + (size_t)w * NE * nb + b;
        const size_t wstride = (size_t)COLS * LB;  // between stored words
        int i = 0, j = 0, dd = wed, pend_op = OP_NONE, pend_cnt = 0;
        bool fin = false;
        while (!fin && dd > 0) {
          // steps run while j < m, i < TB and j < TB (pyref.genasm_tb)
          const int t_term = max(min(min(m - j, TB - i), TB - j), 0);
          int run = t_term, op = OP_NONE;
          const uint64_t* __restrict__ row =
              rl + (size_t)(dd - 1) * row_stride;
          const int tj = m - 1 - j;  // the offset where j+t == m-1
          for (int base = 0; base < t_term; base += CH) {
            // column i+base+k gives bits p, p+1, p+2 (p = W-2-j-base-k):
            // the insertion bit of offset base+k, and the substitution
            // and deletion bits of offset base+k-1. Offsets t < t_term
            // read bits in [O-1, W) of columns < COLS; the others are
            // decided by the j == m-1 bit and t_term alone. A word below
            // FTW reads as 0: only bit p of such a column can lie there
            // (p = 64 FTW - 1 at most, when O-1 = 64 FTW), and that bit
            // is not used
            uint64_t x[CH + 1];
#pragma unroll
            for (int k = 0; k <= CH; ++k) {
              const int p = W - 2 - j - base - k;  // >= -CH-1
              const int wl = p >> 6;                // the word of bit p
              const unsigned sh = (unsigned)p & 63u;
              const uint64_t* __restrict__ cp =
                  row + (size_t)min(i + base + k, COLS - 1) * LB;
              const uint64_t lo =
                  wl >= FTW ? cp[(size_t)(wl - FTW) * wstride] : 0ull;
              const uint64_t hi = sh >= 62 && wl + 1 >= FTW && wl + 1 < NW
                                      ? cp[(size_t)(wl + 1 - FTW) * wstride]
                                      : 0ull;
              x[k] = sh == 0 ? lo : (lo >> sh) | (hi << (64 - sh));
            }
            unsigned ci = 0, cd = 0, cs = 0;
#pragma unroll
            for (int k = 0; k < CH; ++k) {
              ci |= (unsigned)(~x[k] & 1ull) << k;
              cs |= (unsigned)((~x[k + 1] >> 1) & 1ull) << k;
              cd |= (unsigned)((~x[k + 1] >> 2) & 1ull) << k;
            }
            // priority I > D > X; the j == m-1 step may insert or
            // substitute, never delete; offsets with i+t >= n neither
            // delete nor substitute
            const int tjb = tj - base;
            const unsigned jb = tjb >= 0 && tjb < CH ? 1u << tjb : 0u;
            const unsigned below = low_bits32(n - i - base);
            const unsigned m_ins = ci | jb;
            const unsigned m_del = cd & ~jb & below;
            const unsigned m_sub = (cs | jb) & below;
            const unsigned stop =
                (m_ins | m_del | m_sub) & low_bits32(min(CH, t_term - base));
            if (stop != 0) {
              const int r = __ffs((int)stop) - 1;
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
            ent[(size_t)nrun * nb] = (int16_t)((pend_op << 12) | pend_cnt);
            ++nrun;
          }
          if (run > 0) {
            ent[(size_t)nrun * nb] = (int16_t)((OP_EQ << 12) | run);
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
          ent[(size_t)nrun * nb] = (int16_t)((pend_op << 12) | pend_cnt);
          ++nrun;
        }
        if (!fin) {
          const int run = max(min(min(m - j, TB - i), TB - j), 0);
          if (run > 0) {
            ent[(size_t)nrun * nb] = (int16_t)((OP_EQ << 12) | run);
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
    }
    counts[(size_t)w * nb + b] = nrun;
  }
  if (failed == 0 && read_idx < plen) failed |= FAIL_INCOMPLETE;
  ed_out[b] = ed;
  failed_out[b] = failed;
}

#ifdef __CUDACC__
template <int NW, bool ET>
int launch(const void* text_words, int64_t text_words_n,
           const void* text_base, const void* text_len,
           const void* pattern_words, int64_t pattern_stride,
           const void* pattern_len, int B, int W, int K, int O,
           int max_windows, void* R, void* ff, void* ed, void* failed,
           void* entries, void* counts, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS));
  genasm_windows_kernel<NW, ET><<<grid, THREADS, 0, stream>>>(
      (const uint32_t*)text_words, text_words_n, (const int64_t*)text_base,
      (const int32_t*)text_len, (const uint32_t*)pattern_words,
      pattern_stride, (const int32_t*)pattern_len, B, W, K, O, max_windows,
      (uint64_t*)R, (uint64_t*)ff, (int32_t*)ed, (int32_t*)failed,
      (int16_t*)entries, (int32_t*)counts);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// key: the words per bitvector, ceil(W/64) in 2..3 (genasm_windows1.cu
// takes one word, genasm_windows_wide.cu four and more), with ET_OFF set
// for the instantiation without early termination; returns -1 for
// arguments the kernel does not take, else the launch's
// cudaGetLastError()
extern "C" int genasm_windows_launch(
    int key, const void* text_words, int64_t text_words_n,
    const void* text_base, const void* text_len, const void* pattern_words,
    int64_t pattern_stride, const void* pattern_len, int B, int W, int K,
    int O, int max_windows, void* R, void* ff, void* ed, void* failed,
    void* entries, void* counts, void* stream) {
  const int nw = key & ~ET_OFF;
  if (nw < 2 || nw > 3 || nw != (W + 63) / 64 || O < 0 || O >= W || K < 1 ||
      text_words_n < 0 || pattern_stride < 0 || max_windows < 0)
    return -1;
  if (B <= 0) return 0;
  const bool et = !(key & ET_OFF);
  auto* const fn = nw == 2 ? (et ? &launch<2, true> : &launch<2, false>)
                           : (et ? &launch<3, true> : &launch<3, false>);
  return fn(text_words, text_words_n, text_base, text_len, pattern_words,
            pattern_stride, pattern_len, B, W, K, O, max_windows, R, ff, ed,
            failed, entries, counts, (cudaStream_t)stream);
}
#endif
