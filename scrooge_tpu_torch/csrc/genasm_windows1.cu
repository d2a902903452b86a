// GenASM windowed alignment for one-word bitvectors (W <= 64), one thread
// per pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel scrooge_tpu/ops/engine_pallas.py:901
// (slab_step_kernel, body _multi_window_kernel :367-836) at one word, with
// the slab loop around it, as genasm_windows.cu does for W <= 192. It
// computes what genasm_windows_kernel<1> computes, output for output; the
// difference is where the per-thread time goes.
//
// What bounds it on this card: one thread per pair gives B threads (16384
// at the bench tile, ~4 warps an SM), so each scheduler holds about one
// warp and no latency is hidden: every dependent step of a thread costs
// its full latency. The window kernel of genasm_windows.cu pays a
// device-memory round trip for each pattern and text character of a
// window, for each DP cell (the forefront load right after the store of
// its neighbour) and for each traceback step (a load whose address depends
// on the step before). This kernel keeps the integer work and removes
// those round trips:
//
// (a) window set-up from packed words: the <= 5 words that cover a window's
//     64 characters are loaded at once and funnel-shifted into two 64-bit
//     registers; the pattern's characters are split into a low-bit and a
//     high-bit plane (bit j = bit 0 / bit 1 of char j), the four equality
//     masks formed from them, cut to j < m and bit-reversed so char j
//     lands on bit m-1-j (engine_pallas.py build_pm does the same with 16
//     chars a word);
// (b) the fill with the forefront in registers: the column loop over
//     i = 64..0 is unrolled, n is a predicate (a column i >= n is a start
//     column), so the forefront row lives in 65 registers indexed at
//     compile time and never touches memory; rows d and d+1 go through one
//     wavefront (engine_pallas.py _pair_body :541), which gives the thread
//     two independent chains to interleave; R (rows <= wed, columns < COLS)
//     is still stored, lane-minor, for the traceback;
// (c) the TPU kernel's closed-form level traceback (engine_pallas.py
//     level_body :675, run_tb :770): at level L = dd-1 a '=' run along the
//     diagonal, then at most one edit, with a pending-edit run carried so
//     each emitted run is maximal. The insertion, deletion and substitution
//     bits of R[L] are gathered into 64-bit masks indexed by the offset t
//     (insertion from columns i+t, deletion and substitution from columns
//     i+t+1), CH offsets a batch of independent loads, until a stop bit
//     shows up; the run length is a find-first-set. That is about
//     wed + 1 levels of one or two load batches a window instead of one
//     dependent load per traceback step.
//
// Conventions (shared with genasm_windows.cu and the plain version in
// ops/engine.py): LSB-aligned bitvectors, pattern position j at bit m-1-j,
// the full-match probe at bit m-1; 2-bit codes, 16 a 32-bit word, char k
// of a word in bits [2k, 2k+2); text char k of pair b is global char
// text_base[b] + k (64-bit) of a buffer of text_words_n words; pattern
// char k is char b*pattern_stride*16 + k of a buffer of B*pattern_stride
// words; R[d][i] for rows d <= K+1 (the pair at d = K computes row K+1)
// and columns i < COLS = W-O+1, laid out [lane / 32][row][col][lane % 32]:
// a warp's 32 lanes store one column as 256 contiguous bytes, and a
// column's offset in its row is a compile-time constant, an immediate of
// the store;
// entries[w][e][b] = op << 12 | count, counts[w][b] runs in window w.
//
// Early termination is the template parameter ET (the reference's
// EARLY_TERMINATION, engine_pallas.py:640-646): with it a pair's fill
// stops at the row pair that holds its first hit; without it every
// window fills rows 0..K (and K+1 when K is even), and wed stays the
// first row that hits. The traceback reads rows < wed either way, so the
// output is the same.
//
// The kernel also compiles as host C++: tests/windows_host.cpp defines
// the CUDA keywords and intrinsics it uses, runs each thread's body in
// turn and checks it under AddressSanitizer and UBSan.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "genasm_windows_common.cuh"

namespace {

constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_NONE = 4;
constexpr int FAIL_TB = 1, FAIL_STALL = 2, FAIL_INCOMPLETE = 8;
constexpr int THREADS = 64;
constexpr int MAXC = 65;  // forefront columns i = 0..64
constexpr int CH = 8;     // traceback offsets per batch of R loads
constexpr int LB = 32;    // lanes of an R block, the column stride
constexpr int ET_OFF = 1 << 8;  // the key's flag: no early termination

// pattern masks (pyref._pattern_masks): zero at bit m-1-j where
// pattern[j] == c, ones elsewhere in the W bits; 1 <= m <= 64
__device__ __forceinline__ void pattern_masks(uint64_t lo, uint64_t hi, int m,
                                              uint64_t full,
                                              uint64_t (&pm)[4]) {
  const uint64_t b0 = even_bits(lo) | (even_bits(hi) << 32);
  const uint64_t b1 = even_bits(lo >> 1) | (even_bits(hi >> 1) << 32);
  const uint64_t in = low_bits(m);
  const uint64_t eq[4] = {~b0 & ~b1 & in, b0 & ~b1 & in, ~b0 & b1 & in,
                          b0 & b1 & in};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    pm[c] = full & ~(__brevll(eq[c]) >> (64 - m));
}

// x, as a value the compiler cannot see through: what a row pair derives
// from it per column (the PM select, the start and store predicates) is
// then not hoisted out of the row loop into 65 live registers each
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// ones(W) << d, all ones at d == 0 and 0 from d == 64 on
__device__ __forceinline__ uint64_t start_col(uint64_t full, int d) {
  return d >= 64 ? 0ull : (full << d) & full;
}

// PM[text[i]] for a column i < 64 known at compile time
__device__ __forceinline__ uint64_t pm_at(uint64_t t0, uint64_t t1,
                                          const uint64_t (&pm)[4], int i) {
  const unsigned c = (unsigned)((i < 32 ? t0 >> (2 * i)
                                        : t1 >> (2 * (i - 32))) & 3u);
  return (c & 2u) ? ((c & 1u) ? pm[3] : pm[2]) : ((c & 1u) ? pm[1] : pm[0]);
}

// Rows d (A) and d+1 (B) in one wavefront: the step at i computes A at
// column i and B at column i+1. f holds row d-1 on entry (not read when
// ZERO, i.e. d == 0, whose row matches only) and row d+1 on return; a0 and
// b0 are the two rows' column 0. Columns i >= n hold the start value.
template <bool ZERO>
__device__ __forceinline__ void fill_pair(uint64_t (&f)[MAXC], uint64_t t0,
                                          uint64_t t1,
                                          const uint64_t (&pm)[4],
                                          uint64_t full, int n, int d,
                                          int COLS, uint64_t* __restrict__ ra,
                                          uint64_t& a0, uint64_t& b0) {
  uint64_t* __restrict__ rb = ra + COLS * LB;
  t0 = opaque(t0);
  t1 = opaque(t1);
  n = opaque(n);
  COLS = opaque(COLS);
  const uint64_t startA = start_col(full, d), startB = start_col(full, d + 1);
  uint64_t a1 = 0, a2 = 0;  // A at columns i+1 and i+2
  uint64_t bprev = 0;       // B at column i+2
  uint64_t pm1 = 0;         // PM of column i+1
#pragma unroll
  for (int i = MAXC - 1; i >= -1; --i) {
    uint64_t a = 0, pmi = 0;
    if (i >= 0) {
      if (i == MAXC - 1) {
        a = startA;  // n <= 64: column 64 always starts
      } else {
        pmi = pm_at(t0, t1, pm, i);
        const uint64_t mat = (a1 << 1) | pmi;
        // d >= 1: AND the topright << 1, top << 1 and topright terms of
        // row d-1; topright is within W bits, so bit W of the shifts drops
        const uint64_t rec =
            ZERO ? mat & full
                 : mat & (f[i + 1] << 1) & (f[i] << 1) & f[i + 1];
        a = i >= n ? startA : rec;
      }
      if (i < COLS) ra[i * LB] = a;
      if (i == 0) a0 = a;
    }
    const int k = i + 1;  // B's column
    if (k <= MAXC - 1) {
      // top = A(k) = a1, topright = A(k+1) = a2, right = B(k+1)
      const uint64_t b =
          k == MAXC - 1 || k >= n
              ? startB
              : ((bprev << 1) | pm1) & (a2 << 1) & (a1 << 1) & a2;
      if (k < COLS) rb[k * LB] = b;
      f[k] = b;  // A read f[k] (row d-1) one step ago, at column i
      bprev = b;
      if (k == 0) b0 = b;
    }
    a2 = a1;
    a1 = a;
    pm1 = pmi;
  }
}

template <bool ET>
__global__ void __launch_bounds__(THREADS) genasm_windows1_kernel(
    const uint32_t* __restrict__ text_words, int64_t text_words_n,
    const int64_t* __restrict__ text_base,
    const int32_t* __restrict__ text_len,
    const uint32_t* __restrict__ pattern_words, int64_t pattern_stride,
    const int32_t* __restrict__ pattern_len, int B, int W, int K, int O,
    int max_windows, uint64_t* __restrict__ R, int32_t* __restrict__ ed_out,
    int32_t* __restrict__ failed_out, int16_t* __restrict__ entries,
    int32_t* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t nb = (size_t)B;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  const uint64_t full = low_bits(W);
  const int64_t tbase = text_base[b];
  const int64_t pbase = (int64_t)b * pattern_stride * 16;
  const int64_t pattern_words_n = (int64_t)B * pattern_stride;
  const int tlen = text_len[b];
  const int plen = pattern_len[b];
  const size_t row_stride = (size_t)COLS * LB;
  uint64_t* __restrict__ rl =
      R + (size_t)(b / LB) * (K + 2) * row_stride + b % LB;

  uint64_t f[MAXC];  // the forefront row, in registers
#pragma unroll
  for (int i = 0; i < MAXC; ++i) f[i] = 0;

  int ref_idx = 0, read_idx = 0, ed = 0, failed = 0;
  bool done = plen <= 0;  // an empty read is done before its first window

  for (int w = 0; w < max_windows; ++w) {
    int nrun = 0;
    if (!done) {
      const int m = min(W, plen - read_idx);  // >= 1 while not done
      // text may run out before the read does: n can reach 0
      const int n = max(0, min(W, tlen - ref_idx));

      // ---- (a) window set-up from packed words ----
      uint64_t p[2], t[2] = {0, 0};
      load_chars<2>(pattern_words, pattern_words_n, pbase + read_idx, 64, p);
      if (n > 0)
        load_chars<2>(text_words, text_words_n, tbase + ref_idx, 64, t);
      const uint64_t t0 = t[0], t1 = t[1];
      uint64_t pm[4];
      pattern_masks(p[0], p[1], m, full, pm);

      // ---- (b) DP fill (pyref.genasm_dc), two rows a pass ----
      int wed = -1;
      uint64_t a0, b0;
      fill_pair<true>(f, t0, t1, pm, full, n, 0, COLS, rl, a0, b0);
      const int probe = m - 1;
      if (((a0 >> probe) & 1ull) == 0) wed = 0;
      else if (((b0 >> probe) & 1ull) == 0) wed = 1;  // K >= 1
      // without ET the rows after the first hit are filled all the same
      for (int d = 2; (!ET || wed < 0) && d <= K; d += 2) {
        fill_pair<false>(f, t0, t1, pm, full, n, d, COLS,
                         rl + (size_t)d * row_stride, a0, b0);
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
        int i = 0, j = 0, dd = wed, pend_op = OP_NONE, pend_cnt = 0;
        bool fin = false;
        while (!fin && dd > 0) {
          // steps run while j < m, i < TB and j < TB (pyref.genasm_tb)
          const int t_term = max(min(min(m - j, TB - i), TB - j), 0);
          int run = t_term, op = OP_NONE;
          if (t_term > 0) {
            const uint64_t* __restrict__ row = rl + (size_t)(dd - 1) *
                                                        row_stride;
            const int tj = m - 1 - j;  // the offset where j+t == m-1
            const uint64_t jb = 1ull << tj;          // 0 <= tj <= 63
            const uint64_t below = low_bits(n - i);  // offsets with i+t < n
            // offset-indexed masks: at offset t the step walk reads bit
            // tj-1-t of R[L][i+t] (I) and bits tj-t (D), tj-1-t (X) of
            // R[L][i+t+1]; every column read is < COLS since
            // i + t + 1 <= i + t_term <= TB
            uint64_t mi = 0, md = 0, ms = 0, stop = 0;
            for (int base = 0; base < t_term; base += CH) {
              uint64_t col[CH + 1];
#pragma unroll
              for (int k = 0; k <= CH; ++k)
                col[k] = row[min(i + base + k, COLS - 1) * LB];
              uint64_t ci = 0, cd = 0, cs = 0;
#pragma unroll
              for (int k = 0; k < CH; ++k) {
                // offsets t >= tj are decided by jb and t_term alone, so
                // the wrapped shift there reads bits that are not used
                const unsigned p = (unsigned)(tj - 1 - (base + k)) & 63u;
                ci |= ((~col[k] >> p) & 1ull) << k;
                const uint64_t y = ~col[k + 1] >> p;
                cs |= (y & 1ull) << k;
                cd |= ((y >> 1) & 1ull) << k;
              }
              mi |= ci << base;
              md |= cd << base;
              ms |= cs << base;
              // priority I > D > X; the j == m-1 step may insert or
              // substitute, never delete
              const uint64_t m_ins = mi | jb;
              const uint64_t m_del = md & ~jb & below;
              const uint64_t m_sub = (ms | jb) & below;
              stop = (m_ins | m_del | m_sub) &
                     low_bits(min(base + CH, t_term));
              if (stop != 0) {
                run = __ffsll((long long)stop) - 1;
                const uint64_t at = 1ull << run;
                op = (m_ins & at) ? OP_I : (m_del & at) ? OP_D : OP_X;
                break;
              }
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
template <bool ET>
int launch(const void* text_words, int64_t text_words_n,
           const void* text_base, const void* text_len,
           const void* pattern_words, int64_t pattern_stride,
           const void* pattern_len, int B, int W, int K, int O,
           int max_windows, void* R, void* ed, void* failed, void* entries,
           void* counts, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS));
  genasm_windows1_kernel<ET><<<grid, THREADS, 0, stream>>>(
      (const uint32_t*)text_words, text_words_n, (const int64_t*)text_base,
      (const int32_t*)text_len, (const uint32_t*)pattern_words,
      pattern_stride, (const int32_t*)pattern_len, B, W, K, O, max_windows,
      (uint64_t*)R, (int32_t*)ed, (int32_t*)failed, (int16_t*)entries,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// key: the words per bitvector, which must be 1 (W <= 64), with ET_OFF
// set for the instantiation without early termination; returns -1 for
// arguments the kernel does not take, else the launch's cudaGetLastError()
extern "C" int genasm_windows1_launch(
    int key, const void* text_words, int64_t text_words_n,
    const void* text_base, const void* text_len, const void* pattern_words,
    int64_t pattern_stride, const void* pattern_len, int B, int W, int K,
    int O, int max_windows, void* R, void* ed, void* failed, void* entries,
    void* counts, void* stream) {
  const int nw = key & ~ET_OFF;
  if (nw != 1 || W < 2 || W > 64 || O < 0 || O >= W || K < 1 ||
      text_words_n < 0 || pattern_stride < 0 || max_windows < 0)
    return -1;
  if (B <= 0) return 0;
  auto* const fn = key & ET_OFF ? &launch<false> : &launch<true>;
  return fn(text_words, text_words_n, text_base, text_len, pattern_words,
            pattern_stride, pattern_len, B, W, K, O, max_windows, R, ed,
            failed, entries, counts, (cudaStream_t)stream);
}
#endif
