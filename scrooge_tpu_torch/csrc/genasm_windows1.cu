// GenASM windowed alignment for one-word bitvectors (W <= 64), one warp
// per pair, for Hopper (sm_90a): the main path's window kernel.
//
// Replaces the TPU kernel scrooge_tpu/ops/engine_pallas.py:901
// (slab_step_kernel, body _multi_window_kernel :367-836) at one word, with
// the slab loop around it: one launch runs every window of every pair. It
// computes what the plain version (ops/engine.py align_windows_plain)
// computes, output for output.
//
// What bounds it on this card: a window's DP row is a chain of 65
// dependent column steps, its rows depend on each other, and a pair's
// windows run one after the other. One thread a pair made a tile of
// 1,024 pairs 32 warps on 16 of the 132 SMs, every dependent step's
// latency exposed, and its traceback a chain of loads from device memory.
// So:
//
// (a) a warp a pair, a block a warp: a tile of 1,024 pairs is 1,024
//     warps, about eight on every SM;
// (b) rows in flight: a pass computes ROWS = 32 rows from d0, a row a
//     thread (thread t row d0 + t), each a column behind the row above
//     it (thread t-1's), whose cell comes down by __shfl_up_sync the step
//     it is used. Thread 0 reads row d0-1, the forefront (65 words in
//     shared memory), RING steps ahead into a ring of registers; the
//     pass's last row overwrites it behind the reads. A column step is
//     v = ((right << 1) & A) | C, where A (the row above's terms, zero in
//     a start column) and C ((PM[text] & A) | start) wait for no cell of
//     the row; the pattern masks are kept as the pattern's two bit
//     planes, PM[c] = (P0 ^ c0) | (P1 ^ c1), and the text's chars come
//     32 at a time into a register for UNROLL steps;
// (c) early termination after the pass that holds the first hit: every
//     UNROLL steps the rows that have reached column 0 test the probe bit
//     (bit m-1) of their column 0, and a ballot and a find-first-set give
//     the first row that hits, wed; with a hit the pass ends there. Without
//     early termination (template parameter ET false) the passes run on
//     to row K and wed stays the first row that hits;
// (d) R in shared memory: rows d <= min(K, W) (a window's first hit is at
//     most m <= W, and the traceback reads only rows below it), columns
//     i < COLS = W-O+1, one word each, rows an even number of words
//     apart (r_pitch), so that a step's stores from the threads, pitch+1
//     words apart, fall on distinct bank pairs; no device scratch;
// (e) the TPU kernel's closed-form level traceback (engine_pallas.py
//     level_body :675, run_tb :770): at level L = dd-1 a '=' run along the
//     diagonal, then at most one edit, with a pending-edit run carried so
//     each emitted run is maximal. Thread t reads columns i+t and i+t+1
//     of R[L] for offset t, three ballots give the insertion, deletion and
//     substitution masks of 32 offsets, and a find-first-set the run: a
//     shared-memory round trip a level. Thread 0 writes the runs.
//
// Pattern bits above m-1 and value bits above W-1 are never read: a step
// shifts left only, so bit b of a cell depends on bits <= b, the probe is
// bit m-1 and the traceback reads bits < m.
//
// Conventions (shared with the plain version): LSB-aligned bitvectors,
// pattern position j at bit m-1-j, the full-match probe at bit m-1; 2-bit
// codes, 16 a 32-bit word, char k of a word in bits [2k, 2k+2); text char
// k of pair b is global char text_base[b] + k (64-bit) of a buffer of
// text_words_n words; pattern char k is char b*pattern_stride*16 + k of a
// buffer of B*pattern_stride words; entries[w][e][b] = op << 12 | count,
// counts[w][b] runs in window w.
//
// Counters: each warp adds to rows[0] the rows its passes spanned (those
// <= K, summed over windows: row slots) and to rows[1] the rows up to each
// window's first hit (wed + 1, or K + 1 where no row hits: row work).
//
// Every shuffle and ballot takes the whole warp with a constant mask, and
// a step has no branch: a thread computes at every step, inside its row
// or not, and its stores are predicated on the column.
//
// The warp's code (windows1_warp) also compiles as host C++, with the
// warp primitives of warp_lanes.cuh: tests/windows_host.cpp runs the 32
// threads of a warp in lockstep over an array, and checks it under
// AddressSanitizer and UBSan.

#include <cstddef>
#include <cstdint>

#include "genasm_windows_common.cuh"

namespace {

constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_NONE = 4;
constexpr int FAIL_TB = 1, FAIL_STALL = 2, FAIL_INCOMPLETE = 8;
constexpr int WARP = 32;
constexpr int THREADS = 32;  // a block: one warp, one pair
constexpr int MAXC = 65;     // a row's columns i = 0..64
constexpr int ROWS = 32;     // rows a pass, a row a thread
constexpr int UNROLL = 16;   // steps a block
constexpr int RING = 4;      // steps thread 0 loads the forefront ahead
constexpr int ET_OFF = 1 << 8;  // the key's flag: no early termination
static_assert(ROWS == WARP, "a pass is a row a thread of the warp");
static_assert(UNROLL % RING == 0, "the ring's slot is the step's");
static_assert(UNROLL < 32, "a block's chars lie in 32 of them");

struct Params {
  const uint32_t* text_words;
  int64_t text_words_n;
  const int64_t* text_base;
  const int32_t* text_len;
  const uint32_t* pattern_words;
  int64_t pattern_stride;
  const int32_t* pattern_len;
  int B, W, K, O, max_windows;
  int pitch;       // words a stored row of R
  int64_t* rows;   // row slots, row work (added to)
  int32_t* ed_out;
  int32_t* failed_out;
  int16_t* entries;
  int32_t* counts;
};

// Words a stored row of R: COLS rounded up to even, so that the threads'
// stores at a step (pitch + 1 words apart) are odd apart, which puts 16
// of them on 16 distinct bank pairs
inline int r_pitch(int cols) { return cols + (cols & 1); }

// 64-bit words of shared memory a pair: R's rows d <= min(K, W) and the
// forefront's 65 columns
inline int64_t smem_words(int W, int K, int O) {
  const int rows = (K < W ? K : W) + 1;
  return (int64_t)rows * r_pitch(W - O + 1) + MAXC;
}

}  // namespace

#include "warp_lanes.cuh"

#ifdef __CUDACC__
namespace {

// *p += v, for the warp's one writer
__device__ __forceinline__ void count_add(int64_t* p, long long v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

}  // namespace
#else
// Compiled by the host harness, which defines count_add before it
// includes this file.
#endif

namespace {

LANE_FN int imin(int a, int b) { return a < b ? a : b; }
LANE_FN int imax(int a, int b) { return a > b ? a : b; }

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

// 32 chars from char lo of the window's 64 (t0 chars 0..31, t1 32..63,
// char k of a word in bits [2k, 2k+2)); chars outside 0..63 read as 0
LANE_FN uint64_t text32(uint64_t t0, uint64_t t1, int lo) {
  const int e = imax(0, imin(lo + 32, 96));  // in (0 : t0 : t1 : 0)
  const int q = e >> 5;
  const unsigned sh = 2u * (unsigned)(e & 31);
  const uint64_t a = q == 1 ? t0 : q == 2 ? t1 : 0ull;
  const uint64_t b = q == 0 ? t0 : q == 1 ? t1 : 0ull;
  return sh == 0 ? a : (a >> sh) | (b << (64u - sh));
}

// Every window of pair b on the warp's 32 threads; sm is the pair's
// shared memory (smem_words).
template <bool ET>
LANE_FN void windows1_warp(const Warp& w, const Params& P, size_t b,
                           uint64_t* __restrict__ sm) {
  const int W = P.W, K = P.K, O = P.O;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  const int pitch = P.pitch;
  const int rtop = imin(K, W);  // the last stored row of R
  uint64_t* const R = sm;       // R[d][i] at d * pitch + i
  uint64_t* const ff = sm + (size_t)(rtop + 1) * pitch;  // row d0-1
  const size_t nb = (size_t)P.B;
  const int64_t tbase = P.text_base[b];
  const int64_t pbase = (int64_t)b * P.pattern_stride * 16;
  const int64_t pattern_words_n = (int64_t)P.B * P.pattern_stride;
  const int tlen = P.text_len[b], plen = P.pattern_len[b];
  const bool writer = w.t_lo == 0;

  int ref_idx = 0, read_idx = 0, ed = 0, failed = 0;
  bool done = plen <= 0;  // an empty read is done before its first window
  long long slots = 0, work = 0;

  for (int win = 0; win < P.max_windows; ++win) {
    int nrun = 0;
    if (!done) {
      const int m = imin(W, plen - read_idx);  // >= 1 while not done
      // text may run out before the read does: n can reach 0
      const int n = imax(0, imin(W, tlen - ref_idx));

      // ---- window set-up from packed words, the same in every thread ----
      uint64_t p[2], tx[2] = {0, 0};
      load_chars<2>(P.pattern_words, pattern_words_n, pbase + read_idx, 64,
                    p);
      if (n > 0)
        load_chars<2>(P.text_words, P.text_words_n, tbase + ref_idx, 64, tx);
      // the pattern's bit planes: bit m-1-j holds bit 0 (P0) and bit 1
      // (P1) of pattern char j
      const unsigned down = 64u - (unsigned)m;  // 0..63
      const uint64_t P0 =
          __brevll(even_bits(p[0]) | (even_bits(p[1]) << 32)) >> down;
      const uint64_t P1 =
          __brevll(even_bits(p[0] >> 1) | (even_bits(p[1] >> 1) << 32)) >>
          down;
      const int probe = m - 1;
      // the last window's traceback has read R
      warp_sync(w);

      // ---- DP fill (pyref.genasm_dc), ROWS rows a pass ----
      int wed = -1;
      for (int d0 = 0; d0 <= K && (!ET || wed < 0); d0 += ROWS) {
        const int rows = imin(ROWS, K + 1 - d0);  // rows <= K
        slots += rows;
        // the pass's last row <= K reaches column 0 at step steps-1
        const int steps = MAXC + rows - 1;
        const int nblocks = (steps + UNROLL - 1) / UNROLL;
        // a thread's state: c0 its row's column at step 0, its last cell
        // (right), the row above at the last step (up, and up << 1 in
        // ups), its start value, amask (all ones for row 0, which has no
        // row above), whether its row is stored and where
        Lanes<int> c0, rbase;
        Lanes<bool> last, st;
        Lanes<uint64_t> right, up, ups, start, amask, ring[RING];
        FOR_THREADS(w, t) {
          const int d = d0 + t;
          c0[t] = MAXC - 1 + t;
          last[t] = t == ROWS - 1;
          right[t] = up[t] = ups[t] = 0;
          start[t] = d >= 64 ? 0ull : ~0ull << d;
          amask[t] = d == 0 ? ~0ull : 0ull;
          st[t] = d <= rtop;
          rbase[t] = imin(d, rtop) * pitch;
#pragma unroll
          for (int i = 0; i < RING; ++i) ring[i][t] = ff[MAXC - 1 - i];
        }
        for (int blk = 0; blk < nblocks; ++blk) {
          const int k0 = blk * UNROLL;
          // this block's text: 32 chars from column c0 - k0 - 30, which
          // hold the thread's columns at its steps
          Lanes<uint64_t> X;
          FOR_THREADS(w, t) X[t] = text32(tx[0], tx[1], c0[t] - k0 - 30);
#pragma unroll
          for (int j = 0; j < UNROLL; ++j) {
            // the row above's cell, from the last step
            const Lanes<uint64_t> sh = shfl_up64<1>(w, right);
            FOR_THREADS(w, t) {
              const int c = c0[t] - k0 - j;  // the row's column
              uint64_t u = sh[t];
              if (t == 0) {
                u = ring[j % RING][t];
                // the forefront's column thread 0 reaches RING steps on
                ring[j % RING][t] = ff[imax(0, imin(c - RING, MAXC - 1))];
              }
              const uint64_t us = u << 1;
              // topright << 1, top << 1 and topright (pyref.genasm_dc)
              const uint64_t A0 = ups[t] & us & up[t];
              up[t] = u;
              ups[t] = us;
              const uint64_t text = spread(neg_mask(c - n));  // c < n
              const uint64_t A = (A0 | amask[t]) & text;
              const int pos = 30 - j;  // the column's char in X
              const uint64_t m0 = spread(bit_mask(X[t], 2 * pos));
              const uint64_t m1 = spread(bit_mask(X[t], 2 * pos + 1));
              const uint64_t pm = (P0 ^ m0) | (P1 ^ m1);
              const uint64_t C = (pm & A) | (start[t] & ~text);
              const uint64_t v = ((right[t] << 1) & A) | C;
              if (st[t] && (unsigned)c < (unsigned)COLS) R[rbase[t] + c] = v;
              right[t] = v;
              if (last[t] && (unsigned)c < (unsigned)MAXC) ff[c] = v;
            }
          }
          // the first row that has reached column 0 and hits
          if (k0 + UNROLL > MAXC - 1) {
            Lanes<bool> hit;
            FOR_THREADS(w, t) {
              const bool ended = c0[t] - k0 - (UNROLL - 1) <= 0;
              hit[t] = ended && st[t] && ((R[rbase[t]] >> probe) & 1ull) == 0;
            }
            const unsigned h = ballot(w, hit);
            if (h != 0 && wed < 0) wed = d0 + first_set(h) - 1;
            if (ET && wed >= 0) break;
          }
        }
        // the next pass reads the forefront; the traceback reads R
        warp_sync(w);
      }

      if (wed < 0) {
        failed |= FAIL_TB;  // no alignment within K edits
        done = true;
        work += K + 1;
      } else {
        work += wed + 1;
        // ---- level traceback (engine_pallas.py level_body) ----
        int16_t* __restrict__ ent = P.entries + (size_t)win * NE * nb + b;
        int i = 0, j = 0, dd = wed, pend_op = OP_NONE, pend_cnt = 0;
        bool fin = false;
        while (!fin && dd > 0) {
          // steps run while j < m, i < TB and j < TB (pyref.genasm_tb)
          const int t_term = imax(imin(imin(m - j, TB - i), TB - j), 0);
          int run = t_term, op = OP_NONE;
          const uint64_t* __restrict__ row = R + (size_t)(dd - 1) * pitch;
          const int tj = m - 1 - j;  // the offset where j+t == m-1
          for (int base = 0; base < t_term; base += WARP) {
            // offset t = base + thread: the step walk reads bit tj-1-t of
            // R[L][i+t] (I) and bits tj-t (D), tj-1-t (X) of R[L][i+t+1];
            // offsets t >= tj are decided by the j == m-1 bit and t_term
            // alone, so the wrapped shift there reads bits not used
            Lanes<bool> bi, bs, bd;
            FOR_THREADS(w, t) {
              const int off = base + t;
              const uint64_t x0 = row[imin(i + off, COLS - 1)];
              const uint64_t x1 = row[imin(i + off + 1, COLS - 1)];
              const unsigned p = (unsigned)(tj - 1 - off) & 63u;
              const uint64_t y = ~x1 >> p;
              bi[t] = ((~x0 >> p) & 1ull) != 0;
              bs[t] = (y & 1ull) != 0;
              bd[t] = ((y >> 1) & 1ull) != 0;
            }
            const unsigned ci = ballot(w, bi), cs = ballot(w, bs),
                           cd = ballot(w, bd);
            // priority I > D > X; the j == m-1 step may insert or
            // substitute, never delete; offsets with i+t >= n neither
            // delete nor substitute
            const int tjb = tj - base;
            const unsigned jb = tjb >= 0 && tjb < WARP ? 1u << tjb : 0u;
            const unsigned below = low_bits32(n - i - base);
            const unsigned m_ins = ci | jb;
            const unsigned m_del = cd & ~jb & below;
            const unsigned m_sub = (cs | jb) & below;
            const unsigned stop = (m_ins | m_del | m_sub) &
                                  low_bits32(imin(WARP, t_term - base));
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
            if (writer)
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
          if (writer)
            ent[(size_t)nrun * nb] = (int16_t)((pend_op << 12) | pend_cnt);
          ++nrun;
        }
        if (!fin) {
          const int run = imax(imin(imin(m - j, TB - i), TB - j), 0);
          if (run > 0) {
            if (writer)
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
    if (writer) P.counts[(size_t)win * nb + b] = nrun;
  }
  if (writer) {
    if (failed == 0 && read_idx < plen) failed |= FAIL_INCOMPLETE;
    P.ed_out[b] = ed;
    P.failed_out[b] = failed;
    count_add(P.rows, slots);
    count_add(P.rows + 1, work);
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

// one block an SM at least, nothing more asked: with the block size
// alone, ptxas may cap the registers and spill
template <bool ET>
__global__ void __launch_bounds__(THREADS, 1)
    genasm_windows1_kernel(const Params P) {
  extern __shared__ uint64_t smem[];
  windows1_warp<ET>(Warp{(int)threadIdx.x, (int)threadIdx.x + 1}, P,
                    (size_t)blockIdx.x, smem);
}

template <bool ET>
int launch(const Params& P, cudaStream_t stream) {
  const size_t smem = 8 * (size_t)smem_words(P.W, P.K, P.O);
  const cudaError_t e = cudaFuncSetAttribute(
      genasm_windows1_kernel<ET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  genasm_windows1_kernel<ET><<<(unsigned)P.B, THREADS, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// key: the words per bitvector, which must be 1 (W <= 64), with ET_OFF
// set for the instantiation without early termination; rows: two int64
// counters the warps add to (row slots, row work). No device scratch: R
// and the forefront are in shared memory (smem_words a pair). Returns -1
// for arguments the kernel does not take, else the launch's
// cudaGetLastError().
extern "C" int genasm_windows1_launch(
    int key, const void* text_words, int64_t text_words_n,
    const void* text_base, const void* text_len, const void* pattern_words,
    int64_t pattern_stride, const void* pattern_len, int B, int W, int K,
    int O, int max_windows, void* rows, void* ed, void* failed,
    void* entries, void* counts, void* stream) {
  const int nw = key & ~ET_OFF;
  if (nw != 1 || W < 2 || W > 64 || O < 0 || O >= W || K < 1 ||
      text_words_n < 0 || pattern_stride < 0 || max_windows < 0 ||
      rows == nullptr)
    return -1;
  if (B <= 0) return 0;
  const Params P{(const uint32_t*)text_words, text_words_n,
                 (const int64_t*)text_base,   (const int32_t*)text_len,
                 (const uint32_t*)pattern_words, pattern_stride,
                 (const int32_t*)pattern_len, B, W, K, O, max_windows,
                 r_pitch(W - O + 1),          (int64_t*)rows,
                 (int32_t*)ed,                (int32_t*)failed,
                 (int16_t*)entries,           (int32_t*)counts};
  return key & ET_OFF ? launch<false>(P, (cudaStream_t)stream)
                      : launch<true>(P, (cudaStream_t)stream);
}
#endif
