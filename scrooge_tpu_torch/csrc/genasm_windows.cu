// GenASM windowed alignment, one thread per pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel scrooge_tpu/ops/engine_pallas.py:slab_step_kernel
// (body _multi_window_kernel, :367-836, with its multiword helpers _mw_*,
// _shl1_u32 and _ones_shifted_u32, :241-334) together with the slab loop
// around it (_align_scan, :919-1056) and the per-pair genome segment copy
// (:1114-1117). The Pallas kernel runs KW=8 windows per launch for a tile
// of 128-lane vectors in lockstep, with R in VMEM. Here one launch runs
// every window of every pair: thread b owns pair b and follows the scalar
// oracle's structure (scrooge_tpu/pyref.py:148-302): genasm_dc fills R,
// genasm_tb walks it back, runs are written straight to the output.
//
// What bounds it on this card: integer ALU work and, above all, the serial
// dependency chain of the fill (each cell needs the one to its right, each
// row the row before) and of the traceback, per thread; R and forefront
// traffic in device memory; and divergence, since window distances and
// read lengths differ between the 32 pairs of a warp. One thread per pair
// gives only B threads (16384 at the bench tile, ~4 warps per SM), so
// latency is barely hidden. The design keeps what it can cheap: the window
// text (2 bits a char) and the pattern masks sit in registers, every loop
// over the words of a bitvector is unrolled so no array spills to local
// memory, scratch is lane-minor so a warp's R and forefront accesses
// coalesce, the traceback loads only the one word that holds the bit it
// tests, and each pair stops its d-search at its own first hit (early
// termination is output-invariant). Shared-memory R, warp-per-pair, the
// anti-diagonal wavefront, TMA and wgmma are left to later work.
//
// Conventions (shared with the plain version in ops/engine.py):
// - bitvectors are NW = ceil(W/64) uint64 words (W <= 256, NW <= 4), word
//   0 the lowest, LSB-aligned as in pyref: pattern position j is bit m-1-j
//   of the whole value, the full-match probe is bit m-1; the top word is
//   masked to its W - 64*(NW-1) bits and ones << d saturates to 0 for
//   d >= W; the kernel is a template on NW, one instantiation per count,
//   with a scalar specialization for NW = 1 (the bench configuration);
// - 2-bit codes, 16 per 32-bit word, char k of a word in bits [2k, 2k+2);
// - text char k of pair b is global char text_base[b] + k (64-bit: mapped
//   genomes reach 2^32 bases); pattern char k is char b*pattern_stride*16+k;
// - R[d][i][word] for rows d <= K and columns i < W-O+1 (DENT), all NW
//   words, laid out [row][col][word][lane]; the forefront ff[i][word] for
//   i <= W, [col][word][lane];
// - entries[w][e][b] = op << 12 | count, counts[w][b] runs in window w;
//   runs are flushed per window and never merged across windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OP_EQ = 0, OP_X = 1, OP_I = 2, OP_D = 3, OP_NONE = 4;
constexpr int FAIL_TB = 1, FAIL_STALL = 2, FAIL_INCOMPLETE = 8;
constexpr int THREADS = 64;

__device__ __forceinline__ uint64_t code_at(const uint32_t* __restrict__ w,
                                            int64_t idx) {
  return (__ldg(w + (idx >> 4)) >> ((idx & 15) * 2)) & 3u;
}

__device__ __forceinline__ bool zero_bit(uint64_t v, int bit) {
  return ((v >> bit) & 1ull) == 0;
}

// bits [lo, hi) of a word, 0 <= lo, hi <= 64; empty when lo >= hi
__device__ __forceinline__ uint64_t bit_range(int lo, int hi) {
  if (lo >= hi) return 0ull;
  const uint64_t below_hi = hi >= 64 ? ~0ull : ((1ull << hi) - 1ull);
  return below_hi & ~((1ull << lo) - 1ull);
}

// (ones(W) << d) & ones(W), word by word; all ones at d == 0
template <int NW>
__device__ __forceinline__ void ones_shifted(int d, int topbits,
                                             uint64_t (&out)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    out[k] = bit_range(max(d - 64 * k, 0), k == NW - 1 ? topbits : 64);
}

// v << 1 across the words, the top word masked to W bits
template <int NW>
__device__ __forceinline__ void shl1(const uint64_t (&v)[NW], uint64_t top,
                                     uint64_t (&out)[NW]) {
#pragma unroll
  for (int k = NW - 1; k > 0; --k) out[k] = (v[k] << 1) | (v[k - 1] >> 63);
  out[0] = v[0] << 1;
  out[NW - 1] &= top;
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

template <int NW>
__global__ void __launch_bounds__(THREADS) genasm_windows_kernel(
    const uint32_t* __restrict__ text_words,
    const int64_t* __restrict__ text_base,
    const int32_t* __restrict__ text_len,
    const uint32_t* __restrict__ pattern_words, int64_t pattern_stride,
    const int32_t* __restrict__ pattern_len, int B, int W, int K, int O,
    int max_windows, uint64_t* __restrict__ R, uint64_t* __restrict__ ff,
    int32_t* __restrict__ ed_out, int32_t* __restrict__ failed_out,
    int16_t* __restrict__ entries, int32_t* __restrict__ counts) {
  constexpr int TW = 2 * NW;  // words of window text, 32 chars a word
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t nb = (size_t)B;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  const int topbits = W - 64 * (NW - 1);  // 1..64 bits in the top word
  uint64_t full[NW];
  ones_shifted<NW>(0, topbits, full);
  const uint64_t top = full[NW - 1];
  const int64_t tbase = text_base[b];
  const int64_t pbase = (int64_t)b * pattern_stride * 16;
  const int tlen = text_len[b];
  const int plen = pattern_len[b];
  uint64_t* __restrict__ rl = R + b;
  uint64_t* __restrict__ fl = ff + b;

  int ref_idx = 0, read_idx = 0, ed = 0, failed = 0;
  bool done = plen <= 0;  // an empty read is done before its first window

  for (int w = 0; w < max_windows; ++w) {
    int nrun = 0;
    if (!done) {
      const int m = min(W, plen - read_idx);  // >= 1 while not done
      // text may run out before the read does: n can reach 0
      const int n = max(0, min(W, tlen - ref_idx));

      // pattern masks (pyref._pattern_masks): zero at bit m-1-j where
      // pattern[j] == c, ones everywhere else in the W bits
      uint64_t pm[4][NW];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < NW; ++k) pm[c][k] = full[k];
      for (int j = 0; j < m; ++j) {
        const int c = (int)code_at(pattern_words, pbase + read_idx + j);
        const int p = m - 1 - j;
        const int kp = p >> 6;  // the word that holds bit p
        const uint64_t clr = ~(1ull << (p & 63));
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < NW; ++k)
            pm[q][k] &= (q == c && k == kp) ? clr : ~0ull;
      }
      // the window's text, 2 bits a char, chars 32k..32k+31 in t[k]
      uint64_t t[TW];
#pragma unroll
      for (int k = 0; k < TW; ++k) t[k] = 0;
      for (int i = 0; i < n; ++i) {
        const uint64_t c = code_at(text_words, tbase + ref_idx + i);
#pragma unroll
        for (int k = 0; k < TW; ++k)
          t[k] |= k == (i >> 5) ? c << (2 * (i & 31)) : 0ull;
      }

      // ---- DP fill (pyref.genasm_dc, genasm_cpu.cpp:210-288) ----
      int wed = -1;
      for (int d = 0; d <= K && wed < 0; ++d) {
        // start column i == n: all ones at d == 0 (pyref.py genasm_dc),
        // ones << d after it, 0 once d reaches W
        uint64_t start[NW];
        ones_shifted<NW>(d, topbits, start);
        uint64_t right[NW], topright[NW], center[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) right[k] = topright[k] = 0ull;
        for (int i = n; i >= 0; --i) {
          uint64_t tp[NW];
#pragma unroll
          for (int k = 0; k < NW; ++k)
            tp[k] = d > 0 ? fl[((size_t)i * NW + k) * nb] : 0ull;
          if (i == n) {
#pragma unroll
            for (int k = 0; k < NW; ++k) center[k] = start[k];
          } else {
            const int c = (int)((pick<TW>(t, i >> 5) >> (2 * (i & 31))) & 3);
            uint64_t sr[NW];
            shl1<NW>(right, top, sr);
            if (d == 0) {  // d == 0 rows match only
#pragma unroll
              for (int k = 0; k < NW; ++k) {
                const uint64_t pmv = c == 0   ? pm[0][k]
                                     : c == 1 ? pm[1][k]
                                     : c == 2 ? pm[2][k]
                                              : pm[3][k];
                center[k] = sr[k] | pmv;
              }
            } else {
              uint64_t str[NW], stp[NW];
              shl1<NW>(topright, top, str);
              shl1<NW>(tp, top, stp);
#pragma unroll
              for (int k = 0; k < NW; ++k) {
                const uint64_t pmv = c == 0   ? pm[0][k]
                                     : c == 1 ? pm[1][k]
                                     : c == 2 ? pm[2][k]
                                              : pm[3][k];
                center[k] = (sr[k] | pmv) & str[k] & stp[k] & topright[k];
              }
            }
          }
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            topright[k] = tp[k];
            right[k] = center[k];
            fl[((size_t)i * NW + k) * nb] = center[k];
            if (i < COLS) rl[(((size_t)d * COLS + i) * NW + k) * nb] = center[k];
          }
        }
        // center is column 0 here
        if (zero_bit(pick<NW>(center, (m - 1) >> 6), (m - 1) & 63)) wed = d;
      }

      if (wed < 0) {
        failed |= FAIL_TB;  // no alignment within K edits
        done = true;
      } else {
        // ---- traceback (pyref.genasm_tb, genasm_cpu.cpp:290-409) ----
        int i = 0, j = 0, dd = wed, cur_op = OP_NONE, cur_cnt = 0;
        int16_t* __restrict__ ent = entries + (size_t)w * NE * nb + b;
        // TB_LIMIT stop (pyref.py genasm_tb): i and j both stay below TB,
        // so columns i and i+1 are always stored ones (i + 1 <= TB < COLS)
        while (j < m && i < TB && j < TB) {
          const bool i_limit = i >= n;
          const bool d_limit = dd == 0;
          bool can_ins, can_del, can_sub;
          if (j < m - 1) {
            can_ins = can_del = can_sub = false;
            if (!d_limit) {
              // R[dd-1][col] word of bit p: row[(col*NW + p/64)*nb]
              const uint64_t* row = rl + (size_t)(dd - 1) * COLS * NW * nb;
              const int p0 = m - 1 - j, p1 = m - 2 - j;
              can_ins = zero_bit(row[((size_t)i * NW + (p1 >> 6)) * nb],
                                 p1 & 63);
              if (!i_limit) {
                const size_t c1 = (size_t)(i + 1) * NW;
                can_del = zero_bit(row[(c1 + (p0 >> 6)) * nb], p0 & 63);
                can_sub = zero_bit(row[(c1 + (p1 >> 6)) * nb], p1 & 63);
              }
            }
          } else {
            // last pattern char (pyref.py genasm_tb)
            can_ins = !d_limit;
            can_del = false;
            can_sub = !d_limit && !i_limit;
          }
          int op;  // priority I > D > X > '='
          if (can_ins) {
            op = OP_I; ++j; --dd;
          } else if (can_del) {
            op = OP_D; ++i; --dd;
          } else if (can_sub) {
            op = OP_X; ++i; ++j; --dd;
          } else {
            op = OP_EQ; ++i; ++j;
          }
          if (op != cur_op) {
            if (cur_cnt > 0) {
              ent[(size_t)nrun * nb] = (int16_t)((cur_op << 12) | cur_cnt);
              ++nrun;
            }
            cur_op = op;
            cur_cnt = 1;
          } else {
            ++cur_cnt;
          }
        }
        if (cur_cnt > 0) {
          ent[(size_t)nrun * nb] = (int16_t)((cur_op << 12) | cur_cnt);
          ++nrun;
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

// One word (W <= 64): an explicit specialization that keeps the scalar
// code of the first one-word kernel. The generic template computes the
// same values at NW = 1, but the code nvcc makes of it runs the bench tile
// markedly slower (PERF.md, section 6), so the main path keeps this form.
template <>
__global__ void __launch_bounds__(THREADS) genasm_windows_kernel<1>(
    const uint32_t* __restrict__ text_words,
    const int64_t* __restrict__ text_base,
    const int32_t* __restrict__ text_len,
    const uint32_t* __restrict__ pattern_words, int64_t pattern_stride,
    const int32_t* __restrict__ pattern_len, int B, int W, int K, int O,
    int max_windows, uint64_t* __restrict__ R, uint64_t* __restrict__ ff,
    int32_t* __restrict__ ed_out, int32_t* __restrict__ failed_out,
    int16_t* __restrict__ entries, int32_t* __restrict__ counts) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t nb = (size_t)B;
  const int TB = W - O;  // TB_LIMIT: chars traced back per window
  const int COLS = TB + 1;
  const int NE = 2 * TB + 2;
  // shift counts: x << 64 is undefined, so W == 64 gets the literal mask
  const uint64_t full = W >= 64 ? ~0ull : ((1ull << W) - 1ull);
  const int64_t tbase = text_base[b];
  const int64_t pbase = (int64_t)b * pattern_stride * 16;
  const int tlen = text_len[b];
  const int plen = pattern_len[b];
  uint64_t* __restrict__ rl = R + b;
  uint64_t* __restrict__ fl = ff + b;

  int ref_idx = 0, read_idx = 0, ed = 0, failed = 0;
  bool done = plen <= 0;  // an empty read is done before its first window

  for (int w = 0; w < max_windows; ++w) {
    int nrun = 0;
    if (!done) {
      const int m = min(W, plen - read_idx);  // >= 1 while not done
      // text may run out before the read does: n can reach 0
      const int n = max(0, min(W, tlen - ref_idx));

      // pattern masks (pyref._pattern_masks): zero at bit m-1-j where
      // pattern[j] == c, ones everywhere else in the W bits
      uint64_t pm0 = full, pm1 = full, pm2 = full, pm3 = full;
      for (int j = 0; j < m; ++j) {
        const uint64_t c = code_at(pattern_words, pbase + read_idx + j);
        const uint64_t clr = ~(1ull << (m - 1 - j));
        pm0 &= c == 0 ? clr : ~0ull;
        pm1 &= c == 1 ? clr : ~0ull;
        pm2 &= c == 2 ? clr : ~0ull;
        pm3 &= c == 3 ? clr : ~0ull;
      }
      // the window's text, 2 bits a char: chars 0-31 in t0, 32-63 in t1
      uint64_t t0 = 0, t1 = 0;
      for (int i = 0; i < n; ++i) {
        const uint64_t c = code_at(text_words, tbase + ref_idx + i);
        if (i < 32) t0 |= c << (2 * i);
        else t1 |= c << (2 * (i - 32));
      }

      // ---- DP fill (pyref.genasm_dc, genasm_cpu.cpp:210-288) ----
      int wed = -1;
      for (int d = 0; d <= K && wed < 0; ++d) {
        // start column i == n: all ones at d == 0 (pyref.py:176-178),
        // ones << d after it, saturating to 0 once d reaches 64
        const uint64_t start =
            d == 0 ? full : (d >= 64 ? 0ull : (full << d) & full);
        uint64_t right = 0, topright = 0, center = start;
        for (int i = n; i >= 0; --i) {
          const uint64_t top = d > 0 ? fl[(size_t)i * nb] : 0ull;
          if (i == n) {
            center = start;
          } else {
            const int c =
                (int)(((i < 32 ? t0 >> (2 * i) : t1 >> (2 * (i - 32)))) & 3);
            const uint64_t pmv = c == 0 ? pm0 : c == 1 ? pm1 : c == 2 ? pm2
                                                                        : pm3;
            const uint64_t mat = ((right << 1) & full) | pmv;
            // d == 0 rows match only (pyref.py:179-182)
            center = d == 0 ? mat
                            : mat & ((topright << 1) & full) &
                                  ((top << 1) & full) & topright;
          }
          topright = top;
          right = center;
          fl[(size_t)i * nb] = center;
          if (i < COLS) rl[((size_t)d * COLS + i) * nb] = center;
        }
        if (zero_bit(center, m - 1)) wed = d;  // center is column 0 here
      }

      if (wed < 0) {
        failed |= FAIL_TB;  // no alignment within K edits
        done = true;
      } else {
        // ---- traceback (pyref.genasm_tb, genasm_cpu.cpp:290-409) ----
        int i = 0, j = 0, dd = wed, cur_op = OP_NONE, cur_cnt = 0;
        int16_t* __restrict__ ent = entries + (size_t)w * NE * nb + b;
        // TB_LIMIT stop (pyref.py:241): i and j both stay below TB, so
        // columns i and i+1 are always stored ones (i + 1 <= TB < COLS)
        while (j < m && i < TB && j < TB) {
          const bool i_limit = i >= n;
          const bool d_limit = dd == 0;
          bool can_ins, can_del, can_sub;
          if (j < m - 1) {
            can_ins = can_del = can_sub = false;
            if (!d_limit) {
              const uint64_t* row = rl + (size_t)(dd - 1) * COLS * nb;
              can_ins = zero_bit(row[(size_t)i * nb], m - 2 - j);
              if (!i_limit) {
                const uint64_t v = row[(size_t)(i + 1) * nb];
                can_del = zero_bit(v, m - 1 - j);
                can_sub = zero_bit(v, m - 2 - j);
              }
            }
          } else {
            // last pattern char (pyref.py:261-266)
            can_ins = !d_limit;
            can_del = false;
            can_sub = !d_limit && !i_limit;
          }
          int op;  // priority I > D > X > '='
          if (can_ins) {
            op = OP_I; ++j; --dd;
          } else if (can_del) {
            op = OP_D; ++i; --dd;
          } else if (can_sub) {
            op = OP_X; ++i; ++j; --dd;
          } else {
            op = OP_EQ; ++i; ++j;
          }
          if (op != cur_op) {
            if (cur_cnt > 0) {
              ent[(size_t)nrun * nb] = (int16_t)((cur_op << 12) | cur_cnt);
              ++nrun;
            }
            cur_op = op;
            cur_cnt = 1;
          } else {
            ++cur_cnt;
          }
        }
        if (cur_cnt > 0) {
          ent[(size_t)nrun * nb] = (int16_t)((cur_op << 12) | cur_cnt);
          ++nrun;
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

template <int NW>
int launch(const void* text_words, const void* text_base,
           const void* text_len, const void* pattern_words,
           int64_t pattern_stride, const void* pattern_len, int B, int W,
           int K, int O, int max_windows, void* R, void* ff, void* ed,
           void* failed, void* entries, void* counts, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS));
  genasm_windows_kernel<NW><<<grid, THREADS, 0, stream>>>(
      (const uint32_t*)text_words, (const int64_t*)text_base,
      (const int32_t*)text_len, (const uint32_t*)pattern_words,
      pattern_stride, (const int32_t*)pattern_len, B, W, K, O, max_windows,
      (uint64_t*)R, (uint64_t*)ff, (int32_t*)ed, (int32_t*)failed,
      (int16_t*)entries, (int32_t*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

// nw must be ceil(W/64); returns -1 for arguments the kernel does not take,
// else the launch's cudaGetLastError()
extern "C" int genasm_windows_launch(
    int nw, const void* text_words, const void* text_base,
    const void* text_len, const void* pattern_words, int64_t pattern_stride,
    const void* pattern_len, int B, int W, int K, int O, int max_windows,
    void* R, void* ff, void* ed, void* failed, void* entries, void* counts,
    void* stream) {
  if (W < 2 || W > 256 || O < 0 || O >= W || K < 1 || nw != (W + 63) / 64)
    return -1;
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nw) {
    case 1: return launch<1>(text_words, text_base, text_len, pattern_words,
                             pattern_stride, pattern_len, B, W, K, O,
                             max_windows, R, ff, ed, failed, entries, counts,
                             s);
    case 2: return launch<2>(text_words, text_base, text_len, pattern_words,
                             pattern_stride, pattern_len, B, W, K, O,
                             max_windows, R, ff, ed, failed, entries, counts,
                             s);
    case 3: return launch<3>(text_words, text_base, text_len, pattern_words,
                             pattern_stride, pattern_len, B, W, K, O,
                             max_windows, R, ff, ed, failed, entries, counts,
                             s);
    default: return launch<4>(text_words, text_base, text_len, pattern_words,
                              pattern_stride, pattern_len, B, W, K, O,
                              max_windows, R, ff, ed, failed, entries, counts,
                              s);
  }
}
