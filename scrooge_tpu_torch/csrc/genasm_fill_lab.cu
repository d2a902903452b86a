// Fill-only lab kernel: the GenASM DP fill of one window, without the
// traceback, in three ablation variants, for Hopper (sm_90a).
//
// Replaces the TPU lab kernel tools/kernel_lab.py:run (body fill_kernel,
// :37-98). It exists to split the window kernel's time (genasm_windows.cu)
// between the fill's arithmetic, its R stores and its forefront traffic:
//   full    : the fill as the window kernel runs it, every cell stored to
//             the forefront row and to R[d][min(i, COLS-1)];
//   nostore : no stores to R;
//   noff    : no forefront stores either (the forefront is read as the
//             wrapper zero-filled it, as Pallas interpret mode reads the
//             TPU's unwritten scratch).
// What bounds it: the serial fill chain per thread (each cell needs the
// one to its right, each row the row before) and, in full and nostore, the
// forefront and R traffic; the variants differ only in those stores. One
// thread per lane, the forefront and R in lane-minor device scratch so a
// warp's accesses coalesce, as in the window kernel; R stores the whole
// 64-bit word (the TPU lab stored its upper half), so full makes the
// stores the window kernel makes.
//
// What it computes (tools/kernel_lab.py, W=64 K=64 O=33, MSB-aligned):
// per lane, a pattern of m bits in the top of the word; column i runs from
// W down to 0; a start column (i >= n) holds ones << (W-m+d), saturating to
// 0 for shifts >= 64 and all ones for shifts <= 0; the match is
// (right << 1) | pmi[min(i, W-1)], ANDed from d >= 1 with topright << 1,
// top << 1 and topright; wed is the first d <= K at which bit 63 of column
// 0 is 0, and 0 for a lane that never hits. Each lane stops at its own
// first hit (the TPU stopped per 1024-lane block; a lane's wed is set only
// once, so the results agree). Every one of the nwin windows has the same
// inputs and redoes the same work; acc[b] sums wed[b] over them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 64, K = 64, O = 33, COLS = W - O + 1;
constexpr int THREADS = 128;
constexpr int FULL = 0, NOSTORE = 1, NOFF = 2;

template <int VARIANT>
__global__ void __launch_bounds__(THREADS) fill_lab_kernel(
    int nwin, const int32_t* __restrict__ m_in,
    const int32_t* __restrict__ n_in, const uint64_t* __restrict__ pmi,
    int B, uint64_t* __restrict__ R, uint64_t* ff,
    int32_t* __restrict__ wed_out, int64_t* __restrict__ acc_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t nb = (size_t)B;
  const int s = W - m_in[b];
  const int n = n_in[b];
  int64_t acc = 0;
  int wed = 0;
  for (int win = 0; win < nwin; ++win) {
    // every window reloads its inputs: the compiler may not hoist one
    // window's work out of the loop
    asm volatile("" ::: "memory");
    wed = 0;
    bool found = false;
    for (int d = 0; d <= K && !found; ++d) {
      const int sh = s + d;
      const uint64_t ones_d = sh >= 64 ? 0ull : (sh <= 0 ? ~0ull : ~0ull << sh);
      uint64_t right = 0, topright = 0, center = 0;
      for (int i = W; i >= 0; --i) {
        const uint64_t top = ff[(size_t)i * nb + b];
        const uint64_t pm = __ldg(pmi + (size_t)min(i, W - 1) * nb + b);
        if (i >= n) {
          center = ones_d;
        } else {
          const uint64_t mat = (right << 1) | pm;
          center = d == 0 ? mat : mat & (topright << 1) & (top << 1) & topright;
        }
        if (VARIANT != NOFF) ff[(size_t)i * nb + b] = center;
        if (VARIANT == FULL) R[((size_t)d * COLS + min(i, COLS - 1)) * nb + b] = center;
        topright = top;
        right = center;
      }
      if (((center >> 63) & 1ull) == 0) {
        wed = d;
        found = true;
      }
    }
    acc += wed;
  }
  wed_out[b] = wed;
  acc_out[b] = acc;
}

template <int VARIANT>
int launch(int nwin, const void* m, const void* n, const void* pmi, int B,
           void* R, void* ff, void* wed, void* acc, cudaStream_t stream) {
  const dim3 grid((unsigned)((B + THREADS - 1) / THREADS));
  fill_lab_kernel<VARIANT><<<grid, THREADS, 0, stream>>>(
      nwin, (const int32_t*)m, (const int32_t*)n, (const uint64_t*)pmi, B,
      (uint64_t*)R, (uint64_t*)ff, (int32_t*)wed, (int64_t*)acc);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0 full, 1 nostore, 2 noff; pmi (W, B) uint64 words; R scratch
// (K+1, COLS, B), forefront (W+1, B), both uint64, lane-minor. Returns -1
// for arguments the kernel does not take, else cudaGetLastError().
extern "C" int genasm_fill_lab_launch(int variant, int nwin, const void* m,
                                      const void* n, const void* pmi, int B,
                                      void* R, void* ff, void* wed, void* acc,
                                      void* stream) {
  if (nwin < 1 || variant < FULL || variant > NOFF) return -1;
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL: return launch<FULL>(nwin, m, n, pmi, B, R, ff, wed, acc, s);
    case NOSTORE: return launch<NOSTORE>(nwin, m, n, pmi, B, R, ff, wed, acc, s);
    default: return launch<NOFF>(nwin, m, n, pmi, B, R, ff, wed, acc, s);
  }
}
