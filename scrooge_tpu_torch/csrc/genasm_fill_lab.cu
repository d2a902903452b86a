// Fill-only lab kernel: the GenASM DP fill of one window, without the
// traceback, in three ablation variants, for Hopper (sm_90a).
//
// Replaces the TPU lab kernel tools/kernel_lab.py:102 run (pallas_call at
// :107, body fill_kernel :37-98). It splits a fill's time between its
// arithmetic, its R stores and the row above:
//   full    : every computed cell stored to R[d][min(i, COLS-1)];
//   nostore : no stores to R;
//   noff    : the row above is the constant 0 (the TPU lab never wrote its
//             forefront scratch in this variant, and interpret mode reads
//             unwritten scratch as zeros); no stores to R.
//
// What it computes (W=64 K=64 O=33, MSB-aligned): per lane, a pattern of
// m bits in the top of the word; column i runs from W down to 0; a start
// column (i >= n) holds ones << (W-m+d), saturating to 0 for shifts >= 64
// and all ones for shifts <= 0; the match is (right << 1) | pmi[min(i,
// W-1)], ANDed from d >= 1 with topright << 1, top << 1 and topright; wed
// is the first d <= K at which bit 63 of column 0 is 0, and 0 for a lane
// that never hits. Every one of the nwin windows has the same inputs and
// redoes the same work; acc[b] sums wed[b] over them.
//
// Design: a group of G threads per lane, on an anti-diagonal wavefront
// over rows. In a pass of G rows starting at d0, thread t of a group
// computes row d0+t, and at step s its column W-(s-t). Its `right` is its
// own cell of the step before, its `top` is thread t-1's cell of the step
// before (__shfl_up_sync, width G), and its `topright` is its previous
// step's `top`. Thread 0 takes its `top` from the row that thread G-1
// computed in the last pass, which goes through shared memory (two
// buffers a lane, one __syncwarp a pass), as do the window's pattern
// masks (read from device memory once a window). After each pass a
// ballot finds, for each group, the smallest row d <= K whose column 0
// hits; it ends the lane. Rows computed past it, and rows above K, never
// count. Nothing of the forefront is in device memory. A warp holds 32/G
// lanes and runs its passes until its last lane has hit; the shuffles and
// ballots take the whole warp with a constant mask (with a mask computed
// at run time the compiler checks the threads' convergence at every
// shuffle). In full, R is lane-minor, R[(d*COLS + c)*B + b]: at a step
// the G threads of a lane store G rows, and the 32/G lanes of a warp
// store each row's word side by side (32 bytes, one whole sector, at
// G = 8). A lane stores every row of its passes up to K, so rows past wed
// in its last pass are stored too; a lane that has hit stores nothing in
// the warp's later passes.
//
// What bounds it on this card, and what the design does about each:
// - at B = 2,048 (16 blocks of 128 lanes in the one-thread-a-lane kernel
//   this replaces) the per-step dependency chain: a cell needs the cell
//   to its right and the row above, so each step waits on one shuffle,
//   a select, a shift and a LOP3. G threads a lane make B*G threads in
//   blocks of THREADS, spread over all 132 SMs, and a pass of G rows takes
//   W+G steps where one thread took G*(W+1). A step has no branch: a
//   thread computes inside its row or not, from padded shared columns,
//   and loads the next step's pattern mask and row above a step ahead;
// - in full at B = 16,384, R's write traffic once it leaves the 50 MB L2
//   (16,384 lanes x ~20 rows x 32 words x 8 B, ~84 MB a window, and 65
//   stores a row, since every cell is stored): every store is a whole
//   sector, and no load waits on a store, since the forefront no longer
//   goes through device memory.
//
// The warp's code (fill_warp and fill_window) also compiles as host C++:
// tests/fill_lab_host.cpp defines the warp primitives for the host, where
// the 32 threads of a warp run in lockstep over an array, and checks it
// under AddressSanitizer and UBSan.

#include <cstddef>
#include <cstdint>

namespace {

constexpr int W = 64, K = 64, O = 33, COLS = W - O + 1;
constexpr int G = 8;  // threads a lane
constexpr int THREADS = 64;
constexpr int WARP = 32;
constexpr int FULL = 0, NOSTORE = 1, NOFF = 2;
static_assert(G >= 2 && G <= 16 && (G & (G - 1)) == 0 && THREADS % WARP == 0,
              "a lane group is a power of two inside one warp");

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

// Every primitive takes the whole warp (a constant mask: with a mask
// computed at run time the compiler checks the threads' convergence at
// each shuffle, which costs more than the cell). The warp's control flow
// is uniform around them.

// thread t gets thread t-1's x, within each group of G (its first thread
// its own)
__device__ __forceinline__ Lanes<uint64_t> shfl_up(const Warp&,
                                                   const Lanes<uint64_t>& x) {
  return {(uint64_t)__shfl_up_sync(0xffffffffu, (unsigned long long)x.v, 1,
                                   G)};
}

// bit t: p of thread t
__device__ __forceinline__ unsigned ballot(const Warp&, const Lanes<bool>& p) {
  return __ballot_sync(0xffffffffu, p.v);
}

__device__ __forceinline__ bool warp_any(const Warp&, const Lanes<bool>& p) {
  return __any_sync(0xffffffffu, p.v);
}

__device__ __forceinline__ void warp_sync(const Warp&) { __syncwarp(); }

__device__ __forceinline__ uint64_t load_ro(const uint64_t* p) {
  return __ldg(p);
}

__device__ __forceinline__ int first_set(unsigned x) { return __ffs(x); }

}  // namespace
#else
// Compiled by the host harness, which defines HostLanes, HostWarp,
// shfl_up, ballot, warp_any, warp_sync, load_ro and first_set before it
// includes this file.
template <class T>
using Lanes = HostLanes<T, WARP>;
using Warp = HostWarp;
#define LANE_FN inline
#endif

#define FOR_THREADS(w, t) for (int t = (w).t_lo; t < (w).t_hi; ++t)

namespace {

// A lane's shared scratch: the window's pattern mask of each column, and
// the row that crosses from one pass to the next, in two buffers. Column i
// sits at [PAD + i]; a thread reads and writes columns -G..W+G-1 at its
// steps outside its row, so its accesses need no bounds (what it reads
// there is masked off, what it writes is never read).
constexpr int PAD = G, SPAN = W + 2 * G;
struct LaneScratch {
  uint64_t pm[SPAN];  // [PAD + i]: pmi[min(i, W-1)] for i = 0..W
  uint64_t rows[2][SPAN];
};

// One window of the warp's 32/G lanes; returns each thread's lane's wed.
// Thread t works for lane b[t] (live[t] false past the batch: such a lane
// computes on a clamped b and stores nothing) as its thread t % G. R is
// (K+1, COLS, nb), used in full only.
template <int VARIANT>
LANE_FN Lanes<int> fill_window(const Warp& w, const Lanes<int>& s,
                               const Lanes<int>& n,
                               const uint64_t* __restrict__ pmi, size_t nb,
                               const Lanes<size_t>& b,
                               const Lanes<bool>& live,
                               uint64_t* __restrict__ R,
                               const Lanes<LaneScratch*>& sc) {
  Lanes<int> wed;
  Lanes<bool> todo;  // the lane has not hit yet
  FOR_THREADS(w, t) {
    // the window's pattern masks, read again in every window
    for (int i = t % G; i <= W; i += G)
      sc[t]->pm[PAD + i] =
          load_ro(pmi + (size_t)(i < W ? i : W - 1) * nb + b[t]);
    wed[t] = 0;
    todo[t] = live[t];
  }
  warp_sync(w);
  // the warp runs until its last lane hits; a lane that has hit computes
  // on with the others and stores nothing
  for (int d0 = 0, pass = 0; d0 <= K && warp_any(w, todo); d0 += G, ++pass) {
    // Row 0 has no row above; it reads one of all ones, and `low` shifts a
    // 1 into its topright term, so that its cell reduces to the match. A
    // thread computes at every step, inside its row or not (no branch):
    // before its row's first column its cell is 0, the `right` and
    // `topright` its first column needs; after its row's last column its
    // cell is unused, and col0 keeps column 0's. k = W - i counts the
    // thread's columns: start columns (i >= n) are k < kn, the others
    // kn <= k <= W.
    Lanes<uint64_t> center, topright, ones, low, col0, pm_next, above_next;
    Lanes<int> kn, nc;
    Lanes<const uint64_t*> pm_at, above_at;
    Lanes<uint64_t*> last_at;
    FOR_THREADS(w, t) {
      const int gt = t % G, d = d0 + gt;
      const int sh = s[t] + d;
      ones[t] = sh >= 64 ? 0ull : (sh <= 0 ? ~0ull : ~0ull << sh);
      low[t] = d == 0 ? 1ull : 0ull;
      center[t] = 0;
      topright[t] = d == 0 ? ~0ull : 0ull;
      col0[t] = 0;
      nc[t] = n[t] < 0 ? 0 : (n[t] > W + 1 ? W + 1 : n[t]);
      kn[t] = W + 1 - nc[t];
      // column i of step `step` is W + gt - step
      pm_at[t] = sc[t]->pm + PAD + W + gt;
      above_at[t] = sc[t]->rows[pass & 1] + PAD + W + gt;
      last_at[t] = sc[t]->rows[~pass & 1] + PAD + W + gt;
      pm_next[t] = pm_at[t][0];
      above_next[t] = d0 > 0 ? above_at[t][0] : ~0ull;
    }
#pragma unroll 4
    for (int step = 0; step < W + G; ++step) {
      const Lanes<uint64_t> up = shfl_up(w, center);
      FOR_THREADS(w, t) {
        const int gt = t % G, d = d0 + gt;
        const int k = step - gt;
        // this step's pattern mask and row above were loaded a step ago;
        // load the next step's
        const uint64_t pm = pm_next[t], above = above_next[t];
        pm_next[t] = pm_at[t][-step - 1];
        if (gt == 0 && d0 > 0) above_next[t] = above_at[t][-step - 1];
        const uint64_t top =
            VARIANT == NOFF ? (d == 0 ? ~0ull : 0ull)
                            : (gt > 0 ? up[t] : above);
        // the terms that do not wait for `top`; a start column takes
        // `ones`, and a column outside the row 0
        const uint64_t keep =
            (unsigned)(k - kn[t]) < (unsigned)nc[t] ? ~0ull : 0ull;
        const uint64_t start = (unsigned)k < (unsigned)kn[t] ? ones[t] : 0ull;
        const uint64_t pre = ((center[t] << 1) | pm) &
                             ((topright[t] << 1) | low[t]) & topright[t] &
                             keep;
        const uint64_t c = (pre & (top << 1)) | (pre & low[t]) | start;
        // R in full: the row's cells up to row K, until the lane has hit
        const bool store_r =
            VARIANT == FULL && (unsigned)k <= (unsigned)W && d <= K && todo[t];
        if (store_r) {
          const int i = W - k;
          R[((size_t)d * COLS + (i < COLS ? i : COLS - 1)) * nb + b[t]] = c;
        }
        // row d0+G-1, for the next pass
        if (VARIANT != NOFF && gt == G - 1) last_at[t][-step] = c;
        if (k == W) col0[t] = c;
        topright[t] = top;
        center[t] = c;
      }
    }
    // the next pass reads this one's last row and overwrites the other
    warp_sync(w);
    Lanes<bool> hit;
    FOR_THREADS(w, t) {
      hit[t] = d0 + t % G <= K && ((col0[t] >> 63) & 1ull) == 0;
    }
    const unsigned bits = ballot(w, hit);
    FOR_THREADS(w, t) {
      const unsigned h = (bits >> (t & ~(G - 1))) & ((1u << G) - 1);
      if (todo[t] && h) {
        wed[t] = d0 + first_set(h) - 1;
        todo[t] = false;
      }
    }
  }
  return wed;
}

// Every window of the warp's lanes; thread t % G == 0 of a live lane
// writes its last wed and its sum over windows.
template <int VARIANT>
LANE_FN void fill_warp(const Warp& w, int nwin, const int32_t* m_in,
                       const int32_t* n_in, const uint64_t* __restrict__ pmi,
                       size_t nb, const Lanes<size_t>& b,
                       const Lanes<bool>& live, uint64_t* __restrict__ R,
                       const Lanes<LaneScratch*>& sc, int32_t* wed_out,
                       int64_t* acc_out) {
  Lanes<int> s, n, wed;
  Lanes<int64_t> acc;
  FOR_THREADS(w, t) {
    s[t] = W - m_in[b[t]];
    n[t] = n_in[b[t]];
    acc[t] = 0;
  }
  for (int win = 0; win < nwin; ++win) {
    // every window reloads its inputs: the compiler may not hoist one
    // window's work out of the loop
    asm volatile("" ::: "memory");
    wed = fill_window<VARIANT>(w, s, n, pmi, nb, b, live, R, sc);
    FOR_THREADS(w, t) acc[t] += wed[t];
  }
  FOR_THREADS(w, t) {
    if (live[t] && t % G == 0) {
      wed_out[b[t]] = wed[t];
      acc_out[b[t]] = acc[t];
    }
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

template <int VARIANT>
__global__ void __launch_bounds__(THREADS) genasm_fill_lab_kernel(
    int nwin, const int32_t* __restrict__ m_in,
    const int32_t* __restrict__ n_in, const uint64_t* __restrict__ pmi,
    int B, uint64_t* __restrict__ R, int32_t* __restrict__ wed_out,
    int64_t* __restrict__ acc_out) {
  __shared__ LaneScratch scratch[THREADS / G];
  const int t = threadIdx.x % WARP;
  const int lane = (blockIdx.x * THREADS + threadIdx.x) / G;
  if (lane - t / G >= B) return;  // the warp's first lane: the whole warp
  const Lanes<size_t> b{(size_t)(lane < B ? lane : B - 1)};
  const Lanes<bool> live{lane < B};
  const Lanes<LaneScratch*> sc{&scratch[threadIdx.x / G]};
  fill_warp<VARIANT>(Warp{t, t + 1}, nwin, m_in, n_in, pmi, (size_t)B, b,
                     live, R, sc, wed_out, acc_out);
}

template <int VARIANT>
int launch(int nwin, const void* m, const void* n, const void* pmi, int B,
           void* R, void* wed, void* acc, cudaStream_t stream) {
  const long long threads = (long long)B * G;
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS));
  genasm_fill_lab_kernel<VARIANT><<<grid, THREADS, 0, stream>>>(
      nwin, (const int32_t*)m, (const int32_t*)n, (const uint64_t*)pmi, B,
      (uint64_t*)R, (int32_t*)wed, (int64_t*)acc);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0 full, 1 nostore, 2 noff; m, n (B,) int32 with m in 0..W; pmi
// (W, B) uint64 words; R scratch (K+1, COLS, B) uint64, lane-minor, read
// in full only. Returns -1 for arguments the kernel does not take, else
// cudaGetLastError().
extern "C" int genasm_fill_lab_launch(int variant, int nwin, const void* m,
                                      const void* n, const void* pmi, int B,
                                      void* R, void* wed, void* acc,
                                      void* stream) {
  if (nwin < 1 || variant < FULL || variant > NOFF) return -1;
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL: return launch<FULL>(nwin, m, n, pmi, B, R, wed, acc, s);
    case NOSTORE: return launch<NOSTORE>(nwin, m, n, pmi, B, R, wed, acc, s);
    default: return launch<NOFF>(nwin, m, n, pmi, B, R, wed, acc, s);
  }
}
#endif
