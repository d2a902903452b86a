// CIGAR tokens of a tile, compacted lane-major in one pass, for Hopper
// (sm_90a).
//
// Counterpart of the JAX package's token compaction,
// scrooge_tpu/ops/tokens.py:41-148 (tokenize_u8, compact_tokenize,
// compact_tokens), which XLA runs on the TPU; the port's torch version of
// it (ops/tokens.py: lane_tokens_plain) stays the CPU route and the
// oracle. No Pallas kernel did this: on the card the torch chain scanned
// the dense (windows x runs a window) x lanes layout down its outer dim
// twice (the runs, then the token candidates), with a (rows x lanes)
// temporary a step, and the scan ran over ~10^4 rows with only the tile's
// lanes in parallel.
//
// Input: the window kernels' dense runs as they leave them,
// entries[w][e][b] = op << 12 | count for e < counts[w][b] (rows past a
// window's count are not read), windows 0..wcap-1. Output: out[b][k],
// lane-major, the lane's tokens in k < lane_tot[b] and 0 up to capB, byte
// for byte what compact_tokenize + compact_tokens give (token format in
// ops/tokens.py): a run is repacked to u8 = low 8 bits of op << 6 | count,
// and its tokens read the previous and the next run of the lane's whole
// run list, across windows and past windows with no runs.
//
// What bounds it on this card: each lane's runs are one ordered stream
// (~4,000 at W = 64 under decoys), so the work is a scan; a thread a lane
// would leave a 1,024-lane tile 32 warps, each step a round trip to
// memory. So:
//
// (a) a warp a lane, WARPS lanes a block: 1,024 warps a tile;
// (b) the warp takes CHUNK windows at a time: thread t loads window t's
//     count, a warp scan gives each window's first run in the stream, and
//     the chunk's runs are gathered in stream order into the warp's
//     shared-memory buffer, a run a thread a step (a 5-step search over
//     the scan finds a run's window), so a step's loads are 32 runs and
//     independent of each other;
// (c) the buffer holds the run before the chunk's first (buf[0]) and the
//     runs after it, so a thread reads its run's neighbours there; the
//     chunk's last run waits for the next chunk (its next run), as the
//     lane's first run has 0 before it and its last 0 after it;
// (d) a run gives 0, 1 or 2 tokens; a ballot of each kind and a popcount
//     below the thread place them, so a step's stores fall in one 64-byte
//     stretch of the lane's row; the warp then stores the zeros up to
//     capB, so nothing else writes the output.
//
// Every shuffle and ballot takes the whole warp with a constant mask, and
// the loops' trip counts are the warp's (uniform). A warp past the batch
// returns as a whole.
//
// The warp's code (tokens_warp) also compiles as host C++:
// tests/tokens_host.cpp defines the warp primitives for the host, where
// the 32 threads of a warp run in lockstep over an array, and checks it
// under AddressSanitizer and UBSan against the torch route.

#include <cstddef>
#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 4;    // warps a block: a lane each
constexpr int CHUNK = 32;   // windows gathered at a time: a thread each
constexpr int MAX_NE = 64;  // rows a window: 2 tb_limit + 2, tb_limit <= 31
// the run before the chunk, one run carried, the chunk's runs, a 0 after
// the last run
constexpr int BUF = 2 + CHUNK * MAX_NE + 1;
constexpr uint32_t TAG_EXT = 4, VAL_BITS = 5;
static_assert(CHUNK == WARP, "a thread loads one window's count");

struct Params {
  const int16_t* entries;  // (wcap, ne, B)
  const int32_t* counts;   // (wcap, B)
  int wcap, ne, B;
  int64_t capB;            // bytes a lane's output row
  uint8_t* out;            // (B, capB)
  int32_t* lane_tot;       // (B,)
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

// thread t gets thread t-delta's x (a thread t < delta its own)
__device__ __forceinline__ Lanes<int> shfl_up(const Warp&,
                                              const Lanes<int>& x,
                                              int delta) {
  return {__shfl_up_sync(0xffffffffu, x.v, delta)};
}

// every thread gets thread src's x
__device__ __forceinline__ int shfl_idx(const Warp&, const Lanes<int>& x,
                                        int src) {
  return __shfl_sync(0xffffffffu, x.v, src);
}

// thread t gets thread src[t]'s x
__device__ __forceinline__ Lanes<int> shfl_at(const Warp&,
                                              const Lanes<int>& x,
                                              const Lanes<int>& src) {
  return {__shfl_sync(0xffffffffu, x.v, src.v)};
}

// bit t: p of thread t
__device__ __forceinline__ unsigned ballot(const Warp&, const Lanes<bool>& p) {
  return __ballot_sync(0xffffffffu, p.v);
}

__device__ __forceinline__ void warp_sync(const Warp&) { __syncwarp(); }

__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }

__device__ __forceinline__ int16_t load_ro(const int16_t* p) {
  return __ldg(p);
}
__device__ __forceinline__ int32_t load_ro(const int32_t* p) {
  return __ldg(p);
}

}  // namespace
#else
// Compiled by the host harness, which defines HostLanes, HostWarp,
// shfl_up, shfl_idx, shfl_at, ballot, warp_sync, popc and load_ro before
// it includes this file.
template <class T>
using Lanes = HostLanes<T, WARP>;
using Warp = HostWarp;
#define LANE_FN inline
#endif

#define FOR_THREADS(w, t) for (int t = (w).t_lo; t < (w).t_hi; ++t)

namespace {

// int16 run (op << 12 | count) -> u8 (op << 6 | count), the low 8 bits as
// ops/compact.entries_to_u8 keeps them
LANE_FN uint32_t run_u8(int16_t v) {
  return ((((uint32_t)(v >> 12)) << 6) | (uint32_t)(v & 0x0FFF)) & 0xFFu;
}

// the token a run c starts with, p the run before it and x the one after
// (0: none), as ops/tokens.tokenize_u8: an edit carries the '=' run
// before it, an '=' run before an edit is carried by it, any other '='
// run is bare; 0 where c gives none
LANE_FN uint32_t token_a(uint32_t p, uint32_t c, uint32_t x) {
  const uint32_t op = c >> 6;
  if (op != 0) {
    const uint32_t prev_eq = (p != 0 && (p >> 6) == 0) ? (p & 63u) : 0u;
    return ((op << VAL_BITS) | prev_eq) & 0xFFu;
  }
  return (c != 0 && (x >> 6) == 0) ? (c & 63u) : 0u;
}

// the extension of an edit run of more than one
LANE_FN uint32_t token_b(uint32_t c) {
  const uint32_t cnt = c & 63u;
  return ((c >> 6) != 0 && cnt > 1) ? (((TAG_EXT << VAL_BITS) | (cnt - 1)) &
                                       0xFFu)
                                    : 0u;
}

// lane b's tokens, by one warp; buf: the warp's BUF bytes
LANE_FN void tokens_warp(const Warp& wp, const Params& P, int b,
                         uint8_t* buf) {
  uint8_t* const row = P.out + (int64_t)b * P.capB;
  int64_t pos = 0;  // tokens stored
  int n = 0;        // runs in buf[1..n] without their tokens
  FOR_THREADS(wp, t) if (t == 0) buf[0] = 0;
  for (int w0 = 0; w0 < P.wcap; w0 += CHUNK) {
    // the chunk's counts, then their inclusive scan
    Lanes<int> incl, excl;
    FOR_THREADS(wp, t) {
      const int w = w0 + t;
      const int c = w < P.wcap ? load_ro(P.counts + (size_t)w * P.B + b) : 0;
      incl[t] = c < 0 ? 0 : c > P.ne ? P.ne : c;
      excl[t] = incl[t];
    }
    for (int d = 1; d < WARP; d *= 2) {
      const Lanes<int> up = shfl_up(wp, incl, d);
      FOR_THREADS(wp, t) if (t >= d) incl[t] += up[t];
    }
    FOR_THREADS(wp, t) excl[t] = incl[t] - excl[t];
    const int total = shfl_idx(wp, incl, WARP - 1);
    // gather: stream run r of the chunk to buf[1 + n + r]; its window j
    // is the number of windows whose inclusive scan is <= r
    for (int r0 = 0; r0 < total; r0 += WARP) {
      Lanes<int> j, probe;
      FOR_THREADS(wp, t) j[t] = 0;
      for (int step = WARP / 2; step > 0; step /= 2) {
        FOR_THREADS(wp, t) probe[t] = j[t] + step - 1;
        const Lanes<int> at = shfl_at(wp, incl, probe);
        FOR_THREADS(wp, t) if (at[t] <= r0 + t) j[t] += step;
      }
      const Lanes<int> first = shfl_at(wp, excl, j);
      FOR_THREADS(wp, t) {
        const int r = r0 + t;
        if (r < total) {
          const int e = r - first[t];
          const int16_t v = load_ro(
              P.entries + ((size_t)(w0 + j[t]) * P.ne + e) * P.B + b);
          buf[1 + n + r] = (uint8_t)run_u8(v);
        }
      }
    }
    n += total;
    const bool last = w0 + CHUNK >= P.wcap;
    FOR_THREADS(wp, t) if (last && t == 0) buf[n + 1] = 0;
    warp_sync(wp);
    // tokens of runs 1..m, whose next run is in the buffer
    const int m = last ? n : n - 1;
    for (int i0 = 1; i0 <= m; i0 += WARP) {
      Lanes<uint32_t> ta, tb;
      Lanes<bool> ha, hb;
      FOR_THREADS(wp, t) {
        const int i = i0 + t;
        const uint32_t c = i <= m ? buf[i] : 0u;
        ta[t] = i <= m ? token_a(buf[i - 1], c, buf[i + 1]) : 0u;
        tb[t] = token_b(c);
        ha[t] = ta[t] != 0;
        hb[t] = tb[t] != 0;
      }
      const unsigned ba = ballot(wp, ha), bb = ballot(wp, hb);
      FOR_THREADS(wp, t) {
        const unsigned below = (1u << t) - 1u;
        const int64_t at = pos + popc(ba & below) + popc(bb & below);
        if (ha[t] && at < P.capB) row[at] = (uint8_t)ta[t];
        if (hb[t] && at + ha[t] < P.capB) row[at + ha[t]] = (uint8_t)tb[t];
      }
      pos += popc(ba) + popc(bb);
    }
    warp_sync(wp);
    // carry the waiting run and the run before it
    if (!last && n >= 1) {
      FOR_THREADS(wp, t) if (t == 0) {
        const uint8_t before = buf[n - 1], waiting = buf[n];
        buf[0] = before;
        buf[1] = waiting;
      }
      n = 1;
    }
    warp_sync(wp);
  }
  FOR_THREADS(wp, t) {
    for (int64_t k = pos + t; k < P.capB; k += WARP) row[k] = 0;
    if (t == 0) P.lane_tot[b] = (int32_t)pos;
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

__global__ void __launch_bounds__(WARPS* WARP)
    genasm_tokens_kernel(const Params P) {
  __shared__ uint8_t bufs[WARPS][BUF];
  const int warp = threadIdx.x / WARP;
  const long long b = (long long)blockIdx.x * WARPS + warp;
  if (b >= P.B) return;  // the whole warp
  const int t = threadIdx.x % WARP;
  tokens_warp(Warp{t, t + 1}, P, (int)b, bufs[warp]);
}

}  // namespace

// key: 0, the one instantiation. entries (wcap, ne, B) int16, counts
// (wcap, B) int32, out (B, capB) uint8, lane_tot (B,) int32; capB must be
// at least twice the largest lane's run total. Returns -1 for arguments
// the kernel does not take, else the launch's cudaGetLastError().
extern "C" int genasm_tokens_launch(int key, const void* entries,
                                    const void* counts, int wcap, int ne,
                                    int B, int64_t capB, void* out,
                                    void* lane_tot, void* stream) {
  if (key != 0 || wcap < 0 || ne < 1 || ne > MAX_NE || B < 0 || capB < 0)
    return -1;
  if (B == 0) return 0;
  const Params P{(const int16_t*)entries, (const int32_t*)counts, wcap, ne,
                 B, capB, (uint8_t*)out, (int32_t*)lane_tot};
  const dim3 grid((unsigned)((B + WARPS - 1) / WARPS));
  genasm_tokens_kernel<<<grid, WARPS * WARP, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
#endif
