// The warp primitives of the window kernels that run a warp a pair,
// genasm_windows1.cu (one word) and genasm_windows_wide.cu (four to 32
// words), written so that a kernel's warp code also compiles as host C++.
//
// On the card a Lanes<T> is the thread's own value, FOR_THREADS runs its
// body once, for the thread's own t, and the primitives are the warp's
// intrinsics over the whole warp, with a constant mask. On the host
// (tests/warp_host.h, included first) a Lanes<T> holds the value of each
// of the 32 threads of a warp, FOR_THREADS runs its body for t = 0..31 in
// turn, and the primitives read the whole array, so the threads run in
// lockstep.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define LANE_FN __device__ __forceinline__

namespace {

template <class T>
struct Lanes {
  T v;
  __device__ T& operator[](int) { return v; }
  __device__ const T& operator[](int) const { return v; }
};

struct Warp {
  int t_lo, t_hi;  // the threads this code runs: [t, t+1), t the lane id
};

// thread t gets thread t-DELTA's x (a thread t < DELTA its own)
template <int DELTA>
__device__ __forceinline__ Lanes<uint64_t> shfl_up64(
    const Warp&, const Lanes<uint64_t>& x) {
  return {(uint64_t)__shfl_up_sync(0xffffffffu, (unsigned long long)x.v,
                                   DELTA)};
}

// bit t: p of thread t
__device__ __forceinline__ unsigned ballot(const Warp&, const Lanes<bool>& p) {
  return __ballot_sync(0xffffffffu, p.v);
}

__device__ __forceinline__ void warp_sync(const Warp&) { __syncwarp(); }

__device__ __forceinline__ int first_set(unsigned x) { return __ffs((int)x); }

}  // namespace
#else
template <class T>
using Lanes = HostLanes<T, 32>;
using Warp = HostWarp;
#define LANE_FN inline
#endif

#define FOR_THREADS(w, t) for (int t = (w).t_lo; t < (w).t_hi; ++t)
