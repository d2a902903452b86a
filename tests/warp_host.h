// The card's warp primitives for the host harnesses of the window kernels
// that run a warp a pair (tests/windows_host.cpp, tests/wide_host.cpp),
// included before scrooge_tpu_torch/csrc/warp_lanes.cuh: a HostLanes
// holds the value of each of the 32 threads of a warp, and shfl_up64 and
// ballot read the whole array, so that the threads run in lockstep.

#pragma once

#include <cstdint>

template <class T, int N>
struct HostLanes {
  T v[N];
  T& operator[](int t) { return v[t]; }
  const T& operator[](int t) const { return v[t]; }
};

struct HostWarp {
  int t_lo, t_hi;  // every thread of the warp: [0, 32)
};

using U32Lanes = HostLanes<unsigned, 32>;
using U64Lanes = HostLanes<uint64_t, 32>;

// __shfl_up_sync(mask, x, DELTA): thread t gets thread t-DELTA's x, a
// thread t < DELTA its own
template <int DELTA>
inline U64Lanes shfl_up64(const HostWarp&, const U64Lanes& x) {
  U64Lanes r;
  for (int t = 0; t < 32; ++t) r[t] = x[t >= DELTA ? t - DELTA : t];
  return r;
}

// __ballot_sync(mask, p): bit t is thread t's p
inline unsigned ballot(const HostWarp&, const HostLanes<bool, 32>& p) {
  unsigned r = 0;
  for (int t = 0; t < 32; ++t) r |= (p[t] ? 1u : 0u) << t;
  return r;
}

inline void warp_sync(const HostWarp&) {}
inline int first_set(unsigned x) { return __builtin_ffs((int)x); }
