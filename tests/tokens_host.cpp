// Host harness for the warp code of the token kernel,
// scrooge_tpu_torch/csrc/genasm_tokens.cu, built by
// tests/test_torch_tokens_host.py with g++ under AddressSanitizer and UBSan
// (g++ -I scrooge_tpu_torch/csrc).
//
// The shim below stands in for the card's warp primitives: a HostLanes
// holds the value of each of the 32 threads of a warp, the kernel's
// FOR_THREADS loops run its body for t = 0..31 in turn, and shfl_up,
// shfl_idx, shfl_at and ballot read the whole array, so the threads run in
// lockstep. The output rows and the warp's shared-memory buffer start
// filled with a garbage byte, and lane_tot with -7, so that a byte the
// kernel should have written, or a run it should have gathered, shows.
//
// stdin: int32 wcap, ne, B; int64 capB; then entries (wcap * ne * B
// int16) and counts (wcap * B int32). stdout: out (B * capB uint8, lane-
// major), lane_tot (B int32).

#include <cstdint>
#include <cstdio>
#include <vector>

template <class T, int N>
struct HostLanes {
  T v[N];
  T& operator[](int t) { return v[t]; }
  const T& operator[](int t) const { return v[t]; }
};

struct HostWarp {
  int t_lo, t_hi;  // every thread of the warp: [0, 32)
};

using IntLanes = HostLanes<int, 32>;

// __shfl_up_sync(mask, x, delta): thread t gets thread t-delta's x, a
// thread t < delta its own
inline IntLanes shfl_up(const HostWarp&, const IntLanes& x, int delta) {
  IntLanes r;
  for (int t = 0; t < 32; ++t) r[t] = x[t >= delta ? t - delta : t];
  return r;
}

// __shfl_sync(mask, x, src), src the same in every thread
inline int shfl_idx(const HostWarp&, const IntLanes& x, int src) {
  return x[src];
}

// __shfl_sync(mask, x, src[t]): a source a thread
inline IntLanes shfl_at(const HostWarp&, const IntLanes& x,
                        const IntLanes& src) {
  IntLanes r;
  for (int t = 0; t < 32; ++t) r[t] = x[src[t] & 31];
  return r;
}

// __ballot_sync(mask, p): bit t is thread t's p
inline unsigned ballot(const HostWarp&, const HostLanes<bool, 32>& p) {
  unsigned r = 0;
  for (int t = 0; t < 32; ++t) r |= (p[t] ? 1u : 0u) << t;
  return r;
}

inline void warp_sync(const HostWarp&) {}
inline int popc(unsigned x) { return __builtin_popcount(x); }
inline int16_t load_ro(const int16_t* p) { return *p; }
inline int32_t load_ro(const int32_t* p) { return *p; }

#include "genasm_tokens.cu"

static_assert(WARP == 32, "the shim emulates 32-thread warps");

namespace {

template <class T>
bool read_all(std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

template <class T>
void write_all(const std::vector<T>& v) {
  std::fwrite(v.data(), sizeof(T), v.size(), stdout);
}

}  // namespace

int main() {
  int32_t head[3];
  int64_t capB;
  if (std::fread(head, sizeof(int32_t), 3, stdin) != 3 ||
      std::fread(&capB, sizeof(int64_t), 1, stdin) != 1)
    return 2;
  const int wcap = head[0], ne = head[1], B = head[2];
  if (wcap < 0 || ne < 1 || ne > MAX_NE || B < 1 || capB < 0) return 2;
  std::vector<int16_t> entries((size_t)wcap * ne * B);
  std::vector<int32_t> counts((size_t)wcap * B);
  if (!read_all(entries) || !read_all(counts)) return 2;
  std::vector<uint8_t> out((size_t)B * capB, 0xa5);
  std::vector<int32_t> lane_tot(B, -7);
  const Params P{entries.data(), counts.data(), wcap, ne, B, capB,
                 out.data(), lane_tot.data()};
  // the kernel's warps, a lane each, one after the other, each with a
  // buffer left as the warp before it left it
  std::vector<uint8_t> buf(BUF, 0x5a);
  for (int b = 0; b < B; ++b)
    tokens_warp(HostWarp{0, WARP}, P, b, buf.data());
  write_all(out);
  write_all(lane_tot);
  return 0;
}
