// Host harness for the lane-group code of the fill-lab kernel,
// scrooge_tpu_torch/csrc/genasm_fill_lab.cu, built by
// tests/test_torch_fill_lab_host.py with g++ under AddressSanitizer and
// UBSan (g++ -I scrooge_tpu_torch/csrc).
//
// The shim below stands in for the card's warp primitives: a HostLanes
// holds the value of each of the 32 threads of a warp (32/G lane groups of
// G), the kernel's FOR_THREADS loops run its body for t = 0..31 in turn,
// and shfl_up, ballot and warp_any read the whole array, so the threads
// run in lockstep. Every lane gets its own LaneScratch (the card's shared
// memory) on the heap; R exists in full only (the other variants get a
// null pointer), so a stray access faults.
//
// stdin: int32 variant, nwin, B; then m (B int32), n (B int32) and pmi
// (W*B uint64, lane-minor). stdout: wed (B int32), then acc (B int64),
// then in full R ((K+1)*COLS*B uint64, lane-minor; cells the kernel did
// not store are 0).

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

// the group size G is the source's, known once it is included
template <class T>
using HostWarpLanes = HostLanes<T, 32>;

inline HostWarpLanes<uint64_t> shfl_up(const HostWarp&,
                                       const HostWarpLanes<uint64_t>& x);

inline unsigned ballot(const HostWarp&, const HostWarpLanes<bool>& p) {
  unsigned bits = 0;
  for (int t = 0; t < 32; ++t) bits |= (p[t] ? 1u : 0u) << t;
  return bits;
}

inline bool warp_any(const HostWarp&, const HostWarpLanes<bool>& p) {
  for (int t = 0; t < 32; ++t)
    if (p[t]) return true;
  return false;
}

inline void warp_sync(const HostWarp&) {}
inline uint64_t load_ro(const uint64_t* p) { return *p; }
inline int first_set(unsigned x) { return __builtin_ffs((int)x); }

#include "genasm_fill_lab.cu"

static_assert(WARP == 32, "the shim emulates 32-thread warps");

// __shfl_up_sync(mask, x, 1, G): thread t gets thread t-1's x within its
// group of G, the group's first thread its own
inline HostWarpLanes<uint64_t> shfl_up(const HostWarp&,
                                       const HostWarpLanes<uint64_t>& x) {
  HostWarpLanes<uint64_t> r;
  for (int t = 0; t < 32; ++t) r[t] = x[t % G ? t - 1 : t];
  return r;
}

namespace {

template <class T>
bool read_all(std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

// the kernel's warps, one after the other, each with its 32/G lanes'
// shared scratch on the heap (zeroed: pass 0 reads, but ignores, rows[0])
template <int VARIANT>
void run(int nwin, int B, const std::vector<int32_t>& m,
         const std::vector<int32_t>& n, const std::vector<uint64_t>& pmi,
         std::vector<int32_t>& wed, std::vector<int64_t>& acc,
         std::vector<uint64_t>& R) {
  constexpr int LANES = WARP / G;
  for (int first = 0; first < B; first += LANES) {
    auto* scratch = new LaneScratch[LANES]();
    HostWarpLanes<size_t> b;
    HostWarpLanes<bool> live;
    HostWarpLanes<LaneScratch*> sc;
    for (int t = 0; t < WARP; ++t) {
      const int lane = first + t / G;
      b[t] = (size_t)(lane < B ? lane : B - 1);
      live[t] = lane < B;
      sc[t] = &scratch[t / G];
    }
    fill_warp<VARIANT>(HostWarp{0, WARP}, nwin, m.data(), n.data(),
                       pmi.data(), (size_t)B, b, live,
                       R.empty() ? nullptr : R.data(), sc, wed.data(),
                       acc.data());
    delete[] scratch;
  }
}

}  // namespace

int main() {
  int32_t head[3];
  if (std::fread(head, sizeof(int32_t), 3, stdin) != 3) return 2;
  const int variant = head[0], nwin = head[1], B = head[2];
  if (variant < FULL || variant > NOFF || nwin < 1 || B < 1) return 2;
  std::vector<int32_t> m(B), n(B), wed(B);
  std::vector<uint64_t> pmi((size_t)W * B);
  std::vector<int64_t> acc(B);
  std::vector<uint64_t> R(variant == FULL ? (size_t)(K + 1) * COLS * B : 0);
  if (!read_all(m) || !read_all(n) || !read_all(pmi)) return 2;
  if (variant == FULL) run<FULL>(nwin, B, m, n, pmi, wed, acc, R);
  if (variant == NOSTORE) run<NOSTORE>(nwin, B, m, n, pmi, wed, acc, R);
  if (variant == NOFF) run<NOFF>(nwin, B, m, n, pmi, wed, acc, R);
  std::fwrite(wed.data(), sizeof(int32_t), B, stdout);
  std::fwrite(acc.data(), sizeof(int64_t), B, stdout);
  if (!R.empty()) std::fwrite(R.data(), sizeof(uint64_t), R.size(), stdout);
  return 0;
}
