// Row hash of L 64-bit key limbs — the CUDA counterpart of the TPU kernel
// spark_rapids_tpu/kernels/pallas_backend.py::hash_pairs (pl.pallas_call).
//
// For each row i it folds the limbs limb[0][i] .. limb[L-1][i] through
// hash_layout.mix_rounds (two murmur3 fmix32 lanes with cross-feedback,
// seeds 0x9E3779B9 / 0x85EBCA77) and writes the row's 64-bit hash
// (hi << 32) | lo.  The TPU version took pre-split u32 (hi, lo) lane
// arrays and returned two u32 arrays; here the split of each limb and the
// recombination of the result are fused into the kernel.
//
// Bound: memory.  Per row it reads 8*L bytes and writes 8, and does about
// 20 integer operations per limb: (8*L + 8) * n bytes, which at L = 3
// (TPC-H q1's key limbs) and n = 2^20 is 33.5 MB, 0.0100 ms at 3.35 TB/s
// on an H100 SXM; the join's sides (L = 1, n = 2^18 and 2^16) are 4.2 MB
// and 1 MB, where a launch's fixed cost, not its bytes, sets the time.
//
// What the design does about it:
// * Limbs are read where they lie: one pointer per limb, passed by value
//   in the kernel's parameters (up to kCap per row set), so the caller
//   does not copy its limbs into one [L, n] array first.  A row set of
//   more than kCap limbs is hashed by a chain of launches: the running
//   state (hi, lo) is the output word, so a launch with `chained` set
//   starts from the previous launch's output and gives the same bits.
// * Up to two row sets per launch (a join's build and probe sides): the
//   grid's first blocks cover set 0, the rest set 1, each with its own
//   L, n, limb pointers and output.
// * Wide loads, many in flight: each thread hashes two consecutive rows
//   with one 16-byte non-coherent load per limb (ld.global.nc.v2.u64),
//   issues all L loads before any mixing (the limb loop is unrolled: a
//   specialisation for each L of 1..4, and one for any L up to kCap), and
//   writes both hashes with one 16-byte store.
// * A set whose pointers are not all 16-byte aligned (a row view of a
//   stacked tensor with odd n, a sliced column) takes the one-row-per-
//   thread path of the same kernel; an aligned set with odd n hashes its
//   last row that way.  The host picks the path per set from the
//   pointers.
// * The grid is exact for small sets and, past about one wave, capped at
//   the SMs times the resident blocks per SM, with a grid-stride loop.
// * Staging the limbs in shared memory by bulk asynchronous copies
//   (cp.async.bulk on an mbarrier, a two-stage ring per persistent block)
//   was tried and was slower than these loads at q1's shape (PERF.md).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (kernels/cuda_backend.py loads it with
// ctypes and mirrors HashLaunch).  The launch allocates nothing and runs
// on the caller's stream; the return value is cudaGetLastError().

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kCap = 8;   // limbs of one row set in one launch
constexpr int kSets = 2;  // row sets in one launch

// The C interface: one row set of a launch as the host fills it, and
// the launch.  Outside the unnamed namespace: the exported function takes
// them, and a type with internal linkage would hide its symbol.
struct HashSet {
  const void* limb[kCap];
  void* out;
  long long n;
  int num_limbs;
  int chained;  // 1: start from out's words instead of from zero
};

struct HashLaunch {
  HashSet set[kSets];
  int num_sets;
  int device;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kSeedHi = 0x9E3779B9u;
constexpr uint32_t kSeedLo = 0x85EBCA77u;

// the kernel's view of one row set, with room for kN limb pointers: the
// specialisation's L, or kCap for the generic one
template <int kN>
struct Seg {
  const uint64_t* limb[kN];
  uint64_t* out;
  long long n;
  long long items;  // work items: row pairs (+1 for an odd tail) or rows
  int num_limbs;
  int chained;
  int vec;     // 1: every pointer 16-byte aligned -> two rows per item
  int blocks;  // blocks of the grid on this set
};

template <int kL>
using SegL = Seg<(kL > 0 ? kL : kCap)>;

template <int kL>
struct Params {
  SegL<kL> seg[kSets];
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void mix(uint32_t& hi, uint32_t& lo, uint64_t w) {
  hi ^= static_cast<uint32_t>(w >> 32);
  lo ^= static_cast<uint32_t>(w);
  hi = fmix32(hi + lo + kSeedHi);
  lo = fmix32(lo + hi + kSeedLo);
}

__device__ __forceinline__ uint64_t pack(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// kL > 0: the set has exactly kL limbs; kL == 0: s.num_limbs (<= kCap).
// Every guard below is on a compile-time j, so the loads stay in registers.
template <int kL>
__device__ __forceinline__ bool has_limb(const SegL<kL>& s, int j) {
  return kL > 0 || j < s.num_limbs;
}

// rows 2p and 2p + 1: one 16-byte load per limb, all issued first
template <int kL>
__device__ __forceinline__ void hash_two(const SegL<kL>& s, long long p) {
  constexpr int kLoads = kL > 0 ? kL : kCap;
  ulonglong2 w[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (has_limb<kL>(s, j)) {
      w[j] = __ldg(reinterpret_cast<const ulonglong2*>(s.limb[j]) + p);
    }
  }
  ulonglong2* out = reinterpret_cast<ulonglong2*>(s.out) + p;
  uint32_t hi0 = 0u, lo0 = 0u, hi1 = 0u, lo1 = 0u;
  if (s.chained) {
    const ulonglong2 st = *out;
    hi0 = static_cast<uint32_t>(st.x >> 32);
    lo0 = static_cast<uint32_t>(st.x);
    hi1 = static_cast<uint32_t>(st.y >> 32);
    lo1 = static_cast<uint32_t>(st.y);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (has_limb<kL>(s, j)) {
      mix(hi0, lo0, w[j].x);
      mix(hi1, lo1, w[j].y);
    }
  }
  *out = make_ulonglong2(pack(hi0, lo0), pack(hi1, lo1));
}

// row i alone: 8-byte loads (unaligned sets, and an aligned set's odd tail)
template <int kL>
__device__ __forceinline__ void hash_one(const SegL<kL>& s, long long i) {
  constexpr int kLoads = kL > 0 ? kL : kCap;
  uint64_t w[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (has_limb<kL>(s, j)) {
      w[j] = __ldg(s.limb[j] + i);
    }
  }
  uint32_t hi = 0u, lo = 0u;
  if (s.chained) {
    const uint64_t st = s.out[i];
    hi = static_cast<uint32_t>(st >> 32);
    lo = static_cast<uint32_t>(st);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    if (has_limb<kL>(s, j)) {
      mix(hi, lo, w[j]);
    }
  }
  s.out[i] = pack(hi, lo);
}

template <int kL>
__global__ void __launch_bounds__(kThreads)
    hash_pairs_kernel(const __grid_constant__ Params<kL> P) {
  const bool second = static_cast<int>(blockIdx.x) >= P.seg[0].blocks;
  const SegL<kL>& s = second ? P.seg[1] : P.seg[0];
  const long long block =
      second ? static_cast<long long>(blockIdx.x) - P.seg[0].blocks
             : static_cast<long long>(blockIdx.x);
  const long long stride = static_cast<long long>(s.blocks) * kThreads;
  const long long pairs = s.n >> 1;
  for (long long i = block * kThreads + threadIdx.x; i < s.items;
       i += stride) {
    if (!s.vec) {
      hash_one<kL>(s, i);
    } else if (i < pairs) {
      hash_two<kL>(s, i);
    } else {
      hash_one<kL>(s, s.n - 1);  // odd n: the last row
    }
  }
}

// SMs x resident blocks per SM, read once per device and specialisation
std::atomic<int> g_wave[kMaxDevices][5];

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int kL>
cudaError_t wave_of(int device, int* wave) {
  std::atomic<int>& cached = g_wave[device][kL];
  *wave = cached.load(std::memory_order_relaxed);
  if (*wave > 0) {
    return cudaSuccess;
  }
  int sms = 0;
  int per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hash_pairs_kernel<kL>, kThreads, 0);
  }
  if (err != cudaSuccess) {
    return err;
  }
  *wave = sms * (per_sm > 0 ? per_sm : 1);
  cached.store(*wave, std::memory_order_relaxed);
  return cudaSuccess;
}

template <int kL>
cudaError_t launch_sets(const HashLaunch& h, cudaStream_t stream) {
  const int device = h.device >= 0 && h.device < kMaxDevices ? h.device : 0;
  int wave = 0;
  const cudaError_t err = wave_of<kL>(device, &wave);
  if (err != cudaSuccess) {
    return err;
  }

  Params<kL> P{};
  long long grid = 0;
  for (int s = 0; s < h.num_sets; ++s) {
    const HashSet& hs = h.set[s];
    SegL<kL>& g = P.seg[s];
    bool vec = aligned16(hs.out);
    for (int j = 0; j < hs.num_limbs; ++j) {
      g.limb[j] = static_cast<const uint64_t*>(hs.limb[j]);
      vec = vec && aligned16(hs.limb[j]);
    }
    g.out = static_cast<uint64_t*>(hs.out);
    g.n = hs.n > 0 ? hs.n : 0;
    g.num_limbs = hs.num_limbs;
    g.chained = hs.chained;
    g.vec = vec ? 1 : 0;
    g.items = g.vec ? (g.n >> 1) + (g.n & 1) : g.n;
    const long long want = (g.items + kThreads - 1) / kThreads;
    g.blocks = static_cast<int>(want < wave ? want : wave);
    grid += g.blocks;
  }
  if (grid == 0) {
    return cudaSuccess;
  }
  hash_pairs_kernel<kL><<<static_cast<unsigned int>(grid), kThreads, 0,
                          stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hash_pairs_launch(const HashLaunch* launch, void* stream) {
  const HashLaunch& h = *launch;
  if (h.num_sets < 1 || h.num_sets > kSets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one specialisation for the launch: the sets' common L if it is 1..4
  int kl = h.set[0].num_limbs;
  for (int s = 0; s < h.num_sets; ++s) {
    const int L = h.set[s].num_limbs;
    if (L < 1 || L > kCap) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (L != kl) {
      kl = 0;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kl) {
    case 1: err = launch_sets<1>(h, st); break;
    case 2: err = launch_sets<2>(h, st); break;
    case 3: err = launch_sets<3>(h, st); break;
    case 4: err = launch_sets<4>(h, st); break;
    default: err = launch_sets<0>(h, st); break;
  }
  return static_cast<int>(err);
}
