// The filter's prefilter probe of one key's hash160 words, shared by K5
// (probe_pack.cu) and the fused hash and probe (hash160_probe.cu).
//
// Ports filt.device_probe of the JAX `add` and `mul` steps
// (ecloop_tpu/search/add.py:220, ecloop_tpu/search/mul.py:371), which
// XLA compiles; the plain form is ecloop_tpu_torch/filters.py.  Modes
// (filters.Filter.device_probe):
//   kCompare  the first hash word in the sorted unique first words of the
//             targets: a search of fixed depth (ceil(log2 nfw) levels)
//             and one equality test; none -> no hit.  Up to kSharedWords
//             first words (all of ECLOOP_CMP_MAX's default) are staged as
//             u32 in shared memory by the whole block (`stage`), which the
//             search then reads; kCompareGlobal searches a longer list
//             through the read-only cache.
//   kExact    the first nprobes (1..20) ECBF probe indices mod nbits, every
//             bit set (bloom.probe_exact).  nbits = 64 m with m <= 2^31,
//             so idx mod nbits = ((a mod m) << 6) | (idx & 63), a = idx >> 6;
//             with r = floor((2^64 - 1) / m) from the host (Args::r),
//             q = umulhi(a, r) is floor(a / m) or one less, and one
//             conditional subtract fixes the remainder: no 64-bit divide,
//             which Hopper runs as a software routine.  bloom.exact_bit is
//             the same steps in Python.
//   kPow2     the same indices mod 2^log2_bits (bloom.probe_pow2).
// The probe index is bloom._probe_pairs's as one 64-bit word: the five
// overlapping u64s a[i] of the hash, shifted for s in SHIFTS, i in 0..4,
// (a[i] << s) | (a[i+1 mod 5] >> s).  The bits are the filter's u32 words.
//
// A key passes when every probe finds its bit set, so a probe past the
// first clear bit cannot change the answer.  The probes go in groups of
// kGroup: a group's indices are computed and its loads issued together
// (each load waits on no other), and the warp leaves at a group boundary
// once no lane still passes (__any_sync).  A lane that already failed
// issues no more loads.  The answer is the same AND as one probe at a
// time; only the count of reads past a lane's first clear bit changes,
// while up to kGroup trips to memory overlap.  Call `passes` from whole
// warps (the entries take n a multiple of 32).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace ecl {
namespace probe {

constexpr int kCompare = 0, kExact = 1, kPow2 = 2, kCompareGlobal = 3;
constexpr int kSharedWords = 2048;   // first words staged in shared memory, 8 KB
// probe loads issued together.  2 on an H100: in the fused hash and probe
// it runs a 2^31-bit .blf at fill 0.37 as fast as one probe at a time and
// denser filters a few percent faster, while groups of 4 waste a DRAM
// sector on most extra loads past the L2 (tools/torch_probe_group_sweep.py
// builds the library with -DECL_PROBE_GROUP=1, 2 and 4 to time them; the
// package's own build never sets it)
#ifndef ECL_PROBE_GROUP
#define ECL_PROBE_GROUP 2
#endif
constexpr int kGroup = ECL_PROBE_GROUP;
static_assert(20 % kGroup == 0, "the 20 ECBF probes split into whole groups");

struct Args {
  const uint32_t* bits;  // the filter's u32 bit words (exact, pow2)
  const int64_t* fw;     // sorted unique first words < 2^32 (compare)
  int64_t nfw;
  uint64_t r;            // exact: floor((2^64 - 1) / m)
  uint64_t mask;         // pow2: 2^log2_bits - 1
  uint32_t m;            // exact: nbits / 64
  int nprobes;
};

// The entries' probe arguments: mode 0 compare, 1 exact, 2 pow2 (the
// wrapper's PROBE_MODES); m and r for exact, log2_bits for pow2, fw and
// nfw for compare.
static inline Args make_args(const void* bits, unsigned long long m, unsigned long long r,
                             int nprobes, int log2_bits, const void* fw, long long nfw) {
  return Args{(const uint32_t*)bits, (const int64_t*)fw, (int64_t)nfw, (uint64_t)r,
              log2_bits > 0 ? (~0ull >> (64 - log2_bits)) : 0ull, (uint32_t)m, nprobes};
}

// launch(std::integral_constant<int, MODE>) for the kernel MODE that runs
// entry mode `mode` (compare: staged or global by the list's length).
template <class Launch>
static inline int with_mode(int mode, int64_t nfw, Launch&& launch) {
  switch (mode) {
    case kCompare:
      return nfw <= kSharedWords ? launch(std::integral_constant<int, kCompare>{})
                                 : launch(std::integral_constant<int, kCompareGlobal>{});
    case kExact:
      return launch(std::integral_constant<int, kExact>{});
    case kPow2:
      return launch(std::integral_constant<int, kPow2>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block of MODE needs.
static inline size_t shared_bytes(int mode, int64_t nfw) {
  return mode == kCompare ? (size_t)nfw * sizeof(uint32_t) : 0;
}

// kCompare: the block's threads copy the first words into s.  Every
// thread of the block calls it before any of them leaves.
template <int MODE>
__device__ __forceinline__ void stage(const Args& p, uint32_t* s) {
  if (MODE != kCompare) return;
  for (int64_t i = threadIdx.x; i < p.nfw; i += blockDim.x) s[i] = (uint32_t)p.fw[i];
  __syncthreads();
}

// Whether key is among the len sorted words at base: the last word <= key
// lies in [base, base + len) at every level.
template <typename T, bool LDG>
__device__ __forceinline__ bool search(const T* base, int64_t len, uint32_t key) {
  if (len <= 0) return false;
  while (len > 1) {
    const int64_t half = len >> 1;
    const T v = LDG ? __ldg(base + half) : base[half];
    base = (v <= (T)key) ? base + half : base;
    len -= half;
  }
  return (LDG ? __ldg(base) : *base) == (T)key;
}

// Probe q's 64-bit index.
__device__ __forceinline__ uint64_t probe_index(const uint64_t (&a)[5], int q) {
  const int s = q < 5 ? 24 : q < 10 ? 28 : q < 15 ? 36 : 40, i = q % 5;  // SHIFTS
  return (a[i] << s) | (a[(i + 1) % 5] >> s);
}

// The u32 word and the bit within it that probe index idx reads.
template <int MODE>
__device__ __forceinline__ void probe_bit(const Args& p, uint64_t idx, uint64_t& word,
                                          uint32_t& shift) {
  if (MODE == kExact) {
    const uint64_t a = idx >> 6;
    const uint64_t q = __umul64hi(a, p.r);
    // a - q m < 2 m <= 2^32, so the low words give it exactly
    uint32_t rem = (uint32_t)a - (uint32_t)q * p.m;
    if (rem >= p.m) rem -= p.m;
    word = ((uint64_t)rem << 1) | (((uint32_t)idx >> 5) & 1u);  // bit rem * 64 + (idx & 63)
    shift = (uint32_t)idx & 31u;
  } else {
    const uint64_t b = idx & p.mask;
    word = b >> 5;
    shift = (uint32_t)b & 31u;
  }
}

// Whether the key whose hash160 words (print order) are w passes the
// prefilter; s holds the staged first words in kCompare mode.
template <int MODE>
__device__ __forceinline__ bool passes(const Args& p, const uint32_t (&w)[5],
                                       const uint32_t* s) {
  if (MODE == kCompare) return search<uint32_t, false>(s, p.nfw, w[0]);
  if (MODE == kCompareGlobal) return search<int64_t, true>(p.fw, p.nfw, w[0]);
  uint64_t a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int hi = (2 * i) % 5, lo = (2 * i + 1) % 5;
    a[i] = ((uint64_t)w[hi] << 32) | w[lo];
  }
  bool hit = true;
#pragma unroll
  for (int g = 0; g < 20; g += kGroup) {
    if (g >= p.nprobes) break;  // the same for every lane
    uint32_t v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      uint64_t word;
      uint32_t shift;
      probe_bit<MODE>(p, probe_index(a, g + j), word, shift);
      v[j] = (hit && g + j < p.nprobes) ? (__ldg(p.bits + word) >> shift) : 1u;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) hit = hit && (v[j] & 1u);
    if (!__any_sync(0xFFFFFFFFu, hit)) break;
  }
  return hit;
}

}  // namespace probe
}  // namespace ecl
