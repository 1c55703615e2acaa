// K5: the filter prefilter probe of one plane of hash160 words, packed
// into hit-mask words.
//
// Ports the compiled probe and mask packing of ecloop_tpu/search/add.py
// (make_step: filt.device_probe then _pack_mask; the same pair in
// ecloop_tpu/search/mul.py) that XLA fuses on the TPU; the plain form is
// ecloop_tpu_torch/filters.py:probe_pack_plain.  Input: K1's (5, n) words
// (int64, values below 2^32), n a multiple of 32.  Output: (n/32,) int64
// words below 2^32, bit i of word w set when key 32w + i passes.  Modes
// (filters.Filter.device_probe):
//   0 compare  the first hash word in the sorted unique first words of
//              the targets: a search of fixed depth (ceil(log2 nfw)
//              steps) and one equality test; none -> no hit
//   1 exact    the first nprobes (1..20) ECBF probe indices, each
//              (hi * 2^32 + lo) mod nbits with one uint64_t %, every
//              bit set (bloom.probe_exact)
//   2 pow2     the same indices mod 2^log2_bits (bloom.probe_pow2)
// The probe index is bloom._probe_pairs's as one 64-bit word: the five
// overlapping u64s a[i] of the hash, shifted for s in SHIFTS, i in
// 0..4, (a[i] << s) | (a[i+1 mod 5] >> s).  A probe stops at its first
// clear bit (the AND is already 0).  The bits are the filter's u32 words.
//
// One thread per key; __ballot_sync over the warp gives the packed word
// in the little-endian order of pack_mask (lane i = key 32w + i).
//
// Bound: bytes at the list mode's one compare (40 bytes of hash words
// per key against a few operations); the exact probe's 64-bit remainders
// cost ~70 operations each, so a filter at many probes is bound by them.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ bool bit_set(const uint32_t* __restrict__ bits, uint64_t r) {
  return (__ldg(bits + (r >> 5)) >> (r & 31)) & 1u;
}

__global__ void __launch_bounds__(256)
    probe_pack_kernel(const int64_t* __restrict__ h, int64_t n, int mode,
                      const uint32_t* __restrict__ bits, uint64_t nbits, int nprobes,
                      int log2_bits, const int64_t* __restrict__ fw, int64_t nfw,
                      int64_t* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // n % 32 == 0: whole warps leave together
  bool hit;
  if (mode == 0) {
    const int64_t key = h[e];
    hit = false;
    if (nfw > 0) {
      const int64_t* base = fw;
      int64_t len = nfw;
      while (len > 1) {  // the last first word <= key lies in [base, base + len)
        const int64_t half = len >> 1;
        base = (__ldg(base + half) <= key) ? base + half : base;
        len -= half;
      }
      hit = __ldg(base) == key;
    }
  } else {
    uint32_t w[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) w[i] = (uint32_t)h[i * n + e];
    uint64_t a[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int hi = (2 * i) % 5, lo = (2 * i + 1) % 5;
      a[i] = ((uint64_t)w[hi] << 32) | w[lo];
    }
    const uint64_t mask = (1ull << log2_bits) - 1;
    hit = true;
#pragma unroll
    for (int p = 0; p < 20; ++p) {
      if (p >= nprobes || !hit) break;
      const int s = p < 5 ? 24 : p < 10 ? 28 : p < 15 ? 36 : 40, i = p % 5;  // SHIFTS
      const uint64_t idx = (a[i] << s) | (a[(i + 1) % 5] >> s);
      hit = bit_set(bits, mode == 1 ? idx % nbits : idx & mask);
    }
  }
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, hit);
  if ((threadIdx.x & 31) == 0) out[e >> 5] = (int64_t)word;
}

}  // namespace

// h: (5, n) int64 words, n a multiple of 32; bits: the filter's u32 words;
// fw: nfw sorted unique int64 first words (mode 0); out: (n/32,) int64.
// Returns cudaGetLastError() after the launch.
extern "C" int ecl_probe_pack(const void* h, long long n, int mode, const void* bits,
                              unsigned long long nbits, int nprobes, int log2_bits,
                              const void* fw, long long nfw, void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  probe_pack_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>((const int64_t*)h, (int64_t)n, mode,
                                              (const uint32_t*)bits, (uint64_t)nbits,
                                              nprobes, log2_bits, (const int64_t*)fw,
                                              (int64_t)nfw, (int64_t*)out);
  return (int)cudaGetLastError();
}
