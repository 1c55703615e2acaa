// K5: the filter prefilter probe of one plane of hash160 words, packed
// into hit-mask words.
//
// Ports the compiled probe and mask packing of ecloop_tpu/search/add.py
// (make_step: filt.device_probe then _pack_mask; the same pair in
// ecloop_tpu/search/mul.py) that XLA fuses on the TPU; the plain form is
// ecloop_tpu_torch/filters.py:probe_pack_plain.  Input: K1's (5, n) words
// (int64, values below 2^32), n a multiple of 32.  Output: (n/32,) int64
// words below 2^32, bit i of word w set when key 32w + i passes.  The
// probe itself, in its three modes, is probe.cuh's; the searches run it
// as the epilogue of the hash (hash160_probe.cu), and this entry serves
// the bench, the checks and any caller that holds hash rows.
//
// One thread per key; __ballot_sync over the warp gives the packed word
// in the little-endian order of pack_mask (lane i = key 32w + i).
//
// Bound: bytes at the compare mode's one search (8 bytes of hash word per
// key against a few operations); the exact probe's reads past the L2 at
// a large filter, which the grouped loads overlap.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

using namespace ecl;

template <int MODE>
__global__ void __launch_bounds__(256)
    probe_pack_kernel(const int64_t* __restrict__ h, int64_t n, probe::Args p,
                      int64_t* __restrict__ out) {
  extern __shared__ uint32_t first_words[];
  probe::stage<MODE>(p, first_words);
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // n % 32 == 0: whole warps leave together
  uint32_t w[5];
  if (MODE == probe::kCompare || MODE == probe::kCompareGlobal) {
    w[0] = (uint32_t)h[e];  // the search reads the first word alone
  } else {
#pragma unroll
    for (int i = 0; i < 5; ++i) w[i] = (uint32_t)h[i * n + e];
  }
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, probe::passes<MODE>(p, w, first_words));
  if ((threadIdx.x & 31) == 0) out[e >> 5] = (int64_t)word;
}

}  // namespace

// h: (5, n) int64 words, n a multiple of 32; mode 0 compare, 1 exact,
// 2 pow2; bits: the filter's u32 words; m, r: exact's nbits / 64 and
// floor((2^64 - 1) / m); fw: nfw sorted unique int64 first words (mode 0);
// out: (n/32,) int64.  Returns cudaGetLastError() after the launch.
extern "C" int ecl_probe_pack(const void* h, long long n, int mode, const void* bits,
                              unsigned long long m, unsigned long long r, int nprobes,
                              int log2_bits, const void* fw, long long nfw, void* out,
                              void* stream) {
  if (n <= 0) return 0;
  const probe::Args p = probe::make_args(bits, m, r, nprobes, log2_bits, fw, nfw);
  return probe::with_mode(mode, nfw, [&](auto mode_c) {
    constexpr int MODE = decltype(mode_c)::value;
    const int threads = 256;
    probe_pack_kernel<MODE><<<(unsigned)((n + threads - 1) / threads), threads,
                              probe::shared_bytes(MODE, nfw), (cudaStream_t)stream>>>(
        (const int64_t*)h, (int64_t)n, p, (int64_t*)out);
    return (int)cudaGetLastError();
  });
}
