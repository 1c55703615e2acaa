// K1: hash160 of serialized pubkeys, serialize -> SHA-256 -> RIPEMD-160.
//
// Replaces ecloop_tpu/pallas_kernels.py:_hash_kernel (with _build_hash,
// _hash_rows_pallas, addr33_hash_rows_pallas, addr65_hash_rows_pallas).
//
// One thread per key runs hash160.cuh's hash160_words (the key's limbs
// in, its 5 words in registers) and writes the words in big-endian print
// order (out[w * n + e], int64 values below 2^32).  The searches run the
// same body fused with the probe (hash160_probe.cu); this entry serves
// the bench, the checks and any caller that needs the hash rows.
//
// Bound: 32-bit integer operations, about 3k per key (the rotates are
// funnel shifts, the byte swaps byte permutes).  Nothing goes through
// shared memory; the schedule and round state stay in registers.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash160.cuh"

namespace {

template <bool IS33>
__global__ void __launch_bounds__(256)
    hash160_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                   int64_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // ragged edge
  uint32_t h[5];
  ecl::hash160_words<IS33>(h, x, y, n, e);
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i * n + e] = (int64_t)h[i];
}

}  // namespace

// x, y: (16, n) int64 limbs; out: (5, n) int64 words.  Returns
// cudaGetLastError() after the launch.
extern "C" int ecl_hash160(const void* x, const void* y, void* out, long long n, int is33,
                           void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is33)
    hash160_kernel<true><<<blocks, threads, 0, s>>>((const int64_t*)x, (const int64_t*)y,
                                                    (int64_t*)out, (int64_t)n);
  else
    hash160_kernel<false><<<blocks, threads, 0, s>>>((const int64_t*)x, (const int64_t*)y,
                                                     (int64_t*)out, (int64_t)n);
  return (int)cudaGetLastError();
}
