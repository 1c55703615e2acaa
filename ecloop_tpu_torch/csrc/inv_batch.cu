// K2: batched modular inversion mod p (Montgomery's trick).
//
// Replaces ecloop_tpu/pallas_kernels.py:_inv_kernel (with _inv_chain,
// _build_inv and inv_mod_batch_pallas).  Contract: out[e] = x[e]^-1 mod p
// for every element, 0 -> 0, inputs canonical (< p), any batch length n.
//
// The Pallas kernel walks its grid in order and carries the prefix
// scratch from step to step.  CUDA blocks run in no order, so here each
// thread owns a strided chunk of elements e = t, t + T, t + 2T, ... (T
// threads in all, so every load and store is coalesced across a warp):
// prefix products into the scratch buffer, one Fermat chain for the
// chunk's total, then back-substitution.  Nothing passes between blocks.
//
// Bound: 32-bit integer multiplies.  Each element costs 3 modular
// multiplies (64 mul.wide.u32 each) and each thread adds one 270-squaring
// chain; the chunk length trades the chain's share of the work against
// the number of threads in flight.  Memory traffic is the 16 input and 16
// output limbs plus 8 prefix words written and read once per element.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using ecl::fe;

__global__ void __launch_bounds__(128)
    inv_batch_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                     uint32_t* __restrict__ pfx, int64_t n, int64_t nthreads) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nthreads || t >= n) return;

  fe acc;
  ecl::fe_set(acc, 1);
  int64_t last = t;
  for (int64_t e = t; e < n; e += nthreads) {
    fe a;
    ecl::fe_load16(a, x, n, e);
    if (ecl::fe_is_zero(a)) ecl::fe_set(a, 1);
    ecl::fe_mul(acc, acc, a);
#pragma unroll
    for (int i = 0; i < 8; ++i) pfx[i * n + e] = acc.v[i];
    last = e;
  }

  fe inv;
  ecl::fe_inv(inv, acc);

  for (int64_t e = last;; e -= nthreads) {
    fe a;
    ecl::fe_load16(a, x, n, e);
    const bool zero = ecl::fe_is_zero(a);
    fe o;
    if (e == t) {
      o = inv;
    } else {
      fe prev;
#pragma unroll
      for (int i = 0; i < 8; ++i) prev.v[i] = pfx[i * n + e - nthreads];
      ecl::fe_mul(o, inv, prev);
      if (!zero) ecl::fe_mul(inv, inv, a);
    }
    if (zero) ecl::fe_set(o, 0);
    ecl::fe_store16(out, n, e, o);
    if (e == t) break;
  }
}

}  // namespace

// x, out: (16, n) int64 limbs; pfx: (8, n) 32-bit scratch.  Returns
// cudaGetLastError() after the launch.
extern "C" int ecl_inv_batch(const void* x, void* out, void* pfx, long long n,
                             long long chunk, void* stream) {
  if (n <= 0) return 0;
  if (chunk < 1) chunk = 1;
  const long long nthreads = (n + chunk - 1) / chunk;
  const int threads = 128;
  const long long blocks = (nthreads + threads - 1) / threads;
  inv_batch_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, (int64_t*)out, (uint32_t*)pfx, (int64_t)n, (int64_t)nthreads);
  return (int)cudaGetLastError();
}
