// K2: batched modular inversion mod p (Montgomery's trick).
//
// Replaces ecloop_tpu/pallas_kernels.py:_inv_kernel (with _inv_chain,
// _build_inv and inv_mod_batch_pallas).  Contract: out[e] = x[e]^-1 mod p
// for every element, 0 -> 0, inputs canonical (< p), any batch length n.
//
// Bound: the latency of one dependent chain, not bytes or operations.
// However the batch is cut, some thread must invert one field element, a
// chain of hundreds of dependent steps (the Fermat chain of _inv_chain:
// 255 squarings and 15 multiplies; here a safegcd of some 20 batches of
// divsteps), each needing the one before; the 32 limbs of every element
// move in a few microseconds and the 3 multiplies per element are a small
// share of the card's integer rate.  So the least time is that chain's
// latency, measured at n = 1.
//
// What the design does about it:
// - The block's one inversion is a variable-time safegcd (fe_inv_var:
//   Bernstein-Yang divsteps in batches of 30 on 32-bit words), which on
//   the H100 took less than half the Fermat chain's time (PERF.md).
// - Every multiply on the way (prefix products, the tree) is the lazy
//   fe_mul_lazy of field.cuh: products issued as independent rows and
//   summed afterwards in PTX carry chains, values kept below 2^256 and
//   reduced fully only before the store.
// - Three-level Montgomery's trick, with no scratch in device memory: each
//   thread multiplies CHUNK elements into prefix products held in
//   registers; a product tree over the block's THREADS chunk products in
//   shared memory (up-sweep, one inversion per block, down-sweep) gives
//   each thread the inverse of its chunk product; the thread then
//   back-substitutes.  Blocks are independent and the ragged edge is
//   masked (missing and zero elements count as 1, zeros are stored as 0).
// - A block is one warp holding THREADS * CHUNK = 128 elements, so the main
//   path's batches (32,768 per `mul` job, 65,568 per `add` step, up to
//   155,629 per table-build round) launch 256 to 1,216 blocks: every one
//   of the 132 SMs holds at least one chain, and the chains of an SM's
//   blocks fall on all four of its warp schedulers.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using ecl::fe;

constexpr int THREADS = 32;                // leaves of the block's tree: one warp
constexpr int CHUNK = 4;                   // elements a thread chains
constexpr int PER_BLOCK = THREADS * CHUNK;

// the product tree, word-major: node k (1 = root, THREADS + t = thread t's
// leaf) is words tree[0..7][k]
__device__ __forceinline__ void tree_load(fe& a, const uint32_t (*tree)[2 * THREADS], int k) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = tree[i][k];
}

__device__ __forceinline__ void tree_store(uint32_t (*tree)[2 * THREADS], int k, const fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) tree[i][k] = a.v[i];
}

__global__ void __launch_bounds__(THREADS)
    inv_batch_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out, int64_t n) {
  __shared__ uint32_t tree[8][2 * THREADS];
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * PER_BLOCK + t;

  // chunk elements e = base + c * THREADS (coalesced across the warp);
  // pre[c] = x[0] * ... * x[c], with missing and zero elements as 1
  fe xs[CHUNK], pre[CHUNK];
  bool zero[CHUNK];
#pragma unroll
  for (int c = 0; c < CHUNK; ++c) {
    const int64_t e = base + (int64_t)c * THREADS;
    ecl::fe_set(xs[c], 1);
    zero[c] = false;
    if (e < n) {
      fe a;
      ecl::fe_load16(a, x, n, e);
      zero[c] = ecl::fe_is_zero(a);
      if (!zero[c]) xs[c] = a;
    }
    if (c == 0)
      pre[0] = xs[0];
    else
      ecl::fe_mul_lazy(pre[c], pre[c - 1], xs[c]);
  }

  // up-sweep: node k = product of nodes 2k and 2k + 1
  tree_store(tree, THREADS + t, pre[CHUNK - 1]);
  __syncthreads();
#pragma unroll 1
  for (int s = THREADS / 2; s >= 1; s >>= 1) {
    if (t < s) {
      fe l, r;
      tree_load(l, tree, 2 * (s + t));
      tree_load(r, tree, 2 * (s + t) + 1);
      ecl::fe_mul_lazy(l, l, r);
      tree_store(tree, s + t, l);
    }
    __syncthreads();
  }
  // the block's one inversion
  if (t == 0) {
    fe root;
    tree_load(root, tree, 1);
    ecl::fe_canon(root, root);
    ecl::fe_inv_var(root, root);
    tree_store(tree, 1, root);
  }
  __syncthreads();
  // down-sweep: node k holds the inverse of its product; its children get
  // inv(k) * (the other child's product)
#pragma unroll 1
  for (int s = 1; s < THREADS; s <<= 1) {
    if (t < s) {
      const int k = s + t;
      fe inv, l, r;
      tree_load(inv, tree, k);
      tree_load(l, tree, 2 * k);
      tree_load(r, tree, 2 * k + 1);
      ecl::fe_mul_lazy(r, inv, r);
      ecl::fe_mul_lazy(l, inv, l);
      tree_store(tree, 2 * k, r);
      tree_store(tree, 2 * k + 1, l);
    }
    __syncthreads();
  }

  // back-substitution: inv = (x[0] * ... * x[c])^-1 at step c
  fe inv;
  tree_load(inv, tree, THREADS + t);
#pragma unroll
  for (int c = CHUNK - 1; c >= 0; --c) {
    const int64_t e = base + (int64_t)c * THREADS;
    fe o;
    if (c > 0) {
      ecl::fe_mul_lazy(o, inv, pre[c - 1]);
      ecl::fe_mul_lazy(inv, inv, xs[c]);
    } else {
      o = inv;
    }
    if (e < n) {
      if (zero[c])
        ecl::fe_set(o, 0);
      else
        ecl::fe_canon(o, o);
      ecl::fe_store16(out, n, e, o);
    }
  }
}

}  // namespace

// x, out: (16, n) int64 limbs.  Returns cudaGetLastError() after the launch.
extern "C" int ecl_inv_batch(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + PER_BLOCK - 1) / PER_BLOCK;
  inv_batch_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, (int64_t*)out, (int64_t)n);
  return (int)cudaGetLastError();
}

// Elements per block, for tests that place zeros on block edges.
extern "C" int ecl_inv_batch_block(void) { return PER_BLOCK; }

// The device this library's CUDA runtime holds current for the calling
// thread, or -1 when it cannot tell.  The library links nvcc's static
// runtime, which is not PyTorch's; the wrappers compare this with the
// tensor's device before every launch, so a launch that would land on
// another card than its data fails instead.
extern "C" int ecl_current_device(void) {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}
