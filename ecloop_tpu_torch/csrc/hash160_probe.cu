// K1 with K5 as its epilogue: hash160 of each key of one address form
// over a step's planes, probed against the filter and packed into the
// step's hit-mask words, in one launch per form.
//
// Replaces, on the searches' path, the pair of K1 (hash160.cu, the port
// of ecloop_tpu/pallas_kernels.py:_hash_kernel) and K5 (probe_pack.cu,
// the port of the compiled filt.device_probe and _pack_mask of
// ecloop_tpu/search/add.py:220 and search/mul.py:371).  The plain form is
// kernels.hash160_probe on the CPU: per plane hash160.addr33_hash_rows or
// addr65_hash_rows, then filters.probe_pack_plain.
//
// A plane is one candidate variant of the step (search/add._variants's
// order: endo index major, addr33 before addr65): an x row and a y row of
// the step's 1 or 3 x rows and 1 or 2 y rows (x, beta x, beta^2 x; y, -y)
// and the row of the masks it fills.  blockIdx.y walks the launch's
// planes (up to 6, the endo variants of one form).  Each thread hashes
// one key with hash160.cuh's hash160_words, keeps the 5 words in
// registers and runs probe.cuh's probe on them; the warp's vote is the
// packed word of its 32 keys, written straight to masks[plane, w].
//
// Bound: K1's 32-bit integer operations; the hash rows that K1 wrote and
// K5 read back (40 bytes per key and plane) never reach device memory,
// and the second launch and the stack of the planes are gone.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash160.cuh"
#include "probe.cuh"

namespace {

using namespace ecl;

constexpr int kMaxPlanes = 6;

struct Planes {
  const int64_t* x[kMaxPlanes];  // (16, n) limb rows of each plane's key x
  const int64_t* y[kMaxPlanes];  // and y
  int out[kMaxPlanes];           // each plane's row of the masks
};

// a[v] for the block's plane v, picked by constant indices so that the
// table stays in the kernel's parameter space (an index that is not
// constant would copy the table to local memory)
template <class T>
__device__ __forceinline__ T pick(const T (&a)[kMaxPlanes], int v) {
  T r = a[0];
#pragma unroll
  for (int i = 1; i < kMaxPlanes; ++i)
    if (v == i) r = a[i];
  return r;
}

template <bool IS33, int MODE>
__global__ void __launch_bounds__(256)
    hash160_probe_kernel(Planes planes, int64_t n, probe::Args p, int64_t* __restrict__ masks) {
  extern __shared__ uint32_t first_words[];
  probe::stage<MODE>(p, first_words);
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // n % 32 == 0: whole warps leave together
  const int v = blockIdx.y;
  uint32_t h[5];
  hash160_words<IS33>(h, pick(planes.x, v), pick(planes.y, v), n, e);
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, probe::passes<MODE>(p, h, first_words));
  if ((threadIdx.x & 31) == 0) masks[pick(planes.out, v) * (n >> 5) + (e >> 5)] = (int64_t)word;
}

template <bool IS33>
int launch(int mode, const Planes& planes, int count, int64_t n, const probe::Args& p,
           void* masks, cudaStream_t s) {
  return probe::with_mode(mode, p.nfw, [&](auto mode_c) {
    constexpr int MODE = decltype(mode_c)::value;
    const int threads = 256;
    const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)count);
    hash160_probe_kernel<IS33, MODE><<<grid, threads, probe::shared_bytes(MODE, p.nfw), s>>>(
        planes, n, p, (int64_t*)masks);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// rows: host array of the step's row pointers, x rows in rows[0..2], y
// rows in rows[3..4] ((16, n) int64 limbs each, unused ones null); table:
// host array of count (x index, y index, mask row) triples, count 1..6,
// all of one form (is33); n keys per plane, a multiple of 32; the probe's
// arguments as for ecl_probe_pack; masks: (V, n/32) int64.  Returns
// cudaGetLastError() after the launch.
extern "C" int ecl_hash160_probe(const unsigned long long* rows, const int* table, int count,
                                 int is33, long long n, int mode, const void* bits,
                                 unsigned long long m, unsigned long long r, int nprobes,
                                 int log2_bits, const void* fw, long long nfw, void* masks,
                                 void* stream) {
  if (n <= 0) return 0;
  if (count < 1 || count > kMaxPlanes || n % 32) return (int)cudaErrorInvalidValue;
  Planes planes{};
  for (int v = 0; v < count; ++v) {
    const int xi = table[3 * v], yi = table[3 * v + 1];
    if (xi < 0 || xi > 2 || yi < 0 || yi > 1 || !rows[xi] || !rows[3 + yi])
      return (int)cudaErrorInvalidValue;
    planes.x[v] = (const int64_t*)rows[xi];
    planes.y[v] = (const int64_t*)rows[3 + yi];
    planes.out[v] = table[3 * v + 2];
  }
  const probe::Args p = probe::make_args(bits, m, r, nprobes, log2_bits, fw, nfw);
  cudaStream_t s = (cudaStream_t)stream;
  return is33 ? launch<true>(mode, planes, count, (int64_t)n, p, masks, s)
              : launch<false>(mode, planes, count, (int64_t)n, p, masks, s);
}
