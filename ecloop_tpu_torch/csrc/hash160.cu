// K1: hash160 of serialized pubkeys, serialize -> SHA-256 -> RIPEMD-160.
//
// Replaces ecloop_tpu/pallas_kernels.py:_hash_kernel (with _build_hash,
// _hash_rows_pallas, addr33_hash_rows_pallas, addr65_hash_rows_pallas).
//
// One thread per key.  It reads the 16 limbs of x (and of y) from the
// limb-first layout (limb l of key e at x[l * n + e], int64, so a warp's
// loads are coalesced), builds the message words in registers, runs
// SHA-256 with a rolling 16-word schedule (1 block for addr33, 2 for
// addr65), then RIPEMD-160, and writes 5 words in big-endian print order
// (out[w * n + e], int64 values below 2^32).
//
// Bound: 32-bit integer operations, about 3k per key (the rotates are
// funnel shifts, the byte swaps byte permutes).  Nothing goes through
// shared memory; the schedule and round state stay in registers.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) { return __funnelshift_l(x, x, n); }
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

__constant__ uint32_t SHA_K[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4,
    0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE,
    0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F,
    0x4A7484AA, 0x5CB0A9DC, 0x76F988DA, 0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC,
    0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070, 0x19A4C116,
    0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7,
    0xC67178F2};

// One SHA-256 compression of w into st; w is overwritten by the schedule.
__device__ __forceinline__ void sha256_compress(uint32_t (&st)[8], uint32_t (&w)[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                        SHA_K[i] + w[i & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

template <int G>
__device__ __forceinline__ uint32_t rmd_f(uint32_t x, uint32_t y, uint32_t z) {
  if (G == 0) return x ^ y ^ z;
  if (G == 1) return (x & y) | (~x & z);
  if (G == 2) return (x | ~y) ^ z;
  if (G == 3) return (x & z) | (y & ~z);
  return x ^ (y | ~z);
}

__host__ __device__ constexpr uint32_t rmd_k1(int g) {
  return g == 0 ? 0x00000000u : g == 1 ? 0x5A827999u : g == 2 ? 0x6ED9EBA1u
       : g == 3 ? 0x8F1BBCDCu : 0xA953FD4Eu;
}

__host__ __device__ constexpr uint32_t rmd_k2(int g) {
  return g == 0 ? 0x50A28BE6u : g == 1 ? 0x5C4DD124u : g == 2 ? 0x6D703EF3u
       : g == 3 ? 0x7A6D76E9u : 0x00000000u;
}

struct RmdState {
  uint32_t al, bl, cl, dl, el, ar, br, cr, dr, er;
};

// One round of both lines: group G, left word RL rotated by SL, right
// word RR rotated by SR.  Template arguments keep every index static, so
// the message stays in registers.
template <int G, int RL, int SL, int RR, int SR>
__device__ __forceinline__ void rmd_step(RmdState& s, const uint32_t (&x)[16]) {
  uint32_t t = rotl(s.al + rmd_f<G>(s.bl, s.cl, s.dl) + x[RL] + rmd_k1(G), SL) + s.el;
  s.al = s.el; s.el = s.dl; s.dl = rotl(s.cl, 10); s.cl = s.bl; s.bl = t;
  t = rotl(s.ar + rmd_f<4 - G>(s.br, s.cr, s.dr) + x[RR] + rmd_k2(G), SR) + s.er;
  s.ar = s.er; s.er = s.dr; s.dr = rotl(s.cr, 10); s.cr = s.br; s.br = t;
}

#define RMD_STEP(g, rl, sl, rr, sr) rmd_step<g, rl, sl, rr, sr>(s, x)

// RIPEMD-160 of one 16-word (little-endian) block -> 5 state words.
__device__ __forceinline__ void rmd160_compress(uint32_t (&out)[5], const uint32_t (&x)[16]) {
  const uint32_t h0 = 0x67452301u, h1 = 0xEFCDAB89u, h2 = 0x98BADCFEu, h3 = 0x10325476u,
                 h4 = 0xC3D2E1F0u;
  RmdState s{h0, h1, h2, h3, h4, h0, h1, h2, h3, h4};
  RMD_STEP(0, 0, 11, 5, 8); RMD_STEP(0, 1, 14, 14, 9);
  RMD_STEP(0, 2, 15, 7, 9); RMD_STEP(0, 3, 12, 0, 11);
  RMD_STEP(0, 4, 5, 9, 13); RMD_STEP(0, 5, 8, 2, 15);
  RMD_STEP(0, 6, 7, 11, 15); RMD_STEP(0, 7, 9, 4, 5);
  RMD_STEP(0, 8, 11, 13, 7); RMD_STEP(0, 9, 13, 6, 7);
  RMD_STEP(0, 10, 14, 15, 8); RMD_STEP(0, 11, 15, 8, 11);
  RMD_STEP(0, 12, 6, 1, 14); RMD_STEP(0, 13, 7, 10, 14);
  RMD_STEP(0, 14, 9, 3, 12); RMD_STEP(0, 15, 8, 12, 6);
  RMD_STEP(1, 7, 7, 6, 9); RMD_STEP(1, 4, 6, 11, 13);
  RMD_STEP(1, 13, 8, 3, 15); RMD_STEP(1, 1, 13, 7, 7);
  RMD_STEP(1, 10, 11, 0, 12); RMD_STEP(1, 6, 9, 13, 8);
  RMD_STEP(1, 15, 7, 5, 9); RMD_STEP(1, 3, 15, 10, 11);
  RMD_STEP(1, 12, 7, 14, 7); RMD_STEP(1, 0, 12, 15, 7);
  RMD_STEP(1, 9, 15, 8, 12); RMD_STEP(1, 5, 9, 12, 7);
  RMD_STEP(1, 2, 11, 4, 6); RMD_STEP(1, 14, 7, 9, 15);
  RMD_STEP(1, 11, 13, 1, 13); RMD_STEP(1, 8, 12, 2, 11);
  RMD_STEP(2, 3, 11, 15, 9); RMD_STEP(2, 10, 13, 5, 7);
  RMD_STEP(2, 14, 6, 1, 15); RMD_STEP(2, 4, 7, 3, 11);
  RMD_STEP(2, 9, 14, 7, 8); RMD_STEP(2, 15, 9, 14, 6);
  RMD_STEP(2, 8, 13, 6, 6); RMD_STEP(2, 1, 15, 9, 14);
  RMD_STEP(2, 2, 14, 11, 12); RMD_STEP(2, 7, 8, 8, 13);
  RMD_STEP(2, 0, 13, 12, 5); RMD_STEP(2, 6, 6, 2, 14);
  RMD_STEP(2, 13, 5, 10, 13); RMD_STEP(2, 11, 12, 0, 13);
  RMD_STEP(2, 5, 7, 4, 7); RMD_STEP(2, 12, 5, 13, 5);
  RMD_STEP(3, 1, 11, 8, 15); RMD_STEP(3, 9, 12, 6, 5);
  RMD_STEP(3, 11, 14, 4, 8); RMD_STEP(3, 10, 15, 1, 11);
  RMD_STEP(3, 0, 14, 3, 14); RMD_STEP(3, 8, 15, 11, 14);
  RMD_STEP(3, 12, 9, 15, 6); RMD_STEP(3, 4, 8, 0, 14);
  RMD_STEP(3, 13, 9, 5, 6); RMD_STEP(3, 3, 14, 12, 9);
  RMD_STEP(3, 7, 5, 2, 12); RMD_STEP(3, 15, 6, 13, 9);
  RMD_STEP(3, 14, 8, 9, 12); RMD_STEP(3, 5, 6, 7, 5);
  RMD_STEP(3, 6, 5, 10, 15); RMD_STEP(3, 2, 12, 14, 8);
  RMD_STEP(4, 4, 9, 12, 8); RMD_STEP(4, 0, 15, 15, 5);
  RMD_STEP(4, 5, 5, 10, 12); RMD_STEP(4, 9, 11, 4, 9);
  RMD_STEP(4, 7, 6, 1, 12); RMD_STEP(4, 12, 8, 5, 5);
  RMD_STEP(4, 2, 13, 8, 14); RMD_STEP(4, 10, 12, 7, 6);
  RMD_STEP(4, 14, 5, 6, 8); RMD_STEP(4, 1, 12, 2, 13);
  RMD_STEP(4, 3, 13, 13, 6); RMD_STEP(4, 8, 14, 14, 5);
  RMD_STEP(4, 11, 11, 0, 15); RMD_STEP(4, 6, 8, 3, 13);
  RMD_STEP(4, 15, 5, 9, 11); RMD_STEP(4, 13, 6, 11, 11);
  out[0] = h1 + s.cl + s.dr;
  out[1] = h2 + s.dl + s.er;
  out[2] = h3 + s.el + s.ar;
  out[3] = h4 + s.al + s.br;
  out[4] = h0 + s.bl + s.cr;
}

#undef RMD_STEP

// 16 little-endian 16-bit limbs of key e -> 8 big-endian 32-bit words.
__device__ __forceinline__ void load_be_words(uint32_t (&w)[8], const int64_t* __restrict__ a,
                                              int64_t n, int64_t e) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = ((uint32_t)a[(15 - 2 * i) * n + e] << 16) | (uint32_t)a[(14 - 2 * i) * n + e];
}

template <bool IS33>
__global__ void __launch_bounds__(256)
    hash160_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                   int64_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;  // ragged edge

  uint32_t xw[8];
  load_be_words(xw, x, n, e);
  uint32_t st[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  uint32_t w[16];
  if (IS33) {
    // [02|03, x_be, 0x80, zeros, bit length 264]; the prefix is 02 | (y & 1)
    const uint32_t parity = (uint32_t)y[e] & 1u;
    w[0] = ((2u | parity) << 24) | (xw[0] >> 8);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[i] = (xw[i - 1] << 24) | (xw[i] >> 8);
    w[8] = (xw[7] << 24) | 0x00800000u;
#pragma unroll
    for (int i = 9; i < 15; ++i) w[i] = 0;
    w[15] = 264;
    sha256_compress(st, w);
  } else {
    // [04, x_be, y_be, 0x80, zeros, bit length 520] over two blocks
    uint32_t yw[8];
    load_be_words(yw, y, n, e);
    w[0] = 0x04000000u | (xw[0] >> 8);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[i] = (xw[i - 1] << 24) | (xw[i] >> 8);
    w[8] = (xw[7] << 24) | (yw[0] >> 8);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[8 + i] = (yw[i - 1] << 24) | (yw[i] >> 8);
    sha256_compress(st, w);
    w[0] = (yw[7] << 24) | 0x00800000u;
#pragma unroll
    for (int i = 1; i < 15; ++i) w[i] = 0;
    w[15] = 520;
    sha256_compress(st, w);
  }

  // RIPEMD-160 message: the digest's bytes, 0x80, zeros, bit length 256
  uint32_t m[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = bswap(st[i]);
  m[8] = 0x80;
#pragma unroll
  for (int i = 9; i < 14; ++i) m[i] = 0;
  m[14] = 256;
  m[15] = 0;
  uint32_t h[5];
  rmd160_compress(h, m);
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i * n + e] = (int64_t)bswap(h[i]);
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
