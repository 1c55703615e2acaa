// K8: a `mul` job's keys -> its window digits, on the card.
//
// Replaces the host's cut of every key of a job (ecloop_tpu/search/mul.py
// parse_keys, keys_to_words, words_mod_n and window_digits_words, which
// the port keeps as this kernel's plain form).  Two input forms, chosen
// by the template argument:
//   LINES  a byte buffer with the job's lines back to back, each followed
//          by one separator byte, and n + 1 int64 offsets: line e is
//          buf[offs[e], offs[e + 1] - 1).  The key is SHA-256 of the
//          line's bytes read as a big-endian 256-bit integer (`-raw`).
//   words  (n, 4) u64 little-endian key words (hex lines, run_keys).
// Then, per key: one conditional subtract reduces it mod n (keys are
// below 2^256 and n > 2^255; == n gives 0), and digit i of window i is
// bits [w i, w i + w) of the key, digit 0 meaning the window adds
// nothing, as window_digits_words cuts them.
//
// One thread per lane of the (d, batch) int32 digits; lane e writes
// dig[i * batch + e], coalesced across a warp.  A lane at or past n
// writes zeros, so a short job leaves no digits of the one before it.
// A line of up to 55 bytes is one SHA-256 block; a longer one loops
// over ceil((len + 9) / 64) blocks, any length.  The compression is
// hash160.cuh's (sha256_compress, SHA_K), the same as K1's.
//
// Bound (sol.mul_keys_account): 1,014 operations per SHA-256 block
// (sol.sha_block_ops: the compression as sol.HashOpCount counts it, at
// K1's 64-per-clock rule), the message build, reduction and cut left
// out; memory traffic is the line bytes and offsets (or 32 bytes of
// words) in and 4 d bytes of digits out per lane.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash160.cuh"

namespace {

// the curve order n, 8 little-endian 32-bit words
__constant__ uint32_t N_WORDS[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
                                    0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu};

// SHA-256 of the len bytes at p with the standard padding -> the key as
// 8 little-endian 32-bit words (k[0] the digest's last word).
__device__ __forceinline__ void sha256_key(uint32_t (&k)[8], const uint8_t* __restrict__ p,
                                           int64_t len) {
  uint32_t st[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  const int64_t blocks = (len + 9 + 63) / 64;
  const uint64_t bits = (uint64_t)len * 8;
  for (int64_t b = 0; b < blocks; ++b) {
    const int64_t base = b * 64;
    const bool last = b == blocks - 1;
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t q = base + 4 * i + j;
        const uint32_t byte = q < len ? (uint32_t)p[q] : q == len ? 0x80u : 0u;
        v = (v << 8) | byte;
      }
      w[i] = v;
    }
    if (last) {  // the bit length, big-endian, in the last 8 bytes
      w[14] = (uint32_t)(bits >> 32);
      w[15] = (uint32_t)bits;
    }
    ecl::sha256_compress(st, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = st[7 - i];
}

// k mod n for k < 2^256: k - n where that does not borrow.
__device__ __forceinline__ void reduce_mod_n(uint32_t (&k)[8]) {
  uint32_t r[8];
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)k[i] - N_WORDS[i] - borrow;
    r[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  if (!borrow) {
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = r[i];
  }
}

// word j of k (0 past the top) by selects, so k stays in registers
__device__ __forceinline__ uint32_t word_at(const uint32_t (&k)[8], int j) {
  uint32_t v = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) v = t == j ? k[t] : v;
  return v;
}

template <bool LINES>
__global__ void __launch_bounds__(256)
    mul_keys_kernel(const uint8_t* __restrict__ buf, const int64_t* __restrict__ offs,
                    const uint64_t* __restrict__ words, int64_t n, int64_t batch, int w,
                    int d, int32_t* __restrict__ dig) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= batch) return;  // ragged edge
  if (e >= n) {            // padding lane: no window adds anything
    for (int i = 0; i < d; ++i) dig[i * batch + e] = 0;
    return;
  }
  uint32_t k[8];
  if (LINES) {
    const int64_t start = offs[e];
    sha256_key(k, buf + start, offs[e + 1] - 1 - start);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint64_t v = words[4 * e + i];
      k[2 * i] = (uint32_t)v;
      k[2 * i + 1] = (uint32_t)(v >> 32);
    }
  }
  reduce_mod_n(k);
  const uint32_t mask = (1u << w) - 1u;  // w <= 31
  for (int i = 0; i < d; ++i) {
    const int pos = w * i;
    const int j = pos >> 5;
    const uint64_t v = (uint64_t)word_at(k, j) | (uint64_t)word_at(k, j + 1) << 32;
    dig[i * batch + e] = (int32_t)((uint32_t)(v >> (pos & 31)) & mask);
  }
}

}  // namespace

// lines != 0: buf holds the line bytes, offs n + 1 int64 offsets (words
// unused); lines == 0: words holds (n, 4) u64 key words (buf, offs
// unused).  dig: (d, batch) int32 with d = 255 / w + 1, 1 <= w <= 31,
// 0 <= n <= batch.  Returns cudaGetLastError() after the launch.
extern "C" int ecl_mul_keys(int lines, const void* buf, const void* offs, const void* words,
                            long long n, long long batch, int w, void* dig, void* stream) {
  if (batch <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  const int d = 255 / w + 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (lines)
    mul_keys_kernel<true><<<blocks, threads, 0, s>>>(
        (const uint8_t*)buf, (const int64_t*)offs, nullptr, (int64_t)n, (int64_t)batch, w, d,
        (int32_t*)dig);
  else
    mul_keys_kernel<false><<<blocks, threads, 0, s>>>(
        nullptr, nullptr, (const uint64_t*)words, (int64_t)n, (int64_t)batch, w, d,
        (int32_t*)dig);
  return (int)cudaGetLastError();
}
