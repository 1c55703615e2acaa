// Field arithmetic mod p = 2^256 - 2^32 - 977 (secp256k1) for the device.
//
// Inside a kernel an element is 8 little-endian 32-bit limbs.  At the
// kernel's edges it is the port's layout: 16 little-endian 16-bit limbs,
// limb-first, one int64 per limb (limb l of element e at x[l * n + e]),
// so each thread's loads and stores are coalesced across the warp.
// Products are 64-bit (mul.wide.u32); the high half is folded back with
// 2^256 = 2^32 + 977 (mod p) and the result is fully reduced (< p), so it
// equals the plain torch version (ecloop_tpu_torch/fel.py) bit for bit.
#pragma once

#include <cstdint>

namespace ecl {

struct fe {
  uint32_t v[8];
};

static __device__ __forceinline__ void fe_load16(fe& r, const int64_t* __restrict__ x,
                                                 int64_t n, int64_t e) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.v[i] = (uint32_t)x[(2 * i) * n + e] | ((uint32_t)x[(2 * i + 1) * n + e] << 16);
}

static __device__ __forceinline__ void fe_store16(int64_t* __restrict__ out, int64_t n,
                                                  int64_t e, const fe& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[(2 * i) * n + e] = (int64_t)(a.v[i] & 0xFFFFu);
    out[(2 * i + 1) * n + e] = (int64_t)(a.v[i] >> 16);
  }
}

static __device__ __forceinline__ bool fe_is_zero(const fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc |= a.v[i];
  return acc == 0;
}

static __device__ __forceinline__ void fe_set(fe& a, uint32_t v0) {
  a.v[0] = v0;
#pragma unroll
  for (int i = 1; i < 8; ++i) a.v[i] = 0;
}

// Word i of p, little-endian.
static __device__ __forceinline__ constexpr uint32_t fe_p_word(int i) {
  return i == 0 ? 0xFFFFFC2Fu : i == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu;
}

// r = a + (2^32 + 977) mod 2^256; returns the carry out of 2^256.  For
// a < 2^256 that carry is set exactly when a >= p, and r is then a - p.
static __device__ __forceinline__ uint32_t fe_add_pc(fe& r, const fe& a) {
  uint64_t t = (uint64_t)a.v[0] + 977u;
  r.v[0] = (uint32_t)t;
  t = (uint64_t)a.v[1] + 1u + (t >> 32);
  r.v[1] = (uint32_t)t;
  uint64_t c = t >> 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    t = (uint64_t)a.v[i] + c;
    r.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  return (uint32_t)c;
}

// r = (w[0..15] as a 512-bit value) mod p, fully reduced.
static __device__ __forceinline__ void fe_reduce(fe& r, const uint32_t (&w)[16]) {
  // X = lo + hi * (2^32 + 977): word i takes lo[i] + 977 hi[i] + hi[i-1]
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)w[i] + (uint64_t)w[8 + i] * 977u + c;
    if (i > 0) t += w[7 + i];
    r.v[i] = (uint32_t)t;
    c = t >> 32;  // < 2^10
  }
  uint64_t top = c + w[15];  // X >> 256 < 2^33
  // top * 2^256 = top * (2^32 + 977); the sum stays below 2^256 + 2^66
  uint64_t t = (uint64_t)r.v[0] + top * 977u;
  r.v[0] = (uint32_t)t;
  t = (uint64_t)r.v[1] + top + (t >> 32);
  r.v[1] = (uint32_t)t;
  c = t >> 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    t = (uint64_t)r.v[i] + c;
    r.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  // c in {0, 1}; when 1 the low part is < 2^66, so this fold cannot carry out
  t = (uint64_t)r.v[0] + c * 977u;
  r.v[0] = (uint32_t)t;
  t = (uint64_t)r.v[1] + c + (t >> 32);
  r.v[1] = (uint32_t)t;
  c = t >> 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    t = (uint64_t)r.v[i] + c;
    r.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  // r < 2^256 < 2p: one conditional subtraction of p
  fe s;
  if (fe_add_pc(s, r)) r = s;
}

// r = a + b mod p, for a, b < p.  r may alias a or b.
static __device__ __forceinline__ void fe_add(fe& r, const fe& a, const fe& b) {
  fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)t;
    c = t >> 32;
  }
  // a + b = c * 2^256 + s < 2p: subtract p when c is set or s >= p
  fe d;
  const uint32_t ge = fe_add_pc(d, s);
  r = (c | ge) ? d : s;
}

// r = a - b mod p, for a, b < p.  r may alias a or b.
static __device__ __forceinline__ void fe_sub(fe& r, const fe& a, const fe& b) {
  fe d;
  uint64_t brw = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a.v[i] - b.v[i] - brw;
    d.v[i] = (uint32_t)t;
    brw = t >> 63;
  }
  if (brw) {  // a < b: add p back, mod 2^256
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint64_t t = (uint64_t)d.v[i] + fe_p_word(i) + c;
      d.v[i] = (uint32_t)t;
      c = t >> 32;
    }
  }
  r = d;
}

// r = p - a for a < p; 0 -> 0.  r may alias a.
static __device__ __forceinline__ void fe_neg(fe& r, const fe& a) {
  if (fe_is_zero(a)) {
    r = a;
    return;
  }
  uint64_t brw = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)fe_p_word(i) - a.v[i] - brw;
    r.v[i] = (uint32_t)t;
    brw = t >> 63;
  }
}

// r = a * k mod p for a small constant k < 2^16.  r may alias a.
static __device__ __forceinline__ void fe_mul_small(fe& r, const fe& a, uint32_t k) {
  uint32_t w[16];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t t = (uint64_t)a.v[i] * k + c;
    w[i] = (uint32_t)t;
    c = t >> 32;
  }
  w[8] = (uint32_t)c;
#pragma unroll
  for (int i = 9; i < 16; ++i) w[i] = 0;
  fe_reduce(r, w);
}

// r = a * b mod p.  r may alias a or b.
static __device__ __forceinline__ void fe_mul(fe& r, const fe& a, const fe& b) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t t = (uint64_t)a.v[i] * b.v[j] + w[i + j] + c;
      w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
    w[i + 8] = (uint32_t)c;
  }
  fe_reduce(r, w);
}

static __device__ __noinline__ void fe_sqrn(fe& x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) fe_mul(x, x, x);
}

// r = a^(p-2) mod p (0 -> 0): the addition chain of
// ecloop_tpu/pallas_kernels.py:_inv_chain.
static __device__ void fe_inv(fe& r, const fe& a) {
  fe x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223, t;
  x2 = a; fe_sqrn(x2, 1); fe_mul(x2, x2, a);
  x3 = x2; fe_sqrn(x3, 1); fe_mul(x3, x3, a);
  x6 = x3; fe_sqrn(x6, 3); fe_mul(x6, x6, x3);
  x9 = x6; fe_sqrn(x9, 3); fe_mul(x9, x9, x3);
  x11 = x9; fe_sqrn(x11, 2); fe_mul(x11, x11, x2);
  x22 = x11; fe_sqrn(x22, 11); fe_mul(x22, x22, x11);
  x44 = x22; fe_sqrn(x44, 22); fe_mul(x44, x44, x22);
  x88 = x44; fe_sqrn(x88, 44); fe_mul(x88, x88, x44);
  x176 = x88; fe_sqrn(x176, 88); fe_mul(x176, x176, x88);
  x220 = x176; fe_sqrn(x220, 44); fe_mul(x220, x220, x44);
  x223 = x220; fe_sqrn(x223, 3); fe_mul(x223, x223, x3);
  t = x223; fe_sqrn(t, 23); fe_mul(t, t, x22);
  fe_sqrn(t, 5); fe_mul(t, t, a);
  fe_sqrn(t, 3); fe_mul(t, t, x2);
  fe_sqrn(t, 2); fe_mul(r, t, a);
}

}  // namespace ecl
