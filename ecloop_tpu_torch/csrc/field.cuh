// Field arithmetic mod p = 2^256 - 2^32 - 977 (secp256k1) for the device.
//
// Inside a kernel an element is 8 little-endian 32-bit limbs.  At the
// kernel's edges it is the port's layout: 16 little-endian 16-bit limbs,
// limb-first, one int64 per limb (limb l of element e at x[l * n + e]),
// so each thread's loads and stores are coalesced across the warp.
// Products are 64-bit (mul.wide.u32); the high half is folded back with
// 2^256 = 2^32 + 977 (mod p) and the result is fully reduced (< p), so it
// equals the plain torch version (ecloop_tpu_torch/fel.py) bit for bit.
// The lazy forms at the end (K2 only) keep values below 2^256 instead.
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

// ---------------------------------------------------------------------------
// Lazy forms, for K2's prefix products and product tree only.  A lazy value is
// any 256-bit word vector congruent to the field element (below 2^256, not
// necessarily below p); fe_canon makes it canonical before a store.  Each
// carry chain is one PTX asm statement (mad.lo.cc / madc.hi.cc / addc.cc),
// since the carry flag does not survive from one asm statement to the
// next; the partial products are issued as independent rows and columns
// and summed afterwards.  K3 keeps the fully reduced fe_mul above, op for
// op like the plain version.

// r = (w[0..15] as a 512-bit value) mod p, lazily.  First X = lo + hi * 977
// + (hi << 32) < 2^289, in w[0..7] and (t8, t9); then the top (t8, t9) *
// (2^32 + 977) < 2^66 is added to w[0..2].  Only when that carries out of
// word 2 (about 1 in 2^30 values) does the carry run on to word 7 and, out
// of 2^256, come back as 2^32 + 977 (which cannot carry again): the
// branches are rare, and the chain thread is alone in its warp.
static __device__ __forceinline__ void fe_reduce_lazy(fe& r, uint32_t (&w)[16]) {
  const uint32_t k977 = 977;
  uint32_t t8 = 0, t9 = 0, s0 = 0, s1 = 0, s2 = 0, k = 0;
  asm volatile("mad.lo.cc.u32 %0, %10, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %12, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %13, %11, %2;\n\t"
      "madc.lo.cc.u32 %3, %14, %11, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %11, %4;\n\t"
      "madc.lo.cc.u32 %5, %16, %11, %5;\n\t"
      "madc.lo.cc.u32 %6, %17, %11, %6;\n\t"
      "madc.lo.cc.u32 %7, %18, %11, %7;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %12, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %13, %11, %3;\n\t"
      "madc.hi.cc.u32 %4, %14, %11, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %11, %5;\n\t"
      "madc.hi.cc.u32 %6, %16, %11, %6;\n\t"
      "madc.hi.cc.u32 %7, %17, %11, %7;\n\t"
      "madc.hi.u32 %8, %18, %11, %8;\n\t"
      "add.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %12;\n\t"
      "addc.cc.u32 %3, %3, %13;\n\t"
      "addc.cc.u32 %4, %4, %14;\n\t"
      "addc.cc.u32 %5, %5, %15;\n\t"
      "addc.cc.u32 %6, %6, %16;\n\t"
      "addc.cc.u32 %7, %7, %17;\n\t"
      "addc.cc.u32 %8, %8, %18;\n\t"
      "addc.u32 %9, 0, 0;\n\t"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]), "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(t8), "+r"(t9)
      : "r"(w[8]), "r"(k977), "r"(w[9]), "r"(w[10]), "r"(w[11]), "r"(w[12]), "r"(w[13]), "r"(w[14]), "r"(w[15]));
  asm volatile("mul.lo.u32 %0, %7, %8;\n\t"
      "mul.hi.u32 %1, %7, %8;\n\t"
      "add.cc.u32 %1, %1, %7;\n\t"
      "addc.u32 %2, %9, 0;\n\t"
      "mad.lo.cc.u32 %1, %9, %8, %1;\n\t"
      "addc.u32 %2, %2, 0;\n\t"
      "add.cc.u32 %3, %3, %0;\n\t"
      "addc.cc.u32 %4, %4, %1;\n\t"
      "addc.cc.u32 %5, %5, %2;\n\t"
      "addc.u32 %6, 0, 0;\n\t"
      : "+r"(s0), "+r"(s1), "+r"(s2), "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(k)
      : "r"(t8), "r"(k977), "r"(t9));
  if (k) {
    asm volatile("add.cc.u32 %0, %0, %1;\n\t"
        "addc.cc.u32 %2, %2, 0;\n\t"
        "addc.cc.u32 %3, %3, 0;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.u32 %1, 0, 0;\n\t"
        : "+r"(w[3]), "+r"(k), "+r"(w[4]), "+r"(w[5]), "+r"(w[6]), "+r"(w[7])
        : );
    if (k)
      asm volatile("mad.lo.cc.u32 %0, %3, %4, %0;\n\t"
          "addc.cc.u32 %1, %1, %3;\n\t"
          "addc.u32 %2, %2, 0;\n\t"
          : "+r"(w[0]), "+r"(w[1]), "+r"(w[2])
          : "r"(k), "r"(k977));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = w[i];
}

// acc[0..8] += (x0 + x1 2^64 + x2 2^128 + x3 2^192) * y: the products of
// one row that land on disjoint word pairs, as one 9-instruction chain.
static __device__ __forceinline__ void fe_mac_row(uint32_t* acc, uint32_t x0, uint32_t x1,
                                                  uint32_t x2, uint32_t x3, uint32_t y) {
  asm volatile("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]), "+r"(acc[4]),
        "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "+r"(acc[8])
      : "r"(x0), "r"(x1), "r"(x2), "r"(x3), "r"(y));
}

// r = a * b, lazily; 64 products.  Even words of a go to A (row i at word
// i), odd words to B (row i at word i + 1): two independent accumulators,
// each row one carry chain, summed at the end.  r may alias a or b.
static __device__ __forceinline__ void fe_mul_lazy(fe& r, const fe& a, const fe& b) {
  uint32_t A[16], B[17], c = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) A[i] = 0;
#pragma unroll
  for (int i = 0; i < 17; ++i) B[i] = 0;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    A[j] = a.v[j] * b.v[0];
    A[j + 1] = __umulhi(a.v[j], b.v[0]);
    B[j + 1] = a.v[j + 1] * b.v[0];
    B[j + 2] = __umulhi(a.v[j + 1], b.v[0]);
  }
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    fe_mac_row(A + i, a.v[0], a.v[2], a.v[4], a.v[6], b.v[i]);
    fe_mac_row(B + i + 1, a.v[1], a.v[3], a.v[5], a.v[7], b.v[i]);
  }
  // A += B over words 1..15 (B[16] is 0), the carry kept in c between the
  // two halves and put back into the flag by c + 0xFFFFFFFF
  asm volatile("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, 0, 0;\n\t"
      : "+r"(A[1]), "+r"(A[2]), "+r"(A[3]), "+r"(A[4]), "+r"(A[5]), "+r"(A[6]), "+r"(A[7]), "+r"(c)
      : "r"(B[1]), "r"(B[2]), "r"(B[3]), "r"(B[4]), "r"(B[5]), "r"(B[6]), "r"(B[7]));
  asm volatile("add.cc.u32 %0, %0, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.cc.u32 %7, %7, %15;\n\t"
      "addc.u32 %8, %8, %16;\n\t"
      : "+r"(c), "+r"(A[8]), "+r"(A[9]), "+r"(A[10]), "+r"(A[11]), "+r"(A[12]), "+r"(A[13]), "+r"(A[14]), "+r"(A[15])
      : "r"(B[8]), "r"(B[9]), "r"(B[10]), "r"(B[11]), "r"(B[12]), "r"(B[13]), "r"(B[14]), "r"(B[15]));
  fe_reduce_lazy(r, A);
}

// r = a mod p, canonical, for a lazy a < 2^256 (< 2p).  r may alias a.
static __device__ __forceinline__ void fe_canon(fe& r, const fe& a) {
  fe s;
  r = fe_add_pc(s, a) ? s : a;
}

// ---------------------------------------------------------------------------
// Bernstein-Yang "safegcd" inversion, variable time (divsteps in batches of
// 30 on the low words of f and g, with the eta trick that cancels several
// low bits of g at once).  Values are 9 signed 30-bit limbs; d and e stay in
// (-2p, p).  The result is the unique inverse, canonical.

constexpr int32_t M30 = 0x3FFFFFFF;
constexpr uint32_t PINV30 = 0x2DDACACFu;   // p^-1 mod 2^30

// limb i of p in signed 30-bit limbs
static __device__ __forceinline__ int32_t p30(int i) {
  return i == 0 ? 0x3FFFFC2F : i == 1 ? 0x3FFFFFFB : i == 8 ? 0xFFFF : 0x3FFFFFFF;
}

struct s30 { int32_t v[9]; };

// eta and the 2x2 matrix (times 2^30) of 30 divsteps on the low bits of f, g
static __device__ __forceinline__ int32_t s30_divsteps(int32_t eta, uint32_t f, uint32_t g,
                                                       int32_t& tu, int32_t& tv, int32_t& tq,
                                                       int32_t& tr) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    const int zeros = __ffs(g | (0xFFFFFFFFu << i)) - 1;
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {
      uint32_t tmp;
      eta = -eta;
      tmp = f; f = g; g = 0u - tmp;
      tmp = u; u = q; q = 0u - tmp;
      tmp = v; v = r; r = 0u - tmp;
    }
    const int limit = (eta + 1) > i ? i : (eta + 1);
    // w = -g / f mod 2^lim, lim <= 8; f odd
    const int lim = limit > 8 ? 8 : limit;
    uint32_t finv = f * (2u - f * f);  // f^-1 mod 2^6 (f * f = 1 mod 8), then 2^12
    finv *= 2u - f * finv;
    const uint32_t m = (0xFFFFFFFFu >> (32 - lim));
    const uint32_t w = (0u - g * finv) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  tu = (int32_t)u; tv = (int32_t)v; tq = (int32_t)q; tr = (int32_t)r;
  return eta;
}

// (d, e) <- (t [d, e] + p [md, me]) / 2^30, keeping both in (-2p, p)
static __device__ __forceinline__ void s30_update_de(s30& d, s30& e, int32_t u, int32_t v,
                                                     int32_t q, int32_t r) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((PINV30 * (uint32_t)cd + (uint32_t)md) & M30);
  me -= (int32_t)((PINV30 * (uint32_t)ce + (uint32_t)me) & M30);
  cd += (int64_t)p30(0) * md;
  ce += (int64_t)p30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const int32_t di = d.v[i], ei = e.v[i];
    cd += (int64_t)u * di + (int64_t)v * ei + (int64_t)p30(i) * md;
    ce += (int64_t)q * di + (int64_t)r * ei + (int64_t)p30(i) * me;
    d.v[i - 1] = (int32_t)cd & M30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & M30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30 (exact)
static __device__ __forceinline__ void s30_update_fg(s30& f, s30& g, int32_t u, int32_t v,
                                                     int32_t q, int32_t r) {
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    const int32_t fi = f.v[i], gi = g.v[i];
    cf += (int64_t)u * fi + (int64_t)v * gi;
    cg += (int64_t)q * fi + (int64_t)r * gi;
    f.v[i - 1] = (int32_t)cf & M30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & M30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// carry-normalise a signed-limb value: limbs 0..7 in [0, 2^30), limb 8 signed
static __device__ __forceinline__ void s30_carry(s30& a) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += a.v[i];
    a.v[i] = c & M30;
    c >>= 30;
  }
  a.v[8] += c;
}

static __device__ __forceinline__ void s30_add_p(s30& a, int32_t k) {
#pragma unroll
  for (int i = 0; i < 9; ++i) a.v[i] += k * p30(i);
  s30_carry(a);
}

static __device__ __forceinline__ bool s30_ge_p(const s30& a) {
  // a normalised, a >= 0
  for (int i = 8; i >= 0; --i) {
    if (a.v[i] != p30(i)) return a.v[i] > p30(i);
  }
  return true;
}

// r = a^-1 mod p for a canonical a != 0.  r may alias a.
static __device__ __forceinline__ void fe_inv_var(fe& r, const fe& a) {
  s30 f, g, d, e;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    f.v[i] = p30(i);
    d.v[i] = 0;
    e.v[i] = 0;
    // bits 30i .. 30i + 29 of a
    const int b = 30 * i, w = b >> 5, s = b & 31;
    uint32_t lo = w < 8 ? a.v[w] >> s : 0;
    if (s > 2 && w + 1 < 8) lo |= a.v[w + 1] << (32 - s);
    g.v[i] = (int32_t)(lo & M30);
  }
  e.v[0] = 1;
  int32_t eta = -1;
  for (;;) {
    int32_t tu, tv, tq, tr;
    eta = s30_divsteps(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], tu, tv, tq, tr);
    s30_update_de(d, e, tu, tv, tq, tr);
    s30_update_fg(f, g, tu, tv, tq, tr);
    if (g.v[0] == 0) {
      int32_t any = 0;
#pragma unroll
      for (int i = 1; i < 9; ++i) any |= g.v[i];
      if (any == 0) break;
    }
  }
  // f = +-1; d in (-2p, p): r = d * f mod p
  if (f.v[8] < 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = -d.v[i];
  }
  s30_carry(d);
  while (d.v[8] < 0) s30_add_p(d, 1);
  while (s30_ge_p(d)) s30_add_p(d, -1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = 32 * i, l = b / 30, s = b % 30;
    uint32_t w = (uint32_t)d.v[l] >> s;
    w |= (uint32_t)d.v[l + 1] << (30 - s);
    if (s > 28 && l + 2 < 9) w |= (uint32_t)d.v[l + 2] << (60 - s);
    r.v[i] = w;
  }
}

}  // namespace ecl
