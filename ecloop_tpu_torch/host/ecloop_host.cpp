// Native host runtime for ecloop-tpu.
//
// The TPU owns the compute path (JAX/XLA kernels); this library owns the
// host-side runtime work around it, mirroring the roles the reference
// implements in C (SURVEY.md §2.3/§2.5): bloom filter build/probe
// (reference lib/utils.c:272-475 semantics), exact sorted-list membership
// (main.c:205-217), bulk hex parsing of filter/key files, and an
// independent secp256k1 + SHA-256 + RIPEMD-160 oracle used to verify
// device-reported hits from scratch (the pk_verify_hash property,
// main.c:248-263). Written fresh for this project: 4x64 limbs with
// unsigned __int128 accumulation, Fermat inversion, Jacobian
// double-and-add — structured for clarity, not a port of the reference's
// carry-intrinsic chains.
//
// Exposed as extern "C" and loaded from Python via ctypes
// (ecloop_tpu/native.py); every entry point has a pure-Python fallback.

#include <cstdint>
#include <cstring>
#include <cstddef>

typedef uint64_t u64;
typedef uint32_t u32;
typedef uint8_t u8;
typedef unsigned __int128 u128;

// ============================== 256-bit field ==============================

struct Fe {
  u64 d[4];  // little-endian limbs
};

static const Fe FE_ZERO = {{0, 0, 0, 0}};

// secp256k1 prime p = 2^256 - 2^32 - 977
static const Fe FE_P = {{0xFFFFFFFEFFFFFC2FULL, 0xFFFFFFFFFFFFFFFFULL,
                         0xFFFFFFFFFFFFFFFFULL, 0xFFFFFFFFFFFFFFFFULL}};
// curve order n
static const Fe FE_N = {{0xBFD25E8CD0364141ULL, 0xBAAEDCE6AF48A03BULL,
                         0xFFFFFFFFFFFFFFFEULL, 0xFFFFFFFFFFFFFFFFULL}};

static inline bool fe_is_zero(const Fe &a) {
  return (a.d[0] | a.d[1] | a.d[2] | a.d[3]) == 0;
}

static inline int fe_cmp(const Fe &a, const Fe &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.d[i] < b.d[i]) return -1;
    if (a.d[i] > b.d[i]) return 1;
  }
  return 0;
}

// a + b -> r, returns carry
static inline u64 fe_add_raw(Fe &r, const Fe &a, const Fe &b) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.d[i] + b.d[i];
    r.d[i] = (u64)c;
    c >>= 64;
  }
  return (u64)c;
}

// a - b -> r, returns borrow
static inline u64 fe_sub_raw(Fe &r, const Fe &a, const Fe &b) {
  u128 br = 0;
  for (int i = 0; i < 4; ++i) {
    u128 t = (u128)a.d[i] - b.d[i] - br;
    r.d[i] = (u64)t;
    br = (t >> 64) & 1;
  }
  return (u64)br;
}

static inline void fe_mod_add(Fe &r, const Fe &a, const Fe &b, const Fe &m) {
  u64 carry = fe_add_raw(r, a, b);
  Fe t;
  u64 borrow = fe_sub_raw(t, r, m);
  if (carry || !borrow) r = t;
}

static inline void fe_mod_sub(Fe &r, const Fe &a, const Fe &b, const Fe &m) {
  if (fe_sub_raw(r, a, b)) {
    Fe t;
    fe_add_raw(t, r, m);
    r = t;
  }
}

// full 256x256 -> 512 product
static inline void fe_mul_wide(u64 w[8], const Fe &a, const Fe &b) {
  memset(w, 0, 8 * sizeof(u64));
  for (int i = 0; i < 4; ++i) {
    u64 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 t = (u128)a.d[i] * b.d[j] + w[i + j] + carry;
      w[i + j] = (u64)t;
      carry = (u64)(t >> 64);
    }
    w[i + 4] = carry;
  }
}

// reduce 512-bit w mod p using p = 2^256 - C, C = 0x1000003D1
static void fe_reduce_p(Fe &r, const u64 w[8]) {
  const u64 C = 0x1000003D1ULL;
  // fold hi*C into lo -> 5-limb value
  u64 t[5] = {w[0], w[1], w[2], w[3], 0};
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 v = (u128)w[4 + i] * C + t[i] + carry;
    t[i] = (u64)v;
    carry = (u64)(v >> 64);
  }
  t[4] = carry;
  // fold t[4]*C once more (t[4] < 2^34)
  u128 v = (u128)t[4] * C + t[0];
  r.d[0] = (u64)v;
  u64 c2 = (u64)(v >> 64);
  for (int i = 1; i < 4; ++i) {
    u128 s = (u128)t[i] + c2;
    r.d[i] = (u64)s;
    c2 = (u64)(s >> 64);
  }
  if (c2) {  // one more tiny fold (extremely rare)
    u128 s = (u128)r.d[0] + C;
    r.d[0] = (u64)s;
    u64 c3 = (u64)(s >> 64);
    for (int i = 1; i < 4 && c3; ++i) {
      u128 q = (u128)r.d[i] + c3;
      r.d[i] = (u64)q;
      c3 = (u64)(q >> 64);
    }
  }
  Fe s;
  if (!fe_sub_raw(s, r, FE_P)) r = s;
}

static inline void fe_mul(Fe &r, const Fe &a, const Fe &b) {
  u64 w[8];
  fe_mul_wide(w, a, b);
  fe_reduce_p(r, w);
}

static inline void fe_sqr(Fe &r, const Fe &a) { fe_mul(r, a, a); }

// Fermat inversion a^(p-2) via simple MSB-first square-and-multiply
static void fe_inv(Fe &r, const Fe &a) {
  // e = p - 2
  Fe e = FE_P;
  e.d[0] -= 2;
  Fe acc = {{1, 0, 0, 0}};
  for (int bit = 255; bit >= 0; --bit) {
    fe_sqr(acc, acc);
    if ((e.d[bit >> 6] >> (bit & 63)) & 1) fe_mul(acc, acc, a);
  }
  r = acc;
}

// ============================== EC point ops ==============================

struct Pt {
  Fe x, y, z;  // Jacobian; infinity <=> z == 0
};

static const Fe G_X = {{0x59F2815B16F81798ULL, 0x029BFCDB2DCE28D9ULL,
                        0x55A06295CE870B07ULL, 0x79BE667EF9DCBBACULL}};
static const Fe G_Y = {{0x9C47D08FFB10D4B8ULL, 0xFD17B448A6855419ULL,
                        0x5DA4FBFC0E1108A8ULL, 0x483ADA7726A3C465ULL}};

static void pt_dbl(Pt &r, const Pt &p) {
  if (fe_is_zero(p.z) || fe_is_zero(p.y)) {
    r.x = r.y = {{1, 0, 0, 0}};
    r.z = FE_ZERO;
    return;
  }
  Fe ysq, s, m, t;
  fe_sqr(ysq, p.y);                       // y^2
  fe_mul(s, p.x, ysq);                    // x*y^2
  fe_mod_add(s, s, s, FE_P);
  fe_mod_add(s, s, s, FE_P);              // s = 4*x*y^2
  fe_sqr(m, p.x);
  fe_mod_add(t, m, m, FE_P);
  fe_mod_add(m, t, m, FE_P);              // m = 3*x^2 (a = 0)
  Fe x3, y3, z3;
  fe_sqr(x3, m);
  fe_mod_sub(x3, x3, s, FE_P);
  fe_mod_sub(x3, x3, s, FE_P);            // x3 = m^2 - 2s
  Fe ysq2;
  fe_sqr(ysq2, ysq);                       // y^4
  fe_mod_add(ysq2, ysq2, ysq2, FE_P);
  fe_mod_add(ysq2, ysq2, ysq2, FE_P);
  fe_mod_add(ysq2, ysq2, ysq2, FE_P);     // 8*y^4
  fe_mod_sub(t, s, x3, FE_P);
  fe_mul(y3, m, t);
  fe_mod_sub(y3, y3, ysq2, FE_P);         // y3 = m(s - x3) - 8y^4
  fe_mul(z3, p.y, p.z);
  fe_mod_add(z3, z3, z3, FE_P);           // z3 = 2yz
  r.x = x3; r.y = y3; r.z = z3;
}

static void pt_add(Pt &r, const Pt &p, const Pt &q) {
  if (fe_is_zero(p.z)) { r = q; return; }
  if (fe_is_zero(q.z)) { r = p; return; }
  Fe z1z1, z2z2, u1, u2, s1, s2;
  fe_sqr(z1z1, p.z);
  fe_sqr(z2z2, q.z);
  fe_mul(u1, p.x, z2z2);
  fe_mul(u2, q.x, z1z1);
  Fe t;
  fe_mul(t, q.z, z2z2);
  fe_mul(s1, p.y, t);
  fe_mul(t, p.z, z1z1);
  fe_mul(s2, q.y, t);
  Fe h, rr;
  fe_mod_sub(h, u2, u1, FE_P);
  fe_mod_sub(rr, s2, s1, FE_P);
  if (fe_is_zero(h)) {
    if (fe_is_zero(rr)) { pt_dbl(r, p); return; }
    r.x = r.y = {{1, 0, 0, 0}};
    r.z = FE_ZERO;
    return;
  }
  Fe h2, h3, u1h2;
  fe_sqr(h2, h);
  fe_mul(h3, h2, h);
  fe_mul(u1h2, u1, h2);
  Fe x3, y3, z3;
  fe_sqr(x3, rr);
  fe_mod_sub(x3, x3, h3, FE_P);
  fe_mod_sub(x3, x3, u1h2, FE_P);
  fe_mod_sub(x3, x3, u1h2, FE_P);         // x3 = r^2 - h^3 - 2*u1*h^2
  fe_mod_sub(t, u1h2, x3, FE_P);
  fe_mul(y3, rr, t);
  fe_mul(t, s1, h3);
  fe_mod_sub(y3, y3, t, FE_P);            // y3 = r(u1h2 - x3) - s1*h^3
  fe_mul(t, p.z, q.z);
  fe_mul(z3, t, h);                        // z3 = z1*z2*h
  r.x = x3; r.y = y3; r.z = z3;
}

// k*G -> affine (x, y); returns 0 for k == 0 mod n (infinity)
static int pt_mul_g(Fe &ox, Fe &oy, const Fe &k) {
  Pt acc;
  acc.x = acc.y = {{1, 0, 0, 0}};
  acc.z = FE_ZERO;
  Pt base;
  base.x = G_X; base.y = G_Y; base.z = {{1, 0, 0, 0}};
  for (int bit = 0; bit < 256; ++bit) {
    if ((k.d[bit >> 6] >> (bit & 63)) & 1) pt_add(acc, acc, base);
    pt_dbl(base, base);
  }
  if (fe_is_zero(acc.z)) return 0;
  Fe zi, zi2, zi3;
  fe_inv(zi, acc.z);
  fe_sqr(zi2, zi);
  fe_mul(zi3, zi2, zi);
  fe_mul(ox, acc.x, zi2);
  fe_mul(oy, acc.y, zi3);
  return 1;
}

// =============================== SHA-256 ===================================

static const u32 SHA_K[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2};

static inline u32 rotr32(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha256_block(u32 st[8], const u8 *blk) {
  u32 w[64];
  for (int i = 0; i < 16; ++i)
    w[i] = ((u32)blk[4 * i] << 24) | ((u32)blk[4 * i + 1] << 16) |
           ((u32)blk[4 * i + 2] << 8) | blk[4 * i + 3];
  for (int i = 16; i < 64; ++i) {
    u32 s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
    u32 s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  u32 a = st[0], b = st[1], c = st[2], d = st[3];
  u32 e = st[4], f = st[5], g = st[6], h = st[7];
  for (int i = 0; i < 64; ++i) {
    u32 s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = h + s1 + ch + SHA_K[i] + w[i];
    u32 s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    u32 maj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

static void sha256(const u8 *msg, size_t len, u8 out[32]) {
  u32 st[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
               0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};
  size_t i = 0;
  for (; i + 64 <= len; i += 64) sha256_block(st, msg + i);
  u8 tail[128] = {0};
  size_t rem = len - i;
  memcpy(tail, msg + i, rem);
  tail[rem] = 0x80;
  size_t tlen = (rem < 56) ? 64 : 128;
  u64 bits = (u64)len * 8;
  for (int j = 0; j < 8; ++j) tail[tlen - 1 - j] = (u8)(bits >> (8 * j));
  sha256_block(st, tail);
  if (tlen == 128) sha256_block(st, tail + 64);
  for (int j = 0; j < 8; ++j) {
    out[4 * j] = (u8)(st[j] >> 24);
    out[4 * j + 1] = (u8)(st[j] >> 16);
    out[4 * j + 2] = (u8)(st[j] >> 8);
    out[4 * j + 3] = (u8)st[j];
  }
}

// ============================== RIPEMD-160 =================================

static const u8 RMD_R1[80] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
static const u8 RMD_R2[80] = {
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
static const u8 RMD_S1[80] = {
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
static const u8 RMD_S2[80] = {
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};

static inline u32 rotl32(u32 x, int n) { return (x << n) | (x >> (32 - n)); }

static inline u32 rmd_f(int g, u32 x, u32 y, u32 z) {
  switch (g) {
    case 0: return x ^ y ^ z;
    case 1: return (x & y) | (~x & z);
    case 2: return (x | ~y) ^ z;
    case 3: return (x & z) | (y & ~z);
    default: return x ^ (y | ~z);
  }
}

static void rmd160_block(u32 st[5], const u8 *blk) {
  static const u32 K1[5] = {0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC,
                            0xA953FD4E};
  static const u32 K2[5] = {0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9,
                            0x00000000};
  u32 x[16];
  for (int i = 0; i < 16; ++i)
    x[i] = (u32)blk[4 * i] | ((u32)blk[4 * i + 1] << 8) |
           ((u32)blk[4 * i + 2] << 16) | ((u32)blk[4 * i + 3] << 24);
  u32 al = st[0], bl = st[1], cl = st[2], dl = st[3], el = st[4];
  u32 ar = al, br = bl, cr = cl, dr = dl, er = el;
  for (int i = 0; i < 80; ++i) {
    int g = i / 16;
    u32 t = al + rmd_f(g, bl, cl, dl) + x[RMD_R1[i]] + K1[g];
    t = rotl32(t, RMD_S1[i]) + el;
    al = el; el = dl; dl = rotl32(cl, 10); cl = bl; bl = t;
    t = ar + rmd_f(4 - g, br, cr, dr) + x[RMD_R2[i]] + K2[g];
    t = rotl32(t, RMD_S2[i]) + er;
    ar = er; er = dr; dr = rotl32(cr, 10); cr = br; br = t;
  }
  u32 t = st[1] + cl + dr;
  st[1] = st[2] + dl + er;
  st[2] = st[3] + el + ar;
  st[3] = st[4] + al + br;
  st[4] = st[0] + bl + cr;
  st[0] = t;
}

static void ripemd160_32(const u8 digest32[32], u8 out20[20]) {
  // single-block RMD of a 32-byte message (the SHA digest)
  u32 st[5] = {0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0};
  u8 blk[64] = {0};
  memcpy(blk, digest32, 32);
  blk[32] = 0x80;
  blk[56] = 0x00;  // bitlen 256 little-endian in bytes 56..63
  blk[57] = 0x01;
  rmd160_block(st, blk);
  for (int i = 0; i < 5; ++i) {
    out20[4 * i] = (u8)st[i];
    out20[4 * i + 1] = (u8)(st[i] >> 8);
    out20[4 * i + 2] = (u8)(st[i] >> 16);
    out20[4 * i + 3] = (u8)(st[i] >> 24);
  }
}

// ============================== public API ================================

extern "C" {

// hash160 of an arbitrary serialized pubkey (33 or 65 bytes)
void ecl_hash160(const u8 *pub, size_t len, u8 out20[20]) {
  u8 dig[32];
  sha256(pub, len, dig);
  ripemd160_32(dig, out20);
}

// raw SHA-256 (used for -raw key derivation checks)
void ecl_sha256(const u8 *msg, size_t len, u8 out32[32]) {
  sha256(msg, len, out32);
}

// k (32 bytes big-endian) * G -> x||y (64 bytes big-endian). 0 if infinity.
int ecl_ec_mul_g(const u8 k_be[32], u8 out_xy[64]) {
  Fe k;
  for (int i = 0; i < 4; ++i) {
    u64 v = 0;
    for (int j = 0; j < 8; ++j) v = (v << 8) | k_be[(3 - i) * 8 + j];
    k.d[i] = v;
  }
  Fe x, y;
  if (!pt_mul_g(x, y, k)) return 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j) {
      out_xy[(3 - i) * 8 + j] = (u8)(x.d[i] >> (8 * (7 - j)));
      out_xy[32 + (3 - i) * 8 + j] = (u8)(y.d[i] >> (8 * (7 - j)));
    }
  return 1;
}

// hash160 of k*G, compressed (comp=1) or uncompressed: the full
// independent hit-verification oracle. Returns 0 for infinity.
int ecl_pk_hash160(const u8 k_be[32], int comp, u8 out20[20]) {
  u8 xy[64];
  if (!ecl_ec_mul_g(k_be, xy)) return 0;
  u8 pub[65];
  if (comp) {
    pub[0] = (xy[63] & 1) ? 0x03 : 0x02;
    memcpy(pub + 1, xy, 32);
    ecl_hash160(pub, 33, out20);
  } else {
    pub[0] = 0x04;
    memcpy(pub + 1, xy, 64);
    ecl_hash160(pub, 65, out20);
  }
  return 1;
}

// ------------------------------- bloom ------------------------------------
// Same arithmetic probe derivation as the reference (utils.c:290-326):
// five overlapping u64s x four shifts {24,28,36,40} -> 20 bit indices.

static inline void bloom_indices(const u32 h[5], u64 nbits, u64 idx[20]) {
  u64 a[5] = {((u64)h[0] << 32) | h[1], ((u64)h[2] << 32) | h[3],
              ((u64)h[4] << 32) | h[0], ((u64)h[1] << 32) | h[2],
              ((u64)h[3] << 32) | h[4]};
  static const int SH[4] = {24, 28, 36, 40};
  int k = 0;
  for (int s = 0; s < 4; ++s)
    for (int i = 0; i < 5; ++i)
      idx[k++] = ((a[i] << SH[s]) | (a[(i + 1) % 5] >> SH[s])) % nbits;
}

void ecl_bloom_add(u64 *bits, u64 size_words, const u32 *hashes, size_t n) {
  u64 nbits = size_words * 64, idx[20];
  for (size_t r = 0; r < n; ++r) {
    bloom_indices(hashes + 5 * r, nbits, idx);
    for (int k = 0; k < 20; ++k)
      bits[idx[k] >> 6] |= 1ULL << (idx[k] & 63);
  }
}

void ecl_bloom_has(const u64 *bits, u64 size_words, const u32 *hashes,
                   size_t n, u8 *out) {
  u64 nbits = size_words * 64, idx[20];
  for (size_t r = 0; r < n; ++r) {
    bloom_indices(hashes + 5 * r, nbits, idx);
    u8 hit = 1;
    for (int k = 0; k < 20 && hit; ++k)
      hit = (bits[idx[k] >> 6] >> (idx[k] & 63)) & 1;
    out[r] = hit;
  }
}

// --------------------------- sorted-list search ----------------------------
// list: n rows of 5 big-endian-ordered u32 words, sorted lexicographically.

static inline int cmp160(const u32 *a, const u32 *b) {
  for (int i = 0; i < 5; ++i) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

int64_t ecl_list_search(const u32 *list, size_t n, const u32 h[5]) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = lo + (hi - lo) / 2;
    int c = cmp160(list + 5 * mid, h);
    if (c == 0) return (int64_t)mid;
    if (c < 0) lo = mid + 1;
    else hi = mid;
  }
  return -1;
}

void ecl_list_search_batch(const u32 *list, size_t n, const u32 *hs,
                           size_t count, u8 *out) {
  for (size_t i = 0; i < count; ++i)
    out[i] = ecl_list_search(list, n, hs + 5 * i) >= 0;
}

// ------------------------------ hex parsing --------------------------------

static inline int hexval(char c) {
  if (c >= '0' && c <= '9') return c - '0';
  if (c >= 'a' && c <= 'f') return c - 'a' + 10;
  if (c >= 'A' && c <= 'F') return c - 'A' + 10;
  return -1;
}

// parse 40-hex-char lines into u32[5] rows; skips malformed lines.
// Returns number of rows written (<= max_rows).
size_t ecl_parse_h160_lines(const char *text, size_t len, u32 *out,
                            size_t max_rows) {
  size_t rows = 0, i = 0;
  while (i < len && rows < max_rows) {
    size_t j = i;
    while (j < len && text[j] != '\n') ++j;
    size_t a = i, b = j;
    while (a < b && (text[a] == ' ' || text[a] == '\t' || text[a] == '\r'))
      ++a;
    while (b > a && (text[b - 1] == ' ' || text[b - 1] == '\t' ||
                     text[b - 1] == '\r'))
      --b;
    if (b - a == 40) {
      u32 w[5] = {0, 0, 0, 0, 0};
      bool ok = true;
      for (int c = 0; c < 40 && ok; ++c) {
        int v = hexval(text[a + c]);
        if (v < 0) ok = false;
        else w[c / 8] = (w[c / 8] << 4) | (u32)v;
      }
      if (ok) {
        memcpy(out + 5 * rows, w, sizeof(w));
        ++rows;
      }
    }
    i = j + 1;
  }
  return rows;
}

// parse hex private-key lines (any length <= 64 hex chars) into 32-byte
// big-endian rows; skips malformed/empty lines.
size_t ecl_parse_key_lines(const char *text, size_t len, u8 *out,
                           size_t max_rows) {
  size_t rows = 0, i = 0;
  while (i < len && rows < max_rows) {
    size_t j = i;
    while (j < len && text[j] != '\n') ++j;
    size_t a = i, b = j;
    while (a < b && (text[a] == ' ' || text[a] == '\t' || text[a] == '\r'))
      ++a;
    while (b > a && (text[b - 1] == ' ' || text[b - 1] == '\t' ||
                     text[b - 1] == '\r'))
      --b;
    size_t nlen = b - a;
    if (nlen > 0 && nlen <= 64) {
      u8 key[32] = {0};
      bool ok = true;
      // right-align hex digits into the 32-byte value
      for (size_t c = 0; c < nlen && ok; ++c) {
        int v = hexval(text[b - 1 - c]);
        if (v < 0) ok = false;
        else key[31 - c / 2] |= (u8)(v << (4 * (c & 1)));
      }
      if (ok) {
        memcpy(out + 32 * rows, key, 32);
        ++rows;
      }
    }
    i = j + 1;
  }
  return rows;
}

}  // extern "C"
