"""hash160 (SHA-256 -> RIPEMD-160) of serialized pubkeys, on torch rows.

The plain version of the K1 kernel (`csrc/hash160.cu`).  A point batch
is two (16, ...) limb tensors (`fel`); the pubkey bytes never exist:
the limbs are shifted straight into SHA message words.

  * addr33: one 64-byte SHA block [02|03, x_be, 0x80 pad, bitlen 264]
  * addr65: two blocks            [04, x_be, y_be, 0x80 pad, bitlen 520]
  * RIPEMD message = SHA digest bytes + 0x80 + bitlen 256
  * output: (5, ...) words in big-endian print order

Words are int64 values below 2^32; every add, left shift and rotate is
masked back to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF

SHA_K = (
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
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2)
SHA_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

# RIPEMD-160 schedule and rotation tables (ISO/IEC 10118-3)
RMD_R1 = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
          7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
          3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
          1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
          4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13)
RMD_R2 = (5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
          6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
          15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
          8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
          12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11)
RMD_S1 = (11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
          7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
          11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
          11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
          9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6)
RMD_S2 = (8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
          9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
          9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
          15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
          8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11)
RMD_K1 = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
RMD_K2 = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
RMD_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _rotl(x, n: int):
    return ((x << n) | (x >> (32 - n))) & M32


def byteswap32(x):
    return (((x >> 24) & 0xFF) | ((x >> 8) & 0xFF00)
            | ((x << 8) & 0xFF0000) | ((x << 24) & 0xFF000000))


# --- SHA-256 ---------------------------------------------------------------------

def sha256_compress(w, state=None):
    """One compression: w is 16 word rows, state 8 rows (None: the IV).
    Returns 8 rows."""
    if state is None:
        state = [torch.full_like(w[0], v) for v in SHA_IV]
    w = list(w)
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + SHA_K[i] + w[i]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    return [(u + v) & M32 for u, v in zip(state, (a, b, c, d, e, f, g, h))]


# --- RIPEMD-160 ------------------------------------------------------------------

def _rmd_f(g: int, x, y, z):
    if g == 0:
        return x ^ y ^ z
    if g == 1:
        return (x & y) | (~x & z)
    if g == 2:
        return ((x | ~y) ^ z) & M32
    if g == 3:
        return (x & z) | (y & ~z)
    return (x ^ (y | ~z)) & M32


def rmd160_compress(x):
    """One compression of 16 little-endian word rows -> 5 state rows."""
    h = [torch.full_like(x[0], v) for v in RMD_IV]
    al, bl, cl, dl, el = h
    ar, br, cr, dr, er = h
    for i in range(80):
        g = i // 16
        t = (al + _rmd_f(g, bl, cl, dl) + x[RMD_R1[i]] + RMD_K1[g]) & M32
        t = (_rotl(t, RMD_S1[i]) + el) & M32
        al, el, dl, cl, bl = el, dl, _rotl(cl, 10), bl, t
        t = (ar + _rmd_f(4 - g, br, cr, dr) + x[RMD_R2[i]] + RMD_K2[g]) & M32
        t = (_rotl(t, RMD_S2[i]) + er) & M32
        ar, er, dr, cr, br = er, dr, _rotl(cr, 10), br, t
    return [(h[1] + cl + dr) & M32, (h[2] + dl + er) & M32,
            (h[3] + el + ar) & M32, (h[4] + al + br) & M32,
            (h[0] + bl + cr) & M32]


# --- serialization from limbs ------------------------------------------------------

def rows_to_be_words(rows):
    """16 little-endian 16-bit limb rows -> 8 big-endian 32-bit word rows."""
    return [(rows[15 - 2 * i] << 16) | rows[14 - 2 * i] for i in range(8)]


def msg33_rows(x, y):
    xw = rows_to_be_words(x)
    ws = [((2 | (y[0] & 1)) << 24) | (xw[0] >> 8)]
    for i in range(1, 8):
        ws.append(((xw[i - 1] << 24) & M32) | (xw[i] >> 8))
    ws.append(((xw[7] << 24) & M32) | 0x00800000)
    zero = torch.zeros_like(ws[0])
    return ws + [zero] * 6 + [torch.full_like(ws[0], 264)]


def msg65_rows(x, y):
    xw = rows_to_be_words(x)
    yw = rows_to_be_words(y)
    ws = [(0x04 << 24) | (xw[0] >> 8)]
    for i in range(1, 8):
        ws.append(((xw[i - 1] << 24) & M32) | (xw[i] >> 8))
    ws.append(((xw[7] << 24) & M32) | (yw[0] >> 8))
    for i in range(1, 8):
        ws.append(((yw[i - 1] << 24) & M32) | (yw[i] >> 8))
    w16 = ((yw[7] << 24) & M32) | 0x00800000
    zero = torch.zeros_like(w16)
    return ws, [w16] + [zero] * 14 + [torch.full_like(w16, 520)]


def _sha_to_rmd_msg(st):
    """SHA digest words -> the 16-word RIPEMD message with its padding."""
    le = [byteswap32(s) for s in st]
    zero = torch.zeros_like(le[0])
    return le + [torch.full_like(le[0], 0x80), zero, zero, zero, zero, zero,
                 torch.full_like(le[0], 256), zero]


def _hash160_from_sha(st):
    rmd = rmd160_compress(_sha_to_rmd_msg(st))
    return torch.stack([byteswap32(v) for v in rmd])


def addr33_hash_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hash160 of compressed pubkeys: (16, ...) limbs -> (5, ...) words."""
    return _hash160_from_sha(sha256_compress(msg33_rows(x, y)))


def addr65_hash_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hash160 of uncompressed pubkeys: (16, ...) limbs -> (5, ...) words."""
    b1, b2 = msg65_rows(x, y)
    return _hash160_from_sha(sha256_compress(b2, sha256_compress(b1)))
