"""Pure-Python golden model of secp256k1 and hash160: the port's host
oracle.

Arbitrary-precision integer math for the rare host-side work (found-key
re-derivation, table base points, range bookkeeping) and for checking
the device results.  The port's own copy of `ecloop_tpu.golden`'s curve,
hash and endomorphism parts, so that the port imports nothing of the JAX
package; `tests/test_torch_package.py` holds the two equal.
"""

from __future__ import annotations

import hashlib

# --- secp256k1 domain parameters -------------------------------------------

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C465_5DA4FBFC0E1108A8_FD17B448A6855419_9C47D08FFB10D4B8

# GLV endomorphism: lambda (mod N) scalars and beta (mod P) field constants.
# phi(x, y) = (beta*x, y) corresponds to k -> lambda*k.
# (standard secp256k1 constants)
LAMBDA1 = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
LAMBDA2 = pow(LAMBDA1, 2, N)
BETA1 = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
BETA2 = pow(BETA1, 2, P)


def inv_mod(a: int, m: int = P) -> int:
    return pow(a, m - 2, m)


# --- point arithmetic (affine, None = point at infinity) --------------------

Point = tuple[int, int] | None
G: Point = (GX, GY)


def point_add(p: Point, q: Point) -> Point:
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return point_dbl(p)
    lam = (y2 - y1) * inv_mod(x2 - x1) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_dbl(p: Point) -> Point:
    if p is None:
        return None
    x1, y1 = p
    if y1 == 0:
        return None
    lam = (3 * x1 * x1) * inv_mod(2 * y1) % P
    x3 = (lam * lam - 2 * x1) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def point_neg(p: Point) -> Point:
    if p is None:
        return None
    return (p[0], (-p[1]) % P)


def point_mul(k: int, p: Point = G) -> Point:
    k %= N
    r: Point = None
    while k:
        if k & 1:
            r = point_add(r, p)
        p = point_dbl(p)
        k >>= 1
    return r


def on_curve(p: Point) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 7)) % P == 0


# --- RIPEMD-160 (pure python, RFC/ISO standard) -----------------------------

_RMD_R1 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
           7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
           3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
           1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
           4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_RMD_R2 = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
           6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
           15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
           8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
           12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_RMD_S1 = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
           7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
           11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
           11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
           9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_RMD_S2 = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
           9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
           9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
           15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
           8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_RMD_K1 = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_RMD_K2 = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_RMD_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)

_M32 = 0xFFFFFFFF


def _rol(x: int, n: int) -> int:
    x &= _M32
    return ((x << n) | (x >> (32 - n))) & _M32


def _rmd_f(j: int, x: int, y: int, z: int) -> int:
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | (~x & z) & _M32
    if j < 48:
        return (x | ~y & _M32) ^ z
    if j < 64:
        return (x & z) | (y & ~z & _M32)
    return x ^ (y | ~z & _M32)


def ripemd160(data: bytes) -> bytes:
    msg = bytearray(data)
    bitlen = len(data) * 8
    msg.append(0x80)
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += bitlen.to_bytes(8, "little")

    h = list(_RMD_IV)
    for off in range(0, len(msg), 64):
        x = [int.from_bytes(msg[off + 4 * i: off + 4 * i + 4], "little")
             for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            t = (al + _rmd_f(j, bl, cl, dl) + x[_RMD_R1[j]] + _RMD_K1[j // 16]) & _M32
            t = (_rol(t, _RMD_S1[j]) + el) & _M32
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t
            t = (ar + _rmd_f(79 - j, br, cr, dr) + x[_RMD_R2[j]] + _RMD_K2[j // 16]) & _M32
            t = (_rol(t, _RMD_S2[j]) + er) & _M32
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t
        t = (h[1] + cl + dr) & _M32
        h = [t,
             (h[2] + dl + er) & _M32,
             (h[3] + el + ar) & _M32,
             (h[4] + al + br) & _M32,
             (h[0] + bl + cr) & _M32]
    return b"".join(v.to_bytes(4, "little") for v in h)


# --- address / hash160 pipeline ---------------------------------------------

def serialize33(p: Point) -> bytes:
    x, y = p
    return bytes([0x03 if y & 1 else 0x02]) + x.to_bytes(32, "big")


def serialize65(p: Point) -> bytes:
    x, y = p
    return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")


def hash160(data: bytes) -> bytes:
    return ripemd160(hashlib.sha256(data).digest())


def addr33(p: Point) -> bytes:
    """hash160 of the compressed pubkey."""
    return hash160(serialize33(p))


def addr65(p: Point) -> bytes:
    """hash160 of the uncompressed pubkey."""
    return hash160(serialize65(p))


# --- endomorphism expansion --------------------------------------------------

def endo_points(p: Point) -> list[Point]:
    """The 6 GLV-related candidates, indexed 0..5 like the reference."""
    x, y = p
    ny = (-y) % P
    bx = BETA1 * x % P
    b2x = BETA2 * x % P
    return [(x, y), (x, ny), (bx, y), (bx, ny), (b2x, y), (b2x, ny)]


def endo_priv(k: int, endo: int) -> int:
    """Recover the private key of endo_points(k*G)[endo]."""
    if endo == 0:
        return k % N
    if endo == 1:
        return (-k) % N
    if endo == 2:
        return k * LAMBDA1 % N
    if endo == 3:
        return (-k * LAMBDA1) % N
    if endo == 4:
        return k * LAMBDA2 % N
    if endo == 5:
        return (-k * LAMBDA2) % N
    raise ValueError(endo)
