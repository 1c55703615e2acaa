"""secp256k1 in plain Python: k*G by a table of 2^i * G and Jacobian
mixed additions, the compressed and uncompressed pubkeys' hash160, and
the GLV endomorphism's private keys (SEC 2, section 2.4.1; the beta and
lambda constants of libsecp256k1).

The benchmark's own copy: it imports nothing of the program.
"""

from __future__ import annotations

from . import hashes

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
# (beta x, y) = lambda * (x, y)
LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE


def _affine_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % P == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, P) % P
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, P) % P
    x = (lam * lam - p[0] - q[0]) % P
    return x, (lam * (p[0] - x) - p[1]) % P


def _table():
    out, p = [], (GX, GY)
    for _ in range(256):
        out.append(p)
        p = _affine_add(p, p)
    return out


_G_POW2 = _table()          # 2^i * G, affine


def _jac_double(x, y, z):
    if y == 0:
        return 0, 1, 0
    s = 4 * x * y * y % P
    m = 3 * x * x % P
    x3 = (m * m - 2 * s) % P
    return x3, (m * (s - x3) - 8 * pow(y, 4, P)) % P, 2 * y * z % P


def _jac_add_affine(x, y, z, qx, qy):
    if z == 0:
        return qx, qy, 1
    z2 = z * z % P
    u2 = qx * z2 % P
    s2 = qy * z2 * z % P
    h = (u2 - x) % P
    r = (s2 - y) % P
    if h == 0:
        return _jac_double(x, y, z) if r == 0 else (0, 1, 0)
    h2 = h * h % P
    h3 = h2 * h % P
    v = x * h2 % P
    x3 = (r * r - h3 - 2 * v) % P
    return x3, (r * (v - x3) - y * h3) % P, z * h % P


def point(k: int):
    """k*G as affine (x, y), None for k = 0 mod N."""
    k %= N
    x, y, z = 0, 1, 0
    i = 0
    while k:
        if k & 1:
            x, y, z = _jac_add_affine(x, y, z, *_G_POW2[i])
        k >>= 1
        i += 1
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 * zi % P


def pubkey_hash160(k: int, compressed: bool) -> bytes:
    """hash160 of k*G's SEC encoding (33 bytes compressed, 65 not)."""
    x, y = point(k)
    if compressed:
        enc = bytes([2 | (y & 1)]) + x.to_bytes(32, "big")
    else:
        enc = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return hashes.hash160(enc)


def endo_priv(k: int, e: int) -> int:
    """The private key of the e-th GLV image of k*G, in the search's
    order: x, x with -y, beta x, beta x with -y, beta^2 x, beta^2 x with
    -y (lambda^(e // 2) * k, negated for odd e)."""
    v = pow(LAMBDA, e // 2, N) * k % N
    return (-v) % N if e % 2 else v


def endo_base(priv: int, e: int) -> int:
    """The k with endo_priv(k, e) == priv."""
    v = (-priv) % N if e % 2 else priv
    return pow(LAMBDA, -(e // 2), N) * v % N if e // 2 else v
