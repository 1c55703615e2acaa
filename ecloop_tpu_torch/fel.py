"""Limb-first 256-bit field arithmetic mod p on torch tensors.

A batch of field elements is one int64 tensor of shape (16, ...): 16
little-endian 16-bit limbs along the leading axis, the batch behind it
(the counterpart of `ecloop_tpu.fel`'s 16 limb rows).  Limbs are held in
int64 because the 16x16-bit products and the carry sweeps need more than
32 bits, and torch on the CPU has no shifts or compares on uint32.

Every function returns fully reduced limbs (< p), so results are
bit-identical to `ecloop_tpu.fel` and to `golden`.  Operands broadcast
like ordinary tensors behind the limb axis.  These are the plain forms;
`kernels.inv_mod_batch` is the one hand-written device kernel of this
layer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import golden

P = golden.P
NLIMBS = 16
LIMB_BITS = 16
M16 = 0xFFFF
PCOMP = (1 << 256) - P            # 2^32 + 0x3D1
C977 = 0x3D1
assert PCOMP == (1 << 32) + C977


# --- host conversions ----------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> (16,) uint32 limbs."""
    return np.array([(x >> (LIMB_BITS * i)) & M16 for i in range(NLIMBS)],
                    dtype=np.uint32)


def ints_to_limbs(xs) -> np.ndarray:
    """Python ints -> (len, 16) uint32 limbs (the layout of the JAX
    package's `fe.ints_to_limbs`)."""
    out = np.empty((len(xs), NLIMBS), dtype=np.uint32)
    for i, x in enumerate(xs):
        out[i] = int_to_limbs(x)
    return out


def limbs_to_ints(a) -> list[int]:
    """(..., 16) limbs (numpy) -> Python ints, batch flattened."""
    flat = np.asarray(a).reshape(-1, NLIMBS)
    return [sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(row))
            for row in flat]


def from_last(a: np.ndarray, device) -> torch.Tensor:
    """(..., 16) numpy limbs -> (16, ...) int64 tensor on `device`."""
    a = np.moveaxis(np.asarray(a).astype(np.int64), -1, 0)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_last(t: torch.Tensor) -> np.ndarray:
    """(16, ...) tensor -> (..., 16) uint32 numpy limbs."""
    return np.moveaxis(t.cpu().numpy(), 0, -1).astype(np.uint32)


def tensor_to_ints(t: torch.Tensor) -> list[int]:
    return limbs_to_ints(to_last(t))


def ints_to_tensor(xs, device) -> torch.Tensor:
    """Python ints -> (16, len) tensor."""
    return from_last(ints_to_limbs(xs), device)


def random_limbs(rng: np.random.Generator, n: int) -> np.ndarray:
    """(16, n) int64 limbs of seeded field elements below p (the top limb
    below 0xFFFF), for benches and card checks."""
    a = rng.integers(0, 1 << 16, size=(NLIMBS, n), dtype=np.int64)
    a[NLIMBS - 1] = rng.integers(0, M16, size=n, dtype=np.int64)
    return a


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """Constant x as a (16, 1, ..., 1) tensor that broadcasts against
    `like`.  Made once per device and number of dimensions and kept, so
    that a CUDA graph can capture code that uses it after one warm-up
    run (the cache never evicts: a captured graph keeps reading the
    tensor); callers must not write to it."""
    return _const(x, like.device, like.dim())


@functools.cache
def _const(x: int, device: torch.device, dim: int) -> torch.Tensor:
    t = torch.tensor(int_to_limbs(x).astype(np.int64), device=device)
    return t.reshape((NLIMBS,) + (1,) * (dim - 1))


# --- carries -------------------------------------------------------------------

def _carry(cols: torch.Tensor):
    """Sequential carry sweep over non-negative int64 columns (L, ...)
    -> (L 16-bit limbs, carry out)."""
    out = []
    c = None
    for i in range(cols.shape[0]):
        v = cols[i] if c is None else cols[i] + c
        out.append(v & M16)
        c = v >> LIMB_BITS
    return torch.stack(out), c


def _sub(a: torch.Tensor, b: torch.Tensor):
    """a - b over 16 limbs -> (difference mod 2^256, borrow out in {0,1})."""
    a, b = torch.broadcast_tensors(a, b)
    out = []
    brw = None                                    # -1 on a borrow, else 0
    for i in range(NLIMBS):
        v = a[i] - b[i] if brw is None else a[i] - b[i] + brw
        out.append(v & M16)
        brw = v >> 63
    return torch.stack(out), -brw


def select(cond, a, b):
    """where(cond, a, b) per element; cond has the batch shape."""
    return torch.where(cond, a, b)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


# --- add / sub / neg -------------------------------------------------------------

def add_mod(a, b):
    s, c = _carry(a + b)
    d, borrow = _sub(s, const(P, s))
    return torch.where((c == 1) | (borrow == 0), d, s)


def sub_mod(a, b):
    d, borrow = _sub(a, b)
    dp, _ = _carry(d + const(P, d))               # wraps mod 2^256
    return torch.where(borrow == 1, dp, d)


def neg_mod(a):
    """p - a for a < p; 0 -> 0."""
    d, _ = _sub(const(P, a), a)
    return torch.where(is_zero(a), torch.zeros_like(a), d)


# --- multiply --------------------------------------------------------------------

def _mul_cols(a, b):
    """Schoolbook 16x16 limbs -> 32 carry-saved columns (< 2^36): the
    (16, 16, ...) product summed along its anti-diagonals."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[1:]
    prod = (a[:, None] * b[None, :]).reshape((NLIMBS * NLIMBS,) + batch)
    idx = (torch.arange(NLIMBS, device=a.device)[:, None]
           + torch.arange(NLIMBS, device=a.device)[None, :]).reshape(-1)
    cols = torch.zeros((2 * NLIMBS,) + batch, dtype=a.dtype, device=a.device)
    return cols.index_add_(0, idx, prod)


def _fold(cols):
    """32 columns -> value mod p, fully reduced, by folding the high half
    back with 2^256 = 2^32 + 0x3D1 (mod p).  Same folds as
    `ecloop_tpu.fel._fold_p`; bounds in the comments."""
    w, _ = _carry(cols)                           # exact: product < 2^512
    lo, hi = w[:NLIMBS], w[NLIMBS:]
    cols2 = torch.zeros((NLIMBS + 2,) + w.shape[1:], dtype=w.dtype,
                        device=w.device)
    cols2[:NLIMBS] = lo + hi * C977
    cols2[2:] += hi                               # X < 2^290
    r1, c1 = _carry(cols2)
    hi2 = torch.cat([r1[NLIMBS:], c1[None]])      # X >> 256 < 2^34
    cols3 = r1[:NLIMBS].clone()
    cols3[:3] += hi2 * C977
    cols3[2:5] += hi2
    r2, c2 = _carry(cols3)                        # c2 in {0, 1}
    r2[0] += c2 * C977
    r2[2] += c2
    r3, _ = _carry(r2)                            # < 2^256 < 2p
    d, borrow = _sub(r3, const(P, r3))
    return torch.where(borrow == 0, d, r3)


def mul_mod(a, b):
    return _fold(_mul_cols(a, b))


def sqr_mod(a):
    return _fold(_mul_cols(a, a))


def mul_small(a, k: int):
    """a * k mod p for a small constant 0 <= k < 2^16."""
    cols = torch.zeros((2 * NLIMBS,) + a.shape[1:], dtype=a.dtype,
                       device=a.device)
    cols[:NLIMBS] = a * k
    return _fold(cols)


# --- inversion -------------------------------------------------------------------

def inv_mod(a):
    """Fermat a^(p-2) with the addition chain of `ecloop_tpu.fel.inv_mod`;
    0 -> 0."""
    def sqrn(x, n):
        for _ in range(n):
            x = sqr_mod(x)
        return x

    x1 = a
    x2 = mul_mod(sqr_mod(x1), x1)
    x3 = mul_mod(sqr_mod(x2), x1)
    x6 = mul_mod(sqrn(x3, 3), x3)
    x9 = mul_mod(sqrn(x6, 3), x3)
    x11 = mul_mod(sqrn(x9, 2), x2)
    x22 = mul_mod(sqrn(x11, 11), x11)
    x44 = mul_mod(sqrn(x22, 22), x22)
    x88 = mul_mod(sqrn(x44, 44), x44)
    x176 = mul_mod(sqrn(x88, 88), x88)
    x220 = mul_mod(sqrn(x176, 44), x44)
    x223 = mul_mod(sqrn(x220, 3), x3)
    t = mul_mod(sqrn(x223, 23), x22)
    t = mul_mod(sqrn(t, 5), x1)
    t = mul_mod(sqrn(t, 3), x2)
    return mul_mod(sqrn(t, 2), x1)


def inv_mod_batch(x: torch.Tensor, lanes: int | None = None) -> torch.Tensor:
    """Montgomery batch inversion, the plain version of the K2 kernel.

    x: (16, ...) canonical limbs.  The batch is laid out as (s, w): w
    independent chains of s prefix products, one Fermat inversion of the
    w chain totals, then back-substitution.  Any batch length works (the
    tail is padded with ones).  Zero inputs map to zero outputs.  The
    default w is 4096 on a GPU, where this version is bound by its
    launches (about 270 + 2s), and 256 on the CPU, where it is bound by
    its work (about 270w + 3b products).
    """
    flat = x.reshape(NLIMBS, -1)
    b = flat.shape[1]
    if b == 0:
        return x.clone()
    if lanes is None:
        lanes = 4096 if flat.is_cuda else 256
    zero = is_zero(flat)
    safe = torch.where(zero, const(1, flat), flat)
    w = min(lanes, b)
    s = -(-b // w)
    if s * w > b:
        ones = const(1, flat).expand(NLIMBS, s * w - b)
        safe = torch.cat([safe, ones], dim=1)
    g = safe.reshape(NLIMBS, s, w)
    pref = torch.empty_like(g)
    pref[:, 0] = g[:, 0]
    for i in range(1, s):
        pref[:, i] = mul_mod(pref[:, i - 1], g[:, i])
    acc = inv_mod(pref[:, s - 1])
    out = torch.empty_like(g)
    for i in range(s - 1, 0, -1):
        out[:, i] = mul_mod(acc, pref[:, i - 1])
        acc = mul_mod(acc, g[:, i])
    out[:, 0] = acc
    out = out.reshape(NLIMBS, -1)[:, :b]
    out = torch.where(zero, torch.zeros_like(out), out)
    return out.reshape(x.shape)
