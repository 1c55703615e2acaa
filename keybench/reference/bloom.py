"""The reference's bloom filter semantics (ECBF v1, ecloop's bloom.h), in
plain Python ints for the few hashes the judge looks at.

k = 20 probe indices from the 5 big-endian words of a hash160: five
overlapping 64-bit words, each shifted left by s and or-ed with the next
one shifted right by s, for s in (24, 28, 36, 40); bit = index mod
nbits, nbits = 64 * size over u64[size] words stored little-endian, so
bit b is bit b & 7 of byte b >> 3.  blf-gen sizes a filter for n
entries at a false-positive rate of 1e-9.
"""

from __future__ import annotations

import math

import numpy as np

SHIFTS = (24, 28, 36, 40)
M64 = (1 << 64) - 1
MAGIC = 0x45434246               # 'ECBF'
VERSION = 1


def words(h160: bytes) -> list[int]:
    return [int.from_bytes(h160[i:i + 4], "big") for i in range(0, 20, 4)]


def probe_indices(h160: bytes) -> list[int]:
    """The 20 probe indices of a hash160, before the reduction mod nbits."""
    w = words(h160)
    a = [w[0] << 32 | w[1], w[2] << 32 | w[3], w[4] << 32 | w[0],
         w[1] << 32 | w[2], w[3] << 32 | w[4]]
    return [((a[i] << s) | (a[(i + 1) % 5] >> s)) & M64
            for s in SHIFTS for i in range(5)]


def size_words(n: int) -> int:
    """blf-gen's filter size in u64 words for n entries at p = 1e-9."""
    m = int(n * math.log(1e-9) / math.log(1.0 / math.pow(2.0, math.log(2.0))))
    return (m + 63) // 64


def member(h160: bytes, bits: np.ndarray) -> bool:
    """All 20 probes set in `bits`, the filter's bytes (uint8)."""
    nbits = bits.size * 8
    for idx in probe_indices(h160):
        b = idx % nbits
        if not bits[b >> 3] >> (b & 7) & 1:
            return False
    return True
