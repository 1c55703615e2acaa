"""Bloom filters: the ECBF v1 file format and host build (numpy), and the
device probes (torch).

The host half is the JAX package's (`ecloop_tpu.bloom`), carried over
without jax; the tests hold its bytes identical to that module's.
Reference semantics: k = 20 probe indices from the 5 hash words (five
overlapping u64s x shifts {24, 28, 36, 40}), bit = index mod (size * 64)
over a u64[size] array; file = magic 'ECBF', version 1, u64 size, then
the words little-endian.

On the device a probe index is a (hi, lo) pair of 32-bit halves in
int64, since the 64-bit index can exceed 2^63.  The exact probe reduces
it mod M (M = size * 64 <= 2^37) in int64 without overflow; the list-mode
prefilter uses a power-of-two size, whose mod is a mask.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from . import native

BLF_MAGIC = 0x45434246
BLF_VERSION = 1
SHIFTS = (24, 28, 36, 40)
ADD_CHUNK = 1 << 14          # hashes per batch of BloomFilter.add_new
M32 = 0xFFFFFFFF


# --- host side (numpy, exact reference semantics) ------------------------------

def _h160_to_a5(h: np.ndarray) -> list[np.ndarray]:
    """(..., 5) u32 -> the five overlapping u64s."""
    h = h.astype(np.uint64)
    return [
        (h[..., 0] << np.uint64(32)) | h[..., 1],
        (h[..., 2] << np.uint64(32)) | h[..., 3],
        (h[..., 4] << np.uint64(32)) | h[..., 0],
        (h[..., 1] << np.uint64(32)) | h[..., 2],
        (h[..., 3] << np.uint64(32)) | h[..., 4],
    ]


def probe_indices_host(h: np.ndarray) -> np.ndarray:
    """(..., 5) u32 hash words -> (..., 20) u64 probe indices (pre-mod)."""
    a = _h160_to_a5(h)
    out = []
    for s in SHIFTS:
        s = np.uint64(s)
        for i in range(5):
            out.append((a[i] << s) | (a[(i + 1) % 5] >> s))
    return np.stack(out, axis=-1)


class BloomFilter:
    """Reference-compatible bloom filter (host side)."""

    def __init__(self, size_words: int, bits: np.ndarray | None = None):
        self.size = int(size_words)            # number of u64 words
        self.bits = (np.zeros(self.size, dtype=np.uint64)
                     if bits is None else bits)
        if self.bits.shape != (self.size,):
            raise ValueError(f"bits shape {self.bits.shape} != ({self.size},)")

    @classmethod
    def for_count(cls, n: int) -> "BloomFilter":
        """blf-gen sizing: false-positive rate 1e-9."""
        p = 1.0 / 1e9
        m = int(n * math.log(p) / math.log(1.0 / math.pow(2.0, math.log(2.0))))
        return cls((m + 63) // 64)

    @property
    def nbits(self) -> int:
        return self.size * 64

    def add_many(self, hashes: np.ndarray) -> None:
        if native.available() and hashes.ndim == 2:
            native.bloom_add(self.bits, hashes)
            return
        idx = probe_indices_host(hashes).reshape(-1) % np.uint64(self.nbits)
        np.bitwise_or.at(self.bits, (idx >> np.uint64(6)).astype(np.int64),
                         np.uint64(1) << (idx & np.uint64(63)))

    def add_new(self, hashes: np.ndarray) -> int:
        """Add (N, 5) hashes in order, skipping each one the filter holds
        when its turn comes; returns how many were added.  The bits and
        the count equal those of testing and adding one hash at a time
        (blf-gen), computed a chunk at a time: within a chunk, a hash
        that misses some bits of the filter as the chunk found it is
        held by then exactly when each bit it misses is missed first by
        an earlier hash of the chunk (an earlier hash that was skipped
        missed only bits that hashes before it had set)."""
        added, chunk = 0, ADD_CHUNK
        for lo in range(0, len(hashes), chunk):
            idx = probe_indices_host(hashes[lo:lo + chunk]) % np.uint64(
                self.nbits)
            word = (idx >> np.uint64(6)).astype(np.int64)
            bit = np.uint64(1) << (idx & np.uint64(63))
            row, col = np.nonzero((self.bits[word] & bit) == 0)
            # missed bits in (bit, row) order: one sort of bit*chunk + row
            key = np.sort(idx[row, col].astype(np.int64) * chunk + row)
            b, row = np.divmod(key, chunk)
            first = np.ones(len(b), dtype=bool)
            first[1:] = b[1:] != b[:-1]
            first_row = row[first][np.cumsum(first) - 1]
            new = np.unique(row[row == first_row])
            np.bitwise_or.at(self.bits, word[new].reshape(-1),
                             bit[new].reshape(-1))
            added += len(new)
        return added

    def has_many(self, hashes: np.ndarray) -> np.ndarray:
        """(..., 5) -> (...,) bool, all-20-probes membership."""
        if native.available() and hashes.ndim == 2:
            return native.bloom_has(self.bits, hashes)
        idx = probe_indices_host(hashes) % np.uint64(self.nbits)
        words = self.bits[(idx >> np.uint64(6)).astype(np.int64)]
        hit = (words >> (idx & np.uint64(63))) & np.uint64(1)
        return np.all(hit == 1, axis=-1)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<IIQ", BLF_MAGIC, BLF_VERSION, self.size))
            f.write(self.bits.astype("<u8").tobytes())

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        with open(path, "rb") as f:
            magic, version, size = struct.unpack("<IIQ", f.read(16))
            if magic != BLF_MAGIC or version != BLF_VERSION:
                raise ValueError(
                    "invalid bloom filter version; create a new filter with "
                    "blf-gen command")
            bits = np.frombuffer(f.read(size * 8), dtype="<u8").copy()
        if bits.size != size:
            raise ValueError("failed to read bloom filter bits")
        return cls(size, bits)

    def as_u32(self) -> np.ndarray:
        """Little-endian u32 view of the bits, for the device probe."""
        return self.bits.view("<u4").copy()


def adaptive_probe_count(bits: np.ndarray, target_fp: float = 1e-6) -> int:
    """Fewest device probes whose estimated false-positive rate
    (fill^k) is <= target_fp.  The host re-checks all 20 probes, so this
    changes throughput only, never the found set."""
    nbits = bits.size * 64
    lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(axis=1).astype(np.uint32)
    ones = int(lut[np.ascontiguousarray(bits).view(np.uint8)].sum(
        dtype=np.uint64))
    fill = ones / max(nbits, 1)
    if fill <= 0.0:
        return 1
    if fill >= 1.0:
        return 20
    k = math.ceil(math.log(target_fp) / math.log(fill))
    return max(1, min(20, k))


POW2_BITS_PER_TARGET = 128   # upstream's bloom in front of a list (SURVEY.md)
POW2_FP = 1e-9               # the list prefilter's estimated false positives a key


def pow2_fp(n: int, log2_bits: int, nprobes: int) -> float:
    """The estimated false-positive rate of a pow2 prefilter of n targets
    over 2^log2_bits bits: its fill 1 - e^(-k n / m) to the power of its
    k probes.  Probes past the fifth reuse bits of the first five's
    words (the shifts 24 and 28 of the same u64), so a sixth passes
    more often than the fill says: at 10,128 targets, 2^21 bits and 6
    probes, ~7e-10 of random hashes pass against the estimate's 5.4e-10."""
    return (1.0 - math.exp(-nprobes * n / (1 << log2_bits))) ** nprobes


def pow2_sizing(n: int) -> tuple[int, int]:
    """The list prefilter's (log2_bits, probes) for n targets: the power
    of two at or above POW2_BITS_PER_TARGET bits a target, 2^16 to
    2^37, and the fewest probes, at most 20, whose estimated rate
    (`pow2_fp`) is at most POW2_FP.  10,128 targets: 2^21 bits (256 KB)
    and 6 probes, 5.4e-10."""
    n = max(1, n)
    log2_bits = min(37, max(16, (n * POW2_BITS_PER_TARGET - 1).bit_length()))
    k = next((k for k in range(1, 21) if pow2_fp(n, log2_bits, k) <= POW2_FP),
             20)
    return log2_bits, k


def build_pow2(hashes: np.ndarray, log2_bits: int | None = None,
               nprobes: int = 2) -> tuple[np.ndarray, int]:
    """Host-build the power-of-two prefilter over target hashes.
    Returns (bits_u32, log2_bits)."""
    n = max(1, len(hashes))
    if log2_bits is None:
        log2_bits = max(16, (n * 64 - 1).bit_length())   # ~64 bits/key
    log2_bits = min(log2_bits, 37)
    nbits = 1 << log2_bits
    bits = np.zeros(nbits // 32, dtype=np.uint32)
    if len(hashes):
        idx = probe_indices_host(hashes)[..., :nprobes].reshape(-1)
        idx &= np.uint64(nbits - 1)
        np.bitwise_or.at(bits, (idx >> np.uint64(5)).astype(np.int64),
                         np.uint32(1) << (idx & np.uint64(31)).astype(np.uint32))
    return bits, log2_bits


# --- device probes (torch) --------------------------------------------------------

def bits_tensor(bits_u32: np.ndarray, device) -> torch.Tensor:
    """u32 bit words -> an int32 tensor of the same bits on `device`."""
    words = np.array(bits_u32, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(device)


def _probe_pairs(h: torch.Tensor, count: int):
    """(5, ...) hash words -> the first `count` probe indices as
    (hi, lo) pairs of 32-bit halves."""
    a = [(h[0], h[1]), (h[2], h[3]), (h[4], h[0]), (h[1], h[2]), (h[3], h[4])]
    out = []
    for s in SHIFTS:
        for i in range(5):
            if len(out) == count:
                return out
            ah, al = a[i]
            bh, bl = a[(i + 1) % 5]
            if s < 32:
                hi = ((ah << s) & M32) | (al >> (32 - s)) | (bh >> s)
                lo = ((al << s) & M32) | (bl >> s) | ((bh << (32 - s)) & M32)
            else:
                hi = (al << (s - 32)) & M32
                lo = bh >> (s - 32)
            out.append((hi, lo))
    return out


def _bit(bits: torch.Tensor, word, shift):
    return (bits[word] >> shift) & 1


def probe_exact(h: torch.Tensor, bits: torch.Tensor, nbits: int,
                nprobes: int = 20) -> torch.Tensor:
    """Reference bloom membership of (5, ...) hash words over the ECBF
    bits (int32 words); nprobes < 20 evaluates only the first probes, a
    prefilter whose survivors the host re-checks with all 20."""
    if not (64 <= nbits <= 1 << 37 and nbits % 64 == 0):
        raise ValueError(f"unsupported filter size: {nbits} bits")
    hit = None
    for hi, lo in _probe_pairs(h, nprobes):
        r = hi % nbits                             # (hi * 2^32 + lo) mod M
        r = (r << 16) % nbits
        r = (r << 16) % nbits
        r = (r + lo) % nbits
        bit = _bit(bits, r >> 5, r & 31)
        hit = bit if hit is None else hit & bit
    return hit == 1


def exact_reciprocal(nbits: int) -> int:
    """r = floor((2^64 - 1) / m) for a filter of nbits = 64 m bits
    (m <= 2^31): the kernels' exact probe reduces with it (exact_bit)."""
    if not (64 <= nbits <= 1 << 37 and nbits % 64 == 0):
        raise ValueError(f"unsupported filter size: {nbits} bits")
    return (2**64 - 1) // (nbits // 64)


def exact_bit(idx: int, nbits: int, r: int) -> int:
    """idx mod nbits for a 64-bit probe index, by the integer steps of the
    kernels' exact probe (csrc/probe.cuh: probe_bit): with a = idx >> 6
    and m = nbits / 64, q = umulhi(a, r) is floor(a / m) or one less, so
    a - q m lies in [0, 2m) and, as 2m <= 2^32, equals its low 32 bits;
    one conditional subtract leaves a mod m, and the bit is
    ((a mod m) << 6) | (idx & 63)."""
    m = nbits // 64
    a = idx >> 6
    q = (a * r) >> 64
    rem = ((a & M32) - (q & M32) * m) & M32
    if rem >= m:
        rem -= m
    return (rem << 6) | (idx & 63)


def probe_pow2(h: torch.Tensor, bits: torch.Tensor, log2_bits: int,
               nprobes: int = 2) -> torch.Tensor:
    """Power-of-two prefilter probe: the same indices, mod 2^log2_bits."""
    hit = None
    for hi, lo in _probe_pairs(h, nprobes):
        if log2_bits <= 32:
            word = (lo & ((1 << log2_bits) - 1)) >> 5
        else:
            word = ((hi & ((1 << (log2_bits - 32)) - 1)) << 27) | (lo >> 5)
        bit = _bit(bits, word, lo & 31)
        hit = bit if hit is None else hit & bit
    return hit == 1
