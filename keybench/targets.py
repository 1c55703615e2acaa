"""The cells' target sets, made from the seed: a hash160 list file, or a
`.blf` bloom filter built on the device as blf-gen lays out its bits.

A bloom filter's bits are the OR of every entry's 20 probe bits, so the
bits of blf-gen (which skips an entry the filter already holds) are
those of setting every entry's bits.  The index math is the benchmark's
copy of the reference's (reference/bloom.py), in 32-bit halves held in
int64 so that torch can run it on the card.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .reference import bloom as ref_bloom

M32 = 0xFFFFFFFF
CHUNK = 1 << 22                  # hashes per pass of the bit build


def write_list(path: str, hashes: list[bytes]) -> None:
    with open(path, "w") as f:
        f.writelines(h.hex() + "\n" for h in hashes)


def random_hash_words(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(5, n) int64 words in [0, 2^32): uniform hash160s from `gen`."""
    return torch.randint(0, 1 << 32, (5, n), generator=gen, device=device,
                         dtype=torch.int64)


def words_of(hashes: list[bytes], device) -> torch.Tensor:
    return torch.tensor([ref_bloom.words(h) for h in hashes],
                        dtype=torch.int64, device=device).reshape(-1, 5).T


def _indices(h: torch.Tensor, nbits: int) -> torch.Tensor:
    """(5, B) words -> (20, B) bit indices mod nbits (nbits <= 2^37)."""
    a = [(h[0], h[1]), (h[2], h[3]), (h[4], h[0]), (h[1], h[2]), (h[3], h[4])]
    out = []
    for s in ref_bloom.SHIFTS:
        for i in range(5):
            (ah, al), (bh, bl) = a[i], a[(i + 1) % 5]
            if s < 32:
                hi = ((ah << s) & M32) | (al >> (32 - s)) | (bh >> s)
                lo = ((al << s) & M32) | (bl >> s) | ((bh << (32 - s)) & M32)
            else:
                hi = (al << (s - 32)) & M32
                lo = bh >> (s - 32)
            r = hi % nbits                       # (hi * 2^32 + lo) mod nbits
            r = (r << 16) % nbits
            r = (r << 16) % nbits
            out.append((r + lo) % nbits)
    return torch.stack(out)


def bloom_bytes(parts: list[torch.Tensor], size_words: int) -> torch.Tensor:
    """The filter's bytes (uint8, little-endian u64 words) with every
    entry of the (5, B) word tensors in `parts` added."""
    nbits = size_words * 64
    dev = parts[0].device
    flags = torch.zeros(nbits, dtype=torch.uint8, device=dev)
    for h in parts:
        for lo in range(0, h.shape[1], CHUNK):
            flags[_indices(h[:, lo:lo + CHUNK], nbits).reshape(-1)] = 1
    f = flags.view(-1, 8)
    out = f[:, 0].clone()
    for t in range(1, 8):
        out |= f[:, t] << t
    return out


def fill(bits: torch.Tensor) -> float:
    """Share of the filter's bits that are set."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int64, device=bits.device)
    return float(lut[bits.long()].sum()) / (bits.numel() * 8)


def write_blf(path: str, bits: np.ndarray) -> None:
    """An ECBF v1 file: magic, version, u64 size in words, the words."""
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQ", ref_bloom.MAGIC, ref_bloom.VERSION,
                            bits.size // 8))
        f.write(bits.tobytes())
