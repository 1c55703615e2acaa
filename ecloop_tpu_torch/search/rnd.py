"""`rnd` mode: repeated `add` searches over random bit-window sub-ranges
(the port of `ecloop_tpu.search.rnd`).

Each iteration draws a base in [range_s, range_e], clears the `size`
bits at `offs` for the sub-range start and sets them for its end,
clamps both into the outer range and searches that sub-range with the
`add` engine.  The loop runs until `max_iters`, or stops after one pass
when a window covers the whole range.

A seeded run draws from Python's Mersenne twister seeded with the
reference's string hash (`encode_seed`), so the port and the JAX package
visit the same sub-ranges in the same order for the same `-seed`; an
unseeded run draws from os.urandom.
"""

from __future__ import annotations

import os
import random

from ..filters import Filter
from .add import AddSearch
from .common import Found, SearchConfig, default_offs_size


def encode_seed(seed: str) -> int:
    """The reference's string hash (encode_seed): h = h*31 + byte over
    the UTF-8 bytes, mod 2^32."""
    h = 0
    for ch in seed.encode():
        h = ((h << 5) - h + ch) & 0xFFFFFFFF
    return h


class Rng:
    """rand64 and range sampling from a seeded PRNG or OS entropy."""

    def __init__(self, seed: str | None):
        self.seeded = seed is not None
        self._r = random.Random(encode_seed(seed)) if self.seeded else None

    def rand64(self) -> int:
        if self.seeded:
            return self._r.getrandbits(64)
        return int.from_bytes(os.urandom(8), "little")

    def fe_rand(self) -> int:
        """256-bit sample with the top 64-bit word masked below P's
        (fe_prand / fe_urand)."""
        v = 0
        for i in range(4):
            v |= self.rand64() << (64 * i)
        return v & ((0xFFFFFFFEFFFFFC2F << 192) | (1 << 192) - 1)

    def rand_range(self, a: int, b: int) -> int:
        """Uniform in [a, b] by rejection sampling (fe_rand_range)."""
        rng_size = b - a + 1
        bits = rng_size.bit_length()
        while True:
            x = self.fe_rand() & ((1 << bits) - 1)
            if x < rng_size:
                return a + x


def gen_random_range(rng: Rng, a: int, b: int, offs: int,
                     size: int) -> tuple[int, int]:
    """One random sub-range: a drawn base with its window bits cleared
    (start) and set (end), clamped into [a, b]."""
    base = rng.rand_range(a, b)
    window = ((1 << size) - 1) << offs
    return max(base & ~window, a), min(base | window, b)


def format_range_mask(value: int, offs: int, size: int, color: bool) -> str:
    """64 hex digits in groups of 16, the digits of the window in yellow
    when `color` (print_range_mask)."""
    mask_e = 255 - offs
    mask_s = mask_e - size + 1
    out = []
    for i in range(64):
        if i % 16 == 0 and i != 0:
            out.append(" ")
        bit_s, bit_e = i * 4, i * 4 + 3
        cc = "0123456789abcdef"[(value >> (255 - bit_e)) & 0xF]
        hot = (mask_s <= bit_s <= mask_e) or (mask_s <= bit_e <= mask_e)
        out.append(f"\033[33m{cc}\033[0m" if hot and color else cc)
    return "".join(out)


class RndSearch:
    """Random-window search driver over one `AddSearch` on `devices` (a
    device or a list, of which this process runs the shards in `owned`,
    all by default), which serves every sub-range through `run_range`'s
    range override."""

    def __init__(self, cfg: SearchConfig, filt: Filter, devices,
                 seed: str | None = None, offs: int | None = None,
                 size: int | None = None, owned=None):
        self.cfg = cfg
        self.rng = Rng(seed)
        self.offs, self.size = default_offs_size(
            cfg.range_e, offs, size, self.rng, is_rnd=True)
        self.offs = min(self.offs, 255 - self.size)
        self.engine = AddSearch(cfg, filt, devices, owned)

    def run(self, max_iters: int | None = None, on_found=None,
            on_iter=None, on_range=None, skip_iters: int = 0) -> list[Found]:
        """Search drawn sub-ranges until max_iters, or after one pass
        when a draw covers the whole range.  skip_iters draws and
        discards the first N sub-ranges (the resume cursor of a seeded
        run).  on_range(lo, hi) fires before each search, on_iter(i, lo,
        hi, found) after it with the count of iterations so far."""
        found = []
        iters = 0
        rs, re_ = self.cfg.range_s, self.cfg.range_e
        while True:
            lo, hi = gen_random_range(self.rng, rs, re_, self.offs, self.size)
            is_full = lo == rs and hi == re_
            if iters < skip_iters:
                iters += 1
                if is_full:
                    return found
                continue
            if on_range:
                on_range(lo, hi)
            got = self.engine.run_range(on_found=on_found, range_s=lo,
                                        range_e=hi)
            found.extend(got)
            iters += 1
            if on_iter:
                on_iter(iters, lo, hi, got)
            if is_full or (max_iters is not None and iters >= max_iters):
                return found
