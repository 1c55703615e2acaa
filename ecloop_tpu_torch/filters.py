"""Target filters and the two-tier check of every search mode.

Reference semantics, as in `ecloop_tpu.filters`:

  * `-f file.blf`      -> bloom-only mode: membership IS the bloom probe
                          (false positives included in the found set).
  * `-f hash-list.txt` -> exact mode: 40-hex-char lines, sorted + deduped.

The device runs a cheap prefilter over every candidate hash: a compare
of the first word against the targets' first words for lists of up to
ECLOOP_CMP_MAX (CMP_MAX, 2048) targets, a power-of-two bloom probe for
longer lists, the exact ECBF probe for a .blf.  The host confirms the
rare hits with exact semantics.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import bloom, native, trace

CMP_MAX = 2048               # ECLOOP_CMP_MAX's default


@dataclasses.dataclass
class Filter:
    mode: str                         # "list" | "bloom"
    targets: np.ndarray | None        # sorted unique (N, 5) u32, list mode
    blf: bloom.BloomFilter | None     # exact bloom (bloom mode)
    device_bits: np.ndarray           # u32 bit array for the device probe
    pow2_log2: int | None             # set in list mode
    blf_probes: int = 20              # device probes evaluated (bloom mode)
    pow2_probes: int = 2              # device probes evaluated (list, pow2)

    @property
    def count(self) -> int:
        return 0 if self.targets is None else len(self.targets)

    def use_cmp(self) -> bool:
        if self.mode != "list":
            return False
        return len(self.targets) <= int(os.environ.get("ECLOOP_CMP_MAX",
                                                       CMP_MAX))

    # --- device side ---
    def first_words(self, device) -> torch.Tensor | None:
        """The targets' unique first words on `device` in compare mode,
        else None."""
        if not self.use_cmp():
            return None
        return torch.from_numpy(
            np.unique(self.targets[:, 0]).astype(np.int64)).to(device)

    def device_probe(self, h: torch.Tensor, bits: torch.Tensor,
                     first_words: torch.Tensor | None = None) -> torch.Tensor:
        """(5, ...) hash words -> (...) bool candidate mask; `bits` is
        `bloom.bits_tensor(self.device_bits)`, `first_words` is
        `self.first_words()`."""
        if self.mode == "bloom":
            return bloom.probe_exact(h, bits, nbits=self.blf.nbits,
                                     nprobes=self.blf_probes)
        if first_words is not None:
            return probe_first_words(h[0], first_words)
        return bloom.probe_pow2(h, bits, log2_bits=self.pow2_log2,
                                nprobes=self.pow2_probes)

    # --- host side (authoritative) ---
    def confirm(self, h160_bytes: bytes) -> bool:
        """Exact membership of one hash160."""
        h = np.frombuffer(h160_bytes, dtype=">u4").astype(np.uint32)
        if self.mode == "bloom":
            return bool(self.blf.has_many(h[None])[0])
        if native.available():
            return native.list_search(self.targets, h) >= 0
        return _h160_key(h) in self._keys

    def __post_init__(self):
        self._keys = (None if self.targets is None
                      else {_h160_key(h) for h in self.targets})


def probe_first_words(h0: torch.Tensor,
                      first_words: torch.Tensor) -> torch.Tensor:
    """h0 in first_words (sorted, unique), elementwise: the compare
    prefilter.  A binary search of fixed depth and one equality test,
    with no data-dependent size, so it needs no host sync and a CUDA
    graph can capture it (torch.isin sorts and runs unique past a few
    dozen targets)."""
    if first_words.numel() == 0:
        return torch.zeros_like(h0, dtype=torch.bool)
    h0 = h0.contiguous()
    i = torch.searchsorted(first_words, h0).clamp_(max=first_words.numel() - 1)
    return first_words[i] == h0


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """bool bits (flat order kept) -> (B//32,) int64 words < 2^32,
    little-endian bit order."""
    b = bits.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    return (b << shifts).sum(dim=-1)


def probe_pack_plain(filt: Filter, h: torch.Tensor, bits: torch.Tensor,
                     first_words: torch.Tensor | None = None) -> torch.Tensor:
    """(5, B) hash words -> (B/32,) packed hit words of filt's device
    probe: the plain form of K5 (csrc/probe_pack.cu)."""
    return pack_mask(filt.device_probe(h, bits, first_words))


def _h160_key(h: np.ndarray) -> int:
    v = 0
    for w in h:
        v = (v << 32) | int(w)
    return v


def hex_to_h160(hexstr: str) -> np.ndarray:
    """40 hex chars -> (5,) u32 words; raises ValueError on a bad digit."""
    return np.array([int(hexstr[i:i + 8], 16) for i in range(0, 40, 8)],
                    dtype=np.uint32)


def parse_hash_lines(text: str) -> np.ndarray:
    """40-hex-char lines -> (N, 5) u32; other lines are skipped."""
    rows = []
    for ln in text.splitlines():
        ln = ln.strip()
        if len(ln) != 40:
            continue
        try:
            rows.append([int(ln[i:i + 8], 16) for i in range(0, 40, 8)])
        except ValueError:
            continue
    return np.array(rows, dtype=np.uint32).reshape(-1, 5)


def _sorted_unique(hashes: np.ndarray) -> np.ndarray:
    order = np.lexsort(tuple(hashes[:, i] for i in range(4, -1, -1)))
    hashes = hashes[order]
    keep = np.ones(len(hashes), dtype=bool)
    keep[1:] = (hashes[1:] != hashes[:-1]).any(axis=1)
    return hashes[keep]


def filter_from_hashes(hashes: np.ndarray) -> Filter:
    """The exact filter of a hash160 list, sorted and deduplicated, with
    its pow2 prefilter.  A list longer than CMP_MAX, which the device
    probes with it, takes `bloom.pow2_sizing` (about 1e-9 false
    positives a hashed key); a shorter one, which the device compares
    unless ECLOOP_CMP_MAX is lowered below its length, keeps the JAX
    package's ~64 bits a target and 2 probes.  The tracer counts the
    targets, log2_bits and probes of each list built."""
    with trace.span("filter.build"):
        hashes = _sorted_unique(hashes)
        n = len(hashes)
        log2b, probes = bloom.pow2_sizing(n) if n > CMP_MAX else (None, 2)
        bits, log2b = bloom.build_pow2(hashes, log2b, probes)
    trace.count("filter.list_targets", n)
    trace.count("filter.list_log2_bits", log2b)
    trace.count("filter.list_probes", probes)
    return Filter(mode="list", targets=hashes, blf=None, device_bits=bits,
                  pow2_log2=log2b, pow2_probes=probes)


def load_filter(path: str) -> Filter:
    """A .blf file's filter, or an exact one from a hash160 list.  A
    .blf's device probe count is ECLOOP_BLF_PROBES when set and not
    empty, else `bloom.adaptive_probe_count`, clamped to [1, 20]."""
    if path.endswith(".blf"):
        blf = bloom.BloomFilter.load(path)
        env = os.environ.get("ECLOOP_BLF_PROBES")
        n = int(env) if env else bloom.adaptive_probe_count(blf.bits)
        return Filter(mode="bloom", targets=None, blf=blf,
                      device_bits=blf.as_u32(), pow2_log2=None,
                      blf_probes=max(1, min(20, n)))
    with open(path) as f:
        hashes = parse_hash_lines(f.read())
    if len(hashes) == 0:
        raise ValueError(f"no hash160 entries found in {path}")
    return filter_from_hashes(hashes)
