"""Target filters and the two-tier check of every search mode.

Reference semantics, as in `ecloop_tpu.filters`:

  * `-f file.blf`      -> bloom-only mode: membership IS the bloom probe
                          (false positives included in the found set).
  * `-f hash-list.txt` -> exact mode: 40-hex-char lines, sorted + deduped.

The device runs a cheap prefilter over every candidate hash: a compare
of the first word against the targets' first words for lists of up to
ECLOOP_CMP_MAX (2048) targets, a power-of-two bloom probe for longer
lists, the exact ECBF probe for a .blf.  The host confirms the rare hits
with exact semantics.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ecloop_tpu import native

from . import bloom


@dataclasses.dataclass
class Filter:
    mode: str                         # "list" | "bloom"
    targets: np.ndarray | None        # sorted unique (N, 5) u32, list mode
    blf: bloom.BloomFilter | None     # exact bloom (bloom mode)
    device_bits: np.ndarray           # u32 bit array for the device probe
    pow2_log2: int | None             # set in list mode
    blf_probes: int = 20              # device probes evaluated (bloom mode)

    @property
    def count(self) -> int:
        return 0 if self.targets is None else len(self.targets)

    def use_cmp(self) -> bool:
        if self.mode != "list":
            return False
        return len(self.targets) <= int(os.environ.get("ECLOOP_CMP_MAX", 2048))

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
            return torch.isin(h[0], first_words)
        return bloom.probe_pow2(h, bits, log2_bits=self.pow2_log2)

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


def _h160_key(h: np.ndarray) -> int:
    v = 0
    for w in h:
        v = (v << 32) | int(w)
    return v


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
    hashes = _sorted_unique(hashes)
    bits, log2b = bloom.build_pow2(hashes)
    return Filter(mode="list", targets=hashes, blf=None,
                  device_bits=bits, pow2_log2=log2b)


def load_filter(path: str) -> Filter:
    if path.endswith(".blf"):
        blf = bloom.BloomFilter.load(path)
        return Filter(mode="bloom", targets=None, blf=blf,
                      device_bits=blf.as_u32(), pow2_log2=None,
                      blf_probes=bloom.adaptive_probe_count(blf.bits))
    with open(path) as f:
        hashes = parse_hash_lines(f.read())
    if len(hashes) == 0:
        raise ValueError(f"no hash160 entries found in {path}")
    return filter_from_hashes(hashes)
