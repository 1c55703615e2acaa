"""Private keys on the host (numpy): Python ints or key lines to u64 word
rows, their reduction mod n and their w-bit window digits.

The data format of `mul`'s jobs, below both the engine
(`search.mul`, which re-exports these names) and K8's plain form in
`kernels`.  The port of the JAX package's host helpers of the same
names.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .golden import N


def keys_to_words(keys: list[int]) -> np.ndarray:
    """Python ints < 2^256 -> (B, 4) u64 little-endian word rows."""
    raw = b"".join(k.to_bytes(32, "little") for k in keys)
    return np.frombuffer(raw, dtype="<u8").reshape(len(keys), 4)


def word_to_int(row: np.ndarray) -> int:
    return int.from_bytes(row.tobytes(), "little")


_N_WORDS = np.frombuffer(N.to_bytes(32, "little"), dtype="<u8").copy()


def words_mod_n(words: np.ndarray) -> np.ndarray:
    """(B, 4) u64 key words mod the curve order.  Keys are < 2^256 and
    n > 2^255, so one conditional subtraction suffices."""
    ge = np.zeros(len(words), bool)
    eq = np.ones(len(words), bool)
    for i in (3, 2, 1, 0):
        gt = eq & (words[:, i] > _N_WORDS[i])
        lt = eq & (words[:, i] < _N_WORDS[i])
        ge |= gt
        eq &= ~(gt | lt)
    ge |= eq                      # == n reduces to 0 as well
    if not ge.any():
        return words
    words = words.copy()
    r = words[ge]
    borrow = np.zeros(r.shape[0], np.uint64)
    for i in range(4):
        ni = _N_WORDS[i]
        wi = r[:, i].copy()
        nb = (wi < ni) | ((wi == ni) & (borrow == np.uint64(1)))
        r[:, i] = wi - ni - borrow
        borrow = nb.astype(np.uint64)
    words[ge] = r
    return words


def window_digits_words(words: np.ndarray, w: int) -> np.ndarray:
    """(B, 4) u64 key words -> (B, d) window digits (uint16 for w <= 16,
    uint32 above), d = 255 // w + 1; digit 0 means the window adds
    nothing."""
    n = 1 << w
    d = 255 // w + 1
    out = np.empty((len(words), d), dtype=np.uint16 if w <= 16 else np.uint32)
    for i in range(d):
        j, sh = divmod(w * i, 64)
        lo = words[:, j] >> np.uint64(sh)
        if sh and j + 1 < 4:
            lo = lo | (words[:, j + 1] << np.uint64(64 - sh))
        out[:, i] = (lo & np.uint64(n - 1)).astype(out.dtype)
    return out


def parse_keys(lines: list[str], raw: bool) -> list[int]:
    """Hex private keys mod n, or with -raw the SHA-256 of each line."""
    if raw:
        return [int.from_bytes(hashlib.sha256(ln.encode()).digest(), "big")
                for ln in lines]
    return [int(ln, 16) % N for ln in lines]
