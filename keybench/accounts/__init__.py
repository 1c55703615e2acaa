"""Least times of an `add` step's kernels, from the frozen numbers in
`frozen.json` (their derivation is in that file).

The work is the algorithm's, whatever kernels a later program runs it
with: a step of m centers x k keys needs K4's chords (`chord_dx`,
`chord_points`), K2's inversion and, per candidate plane, a hash160 and
the filter's probe.  The hash-and-probe account is
`ecloop_tpu_torch.sol.hash_probe_account` with its constants frozen.
"""

from __future__ import annotations

import json
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))
NLIMBS = 16


def frozen() -> dict:
    with open(os.path.join(HERE, "frozen.json")) as f:
        return json.load(f)


def step_key(centers: int, group_k: int, endo: bool) -> str:
    return f"m{centers}_k{group_k}_{'endo' if endo else 'plain'}"


def chord_inv(acc: dict, centers: int, group_k: int,
              endo: bool) -> dict[str, tuple[int, int]]:
    """{kernel: (bytes, ops)} of one step's K4 launches and K2 call."""
    return {k: tuple(v) for k, v in
            acc["steps"][step_key(centers, group_k, endo)].items()}


def probe_reads_per_key(fill: float, probes: int) -> float:
    """Bit words read per key and plane by a probe that stops at its first
    clear bit, over uniform hashes: sum of fill^p for p < probes."""
    if fill >= 1.0:
        return float(probes)
    return (1.0 - fill ** probes) / (1.0 - fill)


def device_probes(fill: float, target_fp: float = 1e-6) -> int:
    """blf probes on the device: the fewest whose fill^k <= target_fp,
    clamped to 1-20 (the port's adaptive count at this commit)."""
    if fill <= 0.0:
        return 1
    if fill >= 1.0:
        return 20
    return max(1, min(20, math.ceil(math.log(target_fp) / math.log(fill))))


def hash_probe(acc: dict, n: int, planes, mode: str, reads: float = 0.0,
               n_first: int = 0, bits_words: int = 0) -> tuple[float, float]:
    """(bytes, ops) of hashing and probing n keys in every plane (x row,
    y row, is33) of a step: each x row read once, each y row once (only
    its parity limb where addr33 planes alone read it), the probe's own
    reads (compare: the sorted first words; exact and pow2: `reads` bit
    words of 4 bytes, at most the filter's words once) and one 8-byte
    mask word per 32 keys and plane."""
    y_limbs = {}
    for _, j, is33 in planes:
        y_limbs[j] = max(y_limbs.get(j, 1), 1 if is33 else NLIMBS)
    limbs = NLIMBS * len({i for i, _, _ in planes}) + sum(y_limbs.values())
    keys = n * len(planes)
    if mode == "compare":
        levels = max(n_first - 1, 0).bit_length()
        pbytes = n_first * 8
        pops = keys * (levels * acc["probe_search_ops"] + int(n_first > 0)
                       + acc["pack_ops"])
    else:
        per = acc["probe_exact_ops"] if mode == "exact" else acc["probe_pow2_ops"]
        pbytes = 4 * min(reads, bits_words)
        pops = reads * per + keys * acc["pack_ops"]
    hops = n * sum(acc["hash_ops_per_key"]["addr33" if is33 else "addr65"]
                   for *_, is33 in planes)
    return (n * limbs * acc["limb_bytes"] + pbytes
            + len(planes) * (n // 32) * 8, hops + pops)


def least_s(nbytes: float, ops: float, int_rate: float,
            mem_bps: float) -> tuple[float, str]:
    """The least time in seconds and what sets it."""
    tb, to = nbytes / mem_bps, ops / int_rate
    return (tb, "bytes") if tb >= to else (to, "operations")
