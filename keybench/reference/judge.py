"""The comparison that decides `correct`: every key the program reported in
the window, and every key the benchmark planted among the keys the
window searched, judged by the benchmark's own secp256k1, hashes and
filter semantics.  It reads the program's outputs (found keys, key
counts) only to judge them.

Three numbers, each with the limit 0 (an exact comparison):
  wrong_found     reported keys that are not answers: the re-derived
                  hash160 differs, the hash is not a target (list) or not
                  in the bloom filter (all 20 probes), the key lies
                  outside what the window searched, or it is reported
                  more often than it was searched
  missed_planted  planted keys inside the searched keys, not reported
  k_checked_gap   |program's key count - the reference's| over the
                  sub-ranges (rnd) or lines (mul) the window finished
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np

from . import bloom, secp

MAX_JOB_SIZE = 2 * 1024 * 1024       # ecloop main.c: a worker's claim


@dataclasses.dataclass
class Targets:
    """What the filter holds: a set of hash160s (list mode) or the bloom
    filter's bytes."""
    hashes: set | None = None
    bits: np.ndarray | None = None

    def holds(self, h160: bytes) -> bool:
        if self.bits is not None:
            return bloom.member(h160, self.bits)
        return h160 in self.hashes


def claimed_keys(lo: int, hi: int, stride: int, endo: bool) -> int:
    """ecloop's k_checked for one range: a claim of min(hi - lo, 2^21)
    keys per cursor step of job * stride, until the cursor passes hi or
    wraps; x6 with the endomorphism."""
    job = min(hi - lo, MAX_JOB_SIZE)
    total, cursor = 0, lo
    while cursor < hi:
        total += job
        nxt = (cursor + job * stride) % secp.N
        if nxt < lo:
            break
        cursor = nxt
    return total * (6 if endo else 1)


@dataclasses.dataclass
class Subrange:
    lo: int
    hi: int
    stride: int
    done: int                 # keys lo + i * stride, i < done, were searched
    finished: bool            # the whole sub-range was searched
    program_keys: int         # the program's k_checked for it (finished only)


def _form(label: str) -> bool:
    return label == "addr33"


def judge_range(found, subranges: list[Subrange], planted, targets: Targets,
                endo: bool) -> dict:
    """found: (label, h160 hex, priv) of every report; planted: (priv,
    label, sub-range index, offset) of every planted key."""
    wrong = 0
    seen = collections.Counter()
    for label, h160, priv in found:
        seen[(priv, label)] += 1
        h = secp.pubkey_hash160(priv, _form(label))
        ok = h.hex() == h160 and targets.holds(h) and seen[(priv, label)] == 1
        if ok:
            ok = any(_inside(priv, r, endo) for r in subranges)
        wrong += not ok
    missed = due = 0
    for priv, label, r, off in planted:
        if r < len(subranges) and off < subranges[r].done:
            due += 1
            missed += seen[(priv, label)] == 0
    gap = sum(abs(r.program_keys - claimed_keys(r.lo, r.hi, r.stride, endo))
              for r in subranges if r.finished)
    return _result(wrong, missed, gap, len(found) + due)


def _inside(priv: int, r: Subrange, endo: bool) -> bool:
    for e in range(6) if endo else range(1):
        k = secp.endo_base(priv, e)
        i, rem = divmod(k - r.lo, r.stride)
        if rem == 0 and 0 <= i < r.done:
            return True
    return False


def judge_mul(found, fed: int, program_keys: int, feeds: dict, targets:
              Targets, fed_lines) -> dict:
    """found: (label, h160 hex, priv) of every report; fed: lines fed;
    feeds: {(priv, label): times its line was fed} of the planted lines;
    fed_lines(): the lines fed, read only when a report is not one of
    the planted keys (a bloom false positive)."""
    wrong = 0
    seen = collections.Counter()
    privs = None
    for label, h160, priv in found:
        seen[(priv, label)] += 1
        h = secp.pubkey_hash160(priv, _form(label))
        ok = h.hex() == h160 and targets.holds(h)
        if ok and (priv, label) in feeds:
            ok = seen[(priv, label)] <= feeds[(priv, label)]
        elif ok:
            if privs is None:
                privs = collections.Counter(
                    int.from_bytes(hashlib.sha256(ln.encode()).digest(), "big")
                    % secp.N for ln in fed_lines())
            ok = seen[(priv, label)] <= privs[priv]
        wrong += not ok
    missed = sum(max(0, n - seen[key]) for key, n in feeds.items())
    return _result(wrong, missed, abs(program_keys - fed),
                   len(found) + sum(feeds.values()))


def _result(wrong: int, missed: int, gap: int, attempted: int) -> dict:
    checks = {"wrong_found": {"value": wrong, "limit": 0},
              "missed_planted": {"value": missed, "limit": 0},
              "k_checked_gap": {"value": gap, "limit": 0}}
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": attempted, "failed": wrong + missed,
            "checks": checks}
