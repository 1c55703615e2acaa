"""Host-side search bookkeeping (the `add` path's part of
`ecloop_tpu.search.common`, plus `default_offs_size` from
`ecloop_tpu.search.rnd`).  Scalar arithmetic is plain Python ints."""

from __future__ import annotations

import dataclasses
from typing import Iterator

from ecloop_tpu import golden, native

N = golden.N

# reference constants (main.c:16-17); GROUP is the coverage-rounding unit
# of a claim
MAX_JOB_SIZE = 2 * 1024 * 1024
GROUP = 2048


def derive_h160(priv: int, is33: bool) -> str:
    """hash160(priv*G) as hex, from the native C++ oracle when it is
    built, else from the golden model."""
    if native.available():
        h = native.pk_hash160(priv % N, is33)
        if h is not None:
            return h.hex()
    pt = golden.point_mul(priv)
    return (golden.addr33(pt) if is33 else golden.addr65(pt)).hex()


@dataclasses.dataclass
class SearchConfig:
    range_s: int = GROUP
    range_e: int = golden.P
    stride_offs: int = 0              # -d offset: stride = 2^offs
    addr33: bool = True
    addr65: bool = False
    endo: bool = False
    # device batch geometry: one step covers centers * group_k keys.  The
    # defaults are the JAX package's; they are a starting point here.
    centers: int = 32                 # M parallel group centers
    group_k: int = 4096               # K keys per center per step
    steps_per_call: int = 8           # steps between two mask drains

    @property
    def stride(self) -> int:
        return 1 << self.stride_offs

    @property
    def keys_per_step(self) -> int:
        return self.centers * self.group_k


@dataclasses.dataclass(frozen=True)
class Found:
    label: str                        # "addr33" | "addr65"
    h160: str                         # 40 hex chars
    priv: int

    def line(self) -> str:
        return f"{self.label}: {self.h160} <- {self.priv:064x}"

    def tsv(self) -> str:
        return f"{self.label}\t{self.h160}\t{self.priv:064x}"


@dataclasses.dataclass(frozen=True)
class Claim:
    """One worker claim: keys start + i*stride for i in [0, coverage)."""
    start: int
    job: int                          # k_checked increment (job_size)
    coverage: int                     # ceil(job/GROUP)*GROUP keys hashed


def plan_claims(range_s: int, range_e: int, job_size: int,
                stride: int) -> Iterator[Claim]:
    """The reference's claim arithmetic (cmd_add_worker, main.c:405-435):
    the cursor walks range_s by job_size*stride mod N until it passes
    range_e or wraps."""
    cursor = range_s
    while cursor < range_e:
        cov = -(-job_size // GROUP) * GROUP
        yield Claim(start=cursor, job=job_size, coverage=cov)
        nxt = (cursor + job_size * stride) % N
        if nxt < range_s:
            return
        cursor = nxt


def derive_job_size(range_s: int, range_e: int) -> int:
    return min(range_e - range_s, MAX_JOB_SIZE)


def verify_found(priv: int, label: str, expect_h160: str) -> None:
    """Re-derive the pubkey hash from scratch; raises on a mismatch."""
    h = derive_h160(priv, label == "addr33")
    if h != expect_h160:
        raise AssertionError(
            f"hash mismatch for pk={priv:064x} ({label}): "
            f"expected {expect_h160}, derived {h}")


def recover_priv(base: int, offset: int, stride: int, endo_idx: int) -> int:
    """Private key of candidate (offset, endo) relative to base."""
    return golden.endo_priv((base + offset * stride) % N, endo_idx)


def default_offs_size(range_e: int, offs: int | None, size: int | None,
                      rng, is_rnd: bool) -> tuple[int, int]:
    """-d defaulting and clamping (load_offs_size, main.c:703-746); `rng`
    (with rand64()) is read only when is_rnd."""
    min_size, max_size = 20, 64
    range_bits = range_e.bit_length()
    default_bits = max(min_size, range_bits) if range_bits < 32 else 32
    max_offs = max(1, max(min_size, range_bits) - default_bits)

    if offs is None and size is None:
        if is_rnd:
            return rng.rand64() % max_offs, default_bits
        return 0, default_bits
    offs = offs or 0
    size = size if size is not None else default_bits
    if offs > 255:
        raise ValueError("invalid offset, max is 255")
    if not (min_size <= size <= max_size):
        raise ValueError(f"invalid size, min is {min_size} and max is {max_size}")
    return min(max_offs, offs), size
