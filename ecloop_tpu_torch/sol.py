"""Speed-of-light account of the port on one NVIDIA H100 (the counterpart
of `ecloop_tpu.sol`, whose VPU model it replaces).

The least time the card could take for some work is the larger of two
times: the bytes that the work must move (each input limb read once,
each output limb written once, 8 bytes per int64 limb) over the memory
rate, and its 32-bit integer operations over the integer rate.

  * Integer rate: the CUDA C++ Programming Guide's throughput table
    gives compute capability 9.0 64 results per clock per SM for 32-bit
    integer add, logic, shift and multiply-add, so the rate is 64 x the
    SM count x the maximum SM clock, both read on the card (`int_rate`).
  * Memory rate: 3.35 TB/s, the H100 SXM's HBM3 (`MEM_BPS`).
  * `ECLOOP_INT_PEAK` and `ECLOOP_HBM_PEAK` (ops/s, bytes/s) override
    either, for another card or for a run without one.

Operations are counted without a trace.  A field form is run once on a
small CPU batch with `fel`'s functions counted (`count_field_ops`), and
each call is priced at its 32-bit cost read off `csrc/field.cuh`
(`FIELD_PRICE`); the plain form's own torch ops, which emulate 32-bit
words with 16-bit limbs in int64, are not priced.  K1 is counted by
running its function on one key (`HashOpCount`), K2 and K3 by their own
accounts (`inv_account`, `mixed_add_account`), K4 by running its plain
forms on data-free tensors of the step's shapes (`chord_account`), K5
from the probe terms below and the probes its data reads
(`probe_pack_account`, `probe_reads`), K1 with K5 as its epilogue by
both (`hash_probe_account`), K8 by its SHA-256 blocks counted as K1's
compression is and the bytes it moves (`mul_keys_account`);
`chip_smoke.py` holds their device times against these.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess

import numpy as np
import torch

from . import bloom, ecc, fel, hash160

MEM_BPS = 3.35e12                 # H100 SXM HBM3, bytes/s
INT_LANE_OPS_PER_CLK = 64         # 32-bit integer results per clock per SM
LIMB_BYTES = 8                    # one int64 limb
GATHER_POINT_BYTES = 32 * LIMB_BYTES   # a table point: x and y, 16 limbs each
# a modular multiply (or square: K3 squares with fe_mul) is 64 32x32->64-bit
# multiplies plus about 10 in the fold, a multiply by a small constant 8 + 10
FE_MUL_OPS = 74
FE_SMALL_OPS = 18
FE_ADD_OPS = 16                   # 8-word subtract/add chain + 8-word fix-up
FE_TEST_OPS = 8                   # 8-word OR (is_zero) or select
FE_EQ_OPS = 16                    # 8 XOR + 8 OR
FERMAT_PRODUCTS = 270             # the inversion chain: 255 squares, 15 multiplies
K2_BLOCK = 128                    # elements per K2 block, one inversion each
FIELD_PRICE = {
    "mul_mod": FE_MUL_OPS, "sqr_mod": FE_MUL_OPS, "mul_small": FE_SMALL_OPS,
    "add_mod": FE_ADD_OPS, "sub_mod": FE_ADD_OPS, "neg_mod": FE_ADD_OPS,
    "is_zero": FE_TEST_OPS, "select": FE_TEST_OPS, "eq": FE_EQ_OPS,
    "inv_mod": FERMAT_PRODUCTS * FE_MUL_OPS,
}
# inv_mod_batch is priced per call by inv_account: 3 products per element
# and one inversion per call
COUNTED = tuple(FIELD_PRICE) + ("inv_mod_batch",)
HASH_LIMBS = {True: 16 + 1 + 5, False: 32 + 5}   # read (x, y's parity) + written
# probes, read off csrc/probe.cuh as 32-bit work per element: a pow2
# probe derives its low index word (3 shifts, 2 ors), masks and shifts it
# (2), loads a word (1), extracts the bit (3) and ands it (1); an exact
# probe also derives the high index word (2) and reduces the index mod
# nbits = 64 m by a multiply-high (16: a = idx >> 6 in 2; umulhi(a, r) in
# 11, the high half of one and the full 64 bits of three 32 x 32
# products with the middle column's 4 carries; a - q m in 1 multiply-add
# on the low words; the conditional subtract in 2), its word index taking
# the place of the pow2 mask; the list-mode prefilter compares the first
# hash word with each target's (one op per target).
PROBE_POW2_OPS = 11
PROBE_EXACT_OPS = 11 + 2 + 16
# K5 (csrc/probe_pack.cu) searches the sorted first words instead: per
# level an add, a compare and a select, then one compare; each key's bit
# is packed by one warp vote
PROBE_SEARCH_OPS = 3
PACK_OPS = 1
M32 = 0xFFFFFFFF


# --- the card -------------------------------------------------------------------------

def smi(query: str) -> str:
    """One nvidia-smi --query-gpu field of the first card."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def int_rate() -> tuple[float, int, int]:
    """(32-bit integer ops/s, SMs, maximum SM clock in MHz) of card 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = int(smi("clocks.max.sm").split()[0])
    return INT_LANE_OPS_PER_CLK * sms * mhz * 1e6, sms, mhz


def peaks() -> tuple[float, float]:
    """(32-bit integer ops/s, memory bytes/s) of the card, or of the
    overrides ECLOOP_INT_PEAK / ECLOOP_HBM_PEAK.  Without a CUDA device
    both overrides are needed: a CPU has no device peak."""
    ops = os.environ.get("ECLOOP_INT_PEAK")
    mem = os.environ.get("ECLOOP_HBM_PEAK")
    if ops is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: set ECLOOP_INT_PEAK and "
                               "ECLOOP_HBM_PEAK for a speed-of-light account")
        ops = int_rate()[0]
    return float(ops), float(mem) if mem is not None else MEM_BPS


def bound(nbytes: float, ops: float, int_ops: float,
          mem_bps: float = MEM_BPS) -> tuple[float, str]:
    """The least time in ms for the work, and what sets it ("bytes" or
    "operations"), at `int_ops` 32-bit integer operations per second."""
    t_bytes, t_ops = nbytes / mem_bps * 1e3, ops / int_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- counting field operations -----------------------------------------------------

def _elements(out) -> int:
    """Elements of a field op's result: limbs (16, ...) or a batch mask."""
    t = out[0] if isinstance(out, tuple) else out
    return t[0].numel() if t.dtype == torch.int64 else t.numel()


@contextlib.contextmanager
def count_field_ops():
    """Count the calls of `fel`'s field functions (COUNTED) made inside
    the block; calls made by a counted call (inv_mod's products) are
    part of it.  Yields a list that receives (name, elements) per call."""
    calls = []
    depth = [0]
    saved = {name: getattr(fel, name) for name in COUNTED}

    def counted(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((name, _elements(out)))
            return out
        return run

    for name, fn in saved.items():
        setattr(fel, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(fel, name, fn)


def price(calls) -> float:
    """32-bit operations of counted field calls."""
    return sum(inv_account(n)[1] if name == "inv_mod_batch"
               else FIELD_PRICE[name] * n for name, n in calls)


def ops_per_element(fn, *args, elems: int) -> float:
    """Run fn(*args) once and return its priced field operations per
    element.  fn must reach fel's functions through the module (a
    reference taken before the count is not counted)."""
    with count_field_ops() as calls:
        fn(*args)
    return price(calls) / elems


# --- the kernels' own accounts ---------------------------------------------------

def inv_account(n: int) -> tuple[float, float]:
    """K2 (batched inversion of n elements): (bytes, operations).
    Montgomery's trick needs 3 multiplies per element and one inversion
    per call, counted as the Fermat chain's 270 products however a kernel
    cuts the batch; 16 limbs in and 16 out per element."""
    return n * 32 * LIMB_BYTES, (3 * n + FERMAT_PRODUCTS) * FE_MUL_OPS


def mixed_add_account(n: int, active: int) -> tuple[float, float]:
    """K3 (one window add over n lanes, `active` of them not skipped):
    80 limbs in, 48 out and a skip byte per lane; 12 products and one
    small multiply per active lane (the incomplete form's work; the
    doubling runs only where q == g)."""
    return n * (128 * LIMB_BYTES + 1), active * (12 * FE_MUL_OPS + FE_SMALL_OPS)


def chord_account(m: int, k: int, need_beta: bool,
                  need_neg: bool) -> dict[str, tuple[float, float]]:
    """K4 for one `add` step of m centers x k keys: (bytes, operations)
    of each launch, {"chord_dx": ..., "chord_points": ...}.  Bytes: 16
    limbs per element read or written once; chord_dx reads the centers'
    x, the table's x and D.x and writes m*k/2 + m differences;
    chord_points reads both coordinates of those three and the inverses,
    and writes the m*k points' rows (x, y, beta*x and beta^2*x with
    need_beta, -y with need_neg) and the m advanced centers.  Operations:
    the plain forms (ecc.chord_dx_plain, chord_points_plain) run once on
    tensors of these shapes on the meta device, which holds no data,
    with fel's functions counted and priced."""
    k2 = k // 2
    elem = fel.NLIMBS * LIMB_BYTES
    inv_n = m * k2 + m
    rows = 2 + 2 * need_beta + need_neg

    def meta(*shape):
        return torch.empty((fel.NLIMBS,) + shape, dtype=torch.int64,
                           device="meta")
    cx, cy, tx, ty, dp, inv = (meta(m), meta(m), meta(k2), meta(k2), meta(),
                               meta(inv_n))
    with count_field_ops() as dx_calls:
        ecc.chord_dx_plain(cx, tx, dp)
    with count_field_ops() as pt_calls:
        ecc.chord_points_plain(cx, cy, tx, ty, dp, dp, inv, need_beta,
                               need_neg)
    return {"chord_dx": ((m + k2 + 1 + inv_n) * elem, price(dx_calls)),
            "chord_points": ((2 * (m + k2 + 1) + inv_n + rows * m * k
                              + 2 * m) * elem, price(pt_calls))}


def probe_reads(filt, h: torch.Tensor, bits: torch.Tensor,
                first_words: torch.Tensor | None = None) -> int:
    """Bit words that K5's probes read for the (5, B) hash words h, with
    the arguments of `filt.device_probe`: each key's probes in order up
    to its first clear bit (all of them when it passes); 0 in compare
    mode.  Counted with the plain probes."""
    if filt.mode == "bloom":
        count = filt.blf_probes

        def upto(p):
            return bloom.probe_exact(h, bits, filt.blf.nbits, p)
    elif first_words is not None:
        return 0
    else:
        count = filt.pow2_probes

        def upto(p):
            return bloom.probe_pow2(h, bits, filt.pow2_log2, p)
    reads = h.shape[1]
    for p in range(1, count):
        reads += int(upto(p).sum())
    return reads


def _probe_work(keys: int, mode: str, reads: int, n_first: int,
                bits_words: int) -> tuple[float, float]:
    """The probe's own (bytes, operations) over `keys` keys, its input
    hash words and output mask words aside: compare mode reads the
    n_first sorted first words once and searches them, ceil(log2
    n_first) levels and a compare per key; exact and pow2 read the
    `reads` probed bit words (`probe_reads`), 4 bytes each but at most
    the filter's bits_words once, PROBE_EXACT_OPS or PROBE_POW2_OPS per
    read.  Both: a vote per key."""
    if mode == "compare":
        levels = max(n_first - 1, 0).bit_length()
        return n_first * 8, keys * (levels * PROBE_SEARCH_OPS
                                    + int(n_first > 0) + PACK_OPS)
    per = PROBE_EXACT_OPS if mode == "exact" else PROBE_POW2_OPS
    return 4 * min(reads, bits_words), reads * per + keys * PACK_OPS


def probe_pack_account(n: int, mode: str, reads: int = 0, n_first: int = 0,
                       bits_words: int = 0) -> tuple[float, float]:
    """K5 over n keys (csrc/probe_pack.cu): (bytes, operations).  The
    first hash word per key in compare mode, the five otherwise, the
    probe's own work (`_probe_work`) and one 8-byte word out per 32
    keys."""
    nbytes, ops = _probe_work(n, mode, reads, n_first, bits_words)
    hash_bytes = n * (1 if mode == "compare" else 5) * LIMB_BYTES
    return hash_bytes + nbytes + n // 32 * 8, ops


def hash_probe_account(n: int, planes, mode: str, reads: int = 0,
                       n_first: int = 0, bits_words: int = 0,
                       counts: dict | None = None) -> tuple[float, float]:
    """K1 with K5 as its epilogue (csrc/hash160_probe.cu) over n keys per
    plane, planes as `kernels.hash160_probe` takes them ((x row, y row,
    is33) each): (bytes, operations).  Bytes: every x row the planes name
    read once (16 limbs per key), every y row once (16 limbs, or only its
    parity limb where addr33 planes alone read it), the probe's own
    (`_probe_work`, `reads` summed over the planes) and one 8-byte mask
    word per 32 keys and plane; no hash rows.  Operations: K1's per key
    and plane (`hash_ops_per_key` of counts[is33], `hash_counts` by
    default) and the probe's."""
    counts = counts or {f: hash_counts(f) for f in (True, False)}
    y_limbs = {}
    for _, j, is33 in planes:
        y_limbs[j] = max(y_limbs.get(j, 1), 1 if is33 else fel.NLIMBS)
    limbs = fel.NLIMBS * len({i for i, _, _ in planes}) + sum(y_limbs.values())
    nbytes, ops = _probe_work(n * len(planes), mode, reads, n_first,
                              bits_words)
    ops += n * sum(hash_ops_per_key(counts[is33]) for *_, is33 in planes)
    return (n * limbs * LIMB_BYTES + nbytes + len(planes) * (n // 32) * 8,
            ops)


def scan_account(n: int, d: int, active: int) -> tuple[float, float]:
    """The window scan (search/mul.window_scan) of n lanes over d windows,
    `active` of the n * d lane-windows not skipped: (bytes, operations).
    Per lane and window the gathered table point (x and y, 32 limbs,
    `GATHER_POINT_BYTES`), its int64 table index and its skip byte; per
    lane the accumulator read once and written once (48 limbs each way);
    K3's operations per active lane-window.  The scan's K3 launches move
    the accumulator through memory every window, which the function
    does not need."""
    per_lane = d * (GATHER_POINT_BYTES + 8 + 1) + 2 * 48 * LIMB_BYTES
    return n * per_lane, mixed_add_account(n, active)[1]


def hash_ops_per_key(counts: dict) -> float:
    """K1's operations per key at the 64-per-clock rate: its ALU-only
    operations, or half of all of them where that is more (its adds may
    issue on the FMA pipe too)."""
    return max(counts["alu"], (counts["alu"] + counts["either"]) / 2)


def hash_account(n: int, is33: bool, counts: dict) -> tuple[float, float]:
    """K1 (hash160 of n keys): (bytes, operations); counts is
    `hash_counts(is33)`."""
    return n * HASH_LIMBS[is33] * LIMB_BYTES, n * hash_ops_per_key(counts)


def mul_keys_account(lanes: int, d: int, keys: int, line_bytes: int = 0,
                     sha_blocks: int = 0) -> tuple[float, float]:
    """K8 over `lanes` lanes of d int32 digits, `keys` of them keys:
    (bytes, operations).  The lines entry (sha_blocks > 0) reads
    line_bytes of lines and n + 1 int64 offsets and runs sha_blocks
    compressions, each counted as K1's (`sha_block_ops`); the words
    entry reads 32 bytes a key.  The message build, the reduction and
    the digit cut are left out of the operations."""
    read = line_bytes + 8 * (keys + 1) if sha_blocks else 32 * keys
    return read + 4 * d * lanes, sha_blocks * sha_block_ops()


@functools.lru_cache(maxsize=1)
def sha_block_ops() -> float:
    """Operations of one SHA-256 compression of a message block that
    depends on the key, from the initial state, at the 64-per-clock
    rate (`hash_ops_per_key`'s rule)."""
    c = HashOpCount()
    c.sha256([(v, False) for v in hash160.SHA_IV],
             [(i, True) for i in range(16)])
    return hash_ops_per_key({"alu": c.alu, "either": c.add})


# --- K1's function, counted ------------------------------------------------------

class HashOpCount:
    """K1's function (csrc/hash160.cu) on one key in plain Python, counting
    the 32-bit operations it needs.  A word is (value, depends on the key);
    work on constants alone is folded away.  A sum of n key-dependent terms
    and one folded constant costs ceil((n - 1) / 2) 3-input adds, and a
    multiply-add one operation: both issue on the ALU or the FMA pipe
    (`add`).  A 3-input logic op, a rotate or shift, a funnel shift, a
    rotate with an add (LEA.HI) and a byte permute cost one operation
    each, on the ALU pipe only (`alu`)."""

    def __init__(self):
        self.alu = self.add = 0

    def sum(self, *xs):
        n_var = sum(v for _, v in xs)
        if n_var:
            self.add += (n_var + (sum(w for w, v in xs if not v) & M32 != 0)) // 2
        return sum(w for w, _ in xs) & M32, n_var > 0

    def mad(self, a, m: int, b):
        """a * m + b: one IMAD (or LEA)."""
        self.add += a[1] or b[1]
        return (a[0] * m + b[0]) & M32, a[1] or b[1]

    def op(self, f, *xs):
        """One ALU-pipe operation f of up to three words."""
        var = any(v for _, v in xs)
        self.alu += var
        return f(*(w for w, _ in xs)) & M32, var

    def rotr(self, x, n):
        return self.op(lambda a: a >> n | a << (32 - n), x)

    def funnel(self, hi, lo, n):
        """(hi:lo) >> n, the low word."""
        return self.op(lambda h, l: (h << 32 | l) >> n, hi, lo)

    def bswap(self, x):
        return self.op(lambda a: int.from_bytes(a.to_bytes(4, "big"),
                                                "little"), x)

    def sha256(self, st, w):
        xor3 = lambda a, b, c: a ^ b ^ c  # noqa: E731
        a, b, c, d, e, f, g, h = st
        for i in range(64):
            if i >= 16:
                w15, w2 = w[(i - 15) & 15], w[(i - 2) & 15]
                s0 = self.op(xor3, self.rotr(w15, 7), self.rotr(w15, 18),
                             self.op(lambda v: v >> 3, w15))
                s1 = self.op(xor3, self.rotr(w2, 17), self.rotr(w2, 19),
                             self.op(lambda v: v >> 10, w2))
                w[i & 15] = self.sum(w[i & 15], s0, w[(i - 7) & 15], s1)
            t1 = self.sum(h, self.op(xor3, *(self.rotr(e, r) for r in
                                             (6, 11, 25))),
                          self.op(lambda x, y, z: (x & y) ^ (~x & z), e, f, g),
                          (hash160.SHA_K[i], False), w[i & 15])
            h, g, f, e = g, f, e, self.sum(d, t1)
            d, c, b, a = c, b, a, self.sum(
                t1, self.op(xor3, *(self.rotr(a, r) for r in (2, 13, 22))),
                self.op(lambda x, y, z: (x & y) ^ (x & z) ^ (y & z), a, b, c))
        return [self.sum(s, v) for s, v in zip(st, (a, b, c, d, e, f, g, h))]

    def rmd160(self, x):
        fs = (lambda a, b, c: a ^ b ^ c, lambda a, b, c: (a & b) | (~a & c),
              lambda a, b, c: (a | ~b) ^ c, lambda a, b, c: (a & c) | (b & ~c),
              lambda a, b, c: a ^ (b | ~c))
        iv = [(v, False) for v in hash160.RMD_IV]
        left, right = list(iv), list(iv)
        for j in range(80):
            for s, f, r, sh, k in (
                    (left, fs[j // 16], hash160.RMD_R1, hash160.RMD_S1,
                     hash160.RMD_K1),
                    (right, fs[4 - j // 16], hash160.RMD_R2, hash160.RMD_S2,
                     hash160.RMD_K2)):
                a, b, c, d, e = s
                t = self.sum(a, self.op(f, b, c, d), x[r[j]],
                             (k[j // 16], False))
                n = sh[j]       # rotate and add: one LEA.HI
                t = self.op(lambda u, v: (u << n | u >> (32 - n)) + v, t, e)
                s[:] = e, t, b, self.rotr(c, 22), d
        (al, bl, cl, dl, el), (ar, br, cr, dr, er) = left, right
        return [self.sum(iv[1], cl, dr), self.sum(iv[2], dl, er),
                self.sum(iv[3], el, ar), self.sum(iv[4], al, br),
                self.sum(iv[0], bl, cr)]

    def hash160(self, x_limbs, y_limbs, is33: bool) -> list[int]:
        """The 5 big-endian words K1 writes for the key whose 16-bit limbs
        (little-endian, as ints) are x_limbs and y_limbs."""
        def be_words(limbs):
            v = [(int(l), True) for l in limbs]
            return [self.mad(v[15 - 2 * i], 1 << 16, v[14 - 2 * i])
                    for i in range(8)]
        xw, zero = be_words(x_limbs), (0, False)
        iv = [(v, False) for v in hash160.SHA_IV]
        if is33:
            pre = self.op(lambda v: v & 1 | 2, (int(y_limbs[0]), True))
            w = [self.funnel(hi, lo, 8) for hi, lo in zip([pre] + xw, xw)]
            w += [self.mad(xw[7], 1 << 24, (0x00800000, False))]
            w += [zero] * 6 + [(264, False)]
            st = self.sha256(iv, w)
        else:
            yw = be_words(y_limbs)
            w = [self.funnel(hi, lo, 8) for hi, lo in
                 zip([(4, False)] + xw + yw[:7], xw + yw)]
            st = self.sha256(iv, w)
            w = [self.mad(yw[7], 1 << 24, (0x00800000, False))]
            st = self.sha256(st, w + [zero] * 14 + [(520, False)])
        m = [self.bswap(v) for v in st] + [(0x80, False)] + [zero] * 5
        return [self.bswap(v)[0] for v in
                self.rmd160(m + [(256, False), zero])]


def hash_ops(x_limbs, y_limbs, is33: bool) -> tuple[int, int, list[int]]:
    """(ALU-only operations, either-pipe operations, K1's 5 words) of one
    key; the count is the same for every key."""
    c = HashOpCount()
    words = c.hash160(x_limbs, y_limbs, is33)
    return c.alu, c.add, words


@functools.lru_cache(maxsize=2)
def hash_counts(is33: bool) -> dict:
    """{"alu": n, "either": n}: K1's operations per key (key 1's limbs)."""
    alu, either, _ = hash_ops([1] + [0] * 15, [2] + [0] * 15, is33)
    return {"alu": alu, "either": either}


# --- leaf and step budgets ---------------------------------------------------------

def leaf_budgets() -> dict[str, float]:
    """32-bit operations per element of every hot leaf: the field forms
    counted on 8 CPU lanes and priced, K1 and K3 by their own accounts,
    the probes as read off their code (the list-mode prefilter at the
    puzzle list's 160 targets)."""
    n = 8
    rng = np.random.default_rng(5)
    a, b, c, d, e = (torch.from_numpy(fel.random_limbs(rng, n))
                     for _ in range(5))
    out = {name: ops_per_element(lambda *xs, name=name:
                                 getattr(fel, name)(*xs), *args, elems=n)
           for name, args in (("mul_mod", (a, b)), ("sqr_mod", (a,)),
                              ("add_mod", (a, b)), ("sub_mod", (a, b)))}
    out.update({
        "chord_add": ops_per_element(ecc.affine_add_rows, a, b, c, d, e,
                                     elems=n),
        "addr33": hash_ops_per_key(hash_counts(True)),
        "addr65": hash_ops_per_key(hash_counts(False)),
        "bloom_probe": 20 * PROBE_EXACT_OPS + 19,
        "bloom_probe_k3": 3 * PROBE_EXACT_OPS + 2,
        "probe_pow2": 2 * PROBE_POW2_OPS + 1,
        "probe_cmp": 160.0,
        "proj_add_affine": mixed_add_account(1, 1)[1],
        "proj_add_affine_complete": mixed_add_account(1, 1)[1],
    })
    return out


def batch_inverse_ops(leaf: dict) -> float:
    """Per element of a K2 batch: 3 products, and one inversion (the
    Fermat chain's 270 products) per 128-element block."""
    return 3 * leaf["mul_mod"] + FERMAT_PRODUCTS * leaf["mul_mod"] / K2_BLOCK


def step_budget(cfg, leaf: dict[str, float] | None = None,
                probe: str = "probe_pow2") -> dict:
    """Per-key operation budget of one `add` step (search/add.make_step)
    of cfg's M*K keys.  The terms of `ecloop_tpu.sol.step_budget`, except
    where the port's step is built otherwise:
      dx sub:        (MK/2 + M) sub_mod (as the JAX package)
      batch inverse: (MK/2 + M) elements of K2, which inverts one
                     128-element block at a time (`batch_inverse_ops`),
                     not 4,096 lanes over one Fermat chain
      chord add:     MK/2 pairs x 2 chords sharing an inverse (as JAX)
      endo synth:    2 mul per key with -endo (as JAX)
      hash+probe:    per variant its own form's K1 count (the JAX package
                     prices every variant as addr33) plus the probe."""
    leaf = leaf or leaf_budgets()
    mk = cfg.keys_per_step
    inv_elems = mk / 2 + cfg.centers
    mult = 6 if cfg.endo else 1
    hashes = mult * (int(cfg.addr33) * leaf["addr33"]
                     + int(cfg.addr65) * leaf["addr65"])
    variants = mult * (int(cfg.addr33) + int(cfg.addr65))
    per_key = {
        "dx sub": leaf["sub_mod"] * inv_elems / mk,
        "batch inverse": batch_inverse_ops(leaf) * inv_elems / mk,
        "chord add": leaf["chord_add"],
        "endo synth": 2 * leaf["mul_mod"] if cfg.endo else 0.0,
        "hash+probe": hashes + variants * leaf[probe],
    }
    total = sum(per_key.values())
    return {"per_key": per_key, "total_ops_per_point": total,
            "ops_per_checked_key": total / mult, "checked_mult": mult}


def mul_step_budget(cfg, w: int, leaf: dict[str, float] | None = None,
                    probe: str = "probe_pow2") -> dict:
    """Per-key budget of one `mul` job (search/mul.make_mul_step): the
    operations, and the bytes of the window scan, which the operation
    count cannot see.  Per key: d = 255 // w + 1 window adds (d - 1
    incomplete, 1 complete: K3's account), one K2 element and 2 products
    to affine, then per address form its K1 count and the probe.  A
    gathered point is x and y as 16 int64 limbs each, 256 bytes (the JAX
    package's u32 limbs: 128 bytes; `gather_bytes_per_key`); the scan's
    bytes add each window's index and skip byte and the accumulator's
    one read and write (`scan_account`, `scan_bytes_per_key`)."""
    leaf = leaf or leaf_budgets()
    d = (255 // w) + 1
    per_key = {
        "window adds": (d - 1) * leaf["proj_add_affine"]
        + leaf["proj_add_affine_complete"],
        "batch inverse": batch_inverse_ops(leaf) + 2 * leaf["mul_mod"],
        "hash+probe": int(cfg.addr33) * leaf["addr33"]
        + int(cfg.addr65) * leaf["addr65"]
        + (int(cfg.addr33) + int(cfg.addr65)) * leaf[probe],
    }
    return {"per_key": per_key, "total_ops_per_key": sum(per_key.values()),
            "gather_bytes_per_key": d * GATHER_POINT_BYTES,
            "scan_bytes_per_key": scan_account(1, d, d)[0], "windows": d}


def mul_ceiling(cfg, w: int, leaf: dict[str, float] | None = None,
                scan_only: bool = False) -> dict:
    """`mul` speed of light at window width w: the lower of the
    operation-bound and the scan-bytes-bound keys/s, and which binds
    ("operations" or "bytes").  scan_only=True budgets the window scan
    alone (what bench-gtable times, priced as the bench's ec_gtable_mul
    row is: `scan_account`)."""
    ops_peak, mem_peak = peaks()
    b = mul_step_budget(cfg, w, leaf)
    ops = b["per_key"]["window adds"] if scan_only else b["total_ops_per_key"]
    ops_rate = ops_peak / ops
    mem_rate = mem_peak / b["scan_bytes_per_key"]
    return {"ops_bound_keys_per_s": ops_rate,
            "bytes_bound_keys_per_s": mem_rate,
            "ceiling_keys_per_s": min(ops_rate, mem_rate),
            "binding": "operations" if ops_rate <= mem_rate else "bytes",
            **b}


def report(cfg, measured_keys_per_sec: float | None = None,
           probe: str = "probe_cmp") -> str:
    """The `add` step's speed-of-light breakdown as text (the probe
    defaults to the list-mode prefilter: the puzzle list's 160 targets)."""
    ops_peak, _ = peaks()
    leaf = leaf_budgets()
    b = step_budget(cfg, leaf, probe=probe)
    lines = [f"# speed-of-light budget ({ops_peak / 1e12:.3f} T 32-bit "
             f"integer ops/s)", f"{'leaf':24s} {'ops/elem':>10s}"]
    lines += [f"{k:24s} {v:10.0f}" for k, v in leaf.items()]
    lines += ["", f"{'step component':24s} {'ops/point':>10s} {'share':>7s}"]
    total = b["total_ops_per_point"]
    lines += [f"{k:24s} {v:10.0f} {v / total:6.1%}"
              for k, v in b["per_key"].items()]
    sol = ops_peak / b["ops_per_checked_key"]
    lines.append(f"{'TOTAL':24s} {total:10.0f}")
    lines.append(f"speed-of-light: {sol / 1e6:.1f} M checked-keys/s "
                 f"({b['ops_per_checked_key']:.0f} ops/checked-key)")
    if measured_keys_per_sec:
        lines.append(f"measured:       {measured_keys_per_sec / 1e6:.1f} "
                     f"M keys/s = {measured_keys_per_sec / sol:.1%} of it")
    return "\n".join(lines)
