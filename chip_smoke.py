#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ecloop_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (printing ptxas's register and spill
report), holds each against its plain torch version on the card, drives
the two main paths through the CLI's own code: `add` on the reference's
9-key vector (plus -endo and a bloom filter) and `mul` on the 1080-key
vector (plus 1,048,576 keys for its rate), with the w=14 table built on
the card; then times the kernels against their plain versions and their
least possible time.  Each phase prints one line; any failure raises.
Before the last line it prints one JSON object describing the kernels,
and the last line is {"ok": true, "device": {...}}.  Without a CUDA
device it exits with 2 and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PUZZLES = os.path.join(ROOT, "data", "btc-puzzles-hash")
BW_PRIV = os.path.join(ROOT, "data", "btc-bw-priv")
BW_HASH = os.path.join(ROOT, "data", "btc-bw-hash")
NINE_KEYS = {0xC936, 0x1764F, 0x3080D, 0x5749F, 0xD2C55, 0x1BA534, 0x2DE40F,
             0x556E52, 0xDC2A04}
SEED = 20261016
HASH_N = 131072          # keys per K1 call at the default 32 x 4096 geometry
INV_N = 65568            # K2 batch at that geometry: M*K/2 + M
MUL_N = 32768            # keys per `mul` job: K3, K2 and K1 run at this width
GTABLE_N = 155629        # K2 batch of the w=14 table build's widest round
RATE_KEYS = 1 << 20      # keys of the `mul` rate run
TIME_WINDOW_S = 1.0
# least-time model (bound_ms): the larger of bytes over the memory rate and
# 32-bit integer operations over the card's instruction rate.  HBM3 3.35 TB/s;
# one warp instruction per clock per SM quarter = 128 32-bit lane ops per
# clock per SM, the rate of the published 67 TFLOP/s fp32 (an FMA counts 2).
MEM_BPS = 3.35e12
INT_OPS = 67e12 / 2
# operation counts read off csrc/: a modular multiply is 64 32x32->64-bit
# multiplies plus about 10 in the fold, a multiply by a small constant
# 8 + 10; K1 counts its SHA-256 and RIPEMD-160 rounds at one instruction
# per 3-input add, logic op or funnel shift
FE_MUL_OPS = 74
FE_SMALL_OPS = 18
HASH_OPS = {True: 2280, False: 3600}     # per key: addr33, addr65
HASH_LIMBS = {True: 16 + 1 + 5, False: 32 + 5}   # read (x, y's parity) + written


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def random_limbs(rng, n: int):
    """(16, n) limbs of seeded field elements below p (top limb < 0xFFFF)."""
    import numpy as np
    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    a[15] = rng.integers(0, 0xFFFF, size=n, dtype=np.int64)
    return a


def time_ms(fn) -> float:
    """Mean ms per call with CUDA events, over a window >= TIME_WINDOW_S."""
    import torch
    fn()
    torch.cuda.synchronize()
    n = 1
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms >= TIME_WINDOW_S * 1e3:
            return ms / n
        n *= 2


def paired_ms(kernel, plain) -> tuple[float, float]:
    """Kernel and plain times taken in turns: plain, kernel, kernel, plain."""
    p1 = time_ms(plain)
    k1 = time_ms(kernel)
    k2 = time_ms(kernel)
    p2 = time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Mean device time in ms of one launch of the kernel whose name
    holds `kernel`, over `calls` calls of fn, from torch.profiler: the
    CUDA-event time of a wrapper call includes its host work, which is
    longer than the kernel itself for K1 and K3.  The profiler may miss
    a launch of the window (it was seen to report 19 of 20), so the mean
    is over the launches it saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    if not calls // 2 <= len(us) <= calls:
        raise AssertionError(f"profiler saw {len(us)} launches of {kernel}, "
                             f"expected {calls}")
    return sum(us) / len(us) / 1e3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms for the work, and what sets it."""
    t_bytes, t_ops = nbytes / MEM_BPS * 1e3, ops / INT_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(path: str) -> dict:
    """{kernel: 'N registers, S bytes spill stores, L bytes spill loads'}
    from the nvcc -Xptxas -v log of the build."""
    forms = {"hash160": ("_addr65", "_addr33"),
             "mixed_add": ("_incomplete", "_complete"),
             "inv_batch": ("", "")}
    out, name = {}, None
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                name = next((k for k in forms if k in mangled), None)
                if name:
                    name += forms[name]["ILb1E" in mangled]
            elif name and "spill stores" in line:
                out[name] = line.strip()
            elif name and "Used" in line and "registers" in line:
                regs = line.split("Used")[1].split(",")[0].strip()
                out[name] = f"{regs}; {out.get(name, '')}"
                name = None
    return out


def window_lanes(rng, n: int, dev):
    """K3 inputs at n lanes: random field elements, except lanes 0-63,
    which hold real points for the host oracle: lane 0 an infinity
    accumulator, 1 P == Q, 2 P == -Q, 3 and 4 skipped; ~10% skips in all.
    Returns (q, g, skip) tensors and the host points of lanes 0-63."""
    import numpy as np
    import torch
    from ecloop_tpu_torch import fel, golden

    cols = [random_limbs(rng, n) for _ in range(5)]
    ks = [int(k) for k in rng.integers(1, 1 << 62, size=128)]
    zs = [int(k) for k in rng.integers(1, 1 << 62, size=64)]
    g = [golden.point_mul(k) for k in ks[64:]]
    q = [golden.point_mul(k) for k in ks[:64]]
    q[1], q[2], zs[0] = g[1], golden.point_neg(g[2]), 0
    host = [[p[0] * z % fel.P for p, z in zip(q, zs)],
            [p[1] * z % fel.P for p, z in zip(q, zs)], zs,
            [p[0] for p in g], [p[1] for p in g]]
    for c, vals in zip(cols, host):
        c[:, :64] = fel.ints_to_limbs(vals).T
    skip = rng.random(n) < 0.1
    skip[:64] = False
    skip[[3, 4]] = True
    t = [torch.from_numpy(c).to(dev) for c in cols]
    return t[:3], t[3:], torch.from_numpy(skip).to(dev), (q, g, zs)


def check_window_add(got, q, g, zs, complete: bool) -> None:
    """Lanes 0-63 of a K3 result against golden.point_add."""
    from ecloop_tpu_torch import fel, golden

    xs, ys, zo = (fel.tensor_to_ints(t[:, :64]) for t in got)
    for i in range(64):
        if i in (3, 4) or (i == 1 and not complete):
            continue
        want = g[i] if i == 0 else golden.point_add(q[i], g[i])
        if want is None:
            if zo[i] != 0:
                raise AssertionError(f"K3 lane {i}: expected infinity")
            continue
        zi = pow(zo[i], -1, fel.P)
        if (xs[i] * zi % fel.P, ys[i] * zi % fel.P) != want:
            raise AssertionError(f"K3 lane {i} (complete={complete}) is "
                                 f"not P + Q")


def mul_run(cli, kernels, lines):
    """run_mul -a cu on data/btc-bw-hash over `lines`, with the launch
    counts of that run."""
    kernels.reset_launches()
    run = cli.run_mul(cli.Args(["ecloop", "mul", "-f", BW_HASH, "-a", "cu",
                                "-q", "-o", os.devnull]), lines)
    launches = dict(kernels.LAUNCHES)
    if run.device.type != "cuda":
        raise AssertionError(f"mul ran on {run.device}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the mul path never ran: {launches}")
    return run, launches


def mul_breakdown(lines, dev) -> dict:
    """Where a `mul` job's time goes: the host parse of the lines, the
    engine over parsed words (host clock, synchronized), and one job's
    device time and device op count from torch.profiler over 4 steps."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ecloop_tpu_torch import filters
    from ecloop_tpu_torch.search import mul
    from ecloop_tpu_torch.search.common import SearchConfig

    eng = mul.MulSearch(SearchConfig(addr33=True, addr65=True),
                        filters.load_filter(BW_HASH), torch.device("cuda"),
                        batch=MUL_N)
    t0 = time.monotonic()
    words = mul.parse_hex_words(lines)
    parse_s = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if len(eng.run_words(words)) != 1080:
        raise AssertionError("mul engine: the vector keys were not all found")
    torch.cuda.synchronize()
    engine_s = time.monotonic() - t0
    dig = np.zeros((mul.n_windows(eng.w), MUL_N), dtype=np.int32)
    dig[:] = mul.window_digits_words(words[:MUL_N], eng.w).T
    dig = torch.from_numpy(dig).to(dev)
    steps = 4
    eng.step_fn(dig, eng.txy, eng.bits)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            eng.step_fn(dig, eng.txy, eng.bits)
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3 / steps
    return {"parse_s": parse_s, "engine_s": engine_s,
            "engine_keys_per_s": len(words) / engine_s,
            "step_wall_ms_profiled": wall_s * 1e3 / steps,
            "step_device_ms": device_ms, "device_ops_per_step": len(dev_ev) / steps,
            "busy_share": device_ms / (wall_s * 1e3 / steps)}


def check_vector(run, vector: set) -> None:
    labels = [f.label for f in run.found]
    if ({f.priv for f in run.found} != vector or len(run.found) != 1080
            or labels.count("addr33") != 540 or labels.count("addr65") != 540):
        raise AssertionError(f"mul vector: {len(run.found)} found "
                             f"({labels.count('addr33')} addr33, "
                             f"{labels.count('addr65')} addr65)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from ecloop_tpu_torch import _build, cli, ecc, fel, hash160, kernels
    from ecloop_tpu_torch import bloom, filters, golden
    from ecloop_tpu_torch.search import common, mul

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()

    # --- 0: versions, card, build ------------------------------------------
    phase("0", f"python {sys.version.split()[0]} torch {torch.__version__} "
               f"cuda {torch.version.cuda} device {kind}")
    print(card, flush=True)
    t0 = time.monotonic()
    path = _build.build()
    _build.lib()
    phase("0", f"kernels built in {time.monotonic() - t0:.1f} s -> "
               f"{os.path.relpath(path, ROOT)}")
    ptxas = ptxas_report(_build.log_path())
    for name, info in sorted(ptxas.items()):
        phase("0", f"ptxas {name}: {info}")

    rng = np.random.default_rng(SEED)
    errs = {}

    # --- 1: K1 against its plain version --------------------------------------
    x = torch.from_numpy(random_limbs(rng, HASH_N)).to(dev)
    y = torch.from_numpy(random_limbs(rng, HASH_N)).to(dev)
    err = 0
    for name, k, p in (("addr33", kernels.addr33_hash_rows,
                        hash160.addr33_hash_rows),
                       ("addr65", kernels.addr65_hash_rows,
                        hash160.addr65_hash_rows)):
        got, want = k(x, y), p(x, y)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {name} differs from its plain version "
                                 f"(max abs err {e})")
        err = max(err, e)
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=8)]
    gx, gy = (fel.from_last(a, dev) for a in ecc.points_host(keys))
    for is33, k in ((True, kernels.addr33_hash_rows),
                    (False, kernels.addr65_hash_rows)):
        words = k(gx, gy).cpu().numpy().T
        for key, w in zip(keys, words):
            got = "".join(f"{int(v):08x}" for v in w)
            if got != common.derive_h160(key, is33):
                raise AssertionError(f"K1 hash of {key:#x} (addr33={is33}) "
                                     f"is {got}")
    errs["hash160"] = err
    phase("1", f"K1 hash160 == plain at {HASH_N} keys (addr33, addr65), "
               f"max abs err {err} (tolerance 0: integer math); 8 points "
               f"== host oracle")

    # --- 2: K2 against its plain version --------------------------------------
    p = fel.P
    blk = kernels.inv_block_elements()
    err, cases = 0, []
    for n in (INV_N, MUL_N, GTABLE_N, 1000, 33, 1):
        a = random_limbs(rng, n)
        for i, v in enumerate((0, 1, p - 1)[:n]):
            a[:, i] = fel.int_to_limbs(v)
        if n > 4 * blk:
            a[:, -3:] = 0                                # zeros at the end
            a[:, blk - 5:blk + 5] = 0                    # across a block edge
            a[:, 2 * blk:3 * blk] = 0                    # one whole block
        cases.append((n, a))
    cases.append((1000, np.zeros((16, 1000), dtype=np.int64)))   # all zero
    for n, a in cases:
        xt = torch.from_numpy(a).to(dev)
        got, want = kernels.inv_mod_batch(xt), fel.inv_mod_batch(xt)
        torch.cuda.synchronize()
        e = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs from its plain version at "
                                 f"n={n} (max abs err {e})")
        err = max(err, e)
        ints_in = fel.limbs_to_ints(a.T[:64])
        ints_out = fel.tensor_to_ints(got[:, :64])
        for v, w in zip(ints_in, ints_out):
            if w != (pow(v, p - 2, p) if v else 0):
                raise AssertionError(f"K2: inverse of {v:#x} is {w:#x}")
    errs["inv_mod_batch"] = err
    phase("2", f"K2 inv_mod_batch == plain at {INV_N}, {MUL_N}, {GTABLE_N}, "
               f"1000, 33 and 1 elements (0, 1, p-1 first; zeros at the end, "
               f"across a {blk}-element block edge and over one whole block) "
               f"and on 1000 zeros, max abs err {err} (tolerance 0); 64 spot "
               f"checks each == pow(x, p-2, p)")

    # --- a: K3 against its plain version ----------------------------------------------
    (qx, qy, qz), (gx, gy), skip, (hq, hg, hz) = window_lanes(rng, MUL_N, dev)
    err = 0
    for complete in (False, True):
        got = kernels.proj_add_affine(qx, qy, qz, gx, gy, skip, complete)
        want = [fel.select(skip, o, p) for o, p in zip(
            (qx, qy, qz), ecc.proj_add_affine_rows(qx, qy, qz, gx, gy,
                                                   complete))]
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            e = int((a - b).abs().max())
            if not torch.equal(a, b):
                raise AssertionError(f"K3 complete={complete} differs from "
                                     f"its plain version (max abs err {e})")
            err = max(err, e)
        check_window_add(got, hq, hg, hz, complete)
        if complete != (fel.tensor_to_ints(got[2][:, 1:2])[0] != 0):
            raise AssertionError("K3: the P == Q lane")
    errs["mixed_add"] = err
    phase("a", f"K3 mixed_add == plain at {MUL_N} lanes, incomplete and "
               f"complete (infinity, P == Q, P == -Q and skip lanes), max abs "
               f"err {err} (tolerance 0: integer math); 60 lanes == golden "
               f"P + Q")

    # --- 3: the main path ---------------------------------------------------------
    kernels.reset_launches()
    run = cli.run_add(cli.Args(["ecloop", "add", "-f", PUZZLES,
                                "-r", "8000:ffffff"]))
    launches_add = dict(kernels.LAUNCHES)
    privs = {f.priv for f in run.found}
    if run.device.type != "cuda":
        raise AssertionError(f"main path ran on {run.device}")
    if privs != NINE_KEYS or len(run.found) != 9:
        raise AssertionError(f"found {sorted(map(hex, privs))}")
    if run.k_checked != 16_777_216:
        raise AssertionError(f"k_checked {run.k_checked}")
    if min(launches_add["hash160"], launches_add["inv_mod_batch"]) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches_add}")
    rate = run.k_checked / run.seconds
    phase("3", f"add -r 8000:ffffff: 9/9 keys, k_checked {run.k_checked:,} "
               f"in {run.seconds:.3f} s = {rate:,.0f} keys/s; launches "
               f"{launches_add}; card {card}")

    # --- 4: -endo ---------------------------------------------------------------
    run = cli.run_add(cli.Args(["ecloop", "add", "-f", PUZZLES,
                                "-r", "8000:ffff", "-endo"]))
    if 0xC936 not in {f.priv for f in run.found}:
        raise AssertionError(f"-endo missed c936: {run.found}")
    if run.k_checked != 196_602:
        raise AssertionError(f"-endo k_checked {run.k_checked}")
    phase("4", f"add -r 8000:ffff -endo: c936 found, k_checked "
               f"{run.k_checked:,}")

    # --- 5: bloom mode, -a cu ------------------------------------------------------
    with open(PUZZLES) as f:
        puzzle = filters.parse_hash_lines(f.read())
    extra = rng.integers(0, 1 << 32, size=(1_000_000, 5),
                         dtype=np.uint64).astype(np.uint32)
    hashes = np.concatenate([puzzle, extra])
    blf = bloom.BloomFilter.for_count(len(hashes))
    blf.add_many(hashes)
    with tempfile.TemporaryDirectory() as tmp:
        blf_path = os.path.join(tmp, "targets.blf")
        blf.save(blf_path)
        run = cli.run_add(cli.Args(["ecloop", "add", "-f", blf_path,
                                    "-r", "8000:ffffff", "-a", "cu"]))
    got33 = {f.priv for f in run.found if f.label == "addr33"}
    if not NINE_KEYS <= got33:
        raise AssertionError(f"bloom mode missed {NINE_KEYS - got33}")
    for f in run.found:
        h = np.frombuffer(bytes.fromhex(f.h160), dtype=">u4").astype(np.uint32)
        if not blf.has_many(h[None])[0]:
            raise AssertionError(f"bloom mode reported a non-member: {f}")
    phase("5", f"bloom mode -a cu: {len(run.found)} found (9 puzzle keys "
               f"addr33 included, {len(run.found) - 9} filter positives), "
               f"k_checked {run.k_checked:,}")

    # --- b: the w=14 table, built on the card ---------------------------------------
    torch.cuda.synchronize()
    t0 = time.monotonic()
    table = mul.build_gtable(mul.W, torch.device("cuda"))   # the CLI's key
    torch.cuda.synchronize()
    gtable_s = time.monotonic() - t0
    n1 = (1 << mul.W) - 1
    for idx in rng.integers(0, table.shape[1], size=64):
        i, j = divmod(int(idx), n1)
        want = golden.point_mul(((j + 1) << (mul.W * i)) % golden.N)
        got = (fel.tensor_to_ints(table[:16, idx:idx + 1])[0],
               fel.tensor_to_ints(table[16:, idx:idx + 1])[0])
        if got != want:
            raise AssertionError(f"gtable entry {idx} (window {i}, digit "
                                 f"{j + 1}) is not its multiple of G")
    phase("b", f"gtable w={mul.W}: {table.shape[1]:,} points built on the card "
               f"in {gtable_s:.3f} s (host clock, synchronized; card {card}); "
               f"64 seeded entries == golden")

    # --- c: the mul main path on the 1080-key vector ----------------------------------
    with open(BW_PRIV) as f:
        bw_lines = f.read().split()
    vector = {int(ln, 16) for ln in bw_lines}
    run, launches_mul = mul_run(cli, kernels, bw_lines)
    check_vector(run, vector)
    if run.k_checked != 1080:
        raise AssertionError(f"mul k_checked {run.k_checked}")
    phase("c", f"mul -a cu on btc-bw-priv: 1080 found (540 addr33, 540 "
               f"addr65), k_checked {run.k_checked:,} in {run.seconds:.3f} s; "
               f"launches {launches_mul}")

    # --- d: mul rate over 2^20 keys -----------------------------------------------------
    raw = rng.bytes(32 * RATE_KEYS).hex()
    lines = [raw[i:i + 64] for i in range(0, len(raw), 64)]
    for pos, ln in zip(rng.choice(RATE_KEYS, size=len(bw_lines),
                                  replace=False), bw_lines):
        lines[pos] = ln
    run = mul_run(cli, kernels, lines)[0]
    check_vector(run, vector)
    if run.k_checked != RATE_KEYS:
        raise AssertionError(f"mul k_checked {run.k_checked}")
    mul_rate = run.k_checked / run.seconds
    phase("d", f"mul -a cu over {RATE_KEYS:,} seeded keys (the 1080 vector "
               f"keys among them, all found) at batch {MUL_N:,}: "
               f"{run.seconds:.3f} s = {mul_rate:,.0f} keys/s (host clock; "
               f"card {card})")
    split = mul_breakdown(lines, dev)
    phase("d", f"mul time split: parse {split['parse_s']:.3f} s; engine on "
               f"parsed keys {split['engine_s']:.3f} s = "
               f"{split['engine_keys_per_s']:,.0f} keys/s; one job (torch."
               f"profiler, 4 steps): wall {split['step_wall_ms_profiled']:.3f} "
               f"ms, device {split['step_device_ms']:.3f} ms in "
               f"{split['device_ops_per_step']:.0f} device ops, busy share "
               f"{split['busy_share']:.3f}")

    # --- 6: timing ----------------------------------------------------------------
    x = torch.from_numpy(random_limbs(rng, HASH_N)).to(dev)
    y = torch.from_numpy(random_limbs(rng, HASH_N)).to(dev)
    xi = torch.from_numpy(random_limbs(rng, INV_N)).to(dev)
    xm = torch.from_numpy(random_limbs(rng, MUL_N)).to(dev)
    # K3 as the main path runs it: a digit of 0 (skip) is 1 in 2^14
    q = [torch.from_numpy(random_limbs(rng, MUL_N)).to(dev) for _ in range(5)]
    no_skip = torch.zeros(MUL_N, dtype=torch.bool, device=dev)
    # name: (kernel call, plain call, kernel name in the profiler)
    timed = {
        "hash160": (lambda: kernels.addr33_hash_rows(x, y),
                    lambda: hash160.addr33_hash_rows(x, y),
                    "hash160_kernel<true>"),
        "hash160_addr65": (lambda: kernels.addr65_hash_rows(x, y),
                           lambda: hash160.addr65_hash_rows(x, y),
                           "hash160_kernel<false>"),
        "inv_mod_batch": (lambda: kernels.inv_mod_batch(xi),
                          lambda: fel.inv_mod_batch(xi),
                          "inv_batch_kernel"),
        "inv_mod_batch_mul": (lambda: kernels.inv_mod_batch(xm),
                              lambda: fel.inv_mod_batch(xm),
                              "inv_batch_kernel"),
    }
    for c in (False, True):
        timed[f"mixed_add_{'complete' if c else 'incomplete'}"] = (
            lambda c=c: kernels.proj_add_affine(*q, no_skip, c),
            lambda c=c: [fel.select(no_skip, o, p) for o, p in zip(
                q[:3], ecc.proj_add_affine_rows(*q, c))],
            f"mixed_add_kernel<{str(c).lower()}>")
    t, call_ms = {}, {}
    for name, (kern, plain, kname) in timed.items():
        call_ms[name], plain_ms = paired_ms(kern, plain)
        t[name] = (device_ms(kern, kname), plain_ms)
    # K2's chain floor: one element, so one block and one inversion
    x1 = torch.from_numpy(random_limbs(rng, 1)).to(dev)
    chain_ms = device_ms(lambda: kernels.inv_mod_batch(x1), "inv_batch_kernel")
    limb = 8                                        # bytes of one int64 limb
    active = int((~fel.is_zero(q[2])).sum())

    def inv_bound(n):
        # Montgomery's trick needs 3 multiplies per element and one
        # inversion per call, counted as the Fermat chain's 255 squarings
        # and 15 multiplies, however a kernel cuts the batch; 16 limbs in
        # and 16 out per element
        return bound(n * 32 * limb, (3 * n + 270) * FE_MUL_OPS)

    bounds = {
        "hash160": bound(HASH_N * HASH_LIMBS[True] * limb,
                         HASH_N * HASH_OPS[True]),
        "hash160_addr65": bound(HASH_N * HASH_LIMBS[False] * limb,
                                HASH_N * HASH_OPS[False]),
        "inv_mod_batch": inv_bound(INV_N),
        "inv_mod_batch_mul": inv_bound(MUL_N),
        "mixed_add_incomplete": bound(MUL_N * (128 * limb + 1),
                                      active * (12 * FE_MUL_OPS + FE_SMALL_OPS)),
        "mixed_add_complete": bound(MUL_N * (128 * limb + 1),
                                    active * (12 * FE_MUL_OPS + FE_SMALL_OPS)),
    }
    for name, (k_ms, p_ms) in t.items():
        n = {"inv": INV_N, "mix": MUL_N}.get(name[:3], HASH_N)
        n = MUL_N if name.endswith("_mul") else n
        b_ms, b_by = bounds[name]
        phase("6", f"{name} at n={n}: kernel {k_ms:.4f} ms on the device "
                   f"(torch.profiler, mean of 20 calls), {call_ms[name]:.4f} ms "
                   f"per wrapper call, plain {p_ms:.4f} ms (CUDA events, "
                   f"windows >= {TIME_WINDOW_S} s), bound {b_ms:.4f} ms "
                   f"({b_by}); card {card}")
    phase("6", f"inv_mod_batch chain floor (n=1, one block, one safegcd "
               f"inversion): kernel {chain_ms:.4f} ms on the device "
               f"(torch.profiler, mean of 20 calls); card {card}")

    def entry(name, key, source, replaces, **extra):
        launches = {"add": launches_add[name], "mul": launches_mul[name]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": errs[name],
                "ms": t[key][0], "call_ms": call_ms[key], "plain_ms": t[key][1],
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "library_ms": None, **extra}

    report = {"kernels": [
        entry("hash160", "hash160", "ecloop_tpu_torch/csrc/hash160.cu",
              "ecloop_tpu/pallas_kernels.py:156",
              ms_addr65=t["hash160_addr65"][0],
              plain_ms_addr65=t["hash160_addr65"][1],
              bound_ms_addr65=bounds["hash160_addr65"][0],
              ptxas={k: v for k, v in ptxas.items() if "hash160" in k}),
        entry("inv_mod_batch", "inv_mod_batch",
              "ecloop_tpu_torch/csrc/inv_batch.cu",
              "ecloop_tpu/pallas_kernels.py:78", chain_floor_ms=chain_ms,
              ms_32768=t["inv_mod_batch_mul"][0],
              call_ms_32768=call_ms["inv_mod_batch_mul"],
              plain_ms_32768=t["inv_mod_batch_mul"][1],
              bound_ms_32768=bounds["inv_mod_batch_mul"][0],
              ptxas={k: v for k, v in ptxas.items() if "inv_batch" in k}),
        entry("mixed_add", "mixed_add_incomplete",
              "ecloop_tpu_torch/csrc/mixed_add.cu",
              "ecloop_tpu/pallas_kernels.py:211",
              ms_complete=t["mixed_add_complete"][0],
              plain_ms_complete=t["mixed_add_complete"][1],
              bound_ms_complete=bounds["mixed_add_complete"][0],
              ptxas={k: v for k, v in ptxas.items() if "mixed_add" in k}),
    ], "card": card, "add_keys_per_s": rate, "mul_keys_per_s": mul_rate,
        "mul_batch": MUL_N, "gtable_build_s": gtable_s, "mul_split": split}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
