#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ecloop_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (printing ptxas's register and spill
report and K1's SASS instruction mix), holds each against its plain
torch version on the card, drives the main paths through the CLI's own
code: `add` on the reference's 9-key vector (plus -endo, and a bloom
filter made by `blf-gen` and queried by `blf-check`), `rnd` over the
same range in one pass and seeded over 2^20-key sub-ranges, `add -c`
resumed from a checkpoint, and `mul` on the 1080-key vector (plus
1,048,576 keys for its rate), with the w=14 table built on the card;
then times the kernels against their plain versions and their least
possible time (ecloop_tpu_torch/sol.py's account), and runs `bench`
(every row within its bound, the K1-K3 rows against the kernels' device
times), `bench-gtable` at w = 8, 14, 16 and `mult-verify` on 16,000
scalars (and once more with a corrupted table entry, which must fail).
The multi-device paths run on the one card: `add -t 2` prints the
clamped device count, the engines split `add` over [cuda:0] x 2 and x 4
(-endo) and `mul` over [cuda:0] x 2 with the single-device found sets
and counts, and two `add` processes joined over gloo on 127.0.0.1 find
disjoint halves of the nine keys (phases k and l); K1 is timed once
more after them.  Phases 1, 2 and a check every width (elements per
launch) that the searches launch a kernel at, the shards' included, and
the script fails if a search ran a kernel at a width they did not check.
On the card every search call runs from one CUDA graph per shard
(`ecloop_tpu_torch/graphs.py`): phase n holds the `add` call (T = 8
steps at 32 x 4096 in list, pow2, bloom and -endo modes, and at
512 x 4096) and one 32,768-key `mul` job against the eager steps bit
for bit and times both (capture, replay wall, device time, busy share,
keys/s, and the step's share of sol.step_budget); phases n and k fail
if a kernel launches outside a replay, and the searches must run K1 and
K5 only fused (csrc/hash160_probe.cu, one launch per address form over
a step's planes), never alone.  Phase 7 holds K4 (the `add` step's
chords, csrc/add_chords.cu), K5 (the prefilter probe with its mask
packing, csrc/probe_pack.cu) and the fused hash and probe bit for bit
against their plain forms at every step geometry and key count the
searches run, -endo and plain, in the three probe modes (compare lists
of 0-4,096 first words, past the kernels' shared-memory cap; bloom at
1, 3 and 20 probes, over 3 x 2^32 + 64 bits, and a 2^31-bit filter
filled as blf-gen fills it at its adaptive probe count; pow2 on each
side of log2_bits 32), the fused entry at 1, 2, 6 and 12 planes, with a
(0, 0) center and zero inverses, and times each against its plain form
and its bound, and the fused entry against K1 + K5 + the stack of the
planes that it replaces.
Phase p runs `add -r 8000:fffff` and `mul` on the 1080-key vector
through the CLI in processes of their own, untraced and with
ECLOOP_PROFILE (a torch.profiler trace of the whole command): stdout,
k_checked, launches and graphs must agree, and the trace must hold the
path's kernels inside graph replays and no K1 or K5 alone; a traced
`blf-check` must leave the card alone.  Phase o, last, fails unless a body the card cannot capture (a
host sync) raises.
Each phase prints one line or more; any failure raises.
Before the last line it prints one JSON object describing the kernels,
and the last line is {"ok": true, "device": {...}}.  Without a CUDA
device it exits with 2 and prints no result.
"""

import collections
import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import socket
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
VERIFY_N = 16000         # mult-verify's scalars: K3 and K2 run at this width
RATE_KEYS = 1 << 20      # keys of the `mul` rate run
TIME_WINDOW_S = 1.0
RND_SEED = "3"           # phase f: its 8 draws of 2^20-key sub-ranges (blocks
RND_ITERS = 8            # 5 3 12 0 13 4 0 7) hold 7 of the nine keys
RESUME_KEY = 0x800000    # phase g: the checkpoint's cursor is this key's offset
BENCH_R = 256            # phase h: iterations per bench row (the CLI's 512 cut)
SWEEP_WS = (8, 14, 16)   # phase i: bench-gtable widths
CORRUPT_N = 256          # phase j: scalars of the corrupted-table run
ROW_TOLERANCE = 0.25     # phase h: a K1-K3 row's rate against its device time
TWO_PROCS_TIMEOUT_S = 600   # phase l: each process's limit
# phase k's `add` runs: (name, devices, range_e, endo) over [cuda:0] x n,
# from range_s 0x8000
SPLITS = (("add_one_device", 1, 0xFFFFFF, False),
          ("add_sharded", 2, 0xFFFFFF, False),
          ("add_sharded_endo", 4, 0xFFFF, True))
TWO_PROCS = 2            # phase l: processes of one device each
WIDE_CENTERS = 512       # phase n: the wide `add` geometry (512 x 4096)
PROFILE_RANGE = "8000:fffff"   # phase p: puzzles 16-20, one call of 8 steps
PROFILE_KEYS = {k for k in NINE_KEYS if k <= 0xFFFFF}
CLI_TIMEOUT_S = 600      # phase p: each traced or untraced CLI process's limit
# phase p: the kernels' names in a trace (the __global__ functions)
KERNEL_SYMBOLS = {"hash160": "hash160_kernel", "inv_mod_batch": "inv_batch_kernel",
                  "mixed_add": "mixed_add_kernel", "add_chords": "chord_",
                  "probe_pack": "probe_pack_kernel",
                  "hash160_probe": "hash160_probe_kernel"}
# the kernels each search path launches, and the two that the searches
# run fused (hash160_probe) and never alone; the bench and its family
# launch K1-K5 alone
ADD_KERNELS = ("inv_mod_batch", "add_chords", "hash160_probe")
MUL_KERNELS = ("inv_mod_batch", "mixed_add", "hash160_probe")
UNFUSED = ("hash160", "probe_pack")
BENCH_KERNELS = ("hash160", "inv_mod_batch", "mixed_add", "add_chords",
                 "probe_pack")
# phase 7: K5's cases, (mode, argument): compare lists of that many first
# words (4,096: above the kernels' shared-memory cap of 2,048), the exact
# bloom probe at that many probes over 64,000 bits (21: 20 probes over
# 3 x 2^32 + 64 bits, past 32-bit indices), a .blf as blf-gen sizes it
# (2^31 bits, past the L2, filled to BLF_FILL, its adaptive probe count),
# pow2 at that log2_bits
PROBE_CASES = (("compare", 0), ("compare", 1), ("compare", 160),
               ("compare", 2048), ("compare", 4096), ("exact", 1),
               ("exact", 3), ("exact", 20), ("exact", 21), ("blf", 31),
               ("pow2", 32), ("pow2", 33))
# blf-gen's fill: 43.1 bits per entry (bloom.BloomFilter.for_count) and 20
# probes leave 1 - exp(-20 / 43.1) of the bits set
BLF_FILL = 0.371
# phase 7: the fused hash and probe's plane sets (x row, y row, is33) in
# search/add._variants's order: addr33, -a cu, -endo, -endo -a cu
EMAP = ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))
PLANE_SETS = {1: [(0, 0, True)], 2: [(0, 0, True), (0, 0, False)],
              6: [(*EMAP[e], True) for e in range(6)],
              12: [(*EMAP[e], f) for e in range(6) for f in (True, False)]}
FUSED_TIMED_NS = (131072, 2097152)   # phase 7 times the fused entry there
PROBE_MODE_NAMES = ("compare", "exact", "pow2", "compare_global")
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
CUDA_CATS = DEVICE_CATS | {"cuda_runtime", "cuda_driver", "gpu_user_annotation"}
TRACE_LINE = re.compile(r"^profile: (.+), ([\d,]+) bytes, written in ([\d.]+) s$",
                        re.M)
PROFILE_TRIES = 8        # profiler windows per device time (device_ms), and
PROFILE_PAUSE_S = 1.0    # the pause after a short one
SHORT_WINDOWS = []       # the short windows' messages, for the report
FOUND_LINE = re.compile(r"^addr33: [0-9a-f]{40} <- ([0-9a-f]{64})$", re.M)
# The least-time model (bound_ms) and every kernel's account live in
# ecloop_tpu_torch/sol.py, which the bench shares: the larger of bytes
# over the memory rate and 32-bit integer operations over the card's
# integer rate (64 per clock per SM x SMs x max SM clock, read on the
# card).  K1's operations are counted by running its function
# (sol.HashOpCount): its ALU-only operations, or half of all of them
# where that is more, since its adds may issue on the FMA pipe too.

# SASS opcodes (before the first '.') that issue to the integer ALU pipe;
# IMAD* issues to the FMA pipe, which runs 32-bit multiply-adds at the
# same 64 per clock per SM beside it
ALU_OPS = {"LOP3", "SHF", "IADD3", "PRMT", "ISETP", "SEL", "LEA", "MOV",
           "IMNMX", "VIADD", "VIMNMX", "PLOP3", "IABS", "BMSK", "SGXT", "FLO",
           "P2R", "R2P", "SHL", "SHR", "LOP"}
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


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
    longer than the kernel itself for K1 and K3.

    The profiler drops the device records of the first launches after
    it starts, more of them late in a long process, and now and then a
    whole window's, two in a row at times; its host side keeps every
    launch call.  So each window follows a warm-up window of the same
    calls (the schedule's warmup step, traced and thrown away), the mean
    is over the launches it saw, and a window that saw fewer than half
    is printed with what the profiler did see and taken again after a
    pause, PROFILE_TRIES windows in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        windows = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: windows.append(p.events())
                     ) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = windows[-1] if windows else []
        us = [e.time_range.elapsed_us() for e in events
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if calls // 2 <= len(us) <= calls:
            return sum(us) / len(us) / 1e3
        seen = collections.Counter(e.name[:60] for e in events
                                   if e.device_type == DeviceType.CUDA)
        host = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and "LaunchKernel" in e.name)
        msg = (f"profiler saw {len(us)} of {calls} launches of {kernel}; "
               f"launch calls on the host {host}; device events {dict(seen)}")
        phase("profiler", msg)
        SHORT_WINDOWS.append(msg)
        time.sleep(PROFILE_PAUSE_S)
    raise AssertionError(msg)


def device_total_ms(fn, ops_per_call: int, calls: int = 20):
    """(device ms, device ops) per call of fn, all its device ops summed
    (kernel_time over `calls` calls); a window that saw fewer than
    ops_per_call ops per call is taken again, PROFILE_TRIES windows in
    all (device_ms's reason)."""
    for _ in range(PROFILE_TRIES):
        ms, ops, _top = kernel_time(lambda: [fn() for _ in range(calls)])
        if ms is not None and ops >= ops_per_call * calls:
            return ms / calls, ops / calls
        msg = f"profiler saw {ops} device ops of {ops_per_call} x {calls}"
        phase("profiler", msg)
        SHORT_WINDOWS.append(msg)
        time.sleep(PROFILE_PAUSE_S)
    raise AssertionError(msg)


def plant_members(filt, bits, h) -> None:
    """Add the keys whose (5, k) hash words are h to a bloom filter's
    device bits, as blf-gen adds an entry: their 20 probe bits set."""
    import numpy as np
    import torch
    from ecloop_tpu_torch import bloom

    idx = bloom.probe_indices_host(h.T.cpu().numpy().astype(np.uint32)).reshape(
        -1) % np.uint64(filt.blf.nbits)
    words, at = np.unique((idx >> np.uint64(5)).astype(np.int64),
                          return_inverse=True)
    add = np.zeros(len(words), dtype=np.uint32)
    np.bitwise_or.at(add, at, np.uint32(1) << (idx & np.uint64(31)).astype(
        np.uint32))
    w = torch.from_numpy(words).to(bits.device)
    bits[w] |= torch.from_numpy(add.view(np.int32)).to(bits.device)


def fused_only(launches: dict, what: str) -> None:
    """Fail if a search launched K1 or K5 alone: they run fused
    (hash160_probe)."""
    alone = {k: launches[k] for k in UNFUSED if launches[k]}
    if alone:
        raise AssertionError(f"{what}: K1 or K5 launched alone {alone}")


def split_config(n: int, range_e: int, endo: bool):
    """`add` from 0x8000 over n devices with the CLI's geometry: n times
    the one-device centers (cli.search_config)."""
    from ecloop_tpu_torch.search.common import SearchConfig

    cfg = SearchConfig(range_s=0x8000, range_e=range_e, endo=endo)
    cfg.centers *= n
    return cfg


def shard_widths(cfg, n: int) -> tuple[int, int]:
    """(K1 keys, K2 elements) per launch of one shard's `add` step over n
    devices: M/n*K keys, and the M/n*K/2 chords plus M/n advances."""
    m = cfg.centers // n
    return m * cfg.group_k, m * cfg.group_k // 2 + m


def gtable_widths(w: int) -> set[int]:
    """K2's widths in mul.build_gtable(w): round r inverts d x (2^r - 1)
    chords, in slices of at most BUILD_CHUNK // d columns."""
    from ecloop_tpu_torch.search import mul

    d = mul.n_windows(w)
    step = max(1, mul.BUILD_CHUNK // d)
    return {d * (min((1 << r) - 1, a + step) - a)
            for r in range(1, w) for a in range(0, (1 << r) - 1, step)}


def sass_mix(lib_path: str) -> dict | None:
    """K1's SASS instructions per form, from cuobjdump -sass on the built
    library: {form: {"alu": n, "fma": n, "other": n, "top": {op: n}}}.
    The kernel is straight-line code, one key per thread, so the static
    count is the count per key.  None where cuobjdump is missing."""
    from ecloop_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    r = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        return None
    ops, form = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            form = None
            if "hash160_kernel" in mangled:
                form = "addr33" if "ILb1E" in mangled else "addr65"
                ops[form] = collections.Counter()
        elif form:
            m = SASS_LINE.search(line)
            if m:
                ops[form][m.group(1)] += 1
    out = {}
    for form, c in ops.items():
        alu = sum(n for op, n in c.items() if op.split(".")[0] in ALU_OPS)
        fma = sum(n for op, n in c.items() if op.startswith("IMAD"))
        out[form] = {"alu": alu, "fma": fma,
                     "other": sum(c.values()) - alu - fma,
                     "top": dict(c.most_common(8))}
    return out or None


def ptxas_report(path: str) -> dict:
    """{kernel: 'N registers, S bytes spill stores, L bytes spill loads'}
    from the nvcc -Xptxas -v log of the build."""
    forms = {"hash160_probe": ("_addr65", "_addr33"),
             "hash160": ("_addr65", "_addr33"),
             "mixed_add": ("_incomplete", "_complete"),
             "inv_batch": ("", ""), "chord_dx": ("", ""),
             "chord_points": ("", ""), "probe_pack": ("", "")}
    out, name = {}, None
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                name = next((k for k in forms if k in mangled), None)
                if name:
                    name += forms[name]["ILb1E" in mangled]
                    mode = re.search(r"Li(\d)E", mangled)
                    if mode and "probe" in name:     # the probe mode
                        name += "_" + PROBE_MODE_NAMES[int(mode.group(1))]
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

    cols = [fel.random_limbs(rng, n) for _ in range(5)]
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
    if min(launches[k] for k in MUL_KERNELS) < 1:
        raise AssertionError(f"a kernel of the mul path never ran: {launches}")
    fused_only(launches, "mul")
    return run, launches


def mul_breakdown(lines, dev) -> dict:
    """Where a `mul` run's time goes: the host parse of the lines and the
    engine over parsed words (host clock, synchronized).  One job's
    device time is phase n's."""
    import torch
    from ecloop_tpu_torch import filters
    from ecloop_tpu_torch.search import mul
    from ecloop_tpu_torch.search.common import SearchConfig

    eng = mul.MulSearch(SearchConfig(addr33=True, addr65=True),
                        filters.load_filter(BW_HASH), dev,
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
    return {"parse_s": parse_s, "engine_s": engine_s,
            "engine_keys_per_s": len(words) / engine_s}


@contextlib.contextmanager
def no_direct_launches(kernels, what: str):
    """Fail if a kernel wrapper launches inside the block: on the card
    the engines' kernels run only from graph replays."""
    direct = []
    launch = kernels._launch

    def counted(fn, *args):
        direct.append(fn)
        return launch(fn, *args)
    kernels._launch = counted
    try:
        yield
    finally:
        kernels._launch = launch
    if direct:
        raise AssertionError(f"{what}: {len(direct)} kernel launches outside "
                             f"a graph replay ({collections.Counter(direct)})")


def kernel_time(run) -> tuple[float | None, int, dict]:
    """Device ms and device op count of one run() from torch.profiler's
    CUDA events (kernels, copies, fills; not the user annotations that
    span a whole profiler step on the device's track), in a window after
    a warm-up window, and the most costly names ({name: [count, ms]});
    (None, 0, {}) when the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    windows = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: windows.append(p.events())) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    ev = [e for e in (windows[-1] if windows else [])
          if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    if not ev:
        return None, 0, {}
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in ev:
        by_name[e.name[:60]][0] += 1
        by_name[e.name[:60]][1] += e.time_range.elapsed_us() / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6])
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev), top


def call_figures(run, steps: int, keys: int, reps: int) -> dict:
    """run() runs `steps` steps of `keys` keys.  Per step: the host wall
    over `reps` runs (synchronized), the CUDA-event time of the same
    runs, the profiler's device time and device ops (one run), the busy
    share (device / wall) and keys/s."""
    import torch
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (reps * steps)
    dev_ms, ops, top = kernel_time(run)
    dev_ms = None if dev_ms is None else dev_ms / steps
    return {"wall_ms": wall_ms,
            "events_ms": start.elapsed_time(end) / (reps * steps),
            "device_ms": dev_ms, "device_ops": ops / steps,
            "busy_share": None if dev_ms is None else dev_ms / wall_ms,
            "keys_per_s": keys / wall_ms * 1e3, "top_device_ops": top}


def in_turns(a, b) -> tuple[dict, dict]:
    """call_figures of a and b taken in turns (a, b, b, a) after one of a
    thrown away (the first window after the eager checks read up to 20%
    slower, whichever form ran in it): the mean of each figure, and each
    run's wall under wall_ms_runs."""
    a()
    runs = [a(), b(), b(), a()]
    out = []
    for x, y in ((runs[0], runs[3]), (runs[1], runs[2])):
        m = {k: (None if x[k] is None or y[k] is None else (x[k] + y[k]) / 2)
             for k in x if k != "top_device_ops"}
        m["top_device_ops"] = x["top_device_ops"]
        m["wall_ms_runs"] = [x["wall_ms"], y["wall_ms"]]
        out.append(m)
    return out[0], out[1]


def show(fig: dict) -> str:
    dev = ("not measured" if fig["device_ms"] is None else
           f"{fig['device_ms']:.3f} ms in {fig['device_ops']:.0f} device ops, "
           f"busy share {fig['busy_share']:.3f}")
    return (f"wall {fig['wall_ms']:.3f} ms, CUDA events {fig['events_ms']:.3f}"
            f" ms, device (torch.profiler) {dev}, {fig['keys_per_s']:,.0f} "
            f"keys/s")


def check_vector(found, vector: set) -> None:
    labels = [f.label for f in found]
    if ({f.priv for f in found} != vector or len(found) != 1080
            or labels.count("addr33") != 540 or labels.count("addr65") != 540):
        raise AssertionError(f"mul vector: {len(found)} found "
                             f"({labels.count('addr33')} addr33, "
                             f"{labels.count('addr65')} addr65)")


def two_processes(argv: list[str]) -> list[dict]:
    """Run the CLI's main(argv) as processes 0 and 1 of one gloo group on
    127.0.0.1, each with a time limit; per process its found keys, the
    k_checked of its last status line, and its kernel launches and their
    widths (printed after main returns).  Fails unless both exit 0 with
    the banner."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = ("import json, sys; from ecloop_tpu_torch import cli, kernels; "
            "rc = cli.main(['ecloop'] + sys.argv[1:]); "
            "print(json.dumps(kernels.LAUNCHES)); print(json.dumps("
            "{k: sorted(v) for k, v in kernels.WIDTHS.items()})); "
            "sys.exit(rc)")
    env = {**os.environ, "ECLOOP_COORDINATOR": f"127.0.0.1:{port}",
           "ECLOOP_NUM_PROCS": str(TWO_PROCS)}
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, *argv], cwd=ROOT,
        env={**env, "ECLOOP_PROC_ID": str(i)}, stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for i in range(TWO_PROCS)]
    try:
        outs = [p.communicate(timeout=TWO_PROCS_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    results = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        err = err.replace("\r", "\n")
        if p.returncode != 0:
            raise AssertionError(f"process {i} exited {p.returncode}: "
                                 f"{err[-2000:]}")
        if (f"process {i}/{TWO_PROCS} ~ local devices: 1 / global: "
                f"{TWO_PROCS}") not in err:
            raise AssertionError(f"process {i}: no banner in {err[:400]!r}")
        status = [ln for ln in err.splitlines() if " Mkeys/s ~ " in ln][-1]
        tail = out.strip().splitlines()
        results.append({
            "found": {int(k, 16) for k in FOUND_LINE.findall(out)},
            "k_checked": int(status.rsplit(" / ", 1)[1].split()[0]
                             .replace(",", "")),
            "launches": json.loads(tail[-2]),
            "widths": json.loads(tail[-1])})
    return results


# phase p's process: the CLI's main(argv) and, as the last line of its
# stdout, what it ran (exit code, host s of main() and of the profiler's
# start and stop, kernel launches and widths, the capture s and launches
# of every graph, whether it initialized the card)
CLI_CHILD = """\
import json, sys, time
import torch
from torch.profiler import profile
from ecloop_tpu_torch import cli, graphs, kernels
captures, spent = [], {}
init = graphs.Graph.__init__
def noted(self, *args, **kwargs):
    init(self, *args, **kwargs)
    captures.append([self.capture_s, len(self.launches)])
graphs.Graph.__init__ = noted
def timed(name, fn):
    def run(self):
        t0 = time.perf_counter()
        fn(self)
        spent[name] = time.perf_counter() - t0
    return run
profile.start = timed("profiler_start_s", profile.start)
profile.stop = timed("profiler_stop_s", profile.stop)
t0 = time.perf_counter()
try:
    rc = cli.main(["ecloop"] + sys.argv[1:])
except SystemExit as e:
    rc = e.code
main_s = time.perf_counter() - t0
print(json.dumps({"rc": rc, "main_s": main_s, **spent,
                  "launches": kernels.LAUNCHES,
                  "widths": {k: sorted(v) for k, v in kernels.WIDTHS.items()},
                  "captures": captures,
                  "cuda_initialized": torch.cuda.is_initialized()}))
"""


def cli_process(argv: list[str], trace_dir: str | None = None,
                stdin: str | None = None) -> dict:
    """The CLI's main(argv) in a process of its own (CLI_CHILD), with
    ECLOOP_PROFILE=trace_dir when given and stdin from the file `stdin`,
    within CLI_TIMEOUT_S: its stdout (without the last line), stderr,
    wall s of the process, and the last line's figures."""
    env = {k: v for k, v in os.environ.items() if k != "ECLOOP_PROFILE"}
    if trace_dir:
        env["ECLOOP_PROFILE"] = trace_dir
    t0 = time.monotonic()
    with open(stdin or os.devnull) as src:
        proc = subprocess.Popen([sys.executable, "-c", CLI_CHILD, *argv],
                                cwd=ROOT, env=env, stdin=src,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=CLI_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    wall_s = time.monotonic() - t0
    err = err.replace("\r", "\n")
    if proc.returncode != 0 or not out.strip():
        raise AssertionError(f"{argv[0]} process exited {proc.returncode}: "
                             f"{err[-2000:]}")
    body, _, last = out.rstrip("\n").rpartition("\n")
    run = json.loads(last)
    status = [ln for ln in err.splitlines() if " Mkeys/s ~ " in ln]
    run.update(stdout=body + "\n" if body else "", stderr=err, wall_s=wall_s,
               k_checked=int(status[-1].rsplit(" / ", 1)[1].split()[0]
                             .replace(",", "")) if status else None)
    return run


def trace_figures(run: dict, trace_dir: str) -> dict:
    """What the one trace file in trace_dir holds: its MB, the s its
    write took (from the CLI's stderr line), its events, the card's
    events (kernels, copies, fills) and every CUDA event, graph launches,
    and per kernel of the port its events and those inside a graph
    replay (a kernel whose correlation id is a cudaGraphLaunch call's),
    and the other kernels inside the replays by name and count."""
    files = os.listdir(trace_dir)
    if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
        raise AssertionError(f"trace files: {files}")
    path = os.path.join(trace_dir, files[0])
    m = TRACE_LINE.search(run["stderr"])
    if not m or m.group(1) != path:
        raise AssertionError(f"no trace line for {path} in stderr")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    replays = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and e.get("name", "").startswith(("cudaGraphLaunch",
                                                 "cuGraphLaunch"))}
    other = collections.Counter(
        e.get("name", "")[:60] for e in events
        if e.get("cat") == "kernel"
        and e.get("args", {}).get("correlation") in replays
        and not any(s in e.get("name", "") for s in KERNEL_SYMBOLS.values()))
    per_kernel = {}
    for name, symbol in KERNEL_SYMBOLS.items():
        ev = [e for e in events
              if e.get("cat") == "kernel" and symbol in e.get("name", "")]
        per_kernel[name] = {
            "events": len(ev),
            "in_replays": sum(e.get("args", {}).get("correlation") in replays
                              for e in ev)}
    return {"mb": os.path.getsize(path) / 1e6, "write_s": float(m.group(3)),
            "events": len(events),
            "device_events": sum(e.get("cat") in DEVICE_CATS for e in events),
            "cuda_events": sum(e.get("cat") in CUDA_CATS for e in events),
            "graph_launches": len(replays), "kernels": per_kernel,
            "other_replay_kernels": dict(other)}


def traced_pair(argv: list[str], tmp: str, stdin: str | None = None):
    """argv run untraced, then traced into tmp/<argv[0]>: both runs'
    figures and the trace's.  Fails unless both exit 0 with the same
    stdout, k_checked, kernel launches and graphs (count and launches
    each captured)."""
    plain = cli_process(argv, stdin=stdin)
    trace_dir = os.path.join(tmp, argv[0])
    traced = cli_process(argv, trace_dir, stdin=stdin)
    for key in ("rc", "stdout", "k_checked", "launches"):
        if plain[key] != traced[key]:
            raise AssertionError(f"{argv[0]} traced: {key} {traced[key]!r:.300}"
                                 f" != untraced {plain[key]!r:.300}")
    if [c[1] for c in plain["captures"]] != [c[1] for c in traced["captures"]]:
        raise AssertionError(f"{argv[0]}: graphs captured untraced "
                             f"{plain['captures']}, traced {traced['captures']}")
    if plain["rc"] != 0:
        raise AssertionError(f"{argv[0]} exited {plain['rc']}")
    return plain, traced, trace_figures(traced, trace_dir)


def chord_inputs(m: int, k: int, dev):
    """K4's inputs for an `add` step of m centers x k keys from key
    0x8000, with center 1 stored as (0, 0) (a center at infinity):
    [cx, cy, tx, ty, dpx, dpy] on dev."""
    from ecloop_tpu_torch import fel
    from ecloop_tpu_torch.search import add
    from ecloop_tpu_torch.search.common import SearchConfig

    cfg = SearchConfig(range_s=0x8000, range_e=0xFFFFFF, centers=m, group_k=k)
    cx, cy = add.center_points(cfg, 0x8000)
    cx[1], cy[1] = 0, 0
    table = add._cached_table(cfg.stride, k, cfg.keys_per_step)
    return [fel.from_last(a, dev) for a in (cx, cy, *table)]


def probe_case(mode: str, arg: int, dev, seed: int):
    """K5's filter, bits and first words for a case of PROBE_CASES: random
    targets for compare mode (their unique first words, however many);
    dense random bits (3/4 set, so that keys pass every count of probes)
    for the exact and pow2 modes; for "blf" 2^arg bits, each set with
    probability BLF_FILL (a filter as blf-gen fills it), probed with
    `bloom.adaptive_probe_count` of them."""
    import numpy as np
    import torch
    from ecloop_tpu_torch import bloom, filters

    if mode == "compare":
        targets = np.random.default_rng(seed + arg).integers(
            0, 1 << 32, size=(arg, 5), dtype=np.uint64).astype(np.uint32)
        filt = filters.filter_from_hashes(targets)
        fw = torch.from_numpy(np.unique(filt.targets[:, 0]).astype(
            np.int64)).to(dev)
        return filt, torch.zeros(1, dtype=torch.int32, device=dev), fw
    if mode == "blf":
        words = 1 << (arg - 5)
        g = torch.Generator(device=dev).manual_seed(seed + arg)
        bits = torch.zeros(words, dtype=torch.int32, device=dev)
        for b in range(32):
            bits |= (torch.rand(words, device=dev, generator=g)
                     < BLF_FILL).to(torch.int32) << b
        blf = bloom.BloomFilter(words // 2, bits.cpu().numpy().view(np.uint64))
        return filters.Filter(mode="bloom", targets=None, blf=blf,
                              device_bits=None, pow2_log2=None,
                              blf_probes=bloom.adaptive_probe_count(blf.bits)
                              ), bits, None
    if mode == "pow2":
        filt = filters.Filter(mode="list", targets=None, blf=None,
                              device_bits=None, pow2_log2=arg)
        words = 1 << (arg - 5)
    else:
        nbits = 64 * 1000 if arg <= 20 else 3 * (1 << 32) + 64
        filt = filters.Filter(mode="bloom", targets=None,
                              blf=bloom.BloomFilter(nbits // 64),
                              device_bits=None, pow2_log2=None,
                              blf_probes=min(arg, 20))
        words = nbits // 32
    g = torch.Generator(device=dev).manual_seed(seed + arg)
    bits = torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32,
                         device=dev, generator=g)
    bits |= torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32,
                          device=dev, generator=g)
    return filt, bits, None


def planted(fw, words):
    """A compare case's first words with a quarter of them (at least one)
    replaced by `words` (hash words of keys the check probes), so that
    the list keeps its length and the keys hit."""
    import torch

    if fw is None or not fw.numel():
        return fw
    k = max(1, fw.numel() // 4)
    return torch.unique(torch.cat([fw[k:], words[:k]]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from ecloop_tpu_torch import _build, cli, ecc, fel, graphs, hash160, kernels
    from ecloop_tpu_torch import benchlib, bloom, checkpoint, filters, golden
    from ecloop_tpu_torch import sol
    from ecloop_tpu_torch.search import add, common, mul, rnd

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = sol.smi("name,power.limit")
    int_ops, sms, sm_mhz = sol.int_rate()

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
    sass = sass_mix(path)
    if sass is None:
        phase("0", "K1 SASS instruction mix: not available (no cuobjdump)")
    for form, mix in sorted((sass or {}).items()):
        phase("0", f"K1 SASS {form} per key: ALU pipe {mix['alu']}, FMA pipe "
                   f"(IMAD*) {mix['fma']}, other {mix['other']}; most "
                   f"frequent {mix['top']}")
    phase("0", f"integer rate {int_ops / 1e12:.4f} T ops/s = "
               f"{sol.INT_LANE_OPS_PER_CLK} x {sms} SMs x {sm_mhz} MHz (max SM "
               f"clock)")

    rng = np.random.default_rng(SEED)
    errs = {}
    # the widths the searches launch K1 and K2 at: the one-device step,
    # the shards of phases k and l, `mul`'s jobs and its table build
    # (bench, bench-gtable and mult-verify add HASH_N and VERIFY_N)
    split_widths = [shard_widths(split_config(n, re_, endo), n)
                    for _, n, re_, endo in SPLITS + (
                        ("two_processes", TWO_PROCS, 0xFFFFFF, False),)]
    wide_cfg = common.SearchConfig(range_s=0x8000, range_e=0xFFFFFF,
                                   centers=WIDE_CENTERS)
    split_widths.append(shard_widths(wide_cfg, 1))
    hash_ns = sorted({HASH_N, MUL_N} | {w for w, _ in split_widths},
                     reverse=True)
    inv_ns = sorted({INV_N, MUL_N, GTABLE_N, HASH_N, VERIFY_N, 1000, 33, 1}
                    | {w for _, w in split_widths} | gtable_widths(mul.W),
                    reverse=True)

    # --- 1: K1 against its plain version --------------------------------------
    err, hops = 0, {}
    for n in hash_ns:
        x = torch.from_numpy(fel.random_limbs(rng, n)).to(dev)
        y = torch.from_numpy(fel.random_limbs(rng, n)).to(dev)
        for name, k, p in (("addr33", kernels.addr33_hash_rows,
                            hash160.addr33_hash_rows),
                           ("addr65", kernels.addr65_hash_rows,
                            hash160.addr65_hash_rows)):
            got, want = k(x, y), p(x, y)
            torch.cuda.synchronize()
            e = int((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {name} differs from its plain "
                                     f"version at {n} keys (max abs err {e})")
            err = max(err, e)
            if n != HASH_N:
                continue
            # the bound's operation count, from K1's function run on key 0
            alu, either, words = sol.hash_ops(
                x[:, 0].tolist(), y[:, 0].tolist(), name == "addr33")
            if words != got[:, 0].tolist():
                raise AssertionError(f"HashOpCount {name} computes {words}, "
                                     f"K1 {got[:, 0].tolist()}")
            hops[name] = {"alu": alu, "either": either}
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
    phase("1", f"K1 hash160 == plain at {hash_ns} keys (addr33, addr65), "
               f"max abs err {err} (tolerance 0: integer math); 8 points "
               f"== host oracle")
    for name, h in hops.items():
        phase("1", f"K1 {name} function per key: {h['alu']} ALU-only + "
                   f"{h['either']} either-pipe operations (HashOpCount, its "
                   f"hash of key 0 == K1's)")

    # --- 2: K2 against its plain version --------------------------------------
    p = fel.P
    blk = kernels.inv_block_elements()
    err, cases = 0, []
    for n in inv_ns:
        a = fel.random_limbs(rng, n)
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
    phase("2", f"K2 inv_mod_batch == plain at {inv_ns} elements (the "
               f"searches' steps, shards and table build; {HASH_N} the "
               f"bench's, {VERIFY_N} mult-verify's) (0, 1, p-1 first; zeros "
               f"at the end, "
               f"across a {blk}-element block edge and over one whole block) "
               f"and on 1000 zeros, max abs err {err} (tolerance 0); 64 spot "
               f"checks each == pow(x, p-2, p)")

    # --- a: K3 against its plain version ----------------------------------------------
    err = 0
    for n in (MUL_N, HASH_N, VERIFY_N):
        (qx, qy, qz), (gx, gy), skip, (hq, hg, hz) = window_lanes(rng, n, dev)
        for complete in (False, True):
            got = kernels.proj_add_affine(qx, qy, qz, gx, gy, skip, complete)
            want = [fel.select(skip, o, p) for o, p in zip(
                (qx, qy, qz), ecc.proj_add_affine_rows(qx, qy, qz, gx, gy,
                                                       complete))]
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                e = int((a - b).abs().max())
                if not torch.equal(a, b):
                    raise AssertionError(f"K3 complete={complete} differs "
                                         f"from its plain version at {n} "
                                         f"lanes (max abs err {e})")
                err = max(err, e)
            check_window_add(got, hq, hg, hz, complete)
            if complete != (fel.tensor_to_ints(got[2][:, 1:2])[0] != 0):
                raise AssertionError("K3: the P == Q lane")
    errs["mixed_add"] = err
    phase("a", f"K3 mixed_add == plain at {MUL_N}, {HASH_N} (bench) and "
               f"{VERIFY_N} (mult-verify) lanes, incomplete and "
               f"complete (infinity, P == Q, P == -Q and skip lanes), max abs "
               f"err {err} (tolerance 0: integer math); 60 lanes == golden "
               f"P + Q")

    # --- 3: the main path ---------------------------------------------------------
    for v in kernels.WIDTHS.values():
        v.clear()
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
    if min(launches_add[k] for k in ADD_KERNELS) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches_add}")
    fused_only(launches_add, "add")
    rate = run.k_checked / run.seconds
    add_s = run.seconds
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

    # --- 5: a bloom filter from blf-gen, blf-check, bloom mode with -a cu -----
    with open(PUZZLES) as f:
        puzzle_text = f.read()
    puzzle = filters.parse_hash_lines(puzzle_text)
    extra = rng.integers(0, 1 << 32, size=(1_000_000, 5),
                         dtype=np.uint64).astype(np.uint32)
    hashes = np.concatenate([puzzle, extra])
    raw = extra.astype(">u4").tobytes().hex()
    blf_text = puzzle_text.rstrip("\n") + "\n" + "\n".join(raw[i:i + 40]
                                       for i in range(0, len(raw), 40)) + "\n"
    non_members = rng.integers(0, 1 << 32, size=(64, 5),
                               dtype=np.uint64).astype(np.uint32)
    sample = hashes[rng.choice(len(hashes), size=64, replace=False)]
    query = ["".join(f"{int(w):08x}" for w in h)
             for h in np.concatenate([sample, non_members])]
    with tempfile.TemporaryDirectory() as tmp:
        blf_path = os.path.join(tmp, "targets.blf")
        t0 = time.monotonic()
        gen_out = io.StringIO()
        with contextlib.redirect_stdout(gen_out):
            cli.run_blf_gen(cli.Args(["ecloop", "blf-gen", "-n",
                                      str(len(hashes)), "-o", blf_path]),
                            blf_text)
        blf_gen_s = time.monotonic() - t0
        gen_out = gen_out.getvalue().strip()
        m = re.match(r"added ([\d,]+) hashes \(([\d,]+) duplicates\)", gen_out)
        if not m or sum(int(g.replace(",", "")) for g in m.groups()) != len(
                hashes):
            raise AssertionError(f"blf-gen: {gen_out!r}")
        blf = bloom.BloomFilter.load(blf_path)
        if not blf.has_many(hashes).all():
            raise AssertionError("blf-gen: a hash is missing from the filter")
        chk_out = io.StringIO()
        with contextlib.redirect_stdout(chk_out):
            chk_rc = cli.run_blf_check(cli.Args(["ecloop", "blf-check", "-f",
                                                 blf_path, *query]), [])
        lines = chk_out.getvalue().splitlines()
        hits = [ln.split()[0] for ln in lines
                if ln.endswith(" FOUND") and "NOT FOUND" not in ln]
        if hits != query[:64] or len(lines) != 128 or chk_rc != 1:
            raise AssertionError(f"blf-check: {len(hits)} real hits of 128 "
                                 f"lines, rc {chk_rc}")
        run = cli.run_add(cli.Args(["ecloop", "add", "-f", blf_path,
                                    "-r", "8000:ffffff", "-a", "cu"]))
        blf_filt = filters.load_filter(blf_path)
    got33 = {f.priv for f in run.found if f.label == "addr33"}
    if not NINE_KEYS <= got33:
        raise AssertionError(f"bloom mode missed {NINE_KEYS - got33}")
    for f in run.found:
        h = np.frombuffer(bytes.fromhex(f.h160), dtype=">u4").astype(np.uint32)
        if not blf.has_many(h[None])[0]:
            raise AssertionError(f"bloom mode reported a non-member: {f}")
    phase("5", f"blf-gen: {gen_out} in {blf_gen_s:.3f} s (host); blf-check: "
               f"64 sampled members FOUND, 64 random non-members NOT FOUND, "
               f"rc 1; bloom mode -a cu: {len(run.found)} found (9 puzzle "
               f"keys addr33 included, {len(run.found) - 9} filter "
               f"positives), k_checked {run.k_checked:,}")

    # --- e: rnd, one full pass --------------------------------------------------
    kernels.reset_launches()
    run = cli.run_rnd(cli.Args(["ecloop", "rnd", "-f", PUZZLES,
                                "-r", "8000:ffffff"]))
    launches_rnd = dict(kernels.LAUNCHES)
    privs = {f.priv for f in run.found}
    if run.device.type != "cuda":
        raise AssertionError(f"rnd ran on {run.device}")
    if privs != NINE_KEYS or len(run.found) != 9:
        raise AssertionError(f"rnd found {sorted(map(hex, privs))}")
    if run.k_checked != 16_777_216:
        raise AssertionError(f"rnd k_checked {run.k_checked}")
    if min(launches_rnd[k] for k in ADD_KERNELS) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches_rnd}")
    fused_only(launches_rnd, "rnd")
    phase("e", f"rnd -r 8000:ffffff (24-bit window, one pass): 9/9 keys, "
               f"k_checked {run.k_checked:,} in {run.seconds:.3f} s = "
               f"{run.k_checked / run.seconds:,.0f} keys/s; launches "
               f"{launches_rnd}")

    # --- f: seeded rnd over 2^20-key sub-ranges -------------------------------------
    cfg = common.SearchConfig(range_s=0x8000, range_e=0xFFFFFF)
    eng = rnd.RndSearch(cfg, filters.load_filter(PUZZLES), dev,
                        seed=RND_SEED, offs=0, size=20)
    spans, walls = [], []
    t_range = [0.0]

    def on_range(lo, hi):
        torch.cuda.synchronize()
        t_range[0] = time.monotonic()

    def on_iter(i, lo, hi, got):
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t_range[0])
        spans.append((lo, hi, {f.priv for f in got}, len(got)))

    found = eng.run(max_iters=RND_ITERS, on_range=on_range, on_iter=on_iter)
    fresh = rnd.Rng(RND_SEED)
    want = [rnd.gen_random_range(fresh, 0x8000, 0xFFFFFF, 0, 20)
            for _ in range(RND_ITERS)]
    if [sp[:2] for sp in spans] != want:
        raise AssertionError(f"rnd sub-ranges {spans} differ from a fresh "
                             f"Rng's {want}")
    inside = [{k for k in NINE_KEYS if lo <= k <= hi} for lo, hi in want]
    for (lo, hi, got, n), keys in zip(spans, inside):
        if got != keys or n != len(keys):
            raise AssertionError(f"rnd [{lo:#x}, {hi:#x}]: found "
                                 f"{sorted(map(hex, got))}")
    claimed = sum(c.job for lo, hi in want for c in common.plan_claims(
        lo, hi, common.derive_job_size(lo, hi), 1))
    if eng.engine.k_checked != claimed or not set().union(*inside):
        raise AssertionError(f"rnd k_checked {eng.engine.k_checked} != "
                             f"{claimed}, or no key inside the draws")
    center_s = []
    for lo, _hi in want:
        t0 = time.monotonic()
        add.center_points(cfg, lo)
        center_s.append(time.monotonic() - t0)
    base71 = (1 << 70) + int(rng.integers(1, 1 << 62))
    t0 = time.monotonic()
    chain71 = add.center_points(cfg, base71)
    chain71_s = time.monotonic() - t0
    h = cfg.group_k // 2
    t0 = time.monotonic()
    per71 = ecc.points_host([(base71 + (m * cfg.group_k + h) * cfg.stride)
                             % golden.N for m in range(cfg.centers)])
    per71_s = time.monotonic() - t0
    if not all(np.array_equal(a, b) for a, b in zip(chain71, per71)):
        raise AssertionError("center_points differs from the per-center form")
    rnd_split = {"center_points_s": sum(center_s) / len(center_s),
                 "search_s": sum(walls) / len(walls),
                 "center_points_71bit_s": chain71_s,
                 "per_center_71bit_s": per71_s}
    phase("f", f"rnd -d 0:20 -seed {RND_SEED}, {RND_ITERS} sub-ranges == a "
               f"fresh Rng's (blocks {[lo >> 20 for lo, _ in want]}): found "
               f"{sorted(map(hex, {f.priv for f in found}))} ({len(found)} "
               f"finds) == the nine keys inside them, k_checked "
               f"{claimed:,} == their claims; per sub-range (host clock, "
               f"synchronized): center_points {rnd_split['center_points_s']:.4f}"
               f" s, search {rnd_split['search_s']:.4f} s; at a 71-bit base "
               f"center_points {chain71_s:.4f} s, per-center form "
               f"{per71_s:.4f} s; card {card}")

    # --- g: add -c, resumed from a checkpoint ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.json")
        key = checkpoint.config_key_for("add", cfg, PUZZLES)
        checkpoint.Checkpoint(state, key).save(
            cursor=RESUME_KEY - cfg.range_s, force=True)
        out = io.StringIO()
        kernels.reset_launches()
        with contextlib.redirect_stdout(out):
            run = cli.run_add(cli.Args(["ecloop", "add", "-f", PUZZLES,
                                        "-r", "8000:ffffff", "-c", state]))
        launches_resume = dict(kernels.LAUNCHES)
        with open(state) as f:
            saved = json.load(f)
    resume_line = f"resuming from checkpoint: offset {RESUME_KEY - 0x8000:,} keys"
    want = {k for k in NINE_KEYS if k >= RESUME_KEY}
    if resume_line not in out.getvalue():
        raise AssertionError(f"add -c printed {out.getvalue()!r}")
    if {f.priv for f in run.found} != want or len(run.found) != len(want):
        raise AssertionError(f"add -c found {run.found}")
    if run.k_checked != 16_777_216 or saved["k_found"] != len(want):
        raise AssertionError(f"add -c k_checked {run.k_checked}, saved {saved}")
    if min(launches_resume[k] for k in ADD_KERNELS) < 1:
        raise AssertionError(f"a kernel of the path never ran: "
                             f"{launches_resume}")
    fused_only(launches_resume, "add -c")
    phase("g", f"add -r 8000:ffffff -c from key {RESUME_KEY:#x}: "
               f"'{resume_line}', found {sorted(map(hex, want))}, k_checked "
               f"{run.k_checked:,}, saved cursor {saved['cursor']:,}, in "
               f"{run.seconds:.3f} s; launches {launches_resume}")

    # --- b: the w=14 table, built on the card ---------------------------------------
    torch.cuda.synchronize()
    t0 = time.monotonic()
    table = mul.build_gtable(mul.W, dev)                    # the CLI's key
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
    check_vector(run.found, vector)
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
    check_vector(run.found, vector)
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
               f"{split['engine_keys_per_s']:,.0f} keys/s")

    # --- n: the one-dispatch calls (a CUDA graph) against the eager steps -----------
    puzzles = filters.load_filter(PUZZLES)
    step_calls = {}

    def add_call(name, cfg, filt, cmp_max=None):
        """Build the call (its capture's host seconds and peak memory),
        replay it from the first centers of 8000:ffffff, and hold its
        masks and next centers against the eager steps'."""
        env = os.environ.pop("ECLOOP_CMP_MAX", None)
        if cmp_max is not None:
            os.environ["ECLOOP_CMP_MAX"] = cmp_max
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            call = add.build_step_fn(cfg, filt, dev)
            peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**20
        finally:
            os.environ.pop("ECLOOP_CMP_MAX", None)
            if env is not None:
                os.environ["ECLOOP_CMP_MAX"] = env
        cx, cy = (fel.from_last(a, dev) for a in add.center_points(cfg, 0x8000))
        call.seed(cx, cy)
        with no_direct_launches(kernels, f"add call ({name})"):
            call()
        masks = []
        for _ in range(cfg.steps_per_call):
            cx, cy, m = call.step(cx, cy, *call.table, call.bits)
            masks.append(m)
        torch.cuda.synchronize()
        if not (torch.equal(call.masks, torch.stack(masks))
                and torch.equal(call.cx, cx) and torch.equal(call.cy, cy)):
            raise AssertionError(f"add call ({name}): the graph's masks or "
                                 f"centers differ from the eager steps'")
        hits = int(call.masks.count_nonzero())
        if not hits:
            raise AssertionError(f"add call ({name}): no hit in the first "
                                 f"{cfg.steps_per_call} steps")
        replay = collections.Counter(k for k, _ in call.graph.launches)
        fused_only(replay, f"add call ({name})")
        if replay["hash160_probe"] != cfg.addr33 + cfg.addr65:
            raise AssertionError(f"add call ({name}): {dict(replay)} per "
                                 f"replay, one hash160_probe per form expected")
        step_calls[name] = {
            "centers": cfg.centers, "steps": cfg.steps_per_call,
            "capture_s": call.graph.capture_s, "peak_mib": peak,
            "kernel_launches_per_replay": len(call.graph.launches),
            "replay_launches": dict(replay),
            "replays_per_call": cfg.steps_per_call, "hit_words": hits}
        phase("n", f"add {name} ({cfg.centers} x {cfg.group_k}, T = "
                   f"{cfg.steps_per_call}): graph call == {cfg.steps_per_call}"
                   f" eager steps (masks and next centers bit-identical, "
                   f"{hits} mask words with a hit); built in "
                   f"{call.graph.capture_s:.3f} s (warm-up and capture), "
                   f"peak {peak:.0f} MiB, {len(call.graph.launches)} kernel "
                   f"launches per replay (one step), {cfg.steps_per_call} "
                   f"replays per call")
        return call

    def add_timing(name, call, cfg):
        """Per step: the call (one step's graph replayed T times), the
        alternative of one graph of all T steps, and the eager steps."""
        t_ = cfg.steps_per_call
        st = [call.cx.clone(), call.cy.clone()]
        masks = call.masks.clone()

        def t_steps(t):
            cx, cy, m = call.step(st[0], st[1], *call.table, call.bits)
            st[0].copy_(cx)
            st[1].copy_(cy)
            masks[t].copy_(m)
        whole = graphs.Graph(t_steps, dev, t_)

        def eager():
            cx, cy = st
            for _ in range(t_):
                cx, cy, _m = call.step(cx, cy, *call.table, call.bits)
        keys = cfg.keys_per_step
        graph, graph_t = in_turns(lambda: call_figures(call, t_, keys, 10),
                                  lambda: call_figures(whole, t_, keys, 10))
        figs = {"graph": graph, "graph_t_steps": graph_t,
                "eager": call_figures(eager, t_, keys, 3)}
        figs["graph_t_steps"]["capture_s"] = whole.capture_s
        # the step's operations (sol.step_budget, the compare probe) at the
        # card's integer rate, against the graph's device time
        budget_ms = (sol.step_budget(cfg, step_leaf, probe="probe_cmp")[
            "total_ops_per_point"] * keys / int_ops * 1e3)
        figs["graph"]["step_budget_ms"] = budget_ms
        step_calls[name].update(figs)
        for k, f in figs.items():
            phase("n", f"add {name} per step, {k}: {show(f)}; card {card}")
        dev_ms = figs["graph"]["device_ms"]
        phase("n", f"add {name}: sol.step_budget {budget_ms:.4f} ms per step "
                   f"(operations), " + ("device time not measured" if dev_ms
                                        is None else f"share {budget_ms / dev_ms:.1%}"
                                        f" of the graph's device time"))

    base_cfg = common.SearchConfig(range_s=0x8000, range_e=0xFFFFFF)
    step_leaf = sol.leaf_budgets()
    # every geometry x prefilter mode x -endo; the list mode without
    # -endo (the CLI's default on the puzzle list) is timed
    for geo, gcfg in (("", base_cfg), ("_512", wide_cfg)):
        for mode, filt, cmp_max in (("list", puzzles, None),
                                    ("pow2", puzzles, "0"),
                                    ("bloom", blf_filt, None)):
            for endo in (False, True):
                cfg = dataclasses.replace(gcfg, endo=endo)
                name = f"{mode}{geo}{'_endo' if endo else ''}"
                call = add_call(name, cfg, filt, cmp_max)
                if mode == "list" and not endo:
                    add_timing(name, call, cfg)
                del call

    mfilt = filters.load_filter(BW_HASH)
    mwords = mul.parse_hex_words(bw_lines + lines[:MUL_N - len(bw_lines)])
    mdig = np.ascontiguousarray(mul.window_digits_words(mwords, mul.W).T,
                                dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    mcall = mul.build_mul_step(common.SearchConfig(addr33=True, addr65=True),
                               mfilt, mul.W, MUL_N, dev)
    mpeak = (torch.cuda.max_memory_allocated(dev) - held) / 2**20
    mcall.upload(mdig)
    with no_direct_launches(kernels, "mul call"):
        mcall()
    mdig_t = torch.from_numpy(mdig).to(dev)
    want = mcall.step(mdig_t, mcall.txy, mcall.bits)
    torch.cuda.synchronize()
    if not torch.equal(mcall.masks, want):
        raise AssertionError("mul call: the graph's masks differ from the "
                             "eager job's")
    mreplay = collections.Counter(k for k, _ in mcall.graph.launches)
    fused_only(mreplay, "mul call")
    mhits = int(np.unpackbits(want.cpu().numpy().astype("<u4").view(
        np.uint8)).sum())
    if mhits < 1080:
        raise AssertionError(f"mul call: {mhits} hit bits, the job holds the "
                             f"1080-key vector")
    step_calls["mul"] = {
        "batch": MUL_N, "capture_s": mcall.graph.capture_s, "peak_mib": mpeak,
        "kernel_launches_per_replay": len(mcall.graph.launches),
        "replay_launches": dict(mreplay), "hit_bits": mhits,
        "graph": call_figures(mcall, 1, MUL_N, 50),
        "eager": call_figures(lambda: mcall.step(mdig_t, mcall.txy,
                                                 mcall.bits), 1, MUL_N, 20)}
    phase("n", f"mul job ({MUL_N:,} keys, the 1080-key vector among them, "
               f"btc-bw-hash's 1,080 targets): graph == eager job "
               f"(masks bit-identical, {mhits} hit bits); built in "
               f"{mcall.graph.capture_s:.3f} s, peak {mpeak:.0f} MiB, "
               f"{len(mcall.graph.launches)} kernel launches per replay")
    for k in ("graph", "eager"):
        phase("n", f"mul job, {k}: {show(step_calls['mul'][k])}; card {card}")
    phase("n", "most costly device ops per call (count, ms): " + "; ".join(
        f"{name} {k}: {v[k]['top_device_ops']}" for name, v in
        step_calls.items() for k in ("graph", "eager") if k in v))
    del mcall

    # --- 6: timing ----------------------------------------------------------------
    x = torch.from_numpy(fel.random_limbs(rng, HASH_N)).to(dev)
    y = torch.from_numpy(fel.random_limbs(rng, HASH_N)).to(dev)
    xi = torch.from_numpy(fel.random_limbs(rng, INV_N)).to(dev)
    xm = torch.from_numpy(fel.random_limbs(rng, MUL_N)).to(dev)
    # K3 as the main path runs it: a digit of 0 (skip) is 1 in 2^14
    q = [torch.from_numpy(fel.random_limbs(rng, MUL_N)).to(dev) for _ in range(5)]
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
    x1 = torch.from_numpy(fel.random_limbs(rng, 1)).to(dev)
    chain_ms = device_ms(lambda: kernels.inv_mod_batch(x1), "inv_batch_kernel")
    active = int((~fel.is_zero(q[2])).sum())
    bounds = {
        "hash160": sol.bound(*sol.hash_account(HASH_N, True, hops["addr33"]),
                             int_ops),
        "hash160_addr65": sol.bound(*sol.hash_account(HASH_N, False,
                                                      hops["addr65"]), int_ops),
        "inv_mod_batch": sol.bound(*sol.inv_account(INV_N), int_ops),
        "inv_mod_batch_mul": sol.bound(*sol.inv_account(MUL_N), int_ops),
        "mixed_add_incomplete": sol.bound(
            *sol.mixed_add_account(MUL_N, active), int_ops),
        "mixed_add_complete": sol.bound(
            *sol.mixed_add_account(MUL_N, active), int_ops),
    }
    for name, (k_ms, p_ms) in t.items():
        n = {"inv": INV_N, "mix": MUL_N}.get(name[:3], HASH_N)
        n = MUL_N if name.endswith("_mul") else n
        b_ms, b_by = bounds[name]
        phase("6", f"{name} at n={n}: kernel {k_ms:.4f} ms on the device "
                   f"(torch.profiler, mean of 20 calls), {call_ms[name]:.4f} ms "
                   f"per wrapper call, plain {p_ms:.4f} ms (CUDA events, "
                   f"windows >= {TIME_WINDOW_S} s), bound {b_ms:.4f} ms "
                   f"({b_by}), share {b_ms / k_ms:.1%}; card {card}")
        if b_ms > k_ms:
            raise AssertionError(f"{name} runs in {k_ms:.4f} ms, under its "
                                 f"least time {b_ms:.4f} ms: the bound's "
                                 f"model is wrong")
    # K1 against its own SASS (evidence, not the bound: it follows the
    # compiler's choice of pipe): ALU-pipe ops at 64 and all lane ops at
    # 128 per clock per SM (the ALU and FMA pipes issue side by side)
    sass_bound = {}
    for form, key in (("addr33", "hash160"), ("addr65", "hash160_addr65")):
        if sass and form in sass:
            mix = sass[form]
            per_clk = max(mix["alu"] / 64, (mix["alu"] + mix["fma"]) / 128)
            sass_bound[form] = HASH_N * per_clk / (sms * sm_mhz * 1e6) * 1e3
            phase("6", f"{key}: SASS dual-pipe bound {sass_bound[form]:.4f} ms "
                       f"({mix['alu']} ALU + {mix['fma']} FMA-pipe ops per "
                       f"key), share {sass_bound[form] / t[key][0]:.1%}")
    phase("6", f"inv_mod_batch chain floor (n=1, one block, one safegcd "
               f"inversion): kernel {chain_ms:.4f} ms on the device "
               f"(torch.profiler, mean of 20 calls); card {card}")

    # --- 7: K4 and K5 against their plain forms at every searched width, timed ---
    # K4 at each step geometry the searches run (every shard of phases 3-5,
    # e-g, k, l and p is 32 x 4096; phase n's wide call 512 x 4096), -endo
    # and plain, with a (0, 0) center and four zero inverses; K5 at every
    # key count they probe, in every mode of PROBE_CASES
    gk = base_cfg.group_k
    chord_ns = sorted({HASH_N} | {w for w, _ in split_widths})
    k4_cases, k5_cases, errs["add_chords"], errs["probe_pack"] = {}, {}, 0, 0
    for keys in chord_ns:
        cx, cy, tx, ty, dpx, dpy = chord_inputs(keys // gk, gk, dev)
        nh = keys // 2
        for endo in (False, True):
            dx = kernels.chord_dx(cx, tx, dpx)
            inv = kernels.inv_mod_batch(dx)
            inv[:, [0, 7, nh - 1, nh + 2]] = 0
            got_dx = ecc.chord_dx_plain(cx, tx, dpx)
            got = kernels.chord_points(cx, cy, tx, ty, dpx, dpy, inv, endo, endo)
            want = ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv, endo,
                                          endo)
            torch.cuda.synchronize()
            for a, b in zip((dx,) + got[0] + got[1] + got[2:],
                            (got_dx,) + want[0] + want[1] + want[2:]):
                e = int((a - b).abs().max())
                if not torch.equal(a, b):
                    raise AssertionError(f"K4 differs from its plain form at "
                                         f"{keys} keys, endo={endo} (max abs "
                                         f"err {e})")
                errs["add_chords"] = max(errs["add_chords"], e)
            acc = sol.chord_account(keys // gk, gk, endo, endo)
            b_dx, b_pt = (sol.bound(*acc[x], int_ops)
                          for x in ("chord_dx", "chord_points"))
            dx_ms = device_ms(lambda: kernels.chord_dx(cx, tx, dpx),
                              "chord_dx_kernel")
            pt_ms = device_ms(lambda: kernels.chord_points(
                cx, cy, tx, ty, dpx, dpy, inv, endo, endo), "chord_points_kernel")
            call, plain = paired_ms(
                lambda: kernels.chord_points(cx, cy, tx, ty, dpx, dpy,
                                             kernels.chord_dx(cx, tx, dpx),
                                             endo, endo),
                lambda: ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy,
                                               ecc.chord_dx_plain(cx, tx, dpx),
                                               endo, endo))
            k_ms, b_ms = dx_ms + pt_ms, b_dx[0] + b_pt[0]
            k4_cases[f"{keys}{'_endo' if endo else ''}"] = {
                "ms": k_ms, "ms_dx": dx_ms, "ms_points": pt_ms, "call_ms": call,
                "plain_ms": plain, "bound_ms": b_ms, "bound_ms_dx": b_dx[0],
                "bound_ms_points": b_pt[0], "bound_by": b_pt[1],
                "bytes": acc["chord_dx"][0] + acc["chord_points"][0],
                "ops": acc["chord_dx"][1] + acc["chord_points"][1]}
            phase("7", f"add_chords at {keys // gk} x {gk} ({'-endo' if endo else 'plain'}):"
                       f" == plain (a (0, 0) center, 4 zero inverses; max abs err "
                       f"{errs['add_chords']}, tolerance 0); kernel {k_ms:.4f} ms on "
                       f"the device (chord_dx {dx_ms:.4f} + chord_points "
                       f"{pt_ms:.4f}, torch.profiler), {call:.4f} ms per wrapper "
                       f"pair, plain {plain:.4f} ms (CUDA events), bound "
                       f"{b_ms:.4f} ms ({b_dx[1]} / {b_pt[1]}), share "
                       f"{b_ms / k_ms:.1%}; card {card}")
            if b_ms > k_ms:
                raise AssertionError(f"add_chords runs in {k_ms:.4f} ms, under "
                                     f"its least time {b_ms:.4f} ms")
    for name, info in sorted(ptxas.items()):
        if "chord" in name or "probe" in name:
            phase("7", f"ptxas {name}: {info}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # per key count: K5's random hash words, and the fused entry's three x
    # and two y rows of random limbs with every plane's plain hash rows
    # (K1's plain form), made once for all the cases
    k5_in, fused_in = {}, {}
    for n in hash_ns:
        k5_in[n] = torch.randint(0, 1 << 32, (5, n), dtype=torch.int64,
                                 device=dev, generator=gen)
        xs = [torch.from_numpy(fel.random_limbs(rng, n)).to(dev)
              for _ in range(3)]
        ys = [torch.from_numpy(fel.random_limbs(rng, n)).to(dev)
              for _ in range(2)]
        fused_in[n] = (xs, ys, {p: (hash160.addr33_hash_rows if p[2] else
                                    hash160.addr65_hash_rows)(xs[p[0]], ys[p[1]])
                                for p in PLANE_SETS[12]})
    counts = {True: hops["addr33"], False: hops["addr65"]}
    k5_cases, fused_cases, errs["probe_pack"], errs["hash160_probe"] = {}, {}, 0, 0
    for mode, arg in PROBE_CASES:
        filt, bits, fw0 = probe_case(mode, arg, dev, SEED)
        kmode = "exact" if mode == "blf" else mode
        what = f"{mode} {arg}" + (f" ({filt.blf_probes} probes)"
                                  if mode == "blf" else "")
        if mode == "blf":       # members: the first keys of each check
            for n in hash_ns:
                plant_members(filt, bits, k5_in[n][:, :32])
                plant_members(filt, bits, fused_in[n][2][(0, 0, True)][:, :32])
        for n in hash_ns:
            h, fw = k5_in[n].clone(), fw0
            if fw is not None and fw.numel():         # plant hits
                h[0, :n // 4] = fw[torch.arange(n // 4, device=dev) % fw.numel()]
            got = kernels.probe_pack(filt, h, bits, fw)
            want = filters.probe_pack_plain(filt, h, bits, fw)
            torch.cuda.synchronize()
            e = int((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"K5 differs from its plain form at {n} "
                                     f"keys, {what} (max abs err {e})")
            errs["probe_pack"] = max(errs["probe_pack"], e)
            hits = int(np.unpackbits(got.cpu().numpy().astype("<u4").view(
                np.uint8)).sum())
            if (hits == 0) != (mode == "compare" and arg == 0):
                raise AssertionError(f"K5 {what}: {hits} hits")
            nfw = 0 if fw is None else fw.numel()
            reads = sol.probe_reads(filt, h, bits, fw)
            b_ms, b_by = sol.bound(*sol.probe_pack_account(
                n, kmode, reads, nfw, bits.numel()), int_ops)
            k_ms = device_ms(lambda: kernels.probe_pack(filt, h, bits, fw),
                             "probe_pack_kernel")
            p_ms = time_ms(lambda: filters.probe_pack_plain(filt, h, bits, fw))
            k5_cases[f"{n}_{mode}_{arg}"] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "hits": hits, "probe_reads": reads, "first_words": nfw,
                "probes": filt.blf_probes if filt.mode == "bloom" else None}
            phase("7", f"probe_pack at {n} keys, {what}: == plain ({hits} "
                       f"hits, {reads} bit words read; max abs err "
                       f"{errs['probe_pack']}, tolerance 0); kernel {k_ms:.4f} ms"
                       f" on the device (torch.profiler), plain {p_ms:.4f} ms "
                       f"(CUDA events), bound {b_ms:.4f} ms ({b_by}), share "
                       f"{b_ms / k_ms:.1%}; card {card}")
            if b_ms > k_ms:
                raise AssertionError(f"probe_pack runs in {k_ms:.4f} ms, under "
                                     f"its least time {b_ms:.4f} ms")
            del h
            # the fused hash and probe, every plane set, against the plain
            # hash rows probed by the plain form
            xs, ys, rows = fused_in[n]
            fw = planted(fw0, rows[(0, 0, True)][0])
            for count, planes in PLANE_SETS.items():
                out = torch.empty((count, n // 32), dtype=torch.int64,
                                  device=dev)
                kernels.hash160_probe(filt, xs, ys, planes, bits, fw, out)
                want = torch.stack([filters.probe_pack_plain(filt, rows[p], bits,
                                                             fw) for p in planes])
                torch.cuda.synchronize()
                e = int((out - want).abs().max())
                if not torch.equal(out, want):
                    raise AssertionError(f"hash160_probe differs from its plain "
                                         f"form at {n} keys x {count} planes, "
                                         f"{what} (max abs err {e})")
                errs["hash160_probe"] = max(errs["hash160_probe"], e)
                if (int(want.count_nonzero()) == 0) != (mode == "compare"
                                                        and arg == 0):
                    raise AssertionError(f"hash160_probe {what}: no hit")
            if n not in FUSED_TIMED_NS:
                continue
            # one plane (the default addr33 step): the fused launch against
            # K1, K5 and the stack of the planes that it replaces
            planes, out = PLANE_SETS[1], torch.empty((1, n // 32),
                                                     dtype=torch.int64, device=dev)
            x, y = xs[0], ys[0]

            def fused():
                kernels.hash160_probe(filt, xs, ys, planes, bits, fw, out)

            def unfused():
                torch.stack([kernels.probe_pack(filt, kernels.addr33_hash_rows(
                    x, y), bits, fw)])
            k_ms = device_ms(fused, "hash160_probe_kernel")
            f_ms, f_ops = device_total_ms(fused, 1)
            u_ms, u_ops = device_total_ms(unfused, 3)
            reads = sol.probe_reads(filt, rows[(0, 0, True)], bits, fw)
            nfw = 0 if fw is None else fw.numel()
            acc = sol.hash_probe_account(n, planes, kmode, reads, nfw,
                                         bits.numel(), counts)
            b_ms, b_by = sol.bound(*acc, int_ops)
            fused_cases[f"{n}_{mode}_{arg}"] = {
                "ms": k_ms, "device_ms": f_ms, "device_ops": f_ops,
                "unfused_ms": u_ms, "unfused_ops": u_ops, "bound_ms": b_ms,
                "bound_by": b_by, "bytes": acc[0], "ops": acc[1],
                "probe_reads": reads, "first_words": nfw}
            phase("7", f"hash160_probe at {n} keys, {what}: == plain at 1, 2, 6 "
                       f"and 12 planes (max abs err {errs['hash160_probe']}, "
                       f"tolerance 0); 1 plane: kernel {k_ms:.4f} ms on the "
                       f"device (torch.profiler), all device ops {f_ms:.4f} ms "
                       f"in {f_ops:.0f} against K1 + K5 + stack {u_ms:.4f} ms "
                       f"in {u_ops:.0f}; bound {b_ms:.4f} ms ({b_by}), share "
                       f"{b_ms / k_ms:.1%}; card {card}")
            if b_ms > k_ms:
                raise AssertionError(f"hash160_probe runs in {k_ms:.4f} ms, "
                                     f"under its least time {b_ms:.4f} ms")
            if (mode, arg, n) == ("compare", 160, HASH_N):
                fused_plain_ms = time_ms(lambda: torch.stack([
                    filters.probe_pack_plain(filt, hash160.addr33_hash_rows(
                        x, y), bits, fw)]))
        del bits
    del k5_in, fused_in
    # the report's rows: what the default `add` step runs (32 x 4096, the
    # puzzle list's compare probe at 160 first words)
    main4, main5 = k4_cases[str(HASH_N)], k5_cases[f"{HASH_N}_compare_160"]
    main_f = fused_cases[f"{HASH_N}_compare_160"]
    t["add_chords"] = (main4["ms"], main4["plain_ms"])
    call_ms["add_chords"] = main4["call_ms"]
    bounds["add_chords"] = (main4["bound_ms"], main4["bound_by"])
    t["probe_pack"] = (main5["ms"], main5["plain_ms"])
    call_ms["probe_pack"] = None
    bounds["probe_pack"] = (main5["bound_ms"], main5["bound_by"])
    t["hash160_probe"] = (main_f["ms"], fused_plain_ms)
    call_ms["hash160_probe"] = None
    bounds["hash160_probe"] = (main_f["bound_ms"], main_f["bound_by"])

    # --- h: bench at the card's default B ---------------------------------------------
    searched = {k: set(v) for k, v in kernels.WIDTHS.items()}
    kernels.reset_launches()
    t0 = time.monotonic()
    rows = benchlib.bench_rows(dev, B=HASH_N, R=BENCH_R, only=[],
                               emit=lambda line: phase("h", line))
    bench_s = time.monotonic() - t0
    launches_bench = dict(kernels.LAUNCHES)
    if min(launches_bench[k] for k in BENCH_KERNELS) < 1:
        raise AssertionError(f"a kernel of the bench never ran: {launches_bench}")
    for row in rows:
        if not row["share"] <= 1.0:
            raise AssertionError(f"bench row {row['name']} reads {row['share']:.1%}"
                                 f" of its bound: the bound's model is wrong")
    # the K1-K3 rows against the kernels' device times at the rows' width
    # (phase 6's method): rate B / device ms per iteration
    by_name = {r["name"].split(" (")[0]: r for r in rows}
    xb = torch.from_numpy(fel.random_limbs(rng, HASH_N)).to(dev)
    qb = [torch.from_numpy(fel.random_limbs(rng, HASH_N)).to(dev) for _ in range(5)]
    skip_b = torch.zeros(HASH_N, dtype=torch.bool, device=dev)
    d14 = mul.n_windows(mul.W)
    kernel_ms = {
        "addr33": (t["hash160"][0], "one K1 launch"),
        "addr65": (t["hash160_addr65"][0], "one K1 launch"),
        "fe_grpinv": (device_ms(lambda: kernels.inv_mod_batch(xb),
                                "inv_batch_kernel"), "one K2 launch"),
        "ec_gtable_mul": (d14 * device_ms(
            lambda: kernels.proj_add_affine(*qb, skip_b, False),
            "mixed_add_kernel<false>"), f"{d14} K3 launches"),
    }
    checks = {}
    for key, (k_ms, what) in kernel_ms.items():
        row = by_name[key]
        row_ms = row["s_per_iter"] * 1e3
        ratio = k_ms / row_ms
        checks[key] = {"row_ms": row_ms, "kernel_ms": k_ms, "rate_ratio": ratio}
        agree = abs(ratio - 1) <= ROW_TOLERANCE
        phase("h", f"{row['name']}: {row['mits']:.3f} M it/s = {row_ms:.4f} ms "
                   f"per iteration against {what} at {k_ms:.4f} ms on the "
                   f"device (torch.profiler): rate ratio {ratio:.3f}, "
                   + ("within" if agree else "outside")
                   + f" {ROW_TOLERANCE:.0%}"
                   + ("" if agree else f"; the row's loop adds "
                      f"{row_ms - k_ms:.4f} ms per iteration ("
                      + ("the fold of a hash word into a limb row: two "
                         "elementwise kernels" if key.startswith("addr") else
                         f"{d14} table gathers (index_select)"
                         if key == "ec_gtable_mul" else "graph replay")
                      + ")"))
    phase("h", f"bench: {len(rows)} rows at B={HASH_N} R={BENCH_R}, every share "
               f"<= 100% (highest {max(r['share'] for r in rows):.1%}), in "
               f"{bench_s:.1f} s; launches (warm-ups and replays) "
               f"{launches_bench}; card {card}")

    # --- i: bench-gtable sweep ------------------------------------------------------------
    kernels.reset_launches()
    sweep = benchlib.gtable_sweep(dev, ws=list(SWEEP_WS),
                                  emit=lambda line: phase("i", line))
    launches_sweep = dict(kernels.LAUNCHES)
    if [r.get("w") for r in sweep if "build_s" in r] != list(SWEEP_WS):
        raise AssertionError(f"bench-gtable: {sweep}")
    if min(launches_sweep["inv_mod_batch"], launches_sweep["mixed_add"]) < 1:
        raise AssertionError(f"a kernel of bench-gtable never ran: "
                             f"{launches_sweep}")
    phase("i", "bench-gtable: " + "; ".join(
        f"w={r['w']} build {r['build_s']:.3f} s, peak "
        f"{r['peak_mb']:.0f} MiB (torch.cuda.max_memory_allocated), scan "
        f"{r['mul_rate_mkeys']:.3f} M keys/s" for r in sweep)
        + f"; launches {launches_sweep}; card {card}")

    # --- j: mult-verify ---------------------------------------------------------------
    kernels.reset_launches()
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = benchlib.mult_verify(dev)
    verify_s = time.monotonic() - t0
    launches_verify = dict(kernels.LAUNCHES)
    if rc != 0 or "OK: all multiplications verified" not in out.getvalue():
        raise AssertionError(f"mult-verify: rc {rc}, {out.getvalue()[-200:]!r}")
    if min(launches_verify["inv_mod_batch"], launches_verify["mixed_add"]) < 1:
        raise AssertionError(f"a kernel of mult-verify never ran: "
                             f"{launches_verify}")
    bad = mul.build_gtable(mul.W, dev).clone()
    digit = next(int(v) for v in mul.window_digits(
        benchlib.verify_keys(CORRUPT_N), mul.W)[:, 0] if v)
    bad[0, digit - 1] ^= 1                       # one window-0 entry's x
    out_bad = io.StringIO()
    with contextlib.redirect_stdout(out_bad):
        rc_bad = benchlib.mult_verify(dev, count=CORRUPT_N, table=bad)
    if rc_bad != 1 or "FAILED" not in out_bad.getvalue():
        raise AssertionError(f"mult-verify missed a corrupted table entry: "
                             f"rc {rc_bad}")
    failed_line = [ln for ln in out_bad.getvalue().splitlines()
                   if "FAILED" in ln][0].strip()
    phase("j", f"mult-verify: {VERIFY_N:,} scalars at w={mul.W}, window scan (K3) "
               f"== double-and-add (CUDA graph per bit), both on the curve, "
               f"OK in {verify_s:.3f} s (host clock, table build included); "
               f"launches {launches_verify}; with window-0 entry {digit - 1} "
               f"corrupted ({CORRUPT_N} scalars): '{failed_line}', rc "
               f"{rc_bad}; card {card}")

    # --- k: the searches split over [cuda:0] * n in one process -----------------
    for v in kernels.WIDTHS.values():
        v.clear()
    out = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(out):
        run = cli.run_add(cli.Args(["ecloop", "add", "-f", PUZZLES,
                                    "-r", "8000:ffff", "-t", "2"]))
    launches_clamp = dict(kernels.LAUNCHES)
    n_cards = min(2, torch.cuda.device_count())
    if not out.getvalue().startswith(f"devices: {n_cards} ~ "):
        raise AssertionError(f"add -t 2 printed {out.getvalue()[:80]!r}")
    if [f.priv for f in run.found] != [0xC936] or run.k_checked != 0x7FFF:
        raise AssertionError(f"add -t 2: {run.found}, {run.k_checked}")
    phase("k", f"add -t 2 with {torch.cuda.device_count()} card(s): "
               f"'devices: {n_cards}', c936 found, k_checked {run.k_checked:,}")
    split_runs = {}
    for name, n, range_e, endo in SPLITS:
        cfg = split_config(n, range_e, endo)
        eng = add.AddSearch(cfg, puzzles, [dev] * n)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with no_direct_launches(kernels, name):
            found = eng.run_range()
        torch.cuda.synchronize()
        split_runs[name] = {"devices": n, "centers": cfg.centers,
                            "seconds": time.monotonic() - t0,
                            "k_checked": eng.k_checked,
                            "launches": dict(kernels.LAUNCHES)}
        if min(kernels.LAUNCHES[k] for k in ADD_KERNELS) < n:
            raise AssertionError(f"{name}: a shard's kernel never ran: "
                                 f"{kernels.LAUNCHES}")
        fused_only(kernels.LAUNCHES, name)
        privs = {f.priv for f in found}
        if cfg.endo:
            ok = 0xC936 in privs and eng.k_checked == 196_602
        else:
            ok = (privs == NINE_KEYS and len(found) == 9
                  and eng.k_checked == 16_777_216)
        if not ok:
            raise AssertionError(f"{name}: found {sorted(map(hex, privs))}, "
                                 f"k_checked {eng.k_checked}")
    meng = mul.MulSearch(common.SearchConfig(addr33=True, addr65=True),
                         filters.load_filter(BW_HASH), [dev] * 2,
                         batch=2 * MUL_N)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with no_direct_launches(kernels, "mul_sharded"):
        found = meng.run_lines(bw_lines)
    torch.cuda.synchronize()
    split_runs["mul_sharded"] = {"devices": 2, "seconds": time.monotonic() - t0,
                                 "k_checked": meng.k_checked,
                                 "launches": dict(kernels.LAUNCHES)}
    check_vector(found, vector)
    if meng.k_checked != 1080 or min(kernels.LAUNCHES[k]
                                     for k in MUL_KERNELS) < 2:
        raise AssertionError(f"sharded mul: k_checked {meng.k_checked}, "
                             f"launches {kernels.LAUNCHES}")
    fused_only(kernels.LAUNCHES, "mul_sharded")
    a1, a2, a4, m2 = (split_runs[k] for k in (
        "add_one_device", "add_sharded", "add_sharded_endo", "mul_sharded"))
    phase("k", f"AddSearch over [cuda:0] x 2 ({a2['centers']} centers), add -r "
               f"8000:ffffff: 9/9 keys, k_checked {a2['k_checked']:,} in "
               f"{a2['seconds']:.3f} s against {a1['seconds']:.3f} s on "
               f"[cuda:0] ({a1['centers']} centers; ratio "
               f"{a2['seconds'] / a1['seconds']:.2f}; phase 3, through the "
               f"CLI: {add_s:.3f} s); launches "
               f"{a2['launches']}; x 4 ({a4['centers']} centers) with -endo "
               f"over 8000:ffff: c936 found, k_checked {a4['k_checked']:,} in "
               f"{a4['seconds']:.3f} s; MulSearch over [cuda:0] x 2 (batch "
               f"{2 * MUL_N:,}) on btc-bw-priv: 1080 found (540 addr33, 540 "
               f"addr65) in {m2['seconds']:.3f} s; launches {m2['launches']}; "
               f"card {card}")

    # --- l: two processes on the one card, joined over gloo --------------------------
    t0 = time.monotonic()
    procs_out = two_processes(["add", "-f", PUZZLES, "-r", "8000:ffffff",
                               "-t", "1"])
    two_procs_s = time.monotonic() - t0
    sets = [r["found"] for r in procs_out]
    launches_procs = [r["launches"] for r in procs_out]
    for i, r in enumerate(procs_out):
        if r["k_checked"] != 16_777_216:
            raise AssertionError(f"process {i}: k_checked {r['k_checked']}")
        if min(r["launches"][k] for k in ADD_KERNELS) < 1:
            raise AssertionError(f"process {i}: a kernel never ran: "
                                 f"{r['launches']}")
        fused_only(r["launches"], f"process {i}")
    if sets[0] & sets[1] or sets[0] | sets[1] != NINE_KEYS:
        raise AssertionError(f"two processes found {sorted(map(hex, sets[0]))}"
                             f" and {sorted(map(hex, sets[1]))}")
    launches_two = {k: sum(lp[k] for lp in launches_procs)
                    for k in kernels.LAUNCHES}
    phase("l", f"two `add -r 8000:ffffff` processes over gloo on the one "
               f"card: {len(sets[0])} + {len(sets[1])} keys, disjoint, union "
               f"the nine; k_checked 16,777,216 in each; {two_procs_s:.3f} s "
               f"wall for both (start-up included); launches per process "
               f"{launches_procs}; card {card}")

    # --- p: a trace of the whole command (ECLOOP_PROFILE) ---------------------------
    def traced_path(name, argv, kernel_names, stdin=None):
        """argv untraced and traced (traced_pair); fails unless the trace
        holds each of kernel_names inside a graph replay.  Prints and
        keeps the figures; returns the traced run."""
        plain, traced, tr = traced_pair(argv, tmp, stdin)
        for k in kernel_names:
            if traced["launches"][k] < 1 or tr["kernels"][k]["in_replays"] < 1:
                raise AssertionError(f"{name} trace: no {k} event inside a "
                                     f"graph replay: {tr}")
        fused_only(traced["launches"], name)
        if any(tr["kernels"][k]["events"] for k in UNFUSED):
            raise AssertionError(f"{name} trace: K1 or K5 ran alone: {tr}")
        for k in searched:
            searched[k] |= set(traced["widths"][k])
        traces[name] = {
            "untraced": {k: plain[k] for k in ("main_s", "wall_s", "captures")},
            "traced": {k: traced[k] for k in (
                "main_s", "wall_s", "profiler_start_s", "profiler_stop_s",
                "captures", "launches")}, "trace": tr}
        phase("p", f"{name}: stdout, k_checked ({traced['k_checked']:,}), "
                   f"launches and graphs equal traced and untraced; main() "
                   f"{plain['main_s']:.3f} s untraced, {traced['main_s']:.3f} s "
                   f"traced (x {traced['main_s'] / plain['main_s']:.2f}; "
                   f"process wall {plain['wall_s']:.3f} / {traced['wall_s']:.3f}"
                   f" s; profiler start {traced['profiler_start_s']:.3f} s, stop "
                   f"{traced['profiler_stop_s']:.3f} s); trace {tr['mb']:.3f} MB "
                   f"written in {tr['write_s']:.3f} s, {tr['events']:,} events, "
                   f"{tr['device_events']:,} on the card, {tr['graph_launches']}"
                   f" graph launches; per kernel trace events (in replays) "
                   f"against kernels.LAUNCHES: " + ", ".join(
                       f"{k} {v['events']} ({v['in_replays']}) / "
                       f"{traced['launches'][k]}" for k, v in tr["kernels"].items())
                   + f"; other kernels in the replays {tr['other_replay_kernels']}"
                   + "; graph captures (s, launches) untraced "
                   f"{[[round(c[0], 3), c[1]] for c in plain['captures']]}, "
                   f"traced {[[round(c[0], 3), c[1]] for c in traced['captures']]}"
                   f"; card {card}")
        return traced

    traces = {}
    with tempfile.TemporaryDirectory() as tmp:
        run = traced_path(f"add -r {PROFILE_RANGE}",
                          ["add", "-f", PUZZLES, "-r", PROFILE_RANGE],
                          ADD_KERNELS)
        # inside an `add` replay only K2, K4, the fused K1 + K5 and copies
        # run: no plain chord, probe or pack op is left on the card's path
        plain_ops = {k: v for k, v in traces[f"add -r {PROFILE_RANGE}"][
            "trace"]["other_replay_kernels"].items() if "memcpy" not in k.lower()}
        if plain_ops:
            raise AssertionError(f"add trace: kernels other than the port's "
                                 f"inside the graph replays: {plain_ops}")
        found = {int(k, 16) for k in FOUND_LINE.findall(run["stdout"])}
        if found != PROFILE_KEYS:
            raise AssertionError(f"add -r {PROFILE_RANGE} traced: found "
                                 f"{sorted(map(hex, found))}")
        launches_add_traced = run["launches"]
        run = traced_path("mul -a cu", ["mul", "-f", BW_HASH, "-a", "cu"],
                          MUL_KERNELS, BW_PRIV)
        lines = [ln for ln in run["stdout"].splitlines() if ln.startswith("addr")]
        if (len(lines) != 1080 or sum(ln.startswith("addr33") for ln in lines)
                != 540 or {int(ln.rsplit(" ", 1)[1], 16) for ln in lines}
                != vector):
            raise AssertionError(f"mul traced: {len(lines)} found")
        launches_mul_traced = run["launches"]
        blf_path = os.path.join(tmp, "puzzles.blf")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.run_blf_gen(cli.Args(["ecloop", "blf-gen", "-n", "160", "-o",
                                      blf_path]), puzzle_text)
        c936 = golden.addr33(golden.point_mul(0xC936)).hex()
        trace_dir = os.path.join(tmp, "blf-check")
        run = cli_process(["blf-check", "-f", blf_path, c936], trace_dir)
        tr = trace_figures(run, trace_dir)
        if (run["rc"] != 0 or run["stdout"] != f"{c936} FOUND\n"
                or tr["cuda_events"] or run["cuda_initialized"]):
            raise AssertionError(f"blf-check traced: rc {run['rc']}, "
                                 f"{run['stdout']!r}, {tr}, card initialized "
                                 f"{run['cuda_initialized']}")
        traces["blf-check"] = {"traced": {k: run[k] for k in (
            "main_s", "profiler_start_s", "profiler_stop_s")}, "trace": tr}
    phase("p", f"add: puzzles 16-20 found traced; mul: 1080 found (540 + 540) "
               f"traced; blf-check traced: FOUND, rc 0, {tr['events']} events, "
               f"none of the card's, card never initialized, main() "
               f"{run['main_s']:.3f} s (profiler start "
               f"{run['profiler_start_s']:.3f} s, stop "
               f"{run['profiler_stop_s']:.3f} s)")

    # --- m: the profiler after k, l and p; every search width checked ---------------
    k1_after = device_ms(timed["hash160"][0], "hash160_kernel<true>")
    phase("m", f"hash160 at n={HASH_N} after phases k, l and p: kernel "
               f"{k1_after:.4f} ms on the device (torch.profiler; phase 6: "
               f"{t['hash160'][0]:.4f} ms)")
    checked = {"hash160": set(hash_ns), "inv_mod_batch": set(inv_ns),
               "mixed_add": {MUL_N, HASH_N, VERIFY_N},
               "add_chords": set(chord_ns), "probe_pack": set(hash_ns),
               "hash160_probe": set(hash_ns)}
    for name in searched:
        searched[name] |= kernels.WIDTHS[name]
        for r in procs_out:
            searched[name] |= set(r["widths"][name])
        if not searched[name] <= checked[name]:
            raise AssertionError(f"the searches ran {name} at widths "
                                 f"{sorted(searched[name] - checked[name])} "
                                 f"that phases 1, 2, a and 7 did not check")
    phase("m", "every width the searches launched a kernel at (every phase "
               "from 3 through 7, and k, l and p) was held against the plain "
               "version: " + "; ".join(
                   f"{k} {sorted(v)}" for k, v in searched.items()))

    # --- o: a body the card cannot capture fails; the old probe was one --------------
    # (last: a failed capture may leave its stream current)
    x = torch.ones(4, device=dev)

    def first_error(e: BaseException) -> str:
        while e.__context__ is not None:            # the body's own error
            e = e.__context__
        return str(e).splitlines()[0][:160]
    fw, h0 = puzzles.first_words(dev), torch.from_numpy(
        rng.integers(0, 1 << 32, size=HASH_N)).to(dev)
    try:
        graphs.Graph(lambda _: torch.isin(h0, fw), dev)
        isin_err = None
    except RuntimeError as e:
        isin_err = first_error(e)
    try:
        graphs.Graph(lambda _: x.sum().item(), dev)
    except RuntimeError as e:
        sync_err = first_error(e)
    else:
        raise AssertionError("a graph that syncs with the host was captured")
    phase("o", f"capture of a body with a host sync raised: {sync_err!r}; "
               f"torch.isin over {fw.numel()} first words (the compare probe's "
               f"former form): "
               + (f"raised {isin_err!r}" if isin_err else "captured"))

    def entry(name, key, source, replaces, **extra):
        launches = {"add": launches_add[name], "mul": launches_mul[name],
                    "rnd": launches_rnd[name],
                    "add_resume": launches_resume[name],
                    "bench": launches_bench[name],
                    "bench_gtable": launches_sweep[name],
                    "mult_verify": launches_verify[name],
                    "add_t_clamp": launches_clamp[name],
                    **{k: v["launches"][name] for k, v in split_runs.items()},
                    "add_two_processes": launches_two[name],
                    "add_traced": launches_add_traced[name],
                    "mul_traced": launches_mul_traced[name]}
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
              ops_per_key=hops, sass=sass, sass_bound_ms=sass_bound,
              ptxas={k: v for k, v in ptxas.items()
                     if k.startswith("hash160_addr")}),
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
        entry("add_chords", "add_chords", "ecloop_tpu_torch/csrc/add_chords.cu",
              "ecloop_tpu/search/add.py:136 (make_step's chords and endo "
              "synthesis, compiled by XLA around the Pallas kernels)",
              cases=k4_cases,
              ptxas={k: v for k, v in ptxas.items() if "chord" in k}),
        entry("probe_pack", "probe_pack", "ecloop_tpu_torch/csrc/probe_pack.cu",
              "ecloop_tpu/search/add.py:220 (make_step's device_probe and "
              "_pack_mask, compiled by XLA)", cases=k5_cases,
              ptxas={k: v for k, v in ptxas.items()
                     if k.startswith("probe_pack")}),
        entry("hash160_probe", "hash160_probe",
              "ecloop_tpu_torch/csrc/hash160_probe.cu",
              "ecloop_tpu/pallas_kernels.py:156 with ecloop_tpu/search/add.py:"
              "220 (K1's hash with make_step's device_probe and _pack_mask "
              "as its epilogue)", cases=fused_cases,
              ptxas={k: v for k, v in ptxas.items()
                     if k.startswith("hash160_probe")}),
    ], "card": card, "int_ops_per_s": int_ops, "sm_clock_mhz": sm_mhz,
        "sms": sms, "add_keys_per_s": rate, "mul_keys_per_s": mul_rate,
        "mul_batch": MUL_N, "gtable_build_s": gtable_s, "mul_split": split,
        "rnd_split": rnd_split, "add_s": add_s, "split_runs": split_runs,
        "hash160_ms_after_splits": k1_after,
        "profiler_short_windows": SHORT_WINDOWS,
        "searched_widths": {k: sorted(v) for k, v in searched.items()},
        "two_processes_s": two_procs_s, "whole_command_traces": traces,
        "bench_rows": rows, "bench_checks": checks,
        "step_calls": step_calls, "capture_sync_error": sync_err,
        "isin_capture_error": isin_err,
        "gtable_sweep": sweep, "mult_verify": {
            "count": VERIFY_N, "w": mul.W, "seconds": verify_s, "rc": rc,
            "corrupt_rc": rc_bad}, "smoke_s": time.monotonic() - t_start}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
