#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ecloop_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/, holds each against its plain torch
version on the card, drives the `add` search through the CLI's own code
path on the reference's 9-key vector (plus -endo and a bloom filter),
and times the kernels against their plain versions.  Each phase prints
one line; any failure raises.  Before the last line it prints one JSON
object describing the kernels, and the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits with 2
and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PUZZLES = os.path.join(ROOT, "data", "btc-puzzles-hash")
NINE_KEYS = {0xC936, 0x1764F, 0x3080D, 0x5749F, 0xD2C55, 0x1BA534, 0x2DE40F,
             0x556E52, 0xDC2A04}
SEED = 20261016
HASH_N = 131072          # keys per K1 call at the default 32 x 4096 geometry
INV_N = 65568            # K2 batch at that geometry: M*K/2 + M
TIME_WINDOW_S = 1.0


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2

    import numpy as np

    from ecloop_tpu_torch import _build, cli, ecc, fel, hash160, kernels
    from ecloop_tpu_torch import bloom, filters
    from ecloop_tpu_torch.search import common

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
    err = 0
    for n in (INV_N, 1000):
        a = random_limbs(rng, n)
        for i, v in enumerate((0, 1, p - 1)):
            a[:, i] = fel.int_to_limbs(v)
        a[:, 100:164] = 0
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
    phase("2", f"K2 inv_mod_batch == plain at {INV_N} and 1000 elements "
               f"(0, 1, p-1, a run of zeros), max abs err {err} (tolerance "
               f"0); 64 spot checks == pow(x, p-2, p)")

    # --- 3: the main path ---------------------------------------------------------
    kernels.reset_launches()
    run = cli.run_add(cli.Args(["ecloop", "add", "-f", PUZZLES,
                                "-r", "8000:ffffff"]))
    launches = dict(kernels.LAUNCHES)
    privs = {f.priv for f in run.found}
    if run.device.type != "cuda":
        raise AssertionError(f"main path ran on {run.device}")
    if privs != NINE_KEYS or len(run.found) != 9:
        raise AssertionError(f"found {sorted(map(hex, privs))}")
    if run.k_checked != 16_777_216:
        raise AssertionError(f"k_checked {run.k_checked}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    rate = run.k_checked / run.seconds
    phase("3", f"add -r 8000:ffffff: 9/9 keys, k_checked {run.k_checked:,} "
               f"in {run.seconds:.3f} s = {rate:,.0f} keys/s; launches "
               f"{launches}; card {card}")

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

    # --- 6: timing ----------------------------------------------------------------
    x = torch.from_numpy(random_limbs(rng, HASH_N)).to(dev)
    y = torch.from_numpy(random_limbs(rng, HASH_N)).to(dev)
    xi = torch.from_numpy(random_limbs(rng, INV_N)).to(dev)
    t = {}
    t["hash160"] = paired_ms(lambda: kernels.addr33_hash_rows(x, y),
                             lambda: hash160.addr33_hash_rows(x, y))
    t["hash160_addr65"] = paired_ms(lambda: kernels.addr65_hash_rows(x, y),
                                    lambda: hash160.addr65_hash_rows(x, y))
    t["inv_mod_batch"] = paired_ms(lambda: kernels.inv_mod_batch(xi),
                                   lambda: fel.inv_mod_batch(xi))
    for name, (k_ms, p_ms) in t.items():
        n = INV_N if name == "inv_mod_batch" else HASH_N
        phase("6", f"{name} at n={n}: kernel {k_ms:.4f} ms, plain "
                   f"{p_ms:.4f} ms (CUDA events, windows >= "
                   f"{TIME_WINDOW_S} s; card {card})")

    report = {"kernels": [
        {"name": "hash160", "route": "cuda",
         "source": "ecloop_tpu_torch/csrc/hash160.cu",
         "replaces": "ecloop_tpu/pallas_kernels.py:156",
         "launches": launches["hash160"], "max_abs_err": errs["hash160"],
         "ms": t["hash160"][0], "plain_ms": t["hash160"][1],
         "ms_addr65": t["hash160_addr65"][0],
         "plain_ms_addr65": t["hash160_addr65"][1]},
        {"name": "inv_mod_batch", "route": "cuda",
         "source": "ecloop_tpu_torch/csrc/inv_batch.cu",
         "replaces": "ecloop_tpu/pallas_kernels.py:78",
         "launches": launches["inv_mod_batch"],
         "max_abs_err": errs["inv_mod_batch"],
         "ms": t["inv_mod_batch"][0], "plain_ms": t["inv_mod_batch"][1]},
    ], "card": card, "main_path_keys_per_s": rate}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
