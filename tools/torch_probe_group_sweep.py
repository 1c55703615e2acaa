#!/usr/bin/env python3
"""K5 (ecloop_tpu_torch/csrc/probe_pack.cu) and the fused hash and probe
(csrc/hash160_probe.cu) with their probe loads issued one at a time and
in groups of 2 and of 4 (csrc/probe.cuh's kGroup), side by side on one
GPU, in every exact and pow2 case of chip_smoke.py's phase 7.

    python3 tools/torch_probe_group_sweep.py

Builds the kernel library once per group size with -DECL_PROBE_GROUP
(_build.build's flags) and runs the package's own wrappers on each
(kernels.probe_pack; kernels.hash160_probe over one addr33 plane): both
are held against their plain forms bit for bit, then timed with
torch.profiler (chip_smoke.device_ms) in turns: 1, 2, 4, 4, 2, 1.
Prints ptxas's registers per build, one line per case, the card's name
and power limit, and a JSON object last.  Exits 2 without a CUDA device.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (the repo root's; standard library only)

GROUPS = (1, 2, 4)
NS = (131072, 2097152)
CASES = [c for c in chip_smoke.PROBE_CASES if c[0] != "compare"]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    from ecloop_tpu_torch import _build, fel, filters, hash160, kernels, sol

    dev = torch.device("cuda", 0)
    card = sol.smi("name,power.limit")
    print(card, flush=True)
    libs = {}
    for g in GROUPS:
        flags = (f"-DECL_PROBE_GROUP={g}",)
        libs[g] = _build.load(_build.build(flags))
        regs = {k: v.split(";")[0] for k, v in chip_smoke.ptxas_report(
            _build.log_path(flags)).items() if "probe" in k}
        print(f"group {g}: ptxas {regs}", flush=True)
    rng = np.random.default_rng(chip_smoke.SEED)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    inputs = {}
    for n in NS:
        x, y = (torch.from_numpy(fel.random_limbs(rng, n)).to(dev)
                for _ in range(2))
        inputs[n] = (torch.randint(0, 1 << 32, (5, n), dtype=torch.int64,
                                   device=dev, generator=gen),
                     x, y, hash160.addr33_hash_rows(x, y))
    planes = [(0, 0, True)]
    rows = {}
    for mode, arg in CASES:
        filt, bits, fw = chip_smoke.probe_case(mode, arg, dev, chip_smoke.SEED)
        if mode == "blf":
            for h, _x, _y, hx in inputs.values():
                chip_smoke.plant_members(filt, bits, h[:, :32])
                chip_smoke.plant_members(filt, bits, hx[:, :32])
        for n, (h, x, y, hx) in inputs.items():
            out = torch.empty((1, n // 32), dtype=torch.int64, device=dev)
            calls = {
                "probe_pack": lambda: kernels.probe_pack(filt, h, bits, fw),
                "hash160_probe": lambda: kernels.hash160_probe(
                    filt, (x,), (y,), planes, bits, fw, out)}
            want = {"probe_pack": filters.probe_pack_plain(filt, h, bits, fw),
                    "hash160_probe": filters.probe_pack_plain(filt, hx, bits,
                                                              fw)[None]}
            ms = {(k, g): [] for k in calls for g in GROUPS}
            for g in GROUPS + GROUPS[::-1]:
                _build._lib = libs[g]
                for k, call in calls.items():
                    got = call()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want[k]):
                        raise AssertionError(f"{k}, group {g}, differs from "
                                             f"its plain form at {n} keys, "
                                             f"{mode} {arg}")
                    ms[k, g].append(chip_smoke.device_ms(call, k + "_kernel"))
            row = {"n": n, "mode": mode, "arg": arg,
                   "probes": filt.blf_probes if filt.mode == "bloom" else 2,
                   "reads": sol.probe_reads(filt, h, bits, fw),
                   **{f"{k}_ms_g{g}": float(np.mean(v))
                      for (k, g), v in ms.items()}}
            rows[f"{n}_{mode}_{arg}"] = row
            print(f"{n} keys, {mode} {arg} ({row['probes']} probes, "
                  f"{row['reads']} bit words needed); K5 / fused ms by group: "
                  + ", ".join(f"{g}: {row[f'probe_pack_ms_g{g}']:.4f} / "
                              f"{row[f'hash160_probe_ms_g{g}']:.4f}"
                              for g in GROUPS)
                  + f" (torch.profiler, mean of 2 x 20 launches); card {card}",
                  flush=True)
        del bits
    _build._lib = None
    print(json.dumps({"card": card, "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
