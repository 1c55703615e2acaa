"""Run one cell of the benchmark of the PyTorch/CUDA port once, from the
root of a checkout:

    python3 keybench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers the
judge compared, each beside its limit, are the last lines of standard
error.  Without a CUDA device, or with fewer than the cell asks for, it
exits 2 and prints no result; it never runs on the CPU.  It exits 3 if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _power_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    # the CLI's defaults are what users run: no geometry or probe override
    for k in [k for k in os.environ if k.startswith("ECLOOP_")]:
        del os.environ[k]

    from keybench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.cell(spec, args.workload, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.workload["chips"]:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{cell.workload['chips']}", file=sys.stderr)
        return 2
    print(f"card: {_power_line()}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda:0"), T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded what the benchmark must not: {loaded}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
