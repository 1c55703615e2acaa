"""The judge's readings on the card at a cell's own size, several seeds in
one process: sound runs (the lower readings) and runs with the control
or a fault of faults.py in the program's place (the upper readings).
Benchmark runs never run this.

    python3 keybench/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--fault skip_confirm]

One JSON line per seed on standard output: the seed, `correct` and the
judge's numbers.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args()
    for k in [k for k in os.environ if k.startswith("ECLOOP_")]:
        del os.environ[k]

    import torch

    from keybench import faults, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    fault = faults.FAULTS[args.fault] if args.fault else None
    spec = harness.load_spec(ROOT)
    c = harness.cell(spec, args.workload, ROOT)
    devices = [torch.device("cuda", i) for i in range(c.workload["chips"])]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(c, seed, args.seconds, False, devices,
                             time.perf_counter(), fault=fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "metrics": {k: v["value"]
                                      for k, v in r["metrics"].items()},
                          "checks": {k: v["value"]
                                     for k, v in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
