"""Command-line interface of the port: `python -m ecloop_tpu_torch add`.

Keeps the reference's flags and output (`-f -o -a -r -d -q -endo`; found
keys as `label: hash <- priv` on stdout and TSV in the `-o` file) and
reuses the JAX package's jax-free host helpers (argument parsing, range
checks, status line, 'p'/'r' pause).  `-device cuda|cpu` picks the
device, `cuda` by default; without a GPU that is an error, never a quiet
run on the CPU.  The other commands of the JAX package are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import locale
import os
import signal
import sys
import time

import torch

from ecloop_tpu.cli import Args, Status, TtyListener, parse_range

from . import __version__

USAGE = """\
ecloop-tpu-torch v{version} ~ secp256k1 key search on PyTorch + CUDA
Usage: {name} add -f <file> [-r <range>] [options]

  add             - walk a contiguous key range by batched point addition

Options:
  -f <file>       - targets: hex hash160 list, or a .blf bloom filter
  -o <file>       - append found keys to this file (TSV; default: stdout only)
  -a <addr_type>  - pubkey form(s) to hash: c = compressed, u = uncompressed
  -r <start:end>  - hex key range to cover, e.g. 8000:ffff (default: whole curve)
  -d <offs:size>  - which bit window the search enumerates, e.g. 128:32
  -q              - suppress stdout hits (requires -o)
  -endo           - also test the 5 GLV-endomorphism images of every point (6x)
  -device <dev>   - cuda (default) or cpu

Batch geometry: ECLOOP_CENTERS, ECLOOP_GROUP_K, ECLOOP_STEPS_PER_CALL.
"""

NOT_PORTED = ("mul", "rnd", "blf-gen", "blf-check", "bench", "bench-gtable",
              "mult-verify")


def _die(msg: str):
    print(msg, file=sys.stderr)
    raise SystemExit(1)


def select_device(args: Args) -> torch.device:
    name = args.get_str("-device") or "cuda"
    if name not in ("cuda", "cpu"):
        _die(f"unknown device: {name} (use -device cuda or -device cpu)")
    if name == "cuda" and not torch.cuda.is_available():
        _die("no CUDA device available; pass -device cpu to run on the CPU")
    return torch.device(name)


def parse_offs_size(args: Args, range_e: int) -> tuple[int, int]:
    """-d offs:size for add (load_offs_size, main.c:703-746)."""
    from .search.common import default_offs_size

    raw = args.get_str("-d")
    offs = size = None
    if raw is not None:
        if ":" not in raw:
            _die("invalid offset:size format, use format: -d 128:32")
        o_raw, s_raw = raw.split(":", 1)
        try:
            offs = int(o_raw or "0")
            size = int(s_raw or "0")
        except ValueError:
            _die("invalid offset:size format, use format: -d 128:32")
    try:
        return default_offs_size(range_e, offs, size, None, is_rnd=False)
    except ValueError as e:
        _die(str(e))


def search_config(args: Args):
    """Filter, SearchConfig and Status from the command line, with the
    reference's startup echo."""
    from . import filters
    from .search.common import SearchConfig

    path = args.get_str("-f")
    if not path:
        _die("missing filter file (-f)")
    if not os.path.exists(path):
        _die(f"failed to open filter file: {path}")
    filt = filters.load_filter(path)

    quiet = args.get_bool("-q")
    outfile = args.get_str("-o")
    if outfile is None and quiet:
        _die("quiet mode chosen without output file")

    addr = args.get_str("-a") or ""
    addr33 = "c" in addr
    addr65 = "u" in addr
    if not addr33 and not addr65:
        addr33 = True
    endo = args.get_bool("-endo")

    range_s, range_e = parse_range(args)
    offs, _size = parse_offs_size(args, range_e)
    cfg = SearchConfig(range_s=range_s, range_e=range_e, stride_offs=offs,
                       addr33=addr33, addr65=addr65, endo=endo)
    cfg.centers = int(os.environ.get("ECLOOP_CENTERS", cfg.centers))
    cfg.group_k = int(os.environ.get("ECLOOP_GROUP_K", cfg.group_k))
    cfg.steps_per_call = int(os.environ.get("ECLOOP_STEPS_PER_CALL",
                                            cfg.steps_per_call))

    status = Status(quiet, outfile, use_color=sys.stdout.isatty())
    filt_desc = (f"list ({filt.count:,})" if filt.mode == "list"
                 else "bloom")
    print(f"devices: 1 ~ addr33: {int(addr33)} ~ addr65: {int(addr65)} "
          f"~ endo: {int(endo)} | filter: {filt_desc}")
    print(f"range_s: {range_s:064x}")
    print(f"range_e: {range_e:064x}")
    print("-" * 40)
    return cfg, filt, status


@dataclasses.dataclass
class AddRun:
    found: list
    k_checked: int
    seconds: float                   # host clock around the search
    device: torch.device


def run_add(args: Args) -> AddRun:
    """The `add` command: search the range, report finds, return them
    with the claim-based key count."""
    from .search.add import AddSearch

    device = select_device(args)
    cfg, filt, status = search_config(args)
    eng = AddSearch(cfg, filt, device)
    mult = 6 if cfg.endo else 1

    def on_step(done_keys):
        # clamp to the claim-based counter: the step-rounded count would
        # overshoot it on a range that is not GROUP-aligned
        status.update(min(done_keys * mult, eng.k_checked) - status.k_checked)

    found = []

    def on_found(f):
        found.append(f)
        status.write_found(f)

    tty = TtyListener(status)
    prev = signal.getsignal(signal.SIGINT)

    def on_sigint(sig, frame):
        tty.cleanup()
        print()
        raise SystemExit(sig)

    signal.signal(signal.SIGINT, on_sigint)
    tty.start()
    try:
        t0 = time.monotonic()
        eng.run_range(on_found=on_found, on_step=on_step)
        seconds = time.monotonic() - t0
        status.finish()
    finally:
        tty.cleanup()
        signal.signal(signal.SIGINT, prev)
    return AddRun(found=found, k_checked=eng.k_checked, seconds=seconds,
                  device=device)


def main(argv: list[str] | None = None) -> int:
    locale.setlocale(locale.LC_ALL, "")
    argv = list(sys.argv if argv is None else argv)
    args = Args(argv)
    cmd = argv[1] if len(argv) > 1 else None
    if cmd == "add":
        run_add(args)
        return 0
    if cmd in NOT_PORTED:
        print(f"{cmd}: not yet ported to ecloop_tpu_torch "
              f"(use python -m ecloop_tpu {cmd})", file=sys.stderr)
        return 1
    if args.get_bool("-v"):
        print(f"ecloop-tpu-torch v{__version__}")
        return 0
    print(USAGE.format(name=os.path.basename(argv[0] or "ecloop"),
                       version=__version__))
    return 0
