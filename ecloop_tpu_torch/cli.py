"""Command-line interface of the port: `python -m ecloop_tpu_torch add|mul`.

Keeps the reference's flags and output (`-f -o -a -r -d -q -endo -raw`;
found keys as `label: hash <- priv` on stdout and TSV in the `-o` file;
the throttled status line on stderr; 'p'/'r' pause on a terminal).
`-device cuda|cpu` picks the device, `cuda` by default; without a GPU
that is an error, never a quiet run on the CPU.  The other commands of
the JAX package are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import locale
import os
import select
import signal
import sys
import termios
import threading
import time

import torch

from . import __version__, golden

GROUP_INV_SIZE = 2048             # reference GROUP_INV_SIZE: lowest range start

USAGE = """\
ecloop-tpu-torch v{version} ~ secp256k1 key search on PyTorch + CUDA
Usage: {name} <cmd> -f <file> [options]

  add             - walk a contiguous key range by batched point addition
  mul             - multiply private keys read from stdin (windowed gtable)

Options:
  -f <file>       - targets: hex hash160 list, or a .blf bloom filter
  -o <file>       - append found keys to this file (TSV; default: stdout only)
  -a <addr_type>  - pubkey form(s) to hash: c = compressed, u = uncompressed
  -r <start:end>  - hex key range to cover, e.g. 8000:ffff (default: whole curve)
  -d <offs:size>  - which bit window the search enumerates, e.g. 128:32
  -q              - suppress stdout hits (requires -o)
  -endo           - add: also test the 5 GLV-endomorphism images of every point (6x)
  -raw            - mul: private key = SHA-256 of each input line
  -device <dev>   - cuda (default) or cpu

Batch geometry: ECLOOP_CENTERS, ECLOOP_GROUP_K, ECLOOP_STEPS_PER_CALL (add),
ECLOOP_MUL_BATCH (mul).
"""

NOT_PORTED = ("rnd", "blf-gen", "blf-check", "bench", "bench-gtable",
              "mult-verify")


# --- arguments (reference args_bool / arg_str) ----------------------------------

class Args:
    def __init__(self, argv: list[str]):
        self.argv = argv

    def get_bool(self, name: str) -> bool:
        return name in self.argv

    def get_str(self, name: str):
        for i, a in enumerate(self.argv[:-1]):
            if a == name:
                return self.argv[i + 1]
        return None


def _die(msg: str):
    print(msg, file=sys.stderr)
    raise SystemExit(1)


def parse_range(args: Args) -> tuple[int, int]:
    """-r hex:hex with the reference's bounds checks."""
    raw = args.get_str("-r")
    if raw is None:
        return GROUP_INV_SIZE, golden.P
    if ":" not in raw:
        _die("invalid search range, use format: -r 8000:ffff")
    s_raw, e_raw = raw.split(":", 1)
    try:
        range_s = int(s_raw, 16) % golden.N if s_raw else 0
        range_e = int(e_raw, 16) % golden.N if e_raw else 0
    except ValueError:
        _die("invalid search range, use format: -r 8000:ffff")
    if range_s <= GROUP_INV_SIZE:
        _die(f"invalid search range, start <= {GROUP_INV_SIZE:#x}")
    if range_e > golden.P:
        _die("invalid search range, end > FE_P")
    if range_s >= range_e:
        _die("invalid search range, start >= end")
    return range_s, range_e


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


# --- status and output (the reference's ctx_t) ------------------------------------

def _fmt_n(n: int) -> str:
    """Thousands separators, as the reference's %'zu."""
    return f"{n:,}"


class Status:
    """Progress counters, the throttled stderr status line and the found
    keys' output (stdout and the -o file)."""

    def __init__(self, quiet: bool, outfile: str | None, use_color: bool):
        self.lock = threading.Lock()
        self.quiet = quiet
        self.out = open(outfile, "a") if outfile else None
        self.use_color = use_color
        self.k_checked = 0
        self.k_found = 0
        self.ts_started = time.monotonic()
        self.ts_printed = self.ts_started - 5.0
        self.paused = False
        self.paused_time = 0.0
        self._ts_paused_at = 0.0
        self.finished = False

    def _print_unlocked(self):
        if self.finished:
            msg = ""
        else:
            msg = " ('r' - resume)" if self.paused else " ('p' - pause)"
        dt = max(1e-3,
                 time.monotonic() - self.ts_started - self.paused_time)
        it = self.k_checked / dt / 1e6
        end = "\n" if self.finished else "\r"
        sys.stderr.write("\033[2K\r")
        sys.stderr.write(f"{dt:.2f}s ~ {it:.2f} Mkeys/s ~ "
                         f"{_fmt_n(self.k_found)} / {_fmt_n(self.k_checked)}"
                         f"{msg}{end}")
        sys.stderr.flush()

    def update(self, k_checked: int):
        with self.lock:
            self.k_checked += k_checked
            now = time.monotonic()
            if now - self.ts_printed >= 0.1:
                self.ts_printed = now
                self._print_unlocked()
        while self.paused:
            time.sleep(0.1)

    def pause(self):
        with self.lock:
            if not self.paused:
                self._ts_paused_at = time.monotonic()
                self.paused = True
                self._print_unlocked()

    def resume(self):
        with self.lock:
            if self.paused:
                self.paused_time += time.monotonic() - self._ts_paused_at
                self.paused = False
                self._print_unlocked()

    def write_found(self, found):
        """One found key: stdout unless -q, a TSV line in the -o file."""
        with self.lock:
            if not self.quiet:
                sys.stderr.write("\033[2K\r")
                sys.stderr.flush()
                print(found.line(), flush=True)
            if self.out is not None:
                self.out.write(found.tsv() + "\n")
                self.out.flush()
            self.k_found += 1
            self._print_unlocked()

    def finish(self):
        with self.lock:
            self.finished = True
            self._print_unlocked()
            if self.out is not None:
                self.out.close()
                self.out = None


class TtyListener:
    """Raw-mode 'p'/'r' pause/resume listener on the controlling
    terminal; does nothing where there is none."""

    def __init__(self, status: Status):
        self.status = status
        self._stop = False
        self._saved = None
        self._fd = None
        self._thread = None

    def start(self):
        try:
            self._fd = os.open("/dev/tty", os.O_RDONLY)
            self._saved = termios.tcgetattr(self._fd)
        except (OSError, termios.error):
            return
        mode = termios.tcgetattr(self._fd)
        mode[3] &= ~(termios.ICANON | termios.ECHO)
        termios.tcsetattr(self._fd, termios.TCSANOW, mode)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            r, _, _ = select.select([self._fd], [], [], 0.2)
            if not r:
                continue
            ch = os.read(self._fd, 1)
            if ch == b"p":
                self.status.pause()
            elif ch == b"r":
                self.status.resume()

    def cleanup(self):
        self._stop = True
        if self._saved is not None:
            termios.tcsetattr(self._fd, termios.TCSANOW, self._saved)
            os.close(self._fd)


@contextlib.contextmanager
def _interactive(status: Status):
    """The 'p'/'r' listener and a SIGINT that restores the terminal, for
    the length of a search."""
    tty = TtyListener(status)
    prev = signal.getsignal(signal.SIGINT)

    def on_sigint(sig, frame):
        tty.cleanup()
        print()
        raise SystemExit(sig)

    signal.signal(signal.SIGINT, on_sigint)
    tty.start()
    try:
        yield
    finally:
        tty.cleanup()
        signal.signal(signal.SIGINT, prev)


# --- commands ------------------------------------------------------------------

def select_device(args: Args) -> torch.device:
    name = args.get_str("-device") or "cuda"
    if name not in ("cuda", "cpu"):
        _die(f"unknown device: {name} (use -device cuda or -device cpu)")
    if name == "cuda" and not torch.cuda.is_available():
        _die("no CUDA device available; pass -device cpu to run on the CPU")
    return torch.device(name)


def search_config(args: Args, cmd: str):
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
    endo = args.get_bool("-endo") and cmd == "add"   # no endo for mul

    range_s, range_e = parse_range(args)
    offs, _size = parse_offs_size(args, range_e)
    cfg = SearchConfig(range_s=range_s, range_e=range_e, stride_offs=offs,
                       addr33=addr33, addr65=addr65, endo=endo)
    cfg.centers = int(os.environ.get("ECLOOP_CENTERS", cfg.centers))
    cfg.group_k = int(os.environ.get("ECLOOP_GROUP_K", cfg.group_k))
    cfg.steps_per_call = int(os.environ.get("ECLOOP_STEPS_PER_CALL",
                                            cfg.steps_per_call))

    status = Status(quiet, outfile, use_color=sys.stdout.isatty())
    filt_desc = (f"list ({_fmt_n(filt.count)})" if filt.mode == "list"
                 else "bloom")
    print(f"devices: 1 ~ addr33: {int(addr33)} ~ addr65: {int(addr65)} "
          f"~ endo: {int(endo)} | filter: {filt_desc}")
    if cmd == "add":
        print(f"range_s: {range_s:064x}")
        print(f"range_e: {range_e:064x}")
    print("-" * 40)
    return cfg, filt, status


@dataclasses.dataclass
class SearchRun:
    found: list
    k_checked: int
    seconds: float                   # host clock around the search
    device: torch.device


def run_add(args: Args) -> SearchRun:
    """The `add` command: search the range, report finds, return them
    with the claim-based key count."""
    from .search.add import AddSearch

    device = select_device(args)
    cfg, filt, status = search_config(args, "add")
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

    with _interactive(status):
        t0 = time.monotonic()
        eng.run_range(on_found=on_found, on_step=on_step)
        seconds = time.monotonic() - t0
        status.finish()
    return SearchRun(found=found, k_checked=eng.k_checked, seconds=seconds,
                     device=device)


def run_mul(args: Args, lines) -> SearchRun:
    """The `mul` command over an iterable of key lines (stdin): jobs of
    ECLOOP_MUL_BATCH keys (32,768 on the GPU, 2,048 on the CPU) stay
    queued on the device while the next lines are read; the status line
    counts drained keys."""
    from .search import mul

    device = select_device(args)
    cfg, filt, status = search_config(args, "mul")
    batch = os.environ.get("ECLOOP_MUL_BATCH",
                           "32768" if device.type == "cuda" else "2048")
    if not batch.isdigit() or int(batch) < 32 or int(batch) % 32:
        _die(f"ECLOOP_MUL_BATCH={batch}: must be a positive multiple of 32")
    eng = mul.MulSearch(cfg, filt, device, w=mul.W, batch=int(batch),
                        raw=args.get_bool("-raw"))
    found = []

    def on_found(f):
        found.append(f)
        status.write_found(f)

    with _interactive(status):
        t0 = time.monotonic()
        chunk = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            chunk.append(line)
            if len(chunk) >= eng.batch:
                eng.run_lines(chunk, on_found=on_found, drain=False)
                status.update(eng.k_checked - status.k_checked)
                chunk = []
        if chunk:
            eng.run_lines(chunk, on_found=on_found, drain=False)
        eng.flush()
        seconds = time.monotonic() - t0
        status.update(eng.k_checked - status.k_checked)
        status.finish()
    return SearchRun(found=found, k_checked=eng.k_checked, seconds=seconds,
                     device=device)


def main(argv: list[str] | None = None) -> int:
    locale.setlocale(locale.LC_ALL, "")
    argv = list(sys.argv if argv is None else argv)
    args = Args(argv)
    cmd = argv[1] if len(argv) > 1 else None
    if cmd == "add":
        run_add(args)
        return 0
    if cmd == "mul":
        run_mul(args, sys.stdin)
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
