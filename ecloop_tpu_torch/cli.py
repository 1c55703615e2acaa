"""Command-line interface of the port: `python -m ecloop_tpu_torch
add|mul|rnd|blf-gen|blf-check|bench|bench-gtable|mult-verify`.

Keeps the reference's flags and output (`-f -o -a -r -d -q -endo -raw
-seed -c -n`; found keys as `label: hash <- priv` on stdout and TSV in
the `-o` file; the throttled status line on stderr; 'p'/'r' pause on a
terminal).  `-device cuda|cpu` picks the device of the searches and of
`bench`, `bench-gtable` and `mult-verify`, `cuda` by default; without a
GPU that is an error, never a quiet run on the CPU.  The searches run
over every visible GPU, or `-t n` of them (with `-device cpu`, over n
CPU shards), and over several processes when ECLOOP_COORDINATOR,
ECLOOP_NUM_PROCS and ECLOOP_PROC_ID say so (`parallel.multihost`).
`blf-gen` and `blf-check` run on the host.  ECLOOP_PROFILE=<dir> writes
a torch.profiler trace of the whole command there (`whole_command_trace`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import locale
import os
import select
import signal
import socket
import sys
import termios
import threading
import time

import torch

from . import __version__, golden
from .parallel import multihost

GROUP_INV_SIZE = 2048             # reference GROUP_INV_SIZE: lowest range start
# the commands that run on the -device device; blf-gen and blf-check
# (and the usage text) run on the host
DEVICE_COMMANDS = ("add", "mul", "rnd", "bench", "bench-gtable", "mult-verify")

USAGE = """\
ecloop-tpu-torch v{version} ~ secp256k1 key search on PyTorch + CUDA
Usage: {name} <cmd> -f <file> [options]

  add             - walk a contiguous key range by batched point addition
  mul             - multiply private keys read from stdin (windowed gtable)
  rnd             - repeatedly search random bit-window slices of a range
  blf-gen         - build/extend a .blf bloom filter from hash160 lines on stdin
                    (-n <count> -o <file.blf>)
  blf-check       - query a .blf filter (-f) for the hash160 values given
                    as arguments or on stdin
  bench           - per-kernel device throughput microbenchmarks
  bench-gtable    - sweep gtable window widths: build time / memory / mul rate
  mult-verify     - prove the two scalar-mul paths agree on random scalars

Options:
  -f <file>       - targets: hex hash160 list, or a .blf bloom filter
  -o <file>       - append found keys to this file (TSV; default: stdout only)
  -a <addr_type>  - pubkey form(s) to hash: c = compressed, u = uncompressed
  -r <start:end>  - hex key range to cover, e.g. 8000:ffff (default: whole curve)
  -d <offs:size>  - which bit window the search enumerates, e.g. 128:32
  -q              - suppress stdout hits (requires -o)
  -endo           - add, rnd: also test the 5 GLV-endomorphism images of every point (6x)
  -raw            - mul: private key = SHA-256 of each input line
  -seed <str>     - rnd: seed the draws of the sub-ranges (repeatable runs)
  -c <file>       - add, rnd: cursor checkpoint; resume an interrupted run
  -t <n>          - add, mul, rnd: devices to use (default: every GPU)
  -device <dev>   - cuda (default) or cpu

Batch geometry, per device: ECLOOP_CENTERS, ECLOOP_GROUP_K,
ECLOOP_STEPS_PER_CALL (add, rnd), ECLOOP_MUL_BATCH (mul).  bench:
ECLOOP_BENCH_B, _R, _ONLY, _SOL, _VERBOSE;
bench-gtable: ECLOOP_GTABLE_WS, ECLOOP_BENCH_B; mult-verify:
ECLOOP_VERIFY_N, ECLOOP_VERIFY_W.  Several processes (add, rnd -seed):
ECLOOP_COORDINATOR=host:port ECLOOP_NUM_PROCS=P ECLOOP_PROC_ID=i.
ECLOOP_MUL_INFLIGHT (mul jobs queued, 4), ECLOOP_BLF_PROBES (device
probes of a .blf, 1-20), ECLOOP_NATIVE_BUILD=0 (do not compile the host
library), ECLOOP_PROFILE=<dir> (a trace of the whole command).
"""


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

    def get_uint(self, name: str, default: int) -> int:
        v = self.get_str(name)
        if v is None:
            return default
        try:
            return int(v)
        except ValueError:
            return default


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


def parse_offs_size(args: Args, range_e: int, cmd: str,
                    rng) -> tuple[int, int]:
    """-d offs:size (load_offs_size, main.c:703-746); `rnd` without -d
    draws its offset from `rng`."""
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
        return default_offs_size(range_e, offs, size, rng,
                                 is_rnd=(cmd == "rnd"))
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


def select_devices(args: Args) -> list[torch.device]:
    """This process's devices: `-t n` of the visible GPUs, at least one
    and at most all of them, or all without -t; with `-device cpu`,
    max(n, 1) CPU shards."""
    from .parallel.mesh import make_devices

    t = args.get_uint("-t", 0)
    if select_device(args).type == "cpu":
        return [torch.device("cpu")] * max(t, 1)
    gpus = make_devices()
    return gpus[:min(max(t, 1), len(gpus))] if t else gpus


def search_devices(args: Args):
    """(devices, owned): the search's global device list and the shards
    this process runs (None: all of them, in a single process)."""
    local = select_devices(args)
    if multihost.process_count() == 1:
        return local, None
    return multihost.global_devices(local)


def search_config(args: Args, cmd: str, n_devices: int = 1):
    """Filter, SearchConfig, Status and the -d (offs, size) from the
    command line, with the reference's startup echo; `rnd` without -d
    draws its offset from the -seed Rng.  Over n devices `add` and `rnd`
    step n times the centers (ECLOOP_CENTERS is per device), as `mul`'s
    job is n times its batch, so each device runs the one-device
    geometry."""
    from . import filters
    from .search.common import SearchConfig
    from .search.rnd import Rng

    rng = Rng(args.get_str("-seed"))

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
    endo = args.get_bool("-endo") and cmd != "mul"   # no endo for mul

    range_s, range_e = parse_range(args)
    offs, size = parse_offs_size(args, range_e, cmd, rng)
    cfg = SearchConfig(range_s=range_s, range_e=range_e, stride_offs=offs,
                       addr33=addr33, addr65=addr65, endo=endo)
    cfg.centers = int(os.environ.get("ECLOOP_CENTERS", cfg.centers))
    cfg.group_k = int(os.environ.get("ECLOOP_GROUP_K", cfg.group_k))
    cfg.steps_per_call = int(os.environ.get("ECLOOP_STEPS_PER_CALL",
                                            cfg.steps_per_call))
    if cmd != "mul":
        cfg.centers *= n_devices

    status = Status(quiet, outfile, use_color=sys.stdout.isatty())
    filt_desc = (f"list ({_fmt_n(filt.count)})" if filt.mode == "list"
                 else "bloom")
    print(f"devices: {n_devices} ~ addr33: {int(addr33)} ~ addr65: "
          f"{int(addr65)} ~ endo: {int(endo)} | filter: {filt_desc}")
    if cmd == "add":
        print(f"range_s: {range_s:064x}")
        print(f"range_e: {range_e:064x}")
    print("-" * 40)
    return cfg, filt, status, (offs, size)


def open_checkpoint(args: Args, cmd: str, cfg, seed: str | None = None):
    """(ckpt, position, k_checked, k_found): the -c checkpoint of this
    search and the state to resume from (the cursor of `add`, the
    finished iterations of `rnd`), agreed by every process of the run;
    (None, 0, 0, 0) without -c.  A file that does not load, or belongs
    to another search, is an error, in every process of the run."""
    from . import checkpoint

    path = args.get_str("-c")
    if not path:
        return None, 0, 0, 0
    key = checkpoint.config_key_for(cmd, cfg, args.get_str("-f"), seed=seed)
    ckpt, state, error = None, (0, 0, 0), None
    try:
        ckpt = checkpoint.Checkpoint(checkpoint.process_local_path(path), key)
        if ckpt.try_resume():
            state = (int(ckpt.cursor or 0) if cmd == "add" else ckpt.iters,
                     ckpt.k_checked, ckpt.k_found)
    except Exception as e:        # still reach the gather, or peers wait
        error = str(e) or type(e).__name__
    try:
        return (ckpt, *checkpoint.reconcile_multihost(*state, error=error))
    except ValueError as e:
        _die(str(e))


@dataclasses.dataclass
class SearchRun:
    found: list
    k_checked: int
    seconds: float                   # host clock around the search
    device: torch.device             # the first of the search's devices


def run_add(args: Args) -> SearchRun:
    """The `add` command: search the range (from the -c cursor when it
    resumes), report finds, return them with the claim-based key count."""
    from .search.add import AddSearch

    devices, owned = search_devices(args)
    cfg, filt, status, _ = search_config(args, "add", len(devices))
    ckpt, start_offset, _, status.k_found = open_checkpoint(args, "add", cfg)
    if start_offset:
        print(f"resuming from checkpoint: offset {_fmt_n(start_offset)} keys")
    eng = AddSearch(cfg, filt, devices, owned)
    mult = 6 if cfg.endo else 1

    def on_step(done_keys):
        # clamp to the claim-based counter: the step-rounded count would
        # overshoot it on a range that is not GROUP-aligned
        status.update(min(done_keys * mult, eng.k_checked) - status.k_checked)
        if ckpt:
            ckpt.save(cursor=done_keys, k_checked=status.k_checked,
                      k_found=status.k_found)

    found = []

    def on_found(f):
        found.append(f)
        status.write_found(f)

    with _interactive(status):
        t0 = time.monotonic()
        eng.run_range(on_found=on_found, on_step=on_step,
                      start_offset=start_offset)
        seconds = time.monotonic() - t0
        if ckpt:
            ckpt.save(force=True)
        status.finish()
    return SearchRun(found=found, k_checked=eng.k_checked, seconds=seconds,
                     device=devices[0])


def run_rnd(args: Args) -> SearchRun:
    """The `rnd` command: search random sub-ranges until a draw covers
    the whole range (forever otherwise), with the range masks before and
    a `found / checked ~ s` line after each.  With -c, a seeded run
    resumes at the iteration after the last one saved.  Several processes
    need -seed, or each would draw its own sub-ranges and cover each
    only in part."""
    from .search.rnd import RndSearch, format_range_mask

    seed = args.get_str("-seed")
    if seed is None and multihost.process_count() > 1:
        _die("rnd over several processes needs -seed: every process must "
             "draw the same sub-ranges")
    devices, owned = search_devices(args)
    cfg, filt, status, (offs, size) = search_config(args, "rnd", len(devices))
    eng = RndSearch(cfg, filt, devices, seed=seed, offs=offs, size=size,
                    owned=owned)
    print(f"[random mode] offs: {eng.offs} ~ bits: {eng.size}\n")

    ckpt, skip_iters, status.k_checked, status.k_found = open_checkpoint(
        args, "rnd", cfg, seed)
    if skip_iters:
        print(f"resuming from checkpoint: iteration {skip_iters}")
        if seed is None:
            print("note: unseeded rnd draws fresh ranges; the "
                  "checkpoint only restores counters", file=sys.stderr)

    def on_range(lo, hi):
        print(format_range_mask(lo, eng.offs, eng.size, status.use_color))
        print(format_range_mask(hi, eng.offs, eng.size, status.use_color))

    # the engine counts from 0 in this process; a resumed run adds the
    # saved count
    base_checked = status.k_checked
    last = {"c": status.k_checked, "f": status.k_found,
            "t": time.monotonic()}

    def on_iter(i, lo, hi, got):
        status.update(base_checked + eng.engine.k_checked - status.k_checked)
        now = time.monotonic()
        dc, df = status.k_checked - last["c"], status.k_found - last["f"]
        dt = max(now - last["t"], 1e-3)
        last.update(c=status.k_checked, f=status.k_found, t=now)
        sys.stderr.write("\033[2K\r")
        print(f"{_fmt_n(df)} / {_fmt_n(dc)} ~ {dt:.1f}s\n")
        if ckpt:
            ckpt.save(iters=i, k_checked=status.k_checked,
                      k_found=status.k_found, force=True)

    found = []

    def on_found(f):
        found.append(f)
        status.write_found(f)

    with _interactive(status):
        t0 = time.monotonic()
        eng.run(on_found=on_found, on_iter=on_iter, on_range=on_range,
                skip_iters=skip_iters)
        seconds = time.monotonic() - t0
        status.finish()
    return SearchRun(found=found, k_checked=status.k_checked,
                     seconds=seconds, device=devices[0])


def run_blf_gen(args: Args, text: str) -> int:
    """`blf-gen -n <count> -o <file.blf>`: add the hash160 lines of
    `text` to the filter (a same-size existing file is updated), counting
    as duplicates the hashes it already holds when their turn comes."""
    from . import bloom, filters

    n = args.get_uint("-n", 0)
    if n <= 0:
        _die("missing filter size (-n <count>)")
    path = args.get_str("-o")
    if not path:
        _die("missing output file (-o <file.blf>)")
    if not path.endswith(".blf"):
        _die("output file should have .blf extension")
    blf = bloom.BloomFilter.for_count(n)
    if os.path.exists(path):
        old = bloom.BloomFilter.load(path)
        if old.size != blf.size:
            _die("filter size mismatch; delete existing file or use same -n")
        blf = old
    hashes = filters.parse_hash_lines(text)
    added = blf.add_new(hashes)
    blf.save(path)
    print(f"added {_fmt_n(added)} hashes ({_fmt_n(len(hashes) - added)} "
          f"duplicates) ~ size {_fmt_n(blf.size * 8)} bytes")
    return 0


def run_blf_check(args: Args, lines) -> int:
    """`blf-check -f <file.blf> [hash...]`: one `<hash> FOUND` or `<hash>
    NOT FOUND` line per hash160 given as an argument or, without any,
    per line of `lines`; 1 when any is not found."""
    import numpy as np

    from . import bloom, filters

    path = args.get_str("-f")
    if not path or not path.endswith(".blf"):
        _die("missing bloom filter file (-f <file.blf>)")
    blf = bloom.BloomFilter.load(path)
    items = [a for a in args.argv[2:] if len(a) == 40 and not a.startswith("-")]
    if not items:
        items = [ln.strip() for ln in lines if len(ln.strip()) == 40]
    names, rows = [], []
    for hx in items:
        try:
            rows.append(filters.hex_to_h160(hx))
        except ValueError:
            continue
        names.append(hx)
    if not rows:
        return 0
    hits = blf.has_many(np.stack(rows))
    for hx, ok in zip(names, hits):
        print(f"{hx} {'FOUND' if ok else 'NOT FOUND'}")
    return 0 if hits.all() else 1


def run_mul(args: Args, lines) -> SearchRun:
    """The `mul` command over an iterable of key lines (stdin): jobs of
    ECLOOP_MUL_BATCH keys per device (32,768 on the GPU, 2,048 on the
    CPU) stay queued on the devices while the next lines are read; the
    status line counts drained keys.  One process only: its keys come
    from its own stdin."""
    from .search import mul

    if multihost.process_count() > 1:
        _die("mul runs in one process (over all of its devices, -t): "
             "unset ECLOOP_COORDINATOR and split the key list instead")
    devices = select_devices(args)
    cfg, filt, status, _ = search_config(args, "mul", len(devices))
    batch = os.environ.get("ECLOOP_MUL_BATCH",
                           "32768" if devices[0].type == "cuda" else "2048")
    if not batch.isdigit() or int(batch) < 32 or int(batch) % 32:
        _die(f"ECLOOP_MUL_BATCH={batch}: must be a positive multiple of 32")
    eng = mul.MulSearch(cfg, filt, devices, w=mul.W,
                        batch=int(batch) * len(devices),
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
                     device=devices[0])


@contextlib.contextmanager
def whole_command_trace(cmd: str | None, args: Args):
    """With ECLOOP_PROFILE=<dir> set and not empty, a torch.profiler
    trace of the block, written on every way out of it (a return,
    SystemExit, an exception) as one Chrome-trace file per process,
    <dir>/<host>.p<process index>.<pid>.pt.trace.json, which Perfetto
    and TensorBoard's PyTorch plugin open; its path, size and the time
    the write took go to stderr.  A device command on CUDA records the
    host and the card; -device cpu, blf-gen, blf-check and the usage
    text record the host only and leave the card alone.  Shapes, stacks
    and memory are not recorded."""
    out_dir = os.environ.get("ECLOOP_PROFILE")
    if not out_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if (cmd in DEVICE_COMMANDS and (args.get_str("-device") or "cuda")
            == "cuda" and torch.cuda.is_available()):
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{socket.gethostname()}.p"
                            f"{multihost.process_index()}.{os.getpid()}"
                            f".pt.trace.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        print(f"profile: {path}, {os.path.getsize(path):,} bytes, written "
              f"in {time.perf_counter() - t0:.3f} s", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    locale.setlocale(locale.LC_ALL, "")
    argv = list(sys.argv if argv is None else argv)
    args = Args(argv)
    cmd = argv[1] if len(argv) > 1 else None
    try:
        with whole_command_trace(cmd, args):
            try:
                several = multihost.init_from_env()
            except ValueError as e:
                _die(str(e))
            if several:
                print(multihost.process_banner(len(select_devices(args))),
                      file=sys.stderr)
            return run_command(cmd, args, argv)
    finally:
        multihost.leave()


def run_command(cmd: str | None, args: Args, argv: list[str]) -> int:
    """Dispatch one command of the command line; its exit code."""
    if cmd == "add":
        run_add(args)
        return 0
    if cmd == "mul":
        run_mul(args, sys.stdin)
        return 0
    if cmd == "rnd":
        run_rnd(args)
        return 0
    if cmd == "blf-gen":
        return run_blf_gen(args, sys.stdin.read())
    if cmd == "blf-check":
        return run_blf_check(args, sys.stdin)
    if cmd in ("bench", "bench-gtable", "mult-verify"):
        device = select_device(args)
        from . import benchlib
        return {"bench": benchlib.run_bench,
                "bench-gtable": benchlib.run_bench_gtable,
                "mult-verify": benchlib.mult_verify}[cmd](device)
    if args.get_bool("-v"):
        print(f"ecloop-tpu-torch v{__version__}")
        return 0
    print(USAGE.format(name=os.path.basename(argv[0] or "ecloop"),
                       version=__version__))
    return 0
