"""One run of one benchmark cell of the PyTorch/CUDA port
(`ecloop_tpu_torch`), driven by data: the cell names a configuration
(`configs/<file>.json`: the targets) and a traffic mix
(`traffic/<name>.json`: the command line and the work's parameters),
and its per-layer metrics are read by `metrics/<name>.py`, all found by
the names in BENCHMARK.json.

A run: set-up (targets and planted keys from the seed, the search
built through the CLI's own `search_config`, every shape warmed up),
then the measured window, then the judge (`reference/judge.py`) over
what the window produced.  The port is imported here only, never by
the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import random
import sys
import tempfile
import time

import numpy as np

from . import accounts, profiling, targets
from .reference import judge, secp
from .reference import hashes as ref_hashes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ecloop_tpu")


class Stop(Exception):
    """Ends a range cell's window at a step boundary."""


# --- the cell ------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str, root: str = ROOT) -> Cell:
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", ())
             or "workloads" not in m and m["moves"] in moved]
    return Cell(name, w, config, traffic, e2e, layer)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: `ecloop_tpu_torch` is not `ecloop_tpu`)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def reader(metric: str):
    """metrics/<metric>.py's `read`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "keybench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- set-up --------------------------------------------------------------------

def _streams(seed: int) -> dict[str, int]:
    """Independent 63-bit seeds for each use, from the run's seed."""
    kids = np.random.SeedSequence(seed % (1 << 64)).spawn(4)
    return {k: int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
            for k, s in zip(("draws", "targets", "plants", "lines"), kids)}


def traffic_chips(traffic: dict) -> int:
    """The cards a traffic's command line runs on: its `-t`, else one."""
    args = traffic["args"]
    return int(args[args.index("-t") + 1]) if "-t" in args else 1


def _argv(cell_: Cell, target_path: str, seed: int) -> list[str]:
    return ["ecloop", cell_.traffic["command"], "-f", target_path,
            *cell_.traffic["args"], "-seed", str(seed)]


def _draw_subranges(rng: random.Random, rs: int, re_: int, offs: int,
                    size: int, n: int) -> list[tuple[int, int]]:
    """rnd's sub-ranges (search/rnd.gen_random_range's rule): a base in
    [rs, re_], its window bits cleared for the start and set for the end,
    both clamped into the range."""
    window = ((1 << size) - 1) << offs
    out = []
    for _ in range(n):
        base = rng.randint(rs, re_)
        out.append((max(base & ~window, rs), min(base | window, re_)))
    return out


def _printable_lines(rng: np.random.Generator, n: int, lo: int,
                     hi: int) -> list[str]:
    """n lines of lo..hi printable ASCII characters (no spaces)."""
    lens = rng.integers(lo, hi + 1, n)
    buf = rng.integers(0x21, 0x7F, int(lens.sum()) + n, dtype=np.uint8)
    buf[np.cumsum(lens + 1) - 1] = ord("\n")
    return buf.tobytes().decode("ascii").split("\n")[:n]


@dataclasses.dataclass
class Setup:
    argv: list[str]
    holds: judge.Targets
    planted: list            # rnd: (priv, label, sub-range, offset); mul: (pool index, priv, label)
    draws: list
    lines: list | None
    fill: float | None
    n_first: int | None
    tmp: tempfile.TemporaryDirectory


def _geometry(cell_: Cell, seed: int):
    """(range_s, range_e, offs, size) as the CLI derives them: rnd
    without -d draws its offset from the -seed Rng."""
    from ecloop_tpu_torch import cli
    from ecloop_tpu_torch.search.rnd import Rng

    args = cli.Args(_argv(cell_, "-", seed))
    rs, re_ = cli.parse_range(args)
    offs, size = cli.parse_offs_size(args, re_, cell_.traffic["command"],
                                     Rng(str(seed)))
    return rs, re_, min(offs, 255 - size), size


def _forms_of(args: list[str]) -> list[str]:
    """The address forms `-a` asks for, compressed alone by default (the
    CLI's rule)."""
    addr = args[args.index("-a") + 1] if "-a" in args else ""
    forms = (["addr33"] if "c" in addr else []) + \
        (["addr65"] if "u" in addr else [])
    return forms or ["addr33"]


def make_targets(cell_: Cell, seed: int, device) -> Setup:
    """The filter file and what it holds, the traffic's draws and the
    planted keys, all from the seed.  Planted keys are targets at
    offsets drawn across each sub-range (rnd: a key of the sub-range, or
    one of its GLV images with -endo) or lines put into the pool (mul),
    each in one of the cell's address forms."""
    import torch

    st = _streams(seed)
    tr, conf = cell_.traffic, cell_.config
    prng = random.Random(st["plants"])
    forms = _forms_of(tr["args"])
    planted, draws, lines, plant_hashes = [], [], None, []
    if tr["command"] == "rnd":
        rs, re_, offs, size = _geometry(cell_, seed)
        draws = _draw_subranges(random.Random(st["draws"]), rs, re_, offs,
                                size, tr["subranges"])
        endo = "-endo" in tr["args"]
        stride = 1 << offs
        for r, (lo, hi) in enumerate(draws):
            span = min((hi - lo) // stride, tr.get("plant_span", hi - lo))
            for _ in range(tr["plants_per_subrange"]):
                off = prng.randrange(span)
                e = prng.randrange(6) if endo else 0
                label = prng.choice(forms)
                priv = secp.endo_priv(lo + off * stride, e)
                planted.append((priv, label, r, off))
                plant_hashes.append(secp.pubkey_hash160(priv, label == "addr33"))
    else:
        lines = _printable_lines(np.random.default_rng(st["lines"]),
                                 tr["pool_lines"], *tr["line_chars"])
        for idx in prng.sample(range(len(lines)), tr["plants"]):
            # the longest lines, so that no other pool line equals one
            line = "".join(chr(prng.randrange(0x21, 0x7F))
                           for _ in range(tr["line_chars"][1]))
            lines[idx] = line
            priv = int.from_bytes(ref_hashes.sha256(line.encode()),
                                  "big") % secp.N
            label = prng.choice(forms)
            planted.append((idx, priv, label))
            plant_hashes.append(secp.pubkey_hash160(priv, label == "addr33"))

    tmp = tempfile.TemporaryDirectory(prefix="keybench-")
    fill = n_first = None
    if conf["targets"] == "list":
        with open(os.path.join(HERE, "configs", conf["hashes_file"])) as f:
            held = [bytes.fromhex(ln.strip()) for ln in f if ln.strip()]
        held += plant_hashes
        path = os.path.join(tmp.name, "targets.txt")
        targets.write_list(path, held)
        holds = judge.Targets(hashes=set(held))
        n_first = len({h[:4] for h in held})
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(st["targets"])
        parts = [targets.random_hash_words(conf["random_hashes"], gen, device)]
        if plant_hashes:
            parts.append(targets.words_of(plant_hashes, device))
        dev_bits = targets.bloom_bytes(parts, targets.ref_bloom.size_words(
            conf["random_hashes"] + len(plant_hashes)))
        del parts
        fill = targets.fill(dev_bits)
        bits = dev_bits.cpu().numpy()
        del dev_bits
        path = os.path.join(tmp.name, "funded.blf")
        targets.write_blf(path, bits)
        holds = judge.Targets(bits=bits)
    return Setup(_argv(cell_, path, seed), holds, planted, draws, lines,
                 fill, n_first, tmp)


def _planes(endo: bool, forms: list[str]) -> list[tuple[int, int, bool]]:
    """A step's candidate planes (x row, y row, compressed): the key's
    point, with -endo also its GLV images (x, beta x, beta^2 x with y and
    -y), in each address form."""
    return [(e // 2, e % 2, f == "addr33")
            for e in range(6 if endo else 1) for f in forms]


def _int_rate() -> float:
    """64 32-bit integer results per clock per SM x the SMs x the maximum
    SM clock, read on card 0 (sol.py's rate)."""
    import subprocess

    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    acc = accounts.frozen()
    return acc["int_lane_ops_per_clk"] * sms * int(mhz.split()[0]) * 1e6


def step_least_s(cfg, su: Setup, forms: list[str],
                 shards: int = 1) -> dict[str, float]:
    """Least seconds of one `add` step's work, per account term.  Over
    `shards` cards each prices its own block of the step at the local
    geometry (cfg.centers // shards centers, the key the frozen accounts
    hold), and the step's work is `shards` times that."""
    acc = accounts.frozen()
    rate, mem = _int_rate(), acc["mem_bps"]
    centers = cfg.centers // shards
    out = {k: shards * accounts.least_s(b, o, rate, mem)[0] for k, (b, o) in
           accounts.chord_inv(acc, centers, cfg.group_k, cfg.endo).items()}
    planes = _planes(cfg.endo, forms)
    n = centers * cfg.group_k
    if su.fill is not None:
        reads = n * len(planes) * accounts.probe_reads_per_key(
            su.fill, accounts.device_probes(su.fill))
        b, o = accounts.hash_probe(acc, n, planes, "exact", reads=reads,
                                   bits_words=su.holds.bits.size // 4)
    else:
        b, o = accounts.hash_probe(acc, n, planes, "compare",
                                   n_first=su.n_first)
    out["hash_probe"] = shards * accounts.least_s(b, o, rate, mem)[0]
    return out


# --- the run ---------------------------------------------------------------------

SPANS = {
    "rnd": (("search.add", "center_points", "center_points"),
            ("search.add.AddSearch", "_drain", "drain"),
            ("search.add.StepCall", "__call__", "launch"),
            ("search.common", "fetched", "fetched"),
            ("search.common", "derive_h160", "derive_h160"),
            ("filters.Filter", "confirm", "confirm")),
    "mul": (("search.mul.MulSearch", "run_lines", "run_lines"),
            ("search.mul", "parse_keys", "parse_keys"),
            ("search.mul", "keys_to_words", "keys_to_words"),
            ("search.mul", "words_mod_n", "words_mod_n"),
            ("search.mul", "window_digits_words", "digits"),
            ("search.mul.MulShard", "launch", "launch"),
            ("search.mul.MulSearch", "_drain_one", "drain"),
            ("search.common", "fetched", "fetched"),
            ("search.common", "derive_h160", "derive_h160"),
            ("filters.Filter", "confirm", "confirm")),
}


def _owner(path: str):
    """ecloop_tpu_torch.<module>[.<class>] from 'module[.Class]'."""
    import importlib

    parts = path.split(".")
    if parts[-1][0].isupper():
        mod = importlib.import_module("ecloop_tpu_torch." + ".".join(parts[:-1]))
        return getattr(mod, parts[-1])
    return importlib.import_module("ecloop_tpu_torch." + path)


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, devices,
             t_start: float, fault=None) -> dict:
    """One run of the cell on `devices` (a device or a list of the cell's
    `chips`; [cpu] * n stands for n cards on the CPU); returns the result
    object that run.py prints (its `metrics` the cell's end-to-end ones,
    or with `trace` its per-layer ones).  `fault` (faults.py) breaks the
    timed path: the judge's own checks use it, never a benchmark run."""
    import torch

    from ecloop_tpu_torch import cli

    devices = [torch.device(d) for d in
               (devices if isinstance(devices, (list, tuple)) else [devices])]
    device = devices[0]
    chips = c.workload["chips"]
    if traffic_chips(c.traffic) != chips or len(devices) != chips:
        raise ValueError(f"{c.name}: chips {chips}, the traffic's -t "
                         f"{traffic_chips(c.traffic)}, {len(devices)} devices")
    # each card once, where a test stacks shards on one
    cards = sorted({d for d in devices if d.type == "cuda"},
                   key=lambda d: d.index)
    cmd = c.traffic["command"]
    su = make_targets(c, seed, device)
    with contextlib.ExitStack() as stack:
        stack.callback(su.tmp.cleanup)
        if fault is not None:
            stack.enter_context(fault())
        with contextlib.redirect_stdout(sys.stderr):
            cfg, filt, _, (offs, size) = cli.search_config(
                cli.Args(su.argv), cmd, len(devices))
        su.tmp.cleanup()
        run = _RangeRun if cmd == "rnd" else _MulRun
        r = run(c, cfg, filt, offs, size, su, devices, seed)
        r.warm_up()
        if cards:
            if trace:
                profiling.warm_up(cards)
            for d in cards:
                torch.cuda.synchronize(d)
            torch.cuda.empty_cache()          # every card's cache
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
        setup_s = time.perf_counter() - t_start
        spans = profiling.Spans()
        if trace:
            stack.callback(spans.restore)
            for owner, attr, span in SPANS[cmd]:
                spans.wrap(_owner(owner), attr, span)
        sampler = (profiling.Sampler(time.perf_counter(), seconds,
                                     c.traffic["profile_window_s"],
                                     cards=[d.index for d in cards])
                   if trace else None)
        window = r.window(seconds, sampler)
        if sampler:
            sampler.close()
        spans.restore()
        for d in cards:
            torch.cuda.synchronize(d)
        peaks = [torch.cuda.max_memory_reserved(d) for d in cards]
        least = (step_least_s(cfg, su, _forms_of(c.traffic["args"]),
                              len(devices))
                 if trace and cmd == "rnd" and cards else {})
        r.eng = r.filt = filt = None      # the program's state, freed
        if cards:
            torch.cuda.empty_cache()
        verdict = r.judge()

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": len(devices), "memory_peak_bytes": max(peaks, default=0),
           "memory_peak_bytes_by_card": peaks}
    out = {"correct": verdict["correct"], "attempted": verdict["attempted"],
           "failed": verdict["failed"]}
    units = {m["name"]: m["unit"] for m in c.end_to_end + c.per_layer}
    if trace:
        samples = sampler.samples
        rec = {"window_s": window["wall_s"], "samples": samples,
               "spans": {k: {"s": spans.seconds[k], "n": spans.calls[k]}
                         for k in spans.calls},
               "least_s": least}
        values = {m["name"]: reader(m["name"])(rec) for m in c.per_layer}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if v is not None}
        dev["busy_s"] = sum(s["busy_s"] for s in samples)
        dev["window_s"] = sum(s["wall_s"] for s in samples)
        out["metrics"] = metrics
        out["device"] = dev
        out["breakdown"] = _breakdown(samples)
        # why a reading is missing: windows summarized, and windows whose
        # device records the profiler dropped
        out["windows_kept"] = len(samples)
        out["windows_dropped"] = sampler.short
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in c.end_to_end}
        out["device"] = dev
    out["checks"] = verdict["checks"]
    return out


def _breakdown(samples: list[dict]) -> dict:
    ops, idle = {}, {}
    for s in samples:
        for k, v in s["device_ops"].items():
            ops[k] = ops.get(k, 0.0) + v
        for k, v in s["idle"].items():
            idle[k] = idle.get(k, 0.0) + v

    def top(d):
        return [[_short(k), v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def _short(name: str) -> str:
    """A device op's name without its argument list and namespaces."""
    for junk in ("void ", "(anonymous namespace)::", "at::native::"):
        name = name.replace(junk, "")
    return name.split("(")[0][:80]


class _RangeRun:
    """rnd: drawn sub-ranges, each searched by the engine's run_range
    (what RndSearch.run does), until the first step boundary past the
    window's end."""

    def __init__(self, c, cfg, filt, offs, size, su, devices, seed):
        from ecloop_tpu_torch.search.rnd import RndSearch

        self.cfg, self.filt, self.su = cfg, filt, su
        self.eng = RndSearch(cfg, filt, devices, offs=offs, size=size).engine
        self.endo, self.offs, self.size = cfg.endo, offs, size
        self.found, self.subs = [], []
        self.rng = random.Random(_streams(seed)["draws"] ^ 1)

    def _on_found(self, f) -> None:
        self.found.append((f.label, f.h160, f.priv))

    def warm_up(self) -> None:
        """The native host library (hit re-derivation) and two calls of
        the engine over a sub-range of the cell's stride."""
        from ecloop_tpu_torch.search import common

        common.derive_h160(1, True)
        self.filt.confirm(bytes(20))
        cfg = self.cfg
        (lo, _), = _draw_subranges(self.rng, cfg.range_s, cfg.range_e,
                                    self.offs, self.size, 1)
        # a claim holds min(range_e - range_s, 2^21) keys whatever the
        # stride (ecloop's rule), so this searches n keys
        n = 2 * max(1, cfg.steps_per_call) * cfg.keys_per_step
        self.eng.run_range(range_s=lo, range_e=lo + n)

    def window(self, seconds: float, sampler) -> dict:
        eng, mult = self.eng, 6 if self.endo else 1
        keys, stop = 0, {}
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def on_step(done):
            self.subs[-1].done = done
            if sampler:
                sampler.tick()
            now = time.perf_counter()
            if now >= deadline:
                stop["t"] = now
                raise Stop

        try:
            for lo, hi in self.su.draws:
                k0 = eng.k_checked
                self.subs.append(judge.Subrange(lo, hi, self.cfg.stride, 0,
                                                False, 0))
                eng.run_range(on_found=self._on_found, on_step=on_step,
                              range_s=lo, range_e=hi)
                sub = self.subs[-1]
                sub.finished, sub.program_keys = True, eng.k_checked - k0
                keys += sub.program_keys
            raise RuntimeError(f"the window outlasted the traffic's "
                               f"{len(self.su.draws)} sub-ranges")
        except Stop:
            keys += min(self.subs[-1].done * mult, eng.k_checked - k0)
        wall = stop["t"] - t0
        return {"wall_s": wall, "metrics": {"keys_per_s": keys / wall}}

    def judge(self) -> dict:
        return judge.judge_range(self.found, self.subs, self.su.planted,
                                 self.su.holds, self.endo)


def _cycled(pool: list):
    """The pool's lines again and again (itertools.cycle would copy the
    pool while it first walks it, slowing the first pass alone)."""
    while True:
        yield from pool


class _MulRun:
    """mul: lines of the seeded pool, cycled, fed in the CLI's chunks of
    the engine's batch through run_lines(drain=False), then flush() (what
    cli.run_mul does with stdin), until the first chunk past the
    window's end."""

    def __init__(self, c, cfg, filt, offs, size, su, devices, seed):
        from ecloop_tpu_torch.search import mul

        device, = devices                 # mul cells run on one card
        batch = os.environ.get("ECLOOP_MUL_BATCH",
                               "32768" if device.type == "cuda" else "2048")
        self.eng = mul.MulSearch(cfg, filt, [device], w=mul.W,
                                 batch=int(batch), raw="-raw" in c.traffic["args"])
        self.c, self.su, self.seed = c, su, seed
        self.found, self.fed, self.k0 = [], 0, 0

    def _on_found(self, f) -> None:
        self.found.append((f.label, f.h160, f.priv))

    def warm_up(self) -> None:
        from ecloop_tpu_torch.search import common

        common.derive_h160(1, True)
        self.eng.filt.confirm(bytes(20))
        rng = np.random.default_rng(_streams(self.seed)["lines"] ^ 1)
        self.eng.run_lines(_printable_lines(rng, self.eng.batch,
                                            *self.c.traffic["line_chars"]))
        self.k0 = self.eng.k_checked

    def window(self, seconds: float, sampler) -> dict:
        eng, chunk = self.eng, []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        for line in _cycled(self.su.lines):
            line = line.strip()
            if not line:
                continue
            chunk.append(line)
            if len(chunk) >= eng.batch:
                eng.run_lines(chunk, on_found=self._on_found, drain=False)
                self.fed += len(chunk)
                chunk = []
                if sampler:
                    sampler.tick()
                if time.perf_counter() >= deadline:
                    break
        eng.flush()
        wall = time.perf_counter() - t0
        self.program_keys = eng.k_checked - self.k0
        return {"wall_s": wall, "metrics": {"mul_keys_per_s": self.fed / wall}}

    def judge(self) -> dict:
        pool = self.su.lines
        cycles, rest = divmod(self.fed, len(pool))
        feeds = {}
        for idx, priv, label in self.su.planted:
            feeds[(priv, label)] = cycles + (idx < rest)

        def fed_lines():
            for i in range(self.fed):
                yield pool[i % len(pool)]
        return judge.judge_mul(self.found, self.fed, self.program_keys, feeds,
                               self.su.holds, fed_lines)
