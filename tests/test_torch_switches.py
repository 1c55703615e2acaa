"""The port's run-time switches against the JAX package's semantics:
ECLOOP_BLF_PROBES (a .blf's device probe count), ECLOOP_MUL_INFLIGHT
(the `mul` jobs queued before the oldest drains), ECLOOP_NATIVE_BUILD=0
(no compile of the host library) and ECLOOP_PROFILE (a trace of the
whole command, here on the CPU: one Chrome-trace file per process, the
untraced run's stdout and keys, also when the command dies)."""

import glob
import json
import os
import socket

import pytest
import torch

from ecloop_tpu import filters as jfilters
from ecloop_tpu_torch import _build, bloom, cli, filters, golden, native
from ecloop_tpu_torch.search import common, mul
from ecloop_tpu_torch.filters import pack_mask
from ecloop_tpu_torch.search.common import SearchConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PUZZLES = os.path.join(ROOT, "data", "btc-puzzles-hash")
BW_PRIV = os.path.join(ROOT, "data", "btc-bw-priv")
BW_HASH = os.path.join(ROOT, "data", "btc-bw-hash")
# one 4 x 2048 step covers c000:dfff, which holds puzzle key c936
SMALL = {"ECLOOP_CENTERS": "4", "ECLOOP_GROUP_K": "2048",
         "ECLOOP_STEPS_PER_CALL": "1"}
ADD = ["add", "-f", PUZZLES, "-r", "c000:dfff", "-device", "cpu"]
C936 = (f"addr33: {golden.addr33(golden.point_mul(0xC936)).hex()} <- "
        f"{0xC936:064x}")
W, BATCH, JOBS = 8, 32, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's own thread pool on
    these small batches only burns the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_switch_set(monkeypatch):
    for name in ("ECLOOP_BLF_PROBES", "ECLOOP_MUL_INFLIGHT",
                 "ECLOOP_NATIVE_BUILD", "ECLOOP_PROFILE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in SMALL.items():
        monkeypatch.setenv(name, value)


@pytest.fixture(scope="module")
def puzzles_blf(tmp_path_factory):
    """A .blf of the 160 puzzle hashes, sized for them (15 adaptive
    probes)."""
    hashes = filters.parse_hash_lines(open(PUZZLES).read())
    blf = bloom.BloomFilter.for_count(len(hashes))
    blf.add_new(hashes)
    path = str(tmp_path_factory.mktemp("blf") / "puzzles.blf")
    blf.save(path)
    return path


def _main(capsys, argv):
    """(exit code, stdout, stderr) of the port's CLI; SystemExit's code
    stands for the exit code."""
    try:
        rc = cli.main(["ecloop", *argv])
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


# --- ECLOOP_BLF_PROBES -------------------------------------------------------------

@pytest.mark.parametrize("env,want", [(None, 15), ("", 15), ("0", 1),
                                      ("3", 3), ("25", 20)])
def test_blf_probes_equal_jax(puzzles_blf, monkeypatch, env, want):
    if env is not None:
        monkeypatch.setenv("ECLOOP_BLF_PROBES", env)
    got = filters.load_filter(puzzles_blf).blf_probes
    assert got == jfilters.load_filter(puzzles_blf).blf_probes == want


def test_one_blf_probe_finds_the_same_keys(puzzles_blf, monkeypatch, capsys):
    """Fewer device probes only let more false positives reach the host,
    which re-derives every hit: the found set does not change."""
    argv = ["add", "-f", puzzles_blf, "-r", "c000:dfff", "-device", "cpu"]
    runs = [_main(capsys, argv)]
    monkeypatch.setenv("ECLOOP_BLF_PROBES", "1")
    runs.append(_main(capsys, argv))
    assert [r[0] for r in runs] == [0, 0]
    assert runs[0][1] == runs[1][1]
    assert C936 in runs[0][1].splitlines()


# --- ECLOOP_MUL_INFLIGHT -----------------------------------------------------------

class _HostShard:
    """Stands in for a device's `mul.MulShard`: a job's hit mask marks
    the lanes whose key, rebuilt from its window digits, is in `keys`,
    as the device step marks them where its prefilter is exact."""

    keys: set = set()

    def __init__(self, device, cfg, filt, w, batch):
        self.w = w

    def launch(self, dig):
        hit = [sum(int(v) << (self.w * i) for i, v in enumerate(col))
               in self.keys for col in dig.T]
        return common.fetch_async(pack_mask(torch.tensor(hit))[None])


@pytest.mark.parametrize("depth", ["1", "2", "8", None])
def test_mul_inflight_bounds_the_queue(monkeypatch, depth):
    """`depth` jobs at most stay queued after run_lines(drain=False), as
    many as that once enough were queued (4 when unset), and every
    depth finds the same keys: the vector keys whose compressed hash is
    a target."""
    lines = open(BW_PRIV).read().split()[:JOBS * BATCH]
    monkeypatch.setattr(_HostShard, "keys", {int(ln, 16) for ln in lines})
    monkeypatch.setattr(mul, "MulShard", _HostShard)
    if depth is not None:
        monkeypatch.setenv("ECLOOP_MUL_INFLIGHT", depth)
    filt = filters.load_filter(BW_HASH)
    eng = mul.MulSearch(SearchConfig(addr33=True), filt, "cpu", w=W,
                        batch=BATCH)
    assert eng.depth == int(depth or 4)
    found, queued = [], []
    for i in range(JOBS):
        eng.run_lines(lines[i * BATCH:(i + 1) * BATCH],
                      on_found=found.append, drain=False)
        queued.append(len(eng._pending))
    eng.flush()
    assert queued == [min(i + 1, eng.depth) for i in range(JOBS)]
    assert eng.k_checked == JOBS * BATCH
    want = {int(ln, 16) for ln in lines
            if filt.confirm(bytes.fromhex(common.derive_h160(int(ln, 16),
                                                             True)))}
    assert len(want) > JOBS
    assert sorted(f.priv for f in found) == sorted(want)


# --- ECLOOP_NATIVE_BUILD=0 ---------------------------------------------------------

@pytest.mark.parametrize("built", [False, True])
def test_native_build_off_compiles_nothing(tmp_path, monkeypatch, built):
    """With ECLOOP_NATIVE_BUILD=0 no compiler runs: the library is loaded
    when this exact build exists, and without it `available()` is
    false (the callers take their Python paths)."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    if built:
        assert native.build() == native.library_path()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("ECLOOP_NATIVE_BUILD", "0")
    ran = []
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: ran.append(a))
    assert native.available() is built
    assert ran == []
    assert os.listdir(tmp_path) == ([os.path.basename(native.library_path())]
                                    if built else [])
    if built:
        want = golden.addr33(golden.point_mul(0xC936))
        assert native.pk_hash160(0xC936, True) == want


# --- ECLOOP_PROFILE ---------------------------------------------------------------

def _trace(out_dir) -> set:
    """The one trace file in out_dir, named for this process, parsed;
    the categories of its events, none of them the card's."""
    paths = glob.glob(os.path.join(out_dir, "*.pt.trace.json"))
    assert [os.path.basename(p) for p in paths] == [
        f"{socket.gethostname()}.p0.{os.getpid()}.pt.trace.json"]
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert events and not cats & {"kernel", "gpu_memcpy", "gpu_memset",
                                  "cuda_runtime", "cuda_driver"}
    return cats


@pytest.mark.parametrize("argv", [
    ADD,
    ["blf-check", "-f", "{blf}", C936.split()[1], "00" * 20],
], ids=["add", "blf-check"])
def test_profile_traces_the_whole_command(puzzles_blf, tmp_path, monkeypatch,
                                          capsys, argv):
    """The traced command prints what the untraced one prints (banner and
    found lines; blf-check's lines and exit code) and counts the same
    keys, and writes one host-only trace file."""
    argv = [puzzles_blf if a == "{blf}" else a for a in argv]
    plain = _main(capsys, argv)
    monkeypatch.setenv("ECLOOP_PROFILE", str(tmp_path / "prof"))
    traced = _main(capsys, argv)
    assert traced[:2] == plain[:2]
    cats = _trace(tmp_path / "prof")
    if argv[0] == "add":
        assert plain[0] == 0 and C936 in plain[1].splitlines()
        assert plain[2].rstrip().endswith("1 / 8,191")
        assert traced[2].split("\nprofile: ")[0].rstrip().endswith("1 / 8,191")
        assert "cpu_op" in cats
    else:
        assert plain[0] == 1 and plain[1].splitlines() == [
            f"{C936.split()[1]} FOUND", f"{'00' * 20} NOT FOUND"]
    assert f"profile: {tmp_path / 'prof'}" in traced[2]


def test_profile_written_when_the_command_dies(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_PROFILE", str(tmp_path))
    rc, out, err = _main(capsys, ["add", "-f", PUZZLES, "-r", "zz:ffff",
                                  "-device", "cpu"])
    assert rc == 1 and out == ""
    assert "invalid search range" in err
    _trace(tmp_path)
