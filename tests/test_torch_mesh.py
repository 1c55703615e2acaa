"""The port's searches over several devices (`ecloop_tpu_torch.parallel.mesh`)
on n CPU "devices": the shards' step masks, joined in flat-offset order,
are bit-identical to those of `AddSearch` on one device (which
tests/test_torch_add.py pins to the JAX package's `make_step`), and the
found set and key count of `add`, `mul` and seeded `rnd` do not depend
on n.  Also the geometry checks,
the CLI's `-t`, the read-back of hit masks on the masks' own device, and
(behind ECLOOP_RUN_SLOW, as the JAX package's own sharded tests) the
sharded engine against the JAX package's `ShardedAddSearch`."""

import os

import numpy as np
import pytest
import torch

from ecloop_tpu_torch import bloom, cli, fel, filters, golden
from ecloop_tpu_torch.parallel import mesh
from ecloop_tpu_torch.search import add, common, mul, rnd
from ecloop_tpu_torch.search.common import SearchConfig

CPU = torch.device("cpu")
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PUZZLES = os.path.join(ROOT, "data", "btc-puzzles-hash")
BW_PRIV = os.path.join(ROOT, "data", "btc-bw-priv")
BW_HASH = os.path.join(ROOT, "data", "btc-bw-hash")
# one step of 8 x 256 keys covers a 2,048-key claim; a CPU step pays one
# Fermat chain of plain torch ops whatever its width, so steps are few
GEOM = dict(centers=8, group_k=256, steps_per_call=1)
BASE = 0x70000
# hits in shards 0, 1 and 3 of 4 (512 keys each)
STEP_TARGETS = [BASE + 5, BASE + 0x2A0, BASE + 0x7F0]
MUL_W, MUL_BATCH = 8, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hash_rows(keys, is33=True):
    return np.stack([np.frombuffer(bytes.fromhex(common.derive_h160(k, is33)),
                                   dtype=">u4").astype(np.uint32)
                     for k in keys])


def _filter_for(keys):
    return filters.filter_from_hashes(_hash_rows(keys))


def _step_filter(mode, tmp_path_factory):
    rows = np.concatenate([_hash_rows(STEP_TARGETS),
                           _hash_rows(STEP_TARGETS, is33=False)])
    if mode != "bloom":
        return filters.filter_from_hashes(rows)
    blf = bloom.BloomFilter.for_count(len(rows) + 1000)
    blf.add_many(np.concatenate([rows, np.random.default_rng(1).integers(
        0, 1 << 32, size=(1000, 5), dtype=np.uint64).astype(np.uint32)]))
    path = str(tmp_path_factory.mktemp("blf") / "t.blf")
    blf.save(path)
    return filters.load_filter(path)


# mode -> (cfg, filter, AddSearch's next centers and masks of one step)
_SINGLE = {}
MODES = {"list": dict(endo=True, addr65=True), "pow2": {},
         "bloom": dict(addr65=True)}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_shard_masks_equal_add_search_masks(mode, n, monkeypatch,
                                            tmp_path_factory):
    if mode == "pow2":
        monkeypatch.setenv("ECLOOP_CMP_MAX", "0")
    if mode not in _SINGLE:
        cfg = SearchConfig(range_s=BASE, range_e=BASE + 0x800, **GEOM,
                           **MODES[mode])
        filt = _step_filter(mode, tmp_path_factory)
        eng = add.AddSearch(cfg, filt, CPU)
        cx, cy = (fel.from_last(a, CPU) for a in add.center_points(cfg, BASE))
        _SINGLE[mode] = cfg, filt, eng.shards[0].step(cx, cy)
    cfg, filt, (want_cx, want_cy, want) = _SINGLE[mode]
    assert filt.use_cmp() == (mode == "list")
    assert want.any()

    eng = add.AddSearch(cfg, filt, [CPU] * n)
    outs = [s.step(cx, cy) for s, (cx, cy) in
            zip(eng.shards, eng.shard_centers(BASE))]
    assert [s.offset for s in eng.shards] == [d * 2048 // n for d in range(n)]
    assert torch.equal(torch.cat([o[2] for o in outs], dim=1), want)
    assert torch.equal(torch.cat([o[0] for o in outs], dim=1), want_cx)
    assert torch.equal(torch.cat([o[1] for o in outs], dim=1), want_cy)


# the range of tests/test_search.py's sharded counter test: 0x2A7 keys
ADD_TARGETS = [0x70005, 0x702A0]


@pytest.mark.parametrize("n", [None, 1, 2, 4])
def test_add_found_set_and_count_do_not_depend_on_n(n):
    cfg = SearchConfig(range_s=0x70000, range_e=0x702A7, **GEOM)
    filt = _filter_for(ADD_TARGETS)
    eng = add.AddSearch(cfg, filt, CPU if n is None else [CPU] * n)
    steps = []
    found = eng.run_range(on_step=steps.append)
    assert {(f.label, f.priv) for f in found} == {("addr33", k)
                                                  for k in ADD_TARGETS}
    # one 2,048-key step covers the claim (its coverage, GROUP-rounded)
    assert eng.k_checked == 0x2A7
    assert eng.k_found == 2 and steps == [2048]


def test_add_shards_own_only_their_keys():
    """Two engines that own shard 0 and shard 1 of two find disjoint sets
    whose union is the whole engine's, each counting the whole range."""
    cfg = SearchConfig(range_s=BASE, range_e=BASE + 0x800, **GEOM)
    filt = _filter_for(STEP_TARGETS)
    got = []
    for owned in ([0], [1]):
        eng = add.AddSearch(cfg, filt, [CPU] * 2, owned=owned)
        got.append({f.priv for f in eng.run_range()})
        assert eng.k_checked == 0x800 and len(eng.shards) == 1
    assert got == [set(STEP_TARGETS[:2]), {STEP_TARGETS[2]}]


MUL_TARGETS = {5: 3, 70: 0xDEADBEEF, 140: 0x123456789ABCDEF, 250: golden.N - 5}


@pytest.mark.parametrize("n", [None, 1, 2, 4])
def test_mul_found_set_and_count_do_not_depend_on_n(n):
    """One job of 256 keys with a target in each quarter."""
    rng = np.random.default_rng(7)
    keys = [int.from_bytes(rng.bytes(32), "big") % golden.N
            for _ in range(MUL_BATCH)]
    for pos, k in MUL_TARGETS.items():
        keys[pos] = k
    cfg = SearchConfig(addr33=True)
    filt = _filter_for(list(MUL_TARGETS.values()))
    eng = mul.MulSearch(cfg, filt, CPU if n is None else [CPU] * n,
                        w=MUL_W, batch=MUL_BATCH)
    assert len(eng.shards) == (n or 1)
    found = eng.run_keys(keys)
    assert sorted(f.priv for f in found) == sorted(MUL_TARGETS.values())
    assert eng.k_checked == MUL_BATCH


# a 2^20-key window over a range that straddles a window edge: every draw
# is one of its two 2,048-key halves, a target in each
RND_SEED, RND_RANGE = "mesh", (0xFF800, 0x100800)
RND_TARGETS = [0xFF900, 0x100123]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_seeded_rnd_does_not_depend_on_n(n):
    fresh = rnd.Rng(RND_SEED)
    draws = [rnd.gen_random_range(fresh, *RND_RANGE, 0, 20) for _ in range(2)]
    assert len(set(draws)) == 2
    cfg = SearchConfig(range_s=RND_RANGE[0], range_e=RND_RANGE[1], **GEOM)
    eng = rnd.RndSearch(cfg, _filter_for(RND_TARGETS), [CPU] * n,
                        seed=RND_SEED, offs=0, size=20)
    assert len(eng.engine.shards) == n
    spans = []
    found = eng.run(max_iters=2, on_range=lambda lo, hi: spans.append(
        (lo, hi)))
    assert spans == draws
    assert [f.priv for f in found] == [k for lo, hi in draws
                                       for k in RND_TARGETS if lo <= k < hi]
    assert eng.engine.k_checked == sum(hi - lo for lo, hi in draws)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_degenerate_range_refused_as_by_add_search(n):
    cfg = SearchConfig(range_s=0x10, range_e=0x500, centers=8, group_k=32)
    filt = _filter_for([0x123])
    with pytest.raises(ValueError, match="collides"):
        add.AddSearch(cfg, filt, CPU).run_span(0, 0x100, lambda o: True)
    with pytest.raises(ValueError, match="collides"):
        add.AddSearch(cfg, filt, [CPU] * n).run_span(
            0, 0x100, lambda o: True)


def test_geometry_that_does_not_split_raises():
    filt = _filter_for([0x123])
    with pytest.raises(ValueError, match="divide"):
        add.AddSearch(SearchConfig(centers=8, group_k=32), filt, [CPU] * 3)
    with pytest.raises(ValueError, match="multiple of 32"):
        add.AddSearch(SearchConfig(centers=8, group_k=8), filt, [CPU] * 4)
    with pytest.raises(ValueError, match="owned"):
        add.AddSearch(SearchConfig(centers=8, group_k=32), filt, [CPU] * 2,
                      owned=[2])
    for n, batch in ((2, 96), (4, 64), (3, 160), (1, 48)):
        with pytest.raises(ValueError, match="multiple of 32"):
            mul.MulSearch(SearchConfig(), filt, [CPU] * n, w=MUL_W,
                          batch=batch)


def test_make_devices():
    assert mesh.make_devices(["cpu", CPU]) == [CPU, CPU]
    assert mesh.make_devices("cpu") == mesh.make_devices(CPU) == [CPU]
    assert mesh.owned_shards(None, 3) == [0, 1, 2]
    assert mesh.owned_shards([2, 1], 3) == [1, 2]
    if not torch.cuda.is_available():
        assert mesh.make_devices() == []


class _Spy:
    """Records the geometry a CLI command gives its engine."""

    def __init__(self, base, seen):
        self.base, self.seen = base, seen

    def __call__(self, cfg, filt, devices, *args, **kw):
        self.seen.append((cfg.centers, len(devices), kw.get("batch")))
        return self.base(cfg, filt, devices, *args, **kw)


def test_cli_t_rounds_centers_and_runs_sharded(monkeypatch, capsys):
    """Over 3 devices a step holds 3 x ECLOOP_CENTERS centers, so each
    device steps the one-device geometry (11 x 1,024 keys)."""
    seen = []
    monkeypatch.setattr(add, "AddSearch", _Spy(add.AddSearch, seen))
    monkeypatch.setenv("ECLOOP_CENTERS", "11")
    monkeypatch.setenv("ECLOOP_GROUP_K", "1024")
    monkeypatch.setenv("ECLOOP_STEPS_PER_CALL", "1")
    run = cli.run_add(cli.Args(["ecloop", "add", "-f", PUZZLES, "-r",
                                "8000:ffff", "-device", "cpu", "-t", "3"]))
    assert seen == [(33, 3, None)]
    assert [f.priv for f in run.found] == [0xC936]
    assert run.k_checked == 0x7FFF and run.device == CPU
    assert capsys.readouterr().out.startswith("devices: 3 ~ ")


def test_cli_t_multiplies_the_mul_batch(monkeypatch, capsys):
    with open(BW_PRIV) as f:
        lines = f.read().splitlines()[:8]
    seen = []
    monkeypatch.setattr(mul, "MulSearch", _Spy(mul.MulSearch, seen))
    monkeypatch.setattr(mul, "W", MUL_W)      # w=14 is too slow to build here
    monkeypatch.setenv("ECLOOP_MUL_BATCH", "64")
    run = cli.run_mul(cli.Args(["ecloop", "mul", "-f", BW_HASH, "-a", "cu",
                                "-device", "cpu", "-t", "3"]), lines)
    assert seen == [(32, 3, 192)]
    assert sorted(f.priv for f in run.found) == sorted(int(ln, 16)
                                                       for ln in lines)
    assert run.k_checked == 8
    assert capsys.readouterr().out.startswith("devices: 3 ~ ")


def test_cli_without_t_on_cpu_is_one_device(capsys):
    assert cli.select_devices(cli.Args(["ecloop", "add", "-device", "cpu"])
                              ) == [CPU]
    assert cli.select_devices(cli.Args(["ecloop", "add", "-device", "cpu",
                                        "-t", "0"])) == [CPU]


class _FakeEvent:
    recorded = []

    def record(self, stream=None):
        self.recorded.append(stream)


class _FakeMasks:
    device = torch.device("cuda", 1)
    shape = (2, 3)
    dtype = torch.int64


def test_fetch_async_records_on_the_masks_device_stream(monkeypatch):
    """The copy of masks on cuda:1 runs on cuda:1's stream whatever the
    current device is; the event that fetched() waits on must be
    recorded there, not on the current device's stream."""
    streams = []
    copies = []

    class Host:
        def copy_(self, t, non_blocking=False):
            copies.append((t, non_blocking))

    monkeypatch.setattr(torch, "empty", lambda *a, **kw: Host())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: streams.append(device) or
                        f"stream of {device}")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.recorded = []
    t = _FakeMasks()
    host, done = common.fetch_async(t)
    assert copies == [(t, True)] and isinstance(done, _FakeEvent)
    assert streams == [torch.device("cuda", 1)]
    assert _FakeEvent.recorded == ["stream of cuda:1"]


class _FakeLib:
    """The kernel library as `kernels._launch` sees it: its runtime's
    current device, and one launcher that records its arguments."""

    def __init__(self, current):
        self.current, self.calls = current, []

    def ecl_current_device(self):
        return self.current

    def ecl_inv_batch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("current,ok", [(1, True), (0, False), (-1, False)])
def test_launch_refuses_another_device_than_the_data(monkeypatch, current,
                                                     ok):
    """A launch for data on cuda:1 runs only when the library's own CUDA
    runtime holds cuda:1 current, on cuda:1's stream."""
    from contextlib import nullcontext

    from ecloop_tpu_torch import _build, kernels

    lib = _FakeLib(current)
    entered = []
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: entered.append(d) or nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type(
        "Stream", (), {"cuda_stream": 1000 + d.index})())
    d1 = torch.device("cuda", 1)
    if ok:
        kernels._launch("ecl_inv_batch", d1, 11, 22, 33)
        assert lib.calls == [(11, 22, 33, 1001)]
    else:
        with pytest.raises(RuntimeError, match="current device"):
            kernels._launch("ecl_inv_batch", d1, 11, 22, 33)
        assert lib.calls == []
    assert entered == [d1]


def test_sharded_add_against_the_jax_package():
    """The found set and key count of the JAX package's ShardedAddSearch
    on a virtual 8-device mesh and of the port's over 8 CPU shards."""
    if os.environ.get("ECLOOP_RUN_SLOW") != "1":
        pytest.skip("compiles the JAX package's shard_map step (100-170 s); "
                    "set ECLOOP_RUN_SLOW=1")
    import jax

    from ecloop_tpu import filters as jfilters
    from ecloop_tpu.parallel.mesh import ShardedAddSearch, make_mesh
    from ecloop_tpu.search.common import SearchConfig as JConfig
    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual 8-device platform of tests/conftest.py")
    rows = _hash_rows(ADD_TARGETS)
    jeng = ShardedAddSearch(JConfig(range_s=0x70000, range_e=0x702A7,
                                    addr33=True, centers=8, group_k=32,
                                    lanes=32),
                            jfilters.filter_from_hashes(rows),
                            make_mesh(jax.devices()[:8]), init="host")
    want = {(f.label, f.priv) for f in jeng.run_range()}
    eng = add.AddSearch(SearchConfig(range_s=0x70000, range_e=0x702A7,
                                     centers=8, group_k=32),
                        filters.filter_from_hashes(rows), [CPU] * 8)
    assert {(f.label, f.priv) for f in eng.run_range()} == want
    assert eng.k_checked == jeng.k_checked == 0x2A7
