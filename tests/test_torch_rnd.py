"""The port's `rnd` mode against the JAX package's: the seeded draws,
the range masks and the -d defaults equal `ecloop_tpu.search.rnd`'s;
RndSearch finds planted keys in one full pass; a stub engine pins the
loop's call order, its resume cursor and its stop; the CLI prints the
reference's lines.  `center_points`' add chain equals the JAX package's
per-center host form (`points_from_scalars(..., "host")`) limb for limb."""

import os
import re

import numpy as np
import pytest
import torch

from ecloop_tpu import cli as jcli
from ecloop_tpu import golden
from ecloop_tpu.search import add as jadd
from ecloop_tpu.search import rnd as jrnd
from ecloop_tpu_torch import cli, filters
from ecloop_tpu_torch.search import add, common, rnd
from ecloop_tpu_torch.search.common import SearchConfig

# one step covers a 2^13-key range: on the CPU every step pays a Fermat
# chain of plain torch ops (about 0.75 s), whatever its width
SMALL = dict(centers=4, group_k=2048, steps_per_call=1)
PUZZLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "data", "btc-puzzles-hash")
SEEDS = ["", "s", "abc", "test-seed", "resume-seed", "20261016", "ключ"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _filter_for(keys):
    rows = [np.frombuffer(bytes.fromhex(common.derive_h160(k, True)),
                          dtype=">u4").astype(np.uint32) for k in keys]
    return filters.filter_from_hashes(np.stack(rows))


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_draws_match_jax(seed):
    assert rnd.encode_seed(seed) == jrnd.encode_seed(seed)
    ours, theirs = rnd.Rng(seed), jrnd.Rng(seed)
    assert ours.seeded and theirs.seeded
    assert ([ours.rand64() for _ in range(64)]
            == [theirs.rand64() for _ in range(64)])
    for a, b in ((0x8000, 0xFFFFFF), (1, 2), (5, 5), (0x2000, golden.P)):
        assert ([ours.rand_range(a, b) for _ in range(64)]
                == [theirs.rand_range(a, b) for _ in range(64)])
    for a, b, offs, size in ((0x8000, 0xFFFFFF, 0, 20),
                             (0x100000, 0x1FFFFF, 3, 20),
                             (1 << 70, (1 << 71) - 1, 40, 32),
                             (0x2000, golden.P, 200, 40)):
        ours, theirs = rnd.Rng(seed), jrnd.Rng(seed)
        assert ([rnd.gen_random_range(ours, a, b, offs, size)
                 for _ in range(32)]
                == [jrnd.gen_random_range(theirs, a, b, offs, size)
                    for _ in range(32)])


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("range_e", [0xFFFF, 0xFFFFFF, 1 << 70, golden.P])
def test_default_offs_size_rnd_matches_jax(seed, range_e):
    ours = [common.default_offs_size(range_e, None, None, rnd.Rng(seed),
                                     is_rnd=True) for _ in range(3)]
    theirs = [jrnd.default_offs_size(range_e, None, None, jrnd.Rng(seed),
                                     is_rnd=True) for _ in range(3)]
    assert ours == theirs
    r1, r2 = rnd.Rng(seed), jrnd.Rng(seed)
    assert ([common.default_offs_size(range_e, None, None, r1, True)
             for _ in range(16)]
            == [jrnd.default_offs_size(range_e, None, None, r2, True)
                for _ in range(16)])


def test_unseeded_rng_draws_entropy():
    r = rnd.Rng(None)
    assert not r.seeded
    draws = {r.rand64() for _ in range(8)}
    assert len(draws) == 8 and all(0 <= d < 1 << 64 for d in draws)


@pytest.mark.parametrize("color", [False, True])
def test_format_range_mask_matches_jax(color):
    rng = np.random.default_rng(3)
    for offs, size in ((0, 20), (0, 24), (3, 20), (40, 32), (200, 55),
                       (236, 20)):
        for _ in range(4):
            v = int.from_bytes(rng.bytes(32), "big")
            assert (rnd.format_range_mask(v, offs, size, color)
                    == jrnd.format_range_mask(v, offs, size, color))


def test_rnd_search_finds_planted_keys_in_one_pass():
    """A 2^20-bit window over a 2^13-key range clamps every draw to the
    whole range: one full pass that finds every planted key."""
    rs = 0x50000
    targets = [rs + 5, 0x51234, rs + (1 << 13) - 1]
    cfg = SearchConfig(range_s=rs, range_e=rs + (1 << 13), **SMALL)
    eng = rnd.RndSearch(cfg, _filter_for(targets), "cpu", seed="abc",
                        offs=0, size=20)
    iters = []
    found = eng.run(max_iters=4, on_iter=lambda i, lo, hi, got:
                    iters.append((i, lo, hi)))
    assert (eng.offs, eng.size) == (0, 20)
    assert iters == [(1, cfg.range_s, cfg.range_e)]
    assert sorted(f.priv for f in found) == targets
    assert eng.engine.k_checked == 1 << 13


class StubEngine:
    """Records run_range's sub-ranges and the order of the callbacks."""

    def __init__(self, log):
        self.log = log
        self.k_checked = 0

    def run_range(self, on_found=None, range_s=None, range_e=None):
        self.log.append(("search", range_s, range_e))
        self.k_checked += range_e - range_s
        return []


def _stub_rnd(cfg, seed, log, offs=0, size=20):
    eng = rnd.RndSearch(cfg, _filter_for([0x9000]), "cpu", seed=seed,
                        offs=offs, size=size)
    eng.engine = StubEngine(log)
    return eng


def test_rnd_call_order_and_draws():
    cfg = SearchConfig(range_s=0x8000, range_e=0xFFFFFF, **SMALL)
    log = []
    eng = _stub_rnd(cfg, "order", log)
    eng.run(max_iters=5,
            on_range=lambda lo, hi: log.append(("range", lo, hi)),
            on_iter=lambda i, lo, hi, got: log.append(("iter", i, lo, hi)))
    r = jrnd.Rng("order")
    want = []
    for i in range(5):
        lo, hi = jrnd.gen_random_range(r, 0x8000, 0xFFFFFF, 0, 20)
        want += [("range", lo, hi), ("search", lo, hi), ("iter", i + 1, lo, hi)]
    assert log == want


def test_rnd_skip_iters_resumes_at_the_next_draw():
    cfg = SearchConfig(range_s=0x100000, range_e=0x1FFFFFFF, **SMALL)
    full, resumed = [], []
    _stub_rnd(cfg, "resume-seed", full).run(max_iters=6)
    _stub_rnd(cfg, "resume-seed", resumed).run(max_iters=6, skip_iters=3)
    assert len(full) == 6 and resumed == full[3:]


def test_rnd_full_window_draw_stops_the_loop():
    cfg = SearchConfig(range_s=0x8000, range_e=0xFFFF, **SMALL)
    log = []
    _stub_rnd(cfg, "s", log).run()
    assert log == [("search", 0x8000, 0xFFFF)]
    # a resume past the single pass searches nothing
    log.clear()
    _stub_rnd(cfg, "s", log).run(skip_iters=1)
    assert log == []


def test_cli_rnd_prints_banner_masks_and_iteration_line(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_CENTERS", str(SMALL["centers"]))
    monkeypatch.setenv("ECLOOP_GROUP_K", str(SMALL["group_k"]))
    monkeypatch.setenv("ECLOOP_STEPS_PER_CALL", "1")
    target = 0x10111
    path = tmp_path / "targets.txt"
    path.write_text(common.derive_h160(target, True) + "\n")
    out = tmp_path / "found.txt"
    assert cli.main(["ecloop", "rnd", "-f", str(path), "-r", "10000:10400",
                     "-d", "0:20", "-seed", "s", "-device", "cpu", "-q",
                     "-o", str(out)]) == 0
    stdout = capsys.readouterr().out
    assert "[random mode] offs: 0 ~ bits: 20\n" in stdout
    assert ("0000000000000000 0000000000000000 0000000000000000 "
            "0000000000010000\n0000000000000000 0000000000000000 "
            "0000000000000000 0000000000010400\n") in stdout
    assert re.search(r"^1 / 1,024 ~ \d+\.\ds$", stdout, re.M)
    assert out.read_text().split("\t")[2].strip() == f"{target:064x}"


@pytest.mark.parametrize("seed", ["s", "abc"])
@pytest.mark.parametrize("range_e", [0xFFFFFF, 1 << 70, golden.P])
def test_cli_rnd_offset_from_seed_matches_jax(seed, range_e):
    argv = ["ecloop", "rnd", "-seed", seed]
    ours = cli.parse_offs_size(cli.Args(argv), range_e, "rnd", rnd.Rng(seed))
    theirs = jcli.parse_offs_size(jcli.Args(argv), range_e, "rnd",
                                  jrnd.Rng(seed))
    assert ours == theirs


@pytest.mark.parametrize("cmd,endo", [("add", True), ("rnd", True),
                                      ("mul", False)])
def test_cli_endo_applies_to_add_and_rnd(cmd, endo, capsys):
    cfg = cli.search_config(cli.Args(
        ["ecloop", cmd, "-f", PUZZLES, "-r", "8000:ffff",
         "-endo"]), cmd)[0]
    assert cfg.endo == endo
    assert f"~ endo: {int(endo)} |" in capsys.readouterr().out


def test_cli_rnd_without_gpu_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        cli.main(["ecloop", "rnd", "-f", PUZZLES,
                  "-r", "8000:ffff"])
    assert exc.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("centers,group_k,offs,bits", [
    (4, 64, 0, 71), (4, 64, 0, 256), (4, 64, 20, 71), (4, 64, 20, 256),
    (4, 64, 40, 71), (4, 64, 40, 256), (32, 4096, 0, 71),
    (32, 4096, 40, 71)])
def test_center_points_chain_equals_per_center(centers, group_k, offs, bits):
    cfg = SearchConfig(centers=centers, group_k=group_k, stride_offs=offs)
    rng = np.random.default_rng(bits * 1000 + offs + centers)
    base = int.from_bytes(rng.bytes(32), "big") % (1 << bits) | 1 << (bits - 1)
    h = group_k // 2
    want = jadd.points_from_scalars([(base + (m * group_k + h) * cfg.stride)
                                     % golden.N for m in range(centers)],
                                    "host")
    got = add.center_points(cfg, base)
    for a, b in zip(got, want):
        assert torch.equal(torch.from_numpy(a.astype(np.int64)),
                           torch.from_numpy(np.asarray(b).astype(np.int64)))


def test_center_points_through_infinity():
    """A center at key 0 is (0, 0) in the chain and in the JAX package's
    per-center form, and the chain goes on past it exactly."""
    cfg = SearchConfig(centers=4, group_k=64, stride_offs=3)
    base = golden.N - (64 + 32) * cfg.stride        # center 1 is key 0
    want = jadd.points_from_scalars([(base + (m * 64 + 32) * cfg.stride)
                                     % golden.N for m in range(4)], "host")
    got = add.center_points(cfg, base)
    assert not got[0][1].any() and not got[1][1].any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
