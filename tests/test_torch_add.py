"""The port's `add` search against the JAX package's: one device step at
`__graft_entry__.entry()`'s geometry on the same inputs must give
bit-identical masks and next centers in every filter mode, and the
engine and CLI must find the reference's c936 with its key counts."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import golden
from ecloop_tpu import filters as jfilters
from ecloop_tpu.search import add as jadd
from ecloop_tpu_torch import bloom, fel, filters
from ecloop_tpu_torch.search import add
from ecloop_tpu_torch.search.common import SearchConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PUZZLES = os.path.join(ROOT, "data", "btc-puzzles-hash")
sys.path.insert(0, ROOT)
import __graft_entry__ as graft  # noqa: E402

SMALL = dict(centers=32, group_k=1024, steps_per_call=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's own thread pool on
    these small batches only burns the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def entry_setup():
    """entry()'s config, filter and step inputs (4 centers x 64 keys)."""
    cfg, filt, args = graft._small_setup(n_centers=4, group_k=64, lanes=64)
    return cfg, filt, [np.asarray(a) for a in args]


def _blf_filters(tmp_path, targets):
    hs = np.concatenate([targets, np.random.default_rng(1).integers(
        0, 1 << 32, size=(1000, 5), dtype=np.uint64).astype(np.uint32)])
    blf = bloom.BloomFilter.for_count(len(hs))
    blf.add_many(hs)
    path = str(tmp_path / "t.blf")
    blf.save(path)
    return filters.load_filter(path), jfilters.load_filter(path)


@pytest.mark.parametrize("mode,endo,addr65", [
    ("list", True, True),
    ("list", False, False),
    ("pow2", False, False),
    ("pow2", True, False),
    ("bloom", False, False),
])
def test_step_parity_with_jax(entry_setup, tmp_path, monkeypatch, mode,
                              endo, addr65):
    cfg, jfilt, args = entry_setup
    cfg = dataclasses.replace(cfg, endo=endo, addr65=addr65)
    if mode == "pow2":
        monkeypatch.setenv("ECLOOP_CMP_MAX", "0")
    if mode == "bloom":
        filt, jfilt = _blf_filters(tmp_path, jfilt.targets)
        args = args[:6] + [jfilt.device_bits]
    else:
        filt = filters.filter_from_hashes(jfilt.targets)
    assert filt.use_cmp() == (mode == "list")

    jcx, jcy, jmasks = jadd.make_step(cfg, jfilt)(*map(jnp.asarray, args))
    port_cfg = SearchConfig(**{f.name: getattr(cfg, f.name) for f in
                               dataclasses.fields(SearchConfig)})
    step = add.make_step(port_cfg, filt, "cpu")
    cx, cy, masks = step(*add.state_from_numpy(*args, device="cpu"))

    jmasks = np.asarray(jmasks).astype(np.int64)
    assert masks.shape == jmasks.shape == (len(add._variants(cfg)),
                                           cfg.keys_per_step // 32)
    np.testing.assert_array_equal(masks.numpy(), jmasks)
    np.testing.assert_array_equal(fel.to_last(cx), np.asarray(jcx))
    np.testing.assert_array_equal(fel.to_last(cy), np.asarray(jcy))
    # the planted key 0x100025 lies in this first step
    assert masks.numpy()[0].any()


def test_cached_table_matches_jax():
    ours = add._cached_table(1 << 3, 64, 256)
    theirs = jadd._cached_table(1 << 3, 64, 256, "host")
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pack_unpack_mask_roundtrip():
    rng = np.random.default_rng(2)
    bits = rng.random(3 * 256) < 0.1
    packed = filters.pack_mask(torch.from_numpy(bits))
    assert packed.shape == (24,) and int(packed.max()) < 1 << 32
    np.testing.assert_array_equal(add.unpack_mask(packed.numpy()),
                                  bits.astype(np.uint8))
    jwords = np.asarray(jadd._pack_mask(jnp.asarray(bits)))
    np.testing.assert_array_equal(packed.numpy(), jwords.astype(np.int64))


@pytest.mark.parametrize("base,n_keys", [
    (0x8000, 32767), (0x100000, 0x100000), (1, 4096), (golden.N - 300, 600)])
def test_check_no_degenerate_matches_jax(base, n_keys):
    cfg = SearchConfig(**SMALL)
    jcfg = jadd.SearchConfig(centers=cfg.centers, group_k=cfg.group_k)

    def outcome(f, c):
        try:
            f(c, base, n_keys)
            return None
        except ValueError as e:
            return str(e)

    assert (outcome(add.check_no_degenerate, cfg)
            == outcome(jadd.check_no_degenerate, jcfg))


@pytest.mark.parametrize("endo,k_checked", [(False, 32767), (True, 196602)])
def test_add_search_run_range_finds_c936(endo, k_checked):
    filt = filters.load_filter(PUZZLES)
    cfg = SearchConfig(range_s=0x8000, range_e=0xFFFF, endo=endo, **SMALL)
    eng = add.AddSearch(cfg, filt, "cpu")
    found = eng.run_range()
    assert [(f.label, f.priv) for f in found] == [("addr33", 0xC936)]
    assert eng.k_checked == k_checked


def _cli(*argv):
    env = dict(os.environ, ECLOOP_CENTERS="32", ECLOOP_GROUP_K="1024",
               ECLOOP_STEPS_PER_CALL="1", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "ecloop_tpu_torch", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("endo,k_checked", [(False, "32,767"),
                                             (True, "196,602")])
def test_cli_add_on_cpu(endo, k_checked):
    r = _cli("add", "-f", PUZZLES, "-r", "8000:ffff", "-device", "cpu",
             *(["-endo"] if endo else []))
    assert r.returncode == 0, r.stderr
    hits = [ln for ln in r.stdout.splitlines() if ln.startswith("addr")]
    assert hits == [f"addr33: {golden.addr33(golden.point_mul(0xC936)).hex()}"
                    f" <- {0xC936:064x}"]
    assert r.stderr.rstrip().endswith(f"1 / {k_checked}")


def test_cli_refuses_without_gpu_and_unported_commands(capsys):
    """Without a GPU every device command, the bench family included,
    exits non-zero unless -device cpu is given."""
    from ecloop_tpu_torch import cli
    if not torch.cuda.is_available():
        for cmd in ("bench", "bench-gtable", "mult-verify"):
            with pytest.raises(SystemExit) as exc:
                cli.main(["ecloop", cmd])
            assert exc.value.code != 0
            out = capsys.readouterr()
            assert "no CUDA device" in out.err and "M it/s" not in out.out
        with pytest.raises(SystemExit) as exc:
            cli.main(["ecloop", "add", "-f", PUZZLES, "-r", "8000:ffff"])
        assert exc.value.code != 0
        out = capsys.readouterr()
        assert "no CUDA device" in out.err and "addr33" not in out.out
