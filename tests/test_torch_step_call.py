"""The port's one-dispatch calls against the JAX package's on the CPU:
`search.add.build_step_fn` (T steps per call) and `search.mul.build_mul_step`
give the JAX calls' masks and next centers bit for bit, the compare-mode
probe gives the JAX probe's mask with no sort or unique (so a CUDA graph
can capture it), a graph's launches are counted at each replay, and the
engine's static masks survive the next call."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ecloop_tpu import filters as jfilters
from ecloop_tpu import golden
from ecloop_tpu.search import add as jadd
from ecloop_tpu.search import mul as jmul
from ecloop_tpu.search.common import SearchConfig as JSearchConfig
from ecloop_tpu_torch import bloom, fel, filters, graphs, kernels
from ecloop_tpu_torch.search import add, mul
from ecloop_tpu_torch.search.common import SearchConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import __graft_entry__ as graft  # noqa: E402

T = 2
W, BATCH = 8, 32


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


def _h160(key, compressed=True):
    pt = golden.point_mul(key)
    h = golden.addr33(pt) if compressed else golden.addr65(pt)
    return np.frombuffer(h, dtype=">u4").astype(np.uint32)


@pytest.mark.parametrize("mode", ["list", "pow2", "bloom"])
def test_build_step_fn_matches_jax(entry_setup, tmp_path, monkeypatch, mode):
    """One call of T = 2 steps: the (T, V, words) masks and the next
    centers equal the JAX `build_step_fn`'s (its eager T-step loop on
    the CPU).  List mode runs -endo with addr65 alone (6 variants; the
    JAX package's eager step takes about a second per variant here) on
    planted keys: a plain hit in step 0 and an endo-3 hit in step 1."""
    cfg, jfilt, args = entry_setup
    cfg = dataclasses.replace(cfg, steps_per_call=T)
    hits = [(0, 0x100025, 0), (1, 0x100125, 3)]       # (step, key, endo)
    if mode == "list":
        cfg = dataclasses.replace(cfg, endo=True, addr33=False, addr65=True)
        jfilt = jfilters.filter_from_hashes(np.concatenate([jfilt.targets, [
            _h160(golden.endo_priv(k, e), False) for _, k, e in hits]]))
        args = args[:6] + [jfilt.device_bits]
    if mode == "pow2":
        monkeypatch.setenv("ECLOOP_CMP_MAX", "0")
    if mode == "bloom":
        filt, jfilt = _blf_filters(tmp_path, jfilt.targets)
        args = args[:6] + [jfilt.device_bits]
    else:
        filt = filters.filter_from_hashes(jfilt.targets)
    assert filt.use_cmp() == (mode == "list")

    jcx, jcy, jmasks = jadd.build_step_fn(cfg, jfilt)(*map(jnp.asarray, args))
    port_cfg = SearchConfig(**{f.name: getattr(cfg, f.name) for f in
                               dataclasses.fields(SearchConfig)})
    call = add.build_step_fn(port_cfg, filt, "cpu", table=args[2:6])
    call.seed(*(fel.from_last(a, "cpu") for a in args[:2]))
    call()
    jmasks = np.asarray(jmasks).astype(np.int64)
    assert call.masks.shape == jmasks.shape == (
        T, len(add._variants(cfg)), cfg.keys_per_step // 32)
    np.testing.assert_array_equal(call.masks.numpy(), jmasks)
    np.testing.assert_array_equal(fel.to_last(call.cx), np.asarray(jcx))
    np.testing.assert_array_equal(fel.to_last(call.cy), np.asarray(jcy))
    if mode == "list":
        for t, key, e in hits:
            j = key - 0x100000 - t * cfg.keys_per_step
            assert add.unpack_mask(jmasks[t, e])[j]
    else:                        # the planted addr33 key 0x100025, step 0
        assert jmasks[0, 0].any()


@pytest.fixture(scope="module")
def jax_table(tmp_path_factory):
    """The JAX package's host-built w=8 table (its disk cache kept in a
    temporary directory)."""
    os.environ["ECLOOP_CACHE_DIR"] = str(tmp_path_factory.mktemp("cache"))
    try:
        tx, ty = jmul.build_gtable(W, how="host")
    finally:
        del os.environ["ECLOOP_CACHE_DIR"]
    return np.asarray(tx), np.asarray(ty)


def test_build_mul_step_matches_jax(jax_table):
    """One job of both address forms, padded, through the port's call and
    the JAX `build_mul_step`: the same masks, again after an upload of no
    keys (every lane zeroed) in between."""
    planted = [3, 0x123456789ABCDEF, golden.N - 5]
    keys = planted + [golden.N, 0xDEADBEEF, 1 << 200] + list(range(7, 27))
    jfilt = jfilters.filter_from_hashes(np.stack(
        [_h160(k) for k in planted[:2]] + [_h160(planted[2], False)]))
    filt = filters.filter_from_hashes(jfilt.targets)
    dig = np.zeros((mul.n_windows(W), BATCH), dtype=np.int32)
    dig[:, :len(keys)] = mul.window_digits(keys, W).T
    jmasks = jmul.build_mul_step(
        JSearchConfig(addr33=True, addr65=True, lanes=BATCH), jfilt, W, BATCH)(
        jnp.asarray(dig.astype(np.uint16)),
        jmul.interleave_gtable(*map(jnp.asarray, jax_table)),
        jnp.asarray(jfilt.device_bits))
    jmasks = np.asarray(jmasks).astype(np.int64)
    call = mul.build_mul_step(SearchConfig(addr33=True, addr65=True), filt, W,
                              BATCH, "cpu",
                              table=mul.gtable_from_numpy(*jax_table, "cpu"))
    words = mul.words_mod_n(mul.keys_to_words(keys))
    for job in (words, words[:0], words):
        call.upload(mul.WordsJob(job))
        call()
    np.testing.assert_array_equal(call.masks.numpy(), jmasks)
    assert mul.unpack_mask(jmasks[0])[:2].all()
    assert mul.unpack_mask(jmasks[1])[2]


def _probe_case(n, seed):
    """n targets, some sharing a first word, and hash words that hit the
    least and the greatest first word, fall below and above them all,
    hit shared first words, and random ones."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, (1 << 32) - 1, size=(n, 5), dtype=np.uint64)
    t = t.astype(np.uint32)
    if n > 1:
        t[1::7, 0] = t[0, 0]                     # duplicated first words
    h = rng.integers(0, 1 << 32, size=(256, 5), dtype=np.uint64).astype(
        np.uint32)
    fw = np.unique(t[:, 0])
    h[0, 0], h[1, 0] = fw[0], fw[-1]
    h[2, 0], h[3, 0] = fw[0] - 1, fw[-1] + 1
    h[4, 0], h[5, 0] = 0, 0xFFFFFFFF
    h[6:6 + min(n, 50), 0] = t[:50, 0]
    return t, h


@pytest.mark.parametrize("n", [1, 40, 160, 1080, 2048])
def test_compare_probe_matches_jax(n):
    t, h = _probe_case(n, n)
    jfilt = jfilters.filter_from_hashes(t)
    filt = filters.filter_from_hashes(t)
    assert filt.use_cmp()
    want = np.asarray(jfilt.device_probe(jnp.asarray(h)))
    got = filt.device_probe(torch.from_numpy(h.T.astype(np.int64)),
                            bloom.bits_tensor(filt.device_bits, "cpu"),
                            filt.first_words("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:4].tolist() == [True, True, False, False]
    assert want[6:6 + min(n, 50)].all()


def test_compare_probe_runs_no_sort_or_unique():
    """The compare probe over 131,072 hash words and the 1,080 first
    words of the `mul` vector's size dispatches no data-dependent ATen
    op (torch.isin runs _unique and sort there)."""
    t, _ = _probe_case(1080, 5)
    filt = filters.filter_from_hashes(t)
    h = torch.from_numpy(np.random.default_rng(6).integers(
        0, 1 << 32, size=(5, 131072), dtype=np.int64))
    bits, fw = bloom.bits_tensor(filt.device_bits, "cpu"), filt.first_words("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        filt.device_probe(h, bits, fw)
    names = {e.key for e in prof.key_averages()}
    assert "aten::searchsorted" in names
    assert not {n for n in names if "unique" in n or n.endswith("sort")}, names


def test_graph_counts_recorded_launches_per_replay():
    """Launches made while recording are noted, not counted; each call
    of `count_launches` (a replay) counts them again.  On the CPU a
    `graphs.Graph` runs its iterations in order and captures nothing."""
    kernels.reset_launches()
    with kernels.recording() as rec:
        kernels._count("hash160", 7)
        kernels._count("hash160", 7)
        kernels._count("inv_mod_batch", 9)
    assert rec == [("hash160", 7), ("hash160", 7), ("inv_mod_batch", 9)]
    assert kernels.LAUNCHES == {"hash160": 0, "inv_mod_batch": 0,
                                "mixed_add": 0, "add_chords": 0,
                                "probe_pack": 0, "hash160_probe": 0,
                                "mul_keys": 0}
    for _ in range(3):
        kernels.count_launches(rec)
    assert kernels.LAUNCHES == {"hash160": 6, "inv_mod_batch": 3,
                                "mixed_add": 0, "add_chords": 0,
                                "probe_pack": 0, "hash160_probe": 0,
                                "mul_keys": 0}
    assert 7 in kernels.WIDTHS["hash160"] and 9 in kernels.WIDTHS["inv_mod_batch"]
    kernels.reset_launches()
    seen = []
    g = graphs.Graph(seen.append, "cpu", iters=3)
    assert seen == [] and g.launches == [] and g.capture_s == 0.0
    g()
    g()
    assert seen == [0, 1, 2, 0, 1, 2]


def test_add_search_keeps_each_calls_masks():
    """Two calls of T = 2 steps with a planted key in each, drained one
    call late from the static masks; then the same engine re-seeded on
    a sub-range (`rnd`'s case) finds the key inside it."""
    keys = [0x100025, 0x1003F0]
    filt = filters.filter_from_hashes(np.stack([_h160(k) for k in keys]))
    cfg = SearchConfig(range_s=0x100000, range_e=0x100400, centers=4,
                       group_k=64, steps_per_call=T)
    eng = add.AddSearch(cfg, filt, "cpu")
    assert sorted(f.priv for f in eng.run_range()) == keys
    assert [f.priv for f in eng.run_range(range_s=0x100200,
                                          range_e=0x100400)] == keys[1:]
    assert eng.k_checked == 0x400 + 0x200
