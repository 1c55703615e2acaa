"""The port's filters and host bookkeeping against the JAX package's:
ECBF bytes, pow2 prefilter bits, the device probe in all three modes,
and the copied claim / key-recovery / -d helpers.  Bit-exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import bloom as jbloom
from ecloop_tpu import filters as jfilters
from ecloop_tpu import golden, native
from ecloop_tpu.search import common as jcommon
from ecloop_tpu.search import rnd as jrnd
from ecloop_tpu_torch import bloom, filters
from ecloop_tpu_torch.search import common

PUZZLES = os.path.join(os.path.dirname(__file__), "..", "data",
                       "btc-puzzles-hash")


def _hashes(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 5), dtype=np.uint64).astype(
        np.uint32)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("native host library not built")
    return request.param


def test_ecbf_bytes_identical(tmp_path, host_path):
    hs = _hashes(3000, 1)
    ours, theirs = bloom.BloomFilter.for_count(3000), jbloom.BloomFilter.for_count(3000)
    ours.add_many(hs)
    theirs.add_many(hs)
    ours.save(str(tmp_path / "a.blf"))
    theirs.save(str(tmp_path / "b.blf"))
    a = (tmp_path / "a.blf").read_bytes()
    assert a == (tmp_path / "b.blf").read_bytes()
    back = bloom.BloomFilter.load(str(tmp_path / "b.blf"))
    np.testing.assert_array_equal(back.bits, theirs.bits)
    probe = np.concatenate([hs[:50], _hashes(200, 2)])
    np.testing.assert_array_equal(back.has_many(probe), theirs.has_many(probe))
    np.testing.assert_array_equal(back.as_u32(), theirs.as_u32())
    assert (bloom.adaptive_probe_count(back.bits)
            == jbloom.adaptive_probe_count(theirs.bits))


def test_ecbf_load_rejects_bad_header(tmp_path):
    p = tmp_path / "bad.blf"
    p.write_bytes(b"XXXX" + bytes(12))
    with pytest.raises(ValueError):
        bloom.BloomFilter.load(str(p))


@pytest.mark.parametrize("n,log2", [(160, None), (5000, None), (10, 20)])
def test_build_pow2_and_probe_indices_identical(n, log2):
    hs = _hashes(n, 3)
    np.testing.assert_array_equal(bloom.probe_indices_host(hs),
                                  jbloom.probe_indices_host(hs))
    ours, l_ours = bloom.build_pow2(hs, log2)
    theirs, l_theirs = jbloom.build_pow2(hs, log2)
    assert l_ours == l_theirs
    np.testing.assert_array_equal(ours, theirs)


def test_probe_pairs_are_the_host_indices():
    hs = _hashes(500, 9)
    pairs = bloom._probe_pairs(torch.from_numpy(hs.T.astype(np.int64)), 20)
    got = np.stack([(hi.numpy().astype(np.uint64) << np.uint64(32))
                    | lo.numpy().astype(np.uint64) for hi, lo in pairs], -1)
    np.testing.assert_array_equal(got, bloom.probe_indices_host(hs))


def _probe_inputs(targets, n=4000, seed=4):
    """Random hash words with every target and near-misses mixed in."""
    hs = _hashes(n, seed)
    hs[:len(targets)] = targets
    near = targets.copy()
    near[:, 4] ^= 1                      # same first word, other hash
    hs[len(targets):2 * len(targets)] = near
    return hs


def _compare_device_probe(ours: filters.Filter, theirs, hs):
    got = ours.device_probe(torch.from_numpy(hs.T.astype(np.int64)),
                            bloom.bits_tensor(ours.device_bits, "cpu"),
                            ours.first_words("cpu"))
    want = np.asarray(theirs.device_probe(jnp.asarray(hs)))
    np.testing.assert_array_equal(got.numpy(), want)
    return got


def test_device_probe_compare_mode():
    ours = filters.load_filter(PUZZLES)
    theirs = jfilters.load_filter(PUZZLES)
    np.testing.assert_array_equal(ours.targets, theirs.targets)
    assert ours.use_cmp() and theirs._use_cmp()
    got = _compare_device_probe(ours, theirs, _probe_inputs(ours.targets))
    assert int(got.sum()) >= 2 * len(ours.targets)


def test_device_probe_pow2_mode(monkeypatch):
    monkeypatch.setenv("ECLOOP_CMP_MAX", "0")
    ours = filters.load_filter(PUZZLES)
    theirs = jfilters.load_filter(PUZZLES)
    assert not ours.use_cmp() and not theirs._use_cmp()
    np.testing.assert_array_equal(ours.device_bits, theirs.device_bits)
    got = _compare_device_probe(ours, theirs, _probe_inputs(ours.targets))
    assert int(got[:len(ours.targets)].sum()) == len(ours.targets)


def test_device_probe_exact_mode(tmp_path):
    targets = _hashes(500, 5)
    blf = bloom.BloomFilter.for_count(500)
    blf.add_many(targets)
    path = str(tmp_path / "t.blf")
    blf.save(path)
    ours, theirs = filters.load_filter(path), jfilters.load_filter(path)
    assert ours.mode == theirs.mode == "bloom"
    assert ours.blf_probes == theirs.blf_probes
    got = _compare_device_probe(ours, theirs, _probe_inputs(targets))
    assert bool(got[:500].all())


@pytest.mark.parametrize("size_words,log2", [(7, 16), (1 << 20, 22)])
def test_probes_on_dense_bits(size_words, log2):
    """Dense random bit arrays, so that both outcomes occur on every
    probe index, against the JAX probes (exact with all 20 probes)."""
    rng = np.random.default_rng(6)
    hs = _hashes(3000, 7)
    bits = rng.integers(0, 1 << 32, size=size_words * 2, dtype=np.uint64)
    bits = (bits | rng.integers(0, 1 << 32, size=bits.size,
                                dtype=np.uint64)).astype(np.uint32)
    h = torch.from_numpy(hs.T.astype(np.int64))
    bt = bloom.bits_tensor(bits, "cpu")
    got = bloom.probe_exact(h, bt, nbits=size_words * 64, nprobes=20)
    want = jbloom.probe_exact(jnp.asarray(hs), jnp.asarray(bits),
                              nbits=size_words * 64, nprobes=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < len(hs)
    pbits = rng.integers(0, 1 << 32, size=(1 << log2) // 32,
                         dtype=np.uint64).astype(np.uint32)
    got = bloom.probe_pow2(h, bloom.bits_tensor(pbits, "cpu"), log2, 3)
    want = jbloom.probe_pow2(jnp.asarray(hs), jnp.asarray(pbits), log2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_confirm_list_and_bloom(tmp_path, host_path):
    ours = filters.load_filter(PUZZLES)
    key_hash = golden.addr33(golden.point_mul(0xC936))
    assert ours.confirm(key_hash)
    assert not ours.confirm(golden.addr65(golden.point_mul(0xC936)))
    blf = bloom.BloomFilter.for_count(16)
    blf.add_many(np.frombuffer(key_hash, dtype=">u4").astype(np.uint32)[None])
    path = str(tmp_path / "one.blf")
    blf.save(path)
    assert filters.load_filter(path).confirm(key_hash)


def test_filter_from_hashes_sorted_unique():
    hs = _hashes(50, 8)
    hs = np.concatenate([hs, hs[:10]])
    ours = filters.filter_from_hashes(hs)
    theirs = jfilters.filter_from_hashes(hs)
    np.testing.assert_array_equal(ours.targets, theirs.targets)
    np.testing.assert_array_equal(ours.device_bits, theirs.device_bits)
    assert ours.count == 50


@pytest.mark.parametrize("rs,re_,job,stride", [
    (0x8000, 0xFFFFFF, None, 1),
    (0x8000, 0xFFFF, None, 1),
    (0x10001, 0x10400, 100, 1),
    (0x2000000, 0x2000000 + (0x400 << 16), None, 1 << 16),
    (golden.N - 5000, golden.N - 1, 1000, 1),
])
def test_plan_claims_identical(rs, re_, job, stride):
    job = job or common.derive_job_size(rs, re_)
    assert job == (job or jcommon.derive_job_size(rs, re_))
    ours = [(c.start, c.job, c.coverage)
            for c in common.plan_claims(rs, re_, job, stride)]
    theirs = [(c.start, c.job, c.coverage)
              for c in jcommon.plan_claims(rs, re_, job, stride)]
    assert ours == theirs and ours


def test_recover_priv_identical():
    for e in range(6):
        for base, off, stride in ((0x8000, 0x4936, 1), (golden.N - 3, 7, 2),
                                  (0x123456789, 99, 1 << 20)):
            assert (common.recover_priv(base, off, stride, e)
                    == jcommon.recover_priv(base, off, stride, e))


@pytest.mark.parametrize("range_e", [0xFFFF, 0xFFFFFF, 1 << 70, golden.P])
@pytest.mark.parametrize("offs,size", [(None, None), (0, 20), (3, None),
                                       (300, 32), (0, 65), (200, 40)])
def test_default_offs_size_identical(range_e, offs, size):
    def call(f):
        try:
            return f(range_e, offs, size, jrnd.Rng("1"), is_rnd=False)
        except ValueError as e:
            return str(e)

    assert call(common.default_offs_size) == call(jrnd.default_offs_size)


def test_verify_found_raises_on_bad_hash():
    h = common.derive_h160(0xC936, True)
    common.verify_found(0xC936, "addr33", h)
    with pytest.raises(AssertionError):
        common.verify_found(0xC936, "addr33", "00" * 20)
