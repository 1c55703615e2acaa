"""The benchmark's bloom filter build against the port's blf-gen."""

import os

import numpy as np
import pytest
import torch

from ecloop_tpu_torch import bloom as port_bloom
from keybench import targets
from keybench.reference import bloom


def _hashes(n, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, (n, 5),
                                                dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 160, 1000])
def test_bloom_bits_equal_blf_gen(n, tmp_path):
    rows = _hashes(n, n)
    blf = port_bloom.BloomFilter.for_count(n)
    blf.add_new(rows)
    size = bloom.size_words(n)
    assert size == blf.size
    h = torch.from_numpy(rows.astype(np.int64).T.copy())
    # in two parts, as the harness adds the planted hashes
    bits = targets.bloom_bytes([h[:, :n // 2], h[:, n // 2:]], size).numpy()
    assert bits.tobytes() == blf.bits.astype("<u8").tobytes()
    mine, theirs = tmp_path / "a.blf", tmp_path / "b.blf"
    targets.write_blf(str(mine), bits)
    blf.save(str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    assert targets.fill(torch.from_numpy(bits)) == pytest.approx(
        np.unpackbits(bits).mean())


def test_reference_membership_equals_the_ports():
    rows = _hashes(500, 9)
    blf = port_bloom.BloomFilter.for_count(500)
    blf.add_new(rows[:300])
    bits = blf.bits.astype("<u8").view(np.uint8)
    probe = np.concatenate([rows[:300], rows[300:]])
    want = blf.has_many(probe)
    got = [bloom.member(b"".join(int(w).to_bytes(4, "big") for w in r), bits)
           for r in probe]
    assert got == list(want) and all(want[:300])


def test_words_of_hash_bytes():
    h = bytes(range(20))
    assert targets.words_of([h], "cpu")[:, 0].tolist() == bloom.words(h)


def test_list_file_round_trips_through_the_port(tmp_path):
    from ecloop_tpu_torch import filters

    hs = [bytes([i]) * 20 for i in range(5)]
    path = os.path.join(tmp_path, "t.txt")
    targets.write_list(path, hs)
    filt = filters.load_filter(path)
    assert filt.count == 5 and all(filt.confirm(h) for h in hs)
