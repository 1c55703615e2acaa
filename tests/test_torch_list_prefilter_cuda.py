"""The list prefilter past the compare path on the card: K5 and the
fused hash and probe with a filter sized by `bloom.pow2_sizing` (2^21
bits and 6 probes for 10,128 targets) equal their plain forms bit for
bit, over an `add` step's 131,072 keys and the 12 planes of `-endo -a
cu`.  Needs a CUDA GPU; skipped without one.  Imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_list_prefilter_cuda.py
"""

import numpy as np
import pytest
import torch

from ecloop_tpu_torch import bloom, filters, hash160, kernels
from ecloop_tpu_torch.search import add

pytestmark = pytest.mark.cuda

N = 131072
PLANES = [(*add.EMAP[e], f) for e in range(6) for f in (True, False)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _limbs(n, seed, dev):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    a[15] = rng.integers(0, 0xFFFF, size=n)
    return torch.from_numpy(a).to(dev)


def _rows_and_filter(dev, dense):
    """Three x and two y rows of random limbs, every plane's plain hash
    rows, the filter of 10,000 random hashes plus 128 of the planes'
    hashes (so that every plane holds hits) and those 128.  `dense`: the sized
    filter's bits replaced by random ones at fill ~0.75, so that keys
    pass every count of the 6 probes."""
    xs = [_limbs(N, 50 + i, dev) for i in range(3)]
    ys = [_limbs(N, 60 + i, dev) for i in range(2)]
    rows = {p: (hash160.addr33_hash_rows if p[2]
                else hash160.addr65_hash_rows)(xs[p[0]], ys[p[1]])
            for p in PLANES}
    rng = np.random.default_rng(7)
    held = [rng.integers(0, 1 << 32, size=(10000, 5),
                         dtype=np.uint64).astype(np.uint32)]
    for v, p in enumerate(PLANES):
        cols = rng.choice(N, size=11 if v < 8 else 10, replace=False)
        held.append(rows[p][:, torch.from_numpy(cols).to(dev)].cpu().numpy()
                    .T.astype(np.uint32))
    filt = filters.filter_from_hashes(np.concatenate(held))
    assert filt.count == 10128
    assert (filt.pow2_log2, filt.pow2_probes) == (21, 6)
    if dense:
        words = filt.device_bits.size
        r = [rng.integers(0, 1 << 32, size=words, dtype=np.uint64)
             for _ in range(2)]
        filt.device_bits = (r[0] | r[1]).astype(np.uint32)
    return xs, ys, rows, filt, np.concatenate(held[1:])


@pytest.mark.parametrize("dense", [False, True])
def test_sized_list_prefilter_matches_plain(dev, dense):
    xs, ys, rows, filt, planted = _rows_and_filter(dev, dense)
    bits = bloom.bits_tensor(filt.device_bits, dev)
    assert filt.first_words(dev) is None
    out = torch.full((len(PLANES), N // 32), -1, dtype=torch.int64,
                     device=dev)
    kernels.hash160_probe(filt, xs, ys, PLANES, bits, None, out)
    want = torch.stack([filters.probe_pack_plain(filt, rows[p], bits)
                        for p in PLANES])
    assert torch.equal(out, want)
    for v, p in enumerate(PLANES):
        assert torch.equal(kernels.probe_pack(filt, rows[p], bits), want[v])
    hits = [int(np.unpackbits(w.cpu().numpy().astype("<u4").view(
        np.uint8)).sum()) for w in want]
    if dense:
        # 0.75^6 of the keys pass: deep probe groups on every plane
        assert all(N // 10 < h < N // 4 for h in hits)
    else:
        # the keys whose hash is a planted one (a plane's planted hash
        # recurs in another plane where the two share x and y's parity
        # or y), and at ~5e-10 a key no false positive
        exact = []
        for p in PLANES:
            r = rows[p].cpu().numpy().T.astype(np.uint32)
            cand = r[np.isin(r[:, 0], planted[:, 0])]
            exact.append(sum(bool((c == planted).all(axis=1).any())
                             for c in cand))
        assert hits == exact and sum(hits) >= 128
