"""The CUDA kernels against their plain versions on the card (bit-exact).
Needs a CUDA GPU; skipped without one.  Imports no jax, so it also runs
where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from ecloop_tpu_torch import fel, filters, hash160, kernels
from ecloop_tpu_torch.search import add
from ecloop_tpu_torch.search.common import SearchConfig

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("n", [131072, 1031, 1])
def test_hash160_kernel_matches_plain(dev, n):
    x, y = _limbs(n, 1, dev), _limbs(n, 2, dev)
    before = kernels.LAUNCHES["hash160"]
    for k, p in ((kernels.addr33_hash_rows, hash160.addr33_hash_rows),
                 (kernels.addr65_hash_rows, hash160.addr65_hash_rows)):
        assert torch.equal(k(x, y), p(x, y))
    assert kernels.LAUNCHES["hash160"] == before + 2


@pytest.mark.parametrize("n", [65568, 1000, 33, 1])
def test_inv_kernel_matches_plain(dev, n):
    x = _limbs(n, 3, dev)
    x[:, : min(n, 3)] = 0
    got = kernels.inv_mod_batch(x)
    assert torch.equal(got, fel.inv_mod_batch(x))
    v = fel.tensor_to_ints(x[:, -1:])[0]
    assert fel.tensor_to_ints(got[:, -1:])[0] == (pow(v, fel.P - 2, fel.P)
                                                 if v else 0)


def test_kernel_rejects_non_contiguous(dev):
    x = _limbs(64, 4, dev)[:, ::2]
    with pytest.raises(ValueError):
        kernels.inv_mod_batch(x)


def test_step_on_card_matches_cpu(dev):
    filt = filters.load_filter(os.path.join(os.path.dirname(__file__), "..", "data",
                                           "btc-puzzles-hash"))
    cfg = SearchConfig(range_s=0x8000, range_e=0x10000, endo=True,
                       addr65=True, centers=8, group_k=256)
    tx, ty, dpx, dpy = add._cached_table(cfg.stride, cfg.group_k,
                                         cfg.keys_per_step)
    cx, cy = add.center_points(cfg, 0x8000)
    outs = []
    for d in ("cpu", dev):
        step = add.make_step(cfg, filt, d)
        state = add.state_from_numpy(cx, cy, tx, ty, dpx, dpy,
                                     filt.device_bits, d)
        outs.append([t.cpu() for t in step(*state)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
