"""The CUDA kernels against their plain versions on the card (bit-exact).
Needs a CUDA GPU; skipped without one.  Imports no jax, so it also runs
where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from ecloop_tpu_torch import ecc, fel, filters, golden, hash160, kernels
from ecloop_tpu_torch.search import add, mul
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


@pytest.mark.parametrize("n", [65568, 32768, 155629, 1000, 33, 1])
def test_inv_kernel_matches_plain(dev, n):
    """The main path's K2 widths (an `add` step, a `mul` job, the widest
    table-build round) and ragged ones, with zeros first and, where the
    batch spans several blocks, across a block edge, over one whole block
    and last."""
    x = _limbs(n, 3, dev)
    x[:, : min(n, 3)] = 0
    blk = kernels.inv_block_elements()
    if n > 4 * blk:
        x[:, blk - 5:blk + 5] = 0
        x[:, 2 * blk:3 * blk] = 0
        x[:, -3:] = 0
    before = kernels.LAUNCHES["inv_mod_batch"]
    got = kernels.inv_mod_batch(x)
    assert kernels.LAUNCHES["inv_mod_batch"] == before + 1
    assert torch.equal(got, fel.inv_mod_batch(x))
    v = fel.tensor_to_ints(x[:, -4:-3] if n > 4 * blk else x[:, -1:])[0]
    w = fel.tensor_to_ints(got[:, -4:-3] if n > 4 * blk else got[:, -1:])[0]
    assert w == (pow(v, fel.P - 2, fel.P) if v else 0)


def test_inv_kernel_all_zero(dev):
    x = torch.zeros((16, 1000), dtype=torch.int64, device=dev)
    assert torch.equal(kernels.inv_mod_batch(x), x)


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


@pytest.mark.parametrize("n", [32768, 1000, 1])
@pytest.mark.parametrize("complete", [True, False])
def test_mixed_add_kernel_matches_plain(dev, n, complete):
    q = [_limbs(n, s, dev) for s in (5, 6, 7)]
    gx, gy = _limbs(n, 8, dev), _limbs(n, 9, dev)
    keys = [3, 0xC936, golden.N - 2]
    px, py = (fel.from_last(a, dev) for a in ecc.points_host(keys))
    m = min(n, 3)
    q[0][:, :m], q[1][:, :m], gx[:, :m], gy[:, :m] = px[:, :m], py[:, :m], \
        px[:, :m], py[:, :m]                          # P == Q lanes
    q[2][:, :m] = fel.const(1, q[2])
    if n > 3:
        q[2][:, 3] = 0                                # infinity accumulator
    skip = torch.from_numpy(np.random.default_rng(10).random(n) < 0.1).to(dev)
    before = kernels.LAUNCHES["mixed_add"]
    got = kernels.proj_add_affine(*q, gx, gy, skip, complete)
    nx, ny, nz = ecc.proj_add_affine_rows(*q, gx, gy, complete)
    for g, p, old in zip(got, (nx, ny, nz), q):
        assert torch.equal(g, fel.select(skip, old, p))
    assert kernels.LAUNCHES["mixed_add"] == before + 1


def test_mul_step_on_card_matches_cpu(dev):
    filt = filters.load_filter(os.path.join(os.path.dirname(__file__), "..",
                                            "data", "btc-bw-hash"))
    with open(os.path.join(os.path.dirname(__file__), "..", "data",
                           "btc-bw-priv")) as f:
        keys = [int(ln, 16) for ln in f.read().split()[:1000]]
    cfg = mul.SearchConfig(addr33=True, addr65=True)
    w, batch = 8, 1024
    dig = np.zeros((mul.n_windows(w), batch), dtype=np.int32)
    dig[:, :len(keys)] = mul.window_digits(keys, w).T
    table = mul.build_gtable(w, torch.device("cpu"))
    outs = []
    for d in ("cpu", dev):
        step = mul.make_mul_step(cfg, filt, w, batch, d)
        bits = torch.from_numpy(filt.device_bits.view(np.int32)).to(d)
        outs.append(step(torch.from_numpy(dig).to(d), table.to(d), bits).cpu())
    assert torch.equal(outs[0], outs[1])
    assert int(np.unpackbits(outs[0].numpy().astype("<u4").view(np.uint8)
                             ).sum()) >= len(keys)
