"""The plain K1 version (ecloop_tpu_torch.hash160) and its kernel
wrappers on CPU tensors, against the JAX package's hash160 rows pipeline
and the golden model.  Bit-exact (tolerance 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import fel as jfel
from ecloop_tpu import golden
from ecloop_tpu import hash160 as jhash
from ecloop_tpu_torch import ecc, fel, hash160, kernels, sol


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's own thread pool on
    these small batches only burns the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_LANES = 64     # the JAX side runs at one width, so it compiles once


@functools.cache
def _jax_hash(is33):
    f = jhash.addr33_hash_rows if is33 else jhash.addr65_hash_rows

    def run(x, y):
        return jnp.stack(f(jfel.from_last(x), jfel.from_last(y)))

    return jax.jit(run)


def _jax_rows(is33, xl, yl):
    """The JAX hash rows of (n, 16) limbs, n <= JAX_LANES, padded to
    JAX_LANES lanes with copies of the first point."""
    n = len(xl)
    pad = [xl[:1].repeat(JAX_LANES - n, 0), yl[:1].repeat(JAX_LANES - n, 0)]
    out = _jax_hash(is33)(jnp.asarray(np.concatenate([xl, pad[0]])),
                          jnp.asarray(np.concatenate([yl, pad[1]])))
    return np.asarray(out)[:, :n]


def _hex_rows(words: np.ndarray) -> list[str]:
    return ["".join(f"{int(v):08x}" for v in col) for col in words.T]


def _points(n, seed):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    return [golden.point_mul(k) for k in keys]


def _check(pts):
    x = fel.ints_to_tensor([p[0] for p in pts], "cpu")
    y = fel.ints_to_tensor([p[1] for p in pts], "cpu")
    xl, yl = fel.to_last(x), fel.to_last(y)
    for is33, plain, wrapper, gold in (
            (True, hash160.addr33_hash_rows, kernels.addr33_hash_rows,
             golden.addr33),
            (False, hash160.addr65_hash_rows, kernels.addr65_hash_rows,
             golden.addr65)):
        got = plain(x, y)
        assert got.shape == (5, len(pts)) and got.dtype == torch.int64
        assert torch.equal(wrapper(x, y), got)
        want_jax = _jax_rows(is33, xl, yl)
        np.testing.assert_array_equal(got.numpy(), want_jax.astype(np.int64))
        assert _hex_rows(got.numpy()) == [gold(p).hex() for p in pts]


def test_random_points_even_and_odd_y():
    pts = _points(64, 11)
    parities = {p[1] & 1 for p in pts}
    assert parities == {0, 1}
    _check(pts)


def test_six_endo_variants_of_one_point():
    _check(golden.endo_points(golden.point_mul(0xC936)))


@pytest.mark.parametrize("batch", [(3, 5), (1,), (0,)])
def test_batch_shapes(batch):
    rng = np.random.default_rng(12)
    n = int(np.prod(batch))
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    x = torch.from_numpy(limbs[:, ::-1].copy()).reshape((16,) + batch)
    y = torch.from_numpy(limbs).reshape((16,) + batch)
    out = hash160.addr33_hash_rows(x, y)
    assert out.shape == (5,) + batch
    flat = hash160.addr33_hash_rows(x.reshape(16, -1), y.reshape(16, -1))
    assert torch.equal(out.reshape(5, -1), flat)


def test_golden_points_from_host_helper():
    keys = [1, 2, 0xC936, golden.N - 1]
    xl, yl = ecc.points_host(keys)
    for k, xs, ys in zip(keys, fel.limbs_to_ints(xl), fel.limbs_to_ints(yl)):
        assert (xs, ys) == golden.point_mul(k)
    assert fel.limbs_to_ints(ecc.points_host([0])[0]) == [0]


@pytest.mark.parametrize("is33,alu,either", [(True, 1474, 581),
                                             (False, 2449, 941)])
def test_hash_op_count_runs_k1s_function(is33, alu, either):
    """sol.HashOpCount, which counts the operations K1's bound prices
    (in the bench and in chip_smoke.py), computes K1's function (the plain
    rows pipeline's words, the golden hash of curve points), and its count
    does not depend on the key."""
    rng = np.random.default_rng(11)
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=3)]
    x, y = (np.asarray(a).T.astype(np.int64) for a in ecc.points_host(keys))
    x = np.concatenate([x, rng.integers(0, 1 << 16, size=(16, 3))], axis=1)
    y = np.concatenate([y, rng.integers(0, 1 << 16, size=(16, 3))], axis=1)
    rows = (hash160.addr33_hash_rows if is33 else hash160.addr65_hash_rows)(
        torch.from_numpy(x), torch.from_numpy(y)).numpy()
    for e in range(x.shape[1]):
        got = sol.hash_ops(x[:, e].tolist(), y[:, e].tolist(), is33)
        assert got == (alu, either, rows[:, e].tolist())
    for e, k in enumerate(keys):
        p = golden.point_mul(k)
        want = (golden.addr33 if is33 else golden.addr65)(p).hex()
        assert "".join(f"{w:08x}" for w in rows[:, e]) == want
