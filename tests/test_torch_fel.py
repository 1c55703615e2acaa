"""The port's field layer (ecloop_tpu_torch.fel) against the JAX
package's `fel` and the golden model.  All comparisons are bit-exact
(tolerance 0): the arithmetic is integer."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import fel as jfel
from ecloop_tpu import golden
from ecloop_tpu_torch import fel, kernels

P = golden.P
SIZES = (1, 33, 1024, 4128)
EDGES = (0, 1, P - 1, P - 2, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's own thread pool on
    these small batches only burns the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(b: int, seed: int) -> list[int]:
    """b seeded field elements with the edge values first (rotated by
    seed) and, for b > 64, a run of zeros."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(b)]
    edges = EDGES[seed % len(EDGES):] + EDGES[:seed % len(EDGES)]
    vals[:len(edges)] = edges[:b]
    if b > 64:
        vals[40:56] = [0] * 16
    return vals


def _jax(op, *ints_lists, **kw):
    rows = [jfel.from_last(jnp.asarray(fel.ints_to_limbs(v))) for v in ints_lists]
    out = getattr(jfel, op)(*rows, **kw)
    return fel.limbs_to_ints(np.asarray(jfel.to_last(out)))


@functools.cache
def _jax_widest(op, *seeds):
    """The JAX op once on the widest inputs: _ints(b, seed) is a prefix of
    _ints(max(SIZES), seed) for every b in SIZES, and every op here gives
    each element's own result (the inverse is unique), so each size's
    results are a prefix of these; eager JAX compiles once per op."""
    return _jax(op, *(_ints(max(SIZES), s) for s in seeds))


def _torch(op, *ints_lists, **kw):
    ts = [fel.ints_to_tensor(v, "cpu") for v in ints_lists]
    return fel.tensor_to_ints(getattr(fel, op)(*ts, **kw))


BINARY = {
    "add_mod": lambda a, b: (a + b) % P,
    "sub_mod": lambda a, b: (a - b) % P,
    "mul_mod": lambda a, b: a * b % P,
}
UNARY = {
    "neg_mod": lambda a: -a % P,
    "sqr_mod": lambda a: a * a % P,
    "inv_mod_batch": lambda a: pow(a, P - 2, P) if a else 0,
}


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_jax_and_golden(op, b):
    xs, ys = _ints(b, 1), _ints(b, 2)
    want = [BINARY[op](x, y) for x, y in zip(xs, ys)]
    got = _torch(op, xs, ys)
    assert got == want
    assert got == _jax_widest(op, 1, 2)[:b]


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_jax_and_golden(op, b):
    xs = _ints(b, 3)
    want = [UNARY[op](x) for x in xs]
    got = _torch(op, xs)
    assert got == want
    assert got == _jax_widest(op, 3)[:b]


@pytest.mark.parametrize("k", [0, 1, 3, 977, 0xFFFF])
def test_mul_small(k):
    xs = _ints(33, 4)
    assert _torch("mul_small", xs, k=k) == [x * k % P for x in xs]
    assert _jax("mul_small", xs, k=k) == [x * k % P for x in xs]


def test_inv_mod_chain_and_wrapper():
    xs = _ints(33, 5)
    want = [pow(x, P - 2, P) if x else 0 for x in xs]
    assert _torch("inv_mod", xs) == want
    t = fel.ints_to_tensor(xs, "cpu")
    # on a CPU tensor the K2 wrapper takes the plain version, and any
    # chain width gives the same exact inverses
    assert fel.tensor_to_ints(kernels.inv_mod_batch(t)) == want
    assert fel.tensor_to_ints(fel.inv_mod_batch(t, lanes=5)) == want


def test_select_is_zero_eq_and_broadcast():
    xs, ys = _ints(33, 6), _ints(33, 7)
    a, b = fel.ints_to_tensor(xs, "cpu"), fel.ints_to_tensor(ys, "cpu")
    assert fel.is_zero(a).tolist() == [x == 0 for x in xs]
    assert fel.eq(a, b).tolist() == [x == y for x, y in zip(xs, ys)]
    assert bool(fel.eq(a, a).all())
    cond = torch.arange(33) % 2 == 0
    sel = fel.tensor_to_ints(fel.select(cond, a, b))
    assert sel == [x if i % 2 == 0 else y
                   for i, (x, y) in enumerate(zip(xs, ys))]
    # (16, 3, 1) x (16, 1, 11) broadcasts like any tensor behind the limbs
    m = fel.mul_mod(a[:, :3, None], b[:, None, :11])
    assert fel.tensor_to_ints(m) == [x * y % P for x in xs[:3] for y in ys[:11]]


def test_limb_conversions_roundtrip():
    xs = _ints(33, 8)
    limbs = fel.ints_to_limbs(xs)
    from ecloop_tpu import fe
    np.testing.assert_array_equal(limbs, fe.ints_to_limbs(xs))
    assert fel.limbs_to_ints(limbs) == xs
    t = fel.from_last(limbs, "cpu")
    assert t.shape == (16, 33) and t.dtype == torch.int64
    np.testing.assert_array_equal(fel.to_last(t), limbs)
