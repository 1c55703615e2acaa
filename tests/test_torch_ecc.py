"""The port's point arithmetic (`ecloop_tpu_torch.ecc`) against the JAX
package's (`ecloop_tpu.ecc`): the same seeded points through both give the
same X:Y:Z limbs, exact integers with no tolerance, in every degenerate
case `tests/test_ecc.py` covers, and each form calls as many field
operations as the JAX form does (the counts `sol` prices).  `scalar_mul`
is held against the host oracle, and its steps against the JAX
package's."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import ecc as jecc
from ecloop_tpu import fe as jfe
from ecloop_tpu import fel as jfel
from ecloop_tpu_torch import ecc, fel, golden, sol

LANES = 6
# the JAX package's field functions under the port's names
JAX_FE = {"mul_mod_p": "mul_mod", "sqr_mod_p": "sqr_mod",
          "mul_mod_p_small": "mul_small", "add_mod": "add_mod",
          "sub_mod": "sub_mod", "neg_mod": "neg_mod", "is_zero": "is_zero",
          "eq": "eq", "select": "select", "inv_mod_p_batch": "inv_mod_batch"}
JAX_FEL = {n: n for n in ("mul_mod", "sqr_mod", "mul_small", "add_mod",
                          "sub_mod", "neg_mod", "is_zero", "eq", "select",
                          "inv_mod_batch")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_jax(fn, *args):
    """fn(*args) with the JAX package's fe and fel functions counted
    (outermost calls only); returns (result, {port name: calls})."""
    counts = {}
    depth = [0]
    saved = []

    def wrap(mod, name, port_name):
        real = getattr(mod, name)
        saved.append((mod, name, real))

        def run(*a, **k):
            depth[0] += 1
            try:
                return real(*a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    counts[port_name] = counts.get(port_name, 0) + 1
        setattr(mod, name, run)

    for mod, names in ((jfe, JAX_FE), (jfel, JAX_FEL)):
        for name, port_name in names.items():
            wrap(mod, name, port_name)
    try:
        out = fn(*args)
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return out, counts


def _count_port(fn, *args):
    """fn(*args) with the port's fel functions counted (sol's counter);
    returns (result, {name: calls})."""
    with sol.count_field_ops() as calls:
        out = fn(*args)
    counts = {}
    for name, _ in calls:
        counts[name] = counts.get(name, 0) + 1
    return out, counts


def _ints(t) -> list[int]:
    return fel.tensor_to_ints(t)


def _proj(pts, zs, jac=False):
    """Host points (None = infinity) scaled by zs: projective (xz, yz, z)
    or Jacobian (xz^2, yz^3, z) coordinate lists."""
    p = golden.P
    out = ([], [], [])
    for pt, z in zip(pts, zs):
        if pt is None:
            vals = (0, 1, 0)
        elif jac:
            vals = (pt[0] * z * z % p, pt[1] * z * z * z % p, z)
        else:
            vals = (pt[0] * z % p, pt[1] * z % p, z)
        for o, v in zip(out, vals):
            o.append(v)
    return out


@functools.lru_cache(maxsize=None)
def _points(seed: int, n: int = LANES):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=n)]
    zs = [int.from_bytes(rng.bytes(32), "big") % (golden.P - 1) + 1
          for _ in range(n)]
    return [golden.point_mul(k) for k in keys], zs


def _case_inputs(form: str, case: str):
    """Coordinate lists (Python ints, one list per argument) of a case."""
    pts, zs = _points(1)
    qts, zs2 = _points(2)
    jac = form.startswith("jac")
    if form in ("proj_add", "jac_add"):
        q = {"generic": qts, "p_inf": qts, "q_inf": [None] * LANES,
             "p_eq_q": pts, "p_eq_neg_q": [golden.point_neg(p) for p in pts]}
        p = [None] * LANES if case == "p_inf" else pts
        return list(_proj(p, zs, jac) + _proj(q[case], zs2, jac))
    if form in ("proj_dbl", "jac_dbl"):
        return list(_proj([None] * LANES if case == "inf" else pts, zs, jac))
    if form == "proj_add_affine":
        q = {"generic": qts, "p_inf": qts, "p_eq_q": pts,
             "p_eq_neg_q": [golden.point_neg(p) for p in pts]}[case]
        p = [None] * LANES if case == "p_inf" else pts
        return list(_proj(p, zs)) + [[a[0] for a in q], [a[1] for a in q]]
    if form in ("proj_to_affine", "jac_to_affine"):
        return list(_proj(pts[:-1] + [None], zs, jac))
    if form == "on_curve":
        ys = [p[1] if case == "on" or i % 2 else (p[1] + 1) % golden.P
              for i, p in enumerate(pts)]
        return [[p[0] for p in pts], ys]
    q = qts
    if case == "p_eq_q":                  # P == Q on the odd lanes
        q = [pts[i] if i % 2 else qts[i] for i in range(LANES)]
    return [[p[0] for p in pts], [p[1] for p in pts],
            [a[0] for a in q], [a[1] for a in q]]


FORMS = {
    "proj_add": (jecc.proj_add, ecc.proj_add),
    "jac_add": (jecc.jac_add, ecc.jac_add),
    "proj_dbl": (jecc.proj_dbl, ecc.proj_dbl_rows),
    "jac_dbl": (jecc.jac_dbl, ecc.jac_dbl),
    "proj_add_affine": (jecc.proj_add_affine, ecc.proj_add_affine_rows),
    "proj_to_affine": (jecc.proj_to_affine, ecc.proj_to_affine_rows),
    "jac_to_affine": (jecc.jac_to_affine, ecc.jac_to_affine),
    "on_curve": (jecc.on_curve, ecc.on_curve),
    "batch_affine_add": (jecc.batch_affine_add, ecc.batch_affine_add),
    "batch_add_or_dbl": (jecc.batch_add_or_dbl, ecc.batch_add_or_dbl),
}
CASES = [(f, c) for f, cases in (
    ("proj_add", ("generic", "p_inf", "q_inf", "p_eq_q", "p_eq_neg_q")),
    ("jac_add", ("generic", "p_inf", "q_inf", "p_eq_q", "p_eq_neg_q")),
    ("proj_dbl", ("generic", "inf")),
    ("jac_dbl", ("generic", "inf")),
    ("proj_add_affine", ("generic", "p_inf", "p_eq_q", "p_eq_neg_q")),
    ("proj_to_affine", ("with_inf",)),
    ("jac_to_affine", ("with_inf",)),
    ("on_curve", ("on", "off")),
    ("batch_affine_add", ("generic",)),
    ("batch_add_or_dbl", ("generic", "p_eq_q")),
) for c in cases]


@functools.lru_cache(maxsize=None)
def _form_results(form: str):
    """Every case of `form` in one call of each package (LANES lanes per
    case, in CASES order): (JAX outputs, port outputs, JAX counts, port
    counts); an output is a list of ints, or of bools for on_curve."""
    cases = [c for f, c in CASES if f == form]
    per_case = [_case_inputs(form, c) for c in cases]
    args = [sum((a[i] for a in per_case), []) for i in range(len(per_case[0]))]
    jax_fn, port_fn = FORMS[form]
    want, jax_counts = _count_jax(
        jax_fn, *(jnp.asarray(jfe.ints_to_limbs(a)) for a in args))
    got, port_counts = _count_port(
        port_fn, *(fel.ints_to_tensor(a, "cpu") for a in args))
    if form == "on_curve":
        return ([np.asarray(want).tolist()], [got.tolist()], jax_counts,
                port_counts)
    return ([jfe.limbs_to_ints(np.asarray(w)) for w in want],
            [_ints(g) for g in got], jax_counts, port_counts)


@pytest.mark.parametrize("form,case", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_form_matches_jax(form, case):
    """Limbs equal to the JAX form's, and so are the counts of field
    calls (one call of each package serves all of a form's cases)."""
    want, got, jax_counts, port_counts = _form_results(form)
    assert port_counts == jax_counts
    i = [c for f, c in CASES if f == form].index(case) * LANES
    lanes = slice(i, i + LANES)
    for w, g in zip(want, got):
        assert g[lanes] == w[lanes]
    if form == "on_curve":
        assert got[0][lanes] == ([True] * LANES if case == "on"
                                 else [bool(j % 2) for j in range(LANES)])
    if form in ("proj_to_affine", "jac_to_affine"):
        assert got[0][lanes][-1] == 0 and got[1][lanes][-1] == 0
    if form in ("proj_add", "jac_add") and case == "p_eq_neg_q":
        assert got[2][lanes] == [0] * LANES                # infinity


def test_scalar_mul_against_oracle():
    """One call on k = 1, 2, n-1 and random keys, reduced to affine and
    held against the host oracle."""
    rng = np.random.default_rng(3)
    rand = [int.from_bytes(rng.bytes(32), "big") % golden.N for _ in range(3)]
    keys = [1, 2, golden.N - 1] + rand
    x, y, z = ecc.scalar_mul(fel.ints_to_tensor(keys, "cpu"))
    ax, ay = ecc.proj_to_affine_rows(x, y, z)
    assert list(zip(_ints(ax), _ints(ay))) == [golden.point_mul(k)
                                               for k in keys]


def _jax_step(ax, ay, az, bx, by, bz, k_limbs, i: int):
    """One bit of the JAX package's scalar_mul, as its `step` writes it
    (jit-compiling the whole 256-bit scan costs about a minute on a CPU)."""
    bit = (jnp.take(k_limbs, i // jfe.LIMB_BITS, axis=-1)
           >> (i % jfe.LIMB_BITS)) & 1
    nx, ny, nz = jecc.proj_add(ax, ay, az, bx, by, bz)
    ax = jfe.select(bit == 1, nx, ax)
    ay = jfe.select(bit == 1, ny, ay)
    az = jfe.select(bit == 1, nz, az)
    return (ax, ay, az) + tuple(jecc.proj_dbl(bx, by, bz))


def test_scalar_mul_steps_match_jax():
    """scalar_mul's start state equals the JAX package's (infinity, G),
    and three consecutive bit steps from a seeded state give the JAX
    step's X:Y:Z limbs and its field-call counts.  The state's lanes
    hold an accumulator at infinity, one equal to the base (the add
    doubles) and one equal to its negation; the keys' bits 100-102 are
    set on some lanes and clear on others."""
    rng = np.random.default_rng(4)
    keys = [int.from_bytes(rng.bytes(32), "big") & ~(7 << 100)
            | j << 100 for j in range(LANES)]
    k = fel.ints_to_tensor(keys, "cpu")
    jk = jnp.asarray(jfe.ints_to_limbs(keys))
    acc, base, i = ecc.scalar_mul_start(k)
    gx = jnp.broadcast_to(jnp.asarray(jecc.GX), jk.shape)
    gy = jnp.broadcast_to(jnp.asarray(jecc.GY), jk.shape)
    want = tuple(jecc.proj_infinity(gx)) + tuple(jecc.proj_from_affine(gx, gy))
    assert [jfe.limbs_to_ints(np.asarray(w)) for w in want] == [
        _ints(t.expand(fel.NLIMBS, LANES)) for t in acc + base]

    pts, zs = _points(1)
    qts, zs2 = _points(2)
    pts = [None, qts[1], golden.point_neg(qts[2])] + pts[3:]
    state = list(_proj(pts, zs) + _proj(qts, zs2))
    port = [fel.ints_to_tensor(c, "cpu") for c in state]
    jax_state = [jnp.asarray(jfe.ints_to_limbs(c)) for c in state]
    for bit in (100, 101, 102):
        jax_state, jax_counts = _count_jax(_jax_step, *jax_state, jk, bit)
        (a, b), port_counts = _count_port(
            ecc.scalar_mul_step, tuple(port[:3]), tuple(port[3:]), k,
            torch.tensor([bit]))
        port = list(a) + list(b)
        assert port_counts == jax_counts
        assert [_ints(t) for t in port] == [
            jfe.limbs_to_ints(np.asarray(w)) for w in jax_state]


def test_scalar_mul_counts_one_step_per_bit():
    """scalar_mul is 256 steps of proj_add, proj_dbl and 3 selects (the
    JAX package's step), which the bench's budget prices per bit."""
    k = fel.ints_to_tensor([5, 7], "cpu")
    acc, base, i = ecc.scalar_mul_start(k)
    _, step = _count_port(ecc.scalar_mul_step, acc, base, k, i)
    _, add = _count_port(ecc.proj_add, *acc, *base)
    _, dbl = _count_port(ecc.proj_dbl_rows, *base)
    want = {n: add.get(n, 0) + dbl.get(n, 0) for n in set(add) | set(dbl)}
    want["select"] += 3
    assert step == want
