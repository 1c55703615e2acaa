"""secp256k1 point arithmetic on limb-first tensors (the counterpart of
`ecloop_tpu.ecc`).

Affine chords serve the `add` step and the gtable build; homogeneous
projective coordinates serve the `mul` window scan, the double-and-add
`scalar_mul` and the bench; Jacobian coordinates (x = X/Z^2, y = Y/Z^3)
are the bench's comparison rows and an independent cross-check.
Projective and Jacobian infinity is z == 0.  Every field op returns
canonical limbs, so running the JAX package's formulas op for op gives
the same X:Y:Z limbs, not merely the same point.  Where the JAX package
has one formula twice (its `fe` forms beside its row forms: `proj_dbl`,
`proj_add_affine`, `proj_to_affine`, `affine_add`), the port has one
function, named as the JAX row form.
"""

from __future__ import annotations

import torch

from . import fel, golden

LIMB_BITS = fel.LIMB_BITS
SCALAR_BITS = 256


def affine_add_rows(px, py, qx, qy, inv_dx):
    """Chord addition P + Q on (16, ...) limbs with a precomputed
    1/(qx - px); P != +-Q is the caller's guarantee."""
    lam = fel.mul_mod(fel.sub_mod(qy, py), inv_dx)
    rx = fel.sub_mod(fel.sub_mod(fel.sqr_mod(lam), px), qx)
    ry = fel.sub_mod(fel.mul_mod(lam, fel.sub_mod(px, rx)), py)
    return rx, ry


def proj_dbl_rows(x1, y1, z1):
    """Projective doubling (a = 0 curve)."""
    w = fel.mul_small(fel.sqr_mod(x1), 3)
    s = fel.mul_mod(y1, z1)
    b = fel.mul_mod(fel.mul_mod(x1, y1), s)
    h = fel.sub_mod(fel.sqr_mod(w), fel.mul_small(b, 8))
    x3 = fel.mul_mod(fel.mul_small(h, 2), s)
    y3 = fel.sub_mod(
        fel.mul_mod(w, fel.sub_mod(fel.mul_small(b, 4), h)),
        fel.mul_small(fel.sqr_mod(fel.mul_mod(y1, s)), 8))
    z3 = fel.mul_small(fel.mul_mod(fel.sqr_mod(s), s), 8)
    return x3, y3, z3


def proj_add_affine_rows(x1, y1, z1, x2, y2, complete: bool = True):
    """Mixed projective + affine addition (x1:y1:z1) + (x2, y2): the
    plain version of K3 (without its skip select).

    complete=True handles P = inf, P == Q (doubling) and P == -Q
    (infinity).  complete=False drops the doubling branch; P = inf and
    P == -Q still work.  The `mul` window scan may use it for every
    window but the top one: there the accumulator's scalar is below
    2^(w*i) and the table point's is digit*2^(w*i), so the two never
    match."""
    u1 = fel.mul_mod(y2, z1)
    v1 = fel.mul_mod(x2, z1)
    u = fel.sub_mod(u1, y1)
    v = fel.sub_mod(v1, x1)

    p_inf = fel.is_zero(z1)

    vsq = fel.sqr_mod(v)
    vcu = fel.mul_mod(vsq, v)
    a = fel.sub_mod(
        fel.sub_mod(fel.mul_mod(fel.sqr_mod(u), z1), vcu),
        fel.mul_small(fel.mul_mod(vsq, x1), 2))
    x3 = fel.mul_mod(v, a)
    y3 = fel.sub_mod(
        fel.mul_mod(u, fel.sub_mod(fel.mul_mod(vsq, x1), a)),
        fel.mul_mod(vcu, y1))
    z3 = fel.mul_mod(vcu, z1)

    if complete:
        dx, dy, dz = proj_dbl_rows(x1, y1, z1)
        is_dbl = fel.is_zero(v) & fel.is_zero(u) & ~p_inf
        x3 = fel.select(is_dbl, dx, x3)
        y3 = fel.select(is_dbl, dy, y3)
        z3 = fel.select(is_dbl, dz, z3)

    x3 = fel.select(p_inf, x2, x3)
    y3 = fel.select(p_inf, y2, y3)
    z3 = fel.select(p_inf, fel.const(1, z3), z3)
    return x3, y3, z3


def proj_to_affine_rows(x, y, z, inv=None):
    """Batch projective -> affine with one batched inversion `inv` (the
    plain `fel.inv_mod_batch` by default, or the K2 wrapper); infinity
    (z = 0) maps to (0, 0)."""
    zinv = (inv or fel.inv_mod_batch)(z)
    return fel.mul_mod(x, zinv), fel.mul_mod(y, zinv)


# --- the `add` step's chords (plain forms of K4, csrc/add_chords.cu) -------------

def chord_dx_plain(cx, tx, dpx):
    """The batch that the `add` step inverts, from its (16, M) centers,
    (16, K/2) table T[j] = (j+1)*s*G and (16,) advance point D: the
    chords' tx[j] - cx[m] at m*K/2 + j, then D.x - cx[m] at M*K/2 + m;
    (16, M*K/2 + M)."""
    dx = fel.sub_mod(tx[:, None, :], cx[:, :, None])    # (16, M, K/2)
    dxc = fel.sub_mod(dpx[:, None], cx)                 # (16, M)
    return torch.cat([dx.reshape(fel.NLIMBS, -1), dxc], dim=1)


def chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv, need_beta: bool,
                       need_neg: bool):
    """From the inverses of `chord_dx_plain`'s batch: the step's M*K
    points C[m] + (i - K/2)*s*G at flat index m*K + i and the advanced
    centers C[m] + D.  The mirror neighbours C - T[j] share T[j].x, so
    one inverse serves the +- pair.  Returns ((x, [beta*x, beta^2*x]),
    (y, [-y]), ncx, ncy), the bracketed rows where asked (the endo
    variants' coordinates, golden.endo_points)."""
    m_, k2 = cx.shape[1], tx.shape[1]
    nh = m_ * k2
    cxb, cyb = cx[:, :, None], cy[:, :, None]           # (16, M, 1)
    txb, tyb = tx[:, None, :], ty[:, None, :]           # (16, 1, K/2)
    idx = inv[:, :nh].reshape(fel.NLIMBS, m_, k2)
    xp, yp = affine_add_rows(cxb, cyb, txb, tyb, idx)
    xm, ym = affine_add_rows(cxb, cyb, txb, fel.neg_mod(tyb), idx)
    # offsets 0..K-1, center at h = K/2:
    #   [flip(minus: h-1..0), center, plus[:-1]: h+1..K-1]
    px = torch.cat([xm.flip(2), cxb, xp[:, :, :k2 - 1]],
                   dim=2).reshape(fel.NLIMBS, -1)
    py = torch.cat([ym.flip(2), cyb, yp[:, :, :k2 - 1]],
                   dim=2).reshape(fel.NLIMBS, -1)
    ncx, ncy = affine_add_rows(cx, cy, dpx[:, None], dpy[:, None],
                               inv[:, nh:])
    xs, ys = (px,), (py,)
    if need_beta:
        xs += (fel.mul_mod(px, fel.const(golden.BETA1, px)),
               fel.mul_mod(px, fel.const(golden.BETA2, px)))
    if need_neg:
        ys += (fel.neg_mod(py),)
    return xs, ys, ncx, ncy


# --- affine batches (table construction helpers) -------------------------------

def affine_dbl(px, py, inv_2y):
    """Tangent doubling 2P with a precomputed 1/(2y)."""
    lam = fel.mul_mod(fel.mul_small(fel.sqr_mod(px), 3), inv_2y)
    rx = fel.sub_mod(fel.sqr_mod(lam), fel.mul_small(px, 2))
    ry = fel.sub_mod(fel.mul_mod(lam, fel.sub_mod(px, rx)), py)
    return rx, ry


def batch_affine_add(px, py, qx, qy, inv=None):
    """P + Q with one batched inversion `inv` (as proj_to_affine_rows);
    the chord case only: P != +-Q is the caller's guarantee."""
    dx = fel.sub_mod(qx, px)
    return affine_add_rows(px, py, qx, qy, (inv or fel.inv_mod_batch)(dx))


def batch_add_or_dbl(px, py, qx, qy, inv=None):
    """P + Q that also doubles where P == Q, sharing the one batched
    inversion (denominator 2y there instead of dx).  P == -Q and
    infinities are not handled."""
    dx = fel.sub_mod(qx, px)
    same = fel.eq(px, qx)
    denom = fel.select(same, fel.mul_small(py, 2), dx)
    inv_d = (inv or fel.inv_mod_batch)(denom)
    ax, ay = affine_add_rows(px, py, qx, qy, inv_d)
    dx_, dy_ = affine_dbl(px, py, inv_d)
    return fel.select(same, dx_, ax), fel.select(same, dy_, ay)


# --- homogeneous projective ------------------------------------------------------

def proj_from_affine(x, y):
    return x, y, fel.const(1, x).expand_as(x)


def proj_infinity(like):
    """(0 : 1 : 0) with the shape of `like`."""
    zero = torch.zeros_like(like)
    return zero, fel.const(1, like).expand_as(like), zero


def proj_add(x1, y1, z1, x2, y2, z2):
    """Projective P + Q, complete through selects: P = inf, Q = inf,
    P == Q (doubling) and P == -Q (infinity: v = 0 gives z3 = 0)."""
    u1 = fel.mul_mod(y2, z1)
    u2 = fel.mul_mod(y1, z2)
    v1 = fel.mul_mod(x2, z1)
    v2 = fel.mul_mod(x1, z2)
    u = fel.sub_mod(u1, u2)
    v = fel.sub_mod(v1, v2)

    same_x = fel.is_zero(v)
    same_y = fel.is_zero(u)
    p_inf = fel.is_zero(z1)
    q_inf = fel.is_zero(z2)

    w = fel.mul_mod(z1, z2)
    vsq = fel.sqr_mod(v)
    vcu = fel.mul_mod(vsq, v)
    a = fel.sub_mod(
        fel.sub_mod(fel.mul_mod(fel.sqr_mod(u), w), vcu),
        fel.mul_small(fel.mul_mod(vsq, v2), 2))
    x3 = fel.mul_mod(v, a)
    y3 = fel.sub_mod(
        fel.mul_mod(u, fel.sub_mod(fel.mul_mod(vsq, v2), a)),
        fel.mul_mod(vcu, u2))
    z3 = fel.mul_mod(vcu, w)

    dx, dy, dz = proj_dbl_rows(x1, y1, z1)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf
    x3 = fel.select(is_dbl, dx, x3)
    y3 = fel.select(is_dbl, dy, y3)
    z3 = fel.select(is_dbl, dz, z3)

    x3 = fel.select(q_inf, x1, fel.select(p_inf, x2, x3))
    y3 = fel.select(q_inf, y1, fel.select(p_inf, y2, y3))
    z3 = fel.select(q_inf, z1, fel.select(p_inf, z2, z3))
    return x3, y3, z3


# --- Jacobian ----------------------------------------------------------------------
# The reference's second point-op set (lib/ecc.c:711-806): compiled there
# and here for the bench's comparison rows and as a cross-check of the
# projective forms; the engines use projective coordinates.

jac_from_affine = proj_from_affine


def jac_dbl(x1, y1, z1):
    """Jacobian doubling (a = 0 curve); infinity (z = 0) stays infinity."""
    a = fel.sqr_mod(x1)
    b = fel.sqr_mod(y1)
    c = fel.sqr_mod(b)
    d = fel.mul_small(
        fel.sub_mod(fel.sub_mod(fel.sqr_mod(fel.add_mod(x1, b)), a), c), 2)
    e = fel.mul_small(a, 3)
    x3 = fel.sub_mod(fel.sqr_mod(e), fel.mul_small(d, 2))
    y3 = fel.sub_mod(fel.mul_mod(e, fel.sub_mod(d, x3)), fel.mul_small(c, 8))
    z3 = fel.mul_small(fel.mul_mod(y1, z1), 2)
    return x3, y3, z3


def jac_add(x1, y1, z1, x2, y2, z2):
    """Jacobian P + Q, complete through selects like proj_add."""
    z1z1 = fel.sqr_mod(z1)
    z2z2 = fel.sqr_mod(z2)
    u1 = fel.mul_mod(x1, z2z2)
    u2 = fel.mul_mod(x2, z1z1)
    s1 = fel.mul_mod(fel.mul_mod(y1, z2), z2z2)
    s2 = fel.mul_mod(fel.mul_mod(y2, z1), z1z1)
    h = fel.sub_mod(u2, u1)
    r = fel.sub_mod(s2, s1)

    same_x = fel.is_zero(h)
    same_y = fel.is_zero(r)
    p_inf = fel.is_zero(z1)
    q_inf = fel.is_zero(z2)

    hh = fel.sqr_mod(h)
    hhh = fel.mul_mod(h, hh)
    v = fel.mul_mod(u1, hh)
    x3 = fel.sub_mod(fel.sub_mod(fel.sqr_mod(r), hhh), fel.mul_small(v, 2))
    y3 = fel.sub_mod(fel.mul_mod(r, fel.sub_mod(v, x3)),
                     fel.mul_mod(s1, hhh))
    z3 = fel.mul_mod(fel.mul_mod(z1, z2), h)

    dx, dy, dz = jac_dbl(x1, y1, z1)
    is_dbl = same_x & same_y & ~p_inf & ~q_inf
    x3 = fel.select(is_dbl, dx, x3)
    y3 = fel.select(is_dbl, dy, y3)
    z3 = fel.select(is_dbl, dz, z3)

    x3 = fel.select(q_inf, x1, fel.select(p_inf, x2, x3))
    y3 = fel.select(q_inf, y1, fel.select(p_inf, y2, y3))
    z3 = fel.select(q_inf, z1, fel.select(p_inf, z2, z3))
    return x3, y3, z3


def jac_to_affine(x, y, z, inv=None):
    """Batch Jacobian -> affine with one batched inversion (as
    proj_to_affine_rows); infinity maps to (0, 0)."""
    zinv = (inv or fel.inv_mod_batch)(z)
    zinv2 = fel.sqr_mod(zinv)
    return (fel.mul_mod(x, zinv2),
            fel.mul_mod(y, fel.mul_mod(zinv2, zinv)))


# --- scalar multiplication -----------------------------------------------------------

def scalar_mul_start(k):
    """The state of scalar_mul before bit 0: (accumulator, base, bit
    index), the accumulator at infinity, the base G, the index a
    one-element int64 tensor on k's device."""
    px = fel.const(golden.GX, k).expand_as(k)
    py = fel.const(golden.GY, k).expand_as(k)
    return (proj_infinity(px), proj_from_affine(px, py),
            torch.zeros(1, dtype=torch.int64, device=k.device))


def scalar_mul_step(acc, base, k, i):
    """One bit of the LSB-first double-and-add: acc += base where bit i
    of k is set, base doubles.  i is a one-element int64 tensor, so a
    CUDA graph of this step replays for every bit."""
    bit = (k.index_select(0, i // LIMB_BITS)[0] >> (i % LIMB_BITS)) & 1
    on = bit == 1
    nx, ny, nz = proj_add(*acc, *base)
    acc = (fel.select(on, nx, acc[0]), fel.select(on, ny, acc[1]),
           fel.select(on, nz, acc[2]))
    return acc, proj_dbl_rows(*base)


def scalar_mul(k):
    """k * G for (16, ...) scalar limbs k: LSB-first double-and-add over
    256 bits with proj_add and proj_dbl_rows, the JAX package's
    `scalar_mul` with its default base (reference ec_jacobi_mul,
    lib/ecc.c:821-843).  Returns projective (x, y, z).  Not a search
    path: it is the independent side of `mult-verify`."""
    acc, base, i = scalar_mul_start(k)
    for _ in range(SCALAR_BITS):
        acc, base = scalar_mul_step(acc, base, k, i)
        i = i + 1
    return acc


def on_curve(x, y):
    """y^2 == x^3 + 7 per affine point (ec_verify)."""
    lhs = fel.sqr_mod(y)
    rhs = fel.add_mod(fel.mul_mod(fel.sqr_mod(x), x), fel.const(7, x))
    return fel.eq(lhs, rhs)


def points_host(keys) -> tuple:
    """k*G for each key, on the host with the golden model: (len, 16)
    uint32 limbs of x and of y (0 -> (0, 0))."""
    pts = [golden.point_mul(k) if k % golden.N else (0, 0) for k in keys]
    return (fel.ints_to_limbs([p[0] for p in pts]),
            fel.ints_to_limbs([p[1] for p in pts]))
