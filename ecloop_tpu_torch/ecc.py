"""secp256k1 point arithmetic on limb-first tensors (the counterpart of
`ecloop_tpu.ecc`'s row forms).

Affine chords serve the `add` step and the gtable build; homogeneous
projective coordinates serve the `mul` window scan, where an inversion
per step is unaffordable.  Projective infinity is z == 0.  Every field
op returns canonical limbs, so running the JAX package's formulas op
for op gives the same X:Y:Z limbs, not merely the same point.
"""

from __future__ import annotations

from . import fel, golden


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


def proj_to_affine_rows(x, y, z, inv=fel.inv_mod_batch):
    """Batch projective -> affine with one batched inversion `inv` (the
    plain `fel.inv_mod_batch`, or the K2 wrapper); infinity (z = 0)
    maps to (0, 0)."""
    zinv = inv(z)
    return fel.mul_mod(x, zinv), fel.mul_mod(y, zinv)


def points_host(keys) -> tuple:
    """k*G for each key, on the host with the golden model: (len, 16)
    uint32 limbs of x and of y (0 -> (0, 0))."""
    pts = [golden.point_mul(k) if k % golden.N else (0, 0) for k in keys]
    return (fel.ints_to_limbs([p[0] for p in pts]),
            fel.ints_to_limbs([p[1] for p in pts]))
