"""secp256k1 point arithmetic on limb-first tensors (the `add` path's
part of `ecloop_tpu.ecc`)."""

from __future__ import annotations

from ecloop_tpu import golden

from . import fel


def affine_add_rows(px, py, qx, qy, inv_dx):
    """Chord addition P + Q on (16, ...) limbs with a precomputed
    1/(qx - px); P != +-Q is the caller's guarantee."""
    lam = fel.mul_mod(fel.sub_mod(qy, py), inv_dx)
    rx = fel.sub_mod(fel.sub_mod(fel.sqr_mod(lam), px), qx)
    ry = fel.sub_mod(fel.mul_mod(lam, fel.sub_mod(px, rx)), py)
    return rx, ry


def points_host(keys) -> tuple:
    """k*G for each key, on the host with the golden model: (len, 16)
    uint32 limbs of x and of y (0 -> (0, 0))."""
    pts = [golden.point_mul(k) if k % golden.N else (0, 0) for k in keys]
    return (fel.ints_to_limbs([p[0] for p in pts]),
            fel.ints_to_limbs([p[1] for p in pts]))
