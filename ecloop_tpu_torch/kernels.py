"""Entry points of the hand-written CUDA kernels (the counterpart of
`ecloop_tpu.pallas_kernels`).

  K1  addr33_hash_rows / addr65_hash_rows  -> csrc/hash160.cu
  K2  inv_mod_batch                        -> csrc/inv_batch.cu
  K3  proj_add_affine                      -> csrc/mixed_add.cu

A tensor on the CPU goes to the kernel's plain torch version; a CUDA
tensor launches the kernel on its device's current stream, or raises.
Every wrapper checks device, dtype, shape and contiguity first,
allocates its outputs with torch.empty and raises when the launch
reports an error or would run on another device than its data.
LAUNCHES counts the launches of each kernel, and WIDTHS gathers the
widths (elements per launch) they ran at until its caller clears it.
A launch made while a CUDA graph is captured runs only when the graph
is replayed: inside `recording()` the wrappers note it there instead,
and `graphs.Graph` counts it at each replay (`count_launches`).
"""

from __future__ import annotations

import contextlib

import torch

from . import _build, ecc, fel, hash160

NLIMBS = 16
LAUNCHES = {"hash160": 0, "inv_mod_batch": 0, "mixed_add": 0}
WIDTHS = {k: set() for k in LAUNCHES}
_recorder: list | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count(name: str, n: int) -> None:
    """One launch of kernel `name` at width n: counted, or noted in the
    open `recording()` while a graph is captured."""
    if _recorder is not None:
        _recorder.append((name, n))
    else:
        count_launches(((name, n),))


@contextlib.contextmanager
def recording():
    """Collect the (kernel, width) of every launch inside the block in
    the yielded list instead of counting them."""
    global _recorder
    outer, _recorder = _recorder, []
    try:
        yield _recorder
    finally:
        _recorder = outer


def count_launches(launches) -> None:
    """Count (kernel, width) launches: the ones a `recording()`
    collected, at each replay of the graph that holds them."""
    for name, n in launches:
        LAUNCHES[name] += 1
        WIDTHS[name].add(n)


def _check_limbs(name: str, t: torch.Tensor) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 limbs, got {t.dtype}")
    if t.dim() < 1 or t.shape[0] != NLIMBS:
        raise ValueError(f"{name}: expected shape (16, ...), got "
                         f"{tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: kernel input must be contiguous")


def _check_same(ref: torch.Tensor, **named) -> None:
    for name, t in named.items():
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError(f"{name} {tuple(t.shape)}@{t.device} must match "
                             f"{tuple(ref.shape)}@{ref.device}")


def _launch(fn, device: torch.device, *args) -> None:
    """Call the library's launcher `fn` on `device`'s current stream
    (the last argument), with `device` current.  The library's own CUDA
    runtime must agree that `device` is current, or the launch raises
    before it could run on another card than its data."""
    lib = _build.lib()
    with torch.cuda.device(device):
        cur = lib.ecl_current_device()
        if cur != device.index:
            raise RuntimeError(f"{fn}: the kernel library's current device "
                               f"is {cur}, the data is on {device}")
        rc = getattr(lib, fn)(*args,
                             torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _hash_rows(x: torch.Tensor, y: torch.Tensor, is33: bool) -> torch.Tensor:
    _check_limbs("x", x)
    _check_limbs("y", y)
    _check_same(x, y=y)
    if x.device.type == "cpu":
        return (hash160.addr33_hash_rows if is33
                else hash160.addr65_hash_rows)(x, y)
    out = torch.empty((5,) + x.shape[1:], dtype=torch.int64, device=x.device)
    n = x[0].numel()
    if n:
        _launch("ecl_hash160", x.device, x.data_ptr(), y.data_ptr(),
                out.data_ptr(), n, int(is33))
        _count("hash160", n)
    return out


def addr33_hash_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K1, compressed pubkeys: (16, ...) x/y limbs -> (5, ...) hash160
    words in big-endian print order."""
    return _hash_rows(x, y, True)


def addr65_hash_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K1, uncompressed pubkeys."""
    return _hash_rows(x, y, False)


def inv_mod_batch(x: torch.Tensor) -> torch.Tensor:
    """K2: the inverse mod p of every element of a (16, ...) batch of
    canonical limbs; 0 -> 0."""
    _check_limbs("x", x)
    if x.device.type == "cpu":
        return fel.inv_mod_batch(x)
    n = x[0].numel()
    out = torch.empty_like(x)
    if n:
        _launch("ecl_inv_batch", x.device, x.data_ptr(), out.data_ptr(), n)
        _count("inv_mod_batch", n)
    return out


def inv_block_elements() -> int:
    """Elements per K2 block (the geometry of csrc/inv_batch.cu), for
    tests that put zeros on a block edge; builds the kernels."""
    return int(_build.lib().ecl_inv_batch_block())


def proj_add_affine(qx: torch.Tensor, qy: torch.Tensor, qz: torch.Tensor,
                    gx: torch.Tensor, gy: torch.Tensor, skip: torch.Tensor,
                    complete: bool):
    """K3, one `mul` window step: select(skip, q, q + g) for a projective
    accumulator (qx : qy : qz) and an affine point (gx, gy), all (16, ...)
    canonical limbs, skip a bool tensor of the batch shape.  complete=False
    leaves out the doubling for q == g (see ecc.proj_add_affine_rows).
    Returns the projective (x, y, z)."""
    for name, t in (("qx", qx), ("qy", qy), ("qz", qz), ("gx", gx),
                    ("gy", gy)):
        _check_limbs(name, t)
    _check_same(qx, qy=qy, qz=qz, gx=gx, gy=gy)
    if not isinstance(skip, torch.Tensor) or skip.dtype != torch.bool:
        raise TypeError("skip: expected a bool tensor")
    if skip.shape != qx.shape[1:] or skip.device != qx.device:
        raise ValueError(f"skip {tuple(skip.shape)}@{skip.device} must have "
                         f"the batch shape {tuple(qx.shape[1:])}@{qx.device}")
    if qx.device.type == "cpu":
        nx, ny, nz = ecc.proj_add_affine_rows(qx, qy, qz, gx, gy, complete)
        return (fel.select(skip, qx, nx), fel.select(skip, qy, ny),
                fel.select(skip, qz, nz))
    if not skip.is_contiguous():
        raise ValueError("skip: kernel input must be contiguous")
    out = torch.empty((3,) + qx.shape, dtype=torch.int64, device=qx.device)
    n = qx[0].numel()
    if n:
        _launch("ecl_mixed_add", qx.device, qx.data_ptr(), qy.data_ptr(),
                qz.data_ptr(), gx.data_ptr(), gy.data_ptr(), skip.data_ptr(),
                out.data_ptr(), n, int(complete))
        _count("mixed_add", n)
    return out[0], out[1], out[2]
