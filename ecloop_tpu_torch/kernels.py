"""Entry points of the hand-written CUDA kernels (the counterpart of
`ecloop_tpu.pallas_kernels`).

  K1  addr33_hash_rows / addr65_hash_rows  -> csrc/hash160.cu
  K2  inv_mod_batch                        -> csrc/inv_batch.cu

A tensor on the CPU goes to the kernel's plain torch version; a CUDA
tensor launches the kernel on the current stream, or raises.  Every
wrapper checks device, dtype, shape and contiguity first, allocates its
outputs with torch.empty and raises when the launch reports an error.
LAUNCHES counts the launches of each kernel.
"""

from __future__ import annotations

import torch

from . import _build, fel, hash160

NLIMBS = 16
LAUNCHES = {"hash160": 0, "inv_mod_batch": 0}
# elements one K2 thread chains: the Fermat chain per thread against the
# number of threads in flight (chosen, not tuned)
INV_CHUNK = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _launch(fn, *args) -> None:
    rc = getattr(_build.lib(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")


def _hash_rows(x: torch.Tensor, y: torch.Tensor, is33: bool) -> torch.Tensor:
    _check_limbs("x", x)
    _check_limbs("y", y)
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)}@{x.device} and y "
                         f"{tuple(y.shape)}@{y.device} must match")
    if x.device.type == "cpu":
        return (hash160.addr33_hash_rows if is33
                else hash160.addr65_hash_rows)(x, y)
    out = torch.empty((5,) + x.shape[1:], dtype=torch.int64, device=x.device)
    n = x[0].numel()
    if n:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _launch("ecl_hash160", x.data_ptr(), y.data_ptr(), out.data_ptr(),
                    n, int(is33), stream)
        LAUNCHES["hash160"] += 1
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
        pfx = torch.empty((8, n), dtype=torch.int32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _launch("ecl_inv_batch", x.data_ptr(), out.data_ptr(),
                    pfx.data_ptr(), n, INV_CHUNK, stream)
        LAUNCHES["inv_mod_batch"] += 1
    return out
