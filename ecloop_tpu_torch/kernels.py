"""Entry points of the hand-written CUDA kernels (the counterpart of
`ecloop_tpu.pallas_kernels`).

  K1  addr33_hash_rows / addr65_hash_rows  -> csrc/hash160.cu
  K2  inv_mod_batch                        -> csrc/inv_batch.cu
  K3  proj_add_affine                      -> csrc/mixed_add.cu
  K4  chord_dx, chord_points               -> csrc/add_chords.cu
  K5  probe_pack                           -> csrc/probe_pack.cu
  K1 + K5 hash160_probe                    -> csrc/hash160_probe.cu

K1-K3 port the JAX package's Pallas kernels; K4 and K5 port the stages
of its `add` step that XLA compiles around them (the chords with the
endomorphism rows, and the prefilter probe with the mask packing).  The
searches run K1 with K5 as its epilogue (`hash160_probe`: the hash rows
stay in registers); K1 and K5 alone serve the bench and the checks.

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
import ctypes

import torch

from . import _build, bloom, ecc, fel, filters, hash160

NLIMBS = 16
LAUNCHES = {"hash160": 0, "inv_mod_batch": 0, "mixed_add": 0,
            "add_chords": 0, "probe_pack": 0, "hash160_probe": 0}
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


def _check_rows(name: str, t: torch.Tensor, ndim: int) -> None:
    _check_limbs(name, t)
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got "
                         f"{tuple(t.shape)}")


_CHORD_DIMS = {"cx": 2, "cy": 2, "tx": 2, "ty": 2, "dpx": 1, "dpy": 1}


def _check_chords(**named) -> None:
    """The step's centers cx, cy (16, M), table tx, ty (16, K/2) and
    advance point dpx, dpy (16,), all on cx's device; each y has its x's
    shape."""
    dev = named["cx"].device
    for name, t in named.items():
        _check_rows(name, t, _CHORD_DIMS[name])
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cx on {dev}")
    for x, y in (("cx", "cy"), ("tx", "ty"), ("dpx", "dpy")):
        if y in named:
            _check_same(named[x], **{y: named[y]})


def chord_dx(cx: torch.Tensor, tx: torch.Tensor,
             dpx: torch.Tensor) -> torch.Tensor:
    """K4, first launch: the step's chord denominators, K2's input, as one
    (16, M*K/2 + M) batch: element m*K/2 + j is tx[j] - cx[m], element
    M*K/2 + m is dpx - cx[m] (ecc.chord_dx_plain)."""
    _check_chords(cx=cx, tx=tx, dpx=dpx)
    if cx.device.type == "cpu":
        return ecc.chord_dx_plain(cx, tx, dpx)
    m_, k2 = cx.shape[1], tx.shape[1]
    out = torch.empty((NLIMBS, m_ * k2 + m_), dtype=torch.int64,
                      device=cx.device)
    if m_ and k2:
        _launch("ecl_chord_dx", cx.device, cx.data_ptr(), tx.data_ptr(),
                dpx.data_ptr(), out.data_ptr(), m_, k2)
        _count("add_chords", 2 * m_ * k2)
    return out


def chord_points(cx, cy, tx, ty, dpx, dpy, inv, need_beta: bool,
                 need_neg: bool):
    """K4, second launch: from K2's inverses of `chord_dx`'s batch, the
    step's M*K points in the flat layout and the advanced centers, as
    ecc.chord_points_plain returns them: ((x, [beta*x, beta^2*x]),
    (y, [-y]), ncx, ncy), each (16, M*K) or (16, M)."""
    _check_chords(cx=cx, cy=cy, tx=tx, ty=ty, dpx=dpx, dpy=dpy)
    m_, k2 = cx.shape[1], tx.shape[1]
    _check_rows("inv", inv, 2)
    if tuple(inv.shape) != (NLIMBS, m_ * k2 + m_) or inv.device != cx.device:
        raise ValueError(f"inv {tuple(inv.shape)}@{inv.device} must be "
                         f"{(NLIMBS, m_ * k2 + m_)}@{cx.device}")
    if cx.device.type == "cpu":
        return ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv,
                                      need_beta, need_neg)
    rows = 2 + 2 * bool(need_beta) + bool(need_neg)
    out = torch.empty((rows, NLIMBS, 2 * m_ * k2), dtype=torch.int64,
                      device=cx.device)
    nc = torch.empty((2, NLIMBS, m_), dtype=torch.int64, device=cx.device)
    xs = (out[0],) + ((out[2], out[3]) if need_beta else ())
    ys = (out[1],) + ((out[-1],) if need_neg else ())
    if m_ and k2:
        ptr = [t.data_ptr() for t in xs + ys]
        bx1, bx2 = ptr[1:3] if need_beta else (None, None)
        _launch("ecl_chord_points", cx.device, cx.data_ptr(), cy.data_ptr(),
                tx.data_ptr(), ty.data_ptr(), dpx.data_ptr(), dpy.data_ptr(),
                inv.data_ptr(), ptr[0], ptr[len(xs)], bx1, bx2,
                ptr[-1] if need_neg else None, nc[0].data_ptr(),
                nc[1].data_ptr(), m_, k2)
        _count("add_chords", 2 * m_ * k2)
    return xs, ys, nc[0], nc[1]


PROBE_MODES = {"compare": 0, "exact": 1, "pow2": 2}
MAX_PLANES = 6              # planes of one address form per hash160_probe launch


def _check_probe_inputs(bits: torch.Tensor, first_words, device) -> None:
    """bits: the filter's 1-D int32 words; first_words: None or 1-D int64;
    both on `device`."""
    if not isinstance(bits, torch.Tensor) or bits.dtype != torch.int32 \
            or bits.dim() != 1:
        raise TypeError("bits: expected a 1-D int32 tensor")
    if first_words is not None and (
            not isinstance(first_words, torch.Tensor)
            or first_words.dtype != torch.int64 or first_words.dim() != 1):
        raise TypeError("first_words: expected a 1-D int64 tensor")
    for name, t in (("bits", bits), ("first_words", first_words)):
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, the keys on {device}")


def _probe_args(filt: filters.Filter, bits: torch.Tensor,
                first_words: torch.Tensor | None) -> tuple:
    """The probe's launch arguments (csrc/probe.cuh): mode, bits, m, r,
    nprobes, log2_bits, first words and their count.  The exact probe
    takes nbits = 64 m with m <= 2^31 and r = floor((2^64 - 1) / m)."""
    if filt.mode == "bloom":
        mode, nbits, nprobes = "exact", filt.blf.nbits, filt.blf_probes
        r = bloom.exact_reciprocal(nbits)
        if not 1 <= nprobes <= 20:
            raise ValueError(f"probes: {nprobes}, expected 1 to 20")
    elif first_words is not None:
        mode, nbits, nprobes, r = "compare", 0, 0, 0
    else:
        mode, nbits, nprobes, r = "pow2", 1 << filt.pow2_log2, 2, 0
    if bits.numel() * 32 < nbits:
        raise ValueError(f"bits: {bits.numel()} words, the {mode} probe "
                         f"reads {nbits} bits")
    fw = first_words if mode == "compare" else None
    for name, t in (("bits", bits), ("first_words", fw)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: kernel input must be contiguous")
    return (PROBE_MODES[mode], bits.data_ptr(),
            nbits // 64 if mode == "exact" else 0, r, nprobes,
            filt.pow2_log2 if mode == "pow2" else 0,
            fw.data_ptr() if fw is not None else None,
            fw.numel() if fw is not None else 0)


def probe_pack(filt: filters.Filter, h: torch.Tensor, bits: torch.Tensor,
               first_words: torch.Tensor | None = None) -> torch.Tensor:
    """K5: (5, B) hash words of K1 -> (B/32,) int64 packed hit words,
    `filt`'s prefilter probe with the mask packing
    (filters.probe_pack_plain); bits and first_words as for
    `filt.device_probe`.  B must be a multiple of 32."""
    if not isinstance(h, torch.Tensor) or h.dtype != torch.int64:
        raise TypeError("h: expected an int64 tensor of hash words")
    if h.dim() != 2 or h.shape[0] != 5:
        raise ValueError(f"h: expected shape (5, B), got {tuple(h.shape)}")
    if h.shape[1] % 32:
        raise ValueError(f"h: {h.shape[1]} keys, not a multiple of 32")
    _check_probe_inputs(bits, first_words, h.device)
    if h.device.type == "cpu":
        return filters.probe_pack_plain(filt, h, bits, first_words)
    args = _probe_args(filt, bits, first_words)
    if not h.is_contiguous():
        raise ValueError("h: kernel input must be contiguous")
    n = h.shape[1]
    out = torch.empty((n // 32,), dtype=torch.int64, device=h.device)
    if n:
        _launch("ecl_probe_pack", h.device, h.data_ptr(), n, *args,
                out.data_ptr())
        _count("probe_pack", n)
    return out


def hash160_probe(filt: filters.Filter, xs, ys, planes, bits: torch.Tensor,
                  first_words: torch.Tensor | None,
                  out: torch.Tensor) -> torch.Tensor:
    """K1 with K5 as its epilogue: for plane v of `planes`, v = (i, j,
    is33), out[v] receives the packed hit words of `filt`'s prefilter
    probe of the hash160 of the keys whose x is xs[i] and y is ys[j],
    compressed when is33; returns out.  xs holds 1 to 3 and ys 1 or 2
    (16, B) limb rows (a step's x, beta x, beta^2 x and y, -y), B a
    multiple of 32; out is (V, B/32) int64; bits and first_words as for
    `filt.device_probe`.  On the CPU each plane is K1's and K5's plain
    forms; on the card one launch per address form covers its planes (at
    most MAX_PLANES), and the hash rows never reach memory."""
    xs, ys = tuple(xs), tuple(ys)
    if not (1 <= len(xs) <= 3 and 1 <= len(ys) <= 2):
        raise ValueError(f"{len(xs)} x rows and {len(ys)} y rows, expected "
                         f"1 to 3 and 1 or 2")
    rows = {f"xs[{k}]": t for k, t in enumerate(xs)}
    rows.update({f"ys[{k}]": t for k, t in enumerate(ys)})
    for name, t in rows.items():
        _check_rows(name, t, 2)
    _check_same(xs[0], **rows)
    dev, n = xs[0].device, xs[0].shape[1]
    if n % 32:
        raise ValueError(f"{n} keys per row, not a multiple of 32")
    planes = [(int(i), int(j), bool(is33)) for i, j, is33 in planes]
    if not planes or not all(0 <= i < len(xs) and 0 <= j < len(ys)
                             for i, j, _ in planes):
        raise ValueError(f"planes {planes}: each (x row, y row, is33) must "
                         f"name one of {len(xs)} x and {len(ys)} y rows")
    if max(sum(p[2] == f for p in planes) for f in (True, False)) > MAX_PLANES:
        raise ValueError(f"planes {planes}: more than {MAX_PLANES} of one "
                         f"address form")
    if (not isinstance(out, torch.Tensor) or out.dtype != torch.int64
            or tuple(out.shape) != (len(planes), n // 32)
            or out.device != dev):
        raise ValueError(f"out: expected an int64 tensor of shape "
                         f"{(len(planes), n // 32)} on {dev}")
    _check_probe_inputs(bits, first_words, dev)
    if dev.type == "cpu":
        for v, (i, j, is33) in enumerate(planes):
            h = (hash160.addr33_hash_rows if is33
                 else hash160.addr65_hash_rows)(xs[i], ys[j])
            out[v] = filters.probe_pack_plain(filt, h, bits, first_words)
        return out
    args = _probe_args(filt, bits, first_words)
    if not out.is_contiguous():
        raise ValueError("out: kernel output must be contiguous")
    ptrs = [t.data_ptr() for t in xs] + [0] * (3 - len(xs)) \
        + [t.data_ptr() for t in ys] + [0] * (2 - len(ys))
    row_ptrs = (ctypes.c_ulonglong * 5)(*ptrs)
    for is33 in (True, False):
        table = [c for v, (i, j, f) in enumerate(planes) if f == is33
                 for c in (i, j, v)]
        if n and table:
            _launch("ecl_hash160_probe", dev, row_ptrs,
                    (ctypes.c_int * len(table))(*table), len(table) // 3,
                    int(is33), n, *args, out.data_ptr())
            _count("hash160_probe", n)
    return out
