"""ctypes bindings for the host oracle library (`host/ecloop_host.cpp`).

The library holds the host-side fast paths the port calls: an
independent C++ secp256k1 + hash160 oracle for re-deriving hits, bloom
add and probe, and exact sorted-list membership.  It is built with the
host C++ compiler into `build/ecloop_tpu_torch/` at first use, keyed by
a hash of the source and flags, like the CUDA kernels (`_build.py`).
ECLOOP_NATIVE_BUILD=0 (any value but 1) compiles nothing: a library
already built is loaded, and without one `available()` is false.  Every
caller has a pure-Python fallback: `available()` is false where no
compiler or no library can be had.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from . import _build

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "host",
                      "ecloop_host.cpp")
# the flags of native/Makefile
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR,
                        f"libecloop_host_{h.hexdigest()[:16]}.so")


def build() -> str | None:
    """Compile the library unless this exact build exists; returns its
    path, or None when the compiler is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o",
                            tmp, SOURCE], capture_output=True, timeout=300)
        if r.returncode != 0:
            return None
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = (build() if os.environ.get("ECLOOP_NATIVE_BUILD", "1") == "1"
            else library_path())
    if path is None or not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ecl_pk_hash160.argtypes = [u8p, ctypes.c_int, u8p]
    lib.ecl_pk_hash160.restype = ctypes.c_int
    lib.ecl_bloom_add.argtypes = [u64p, ctypes.c_uint64, u32p, ctypes.c_size_t]
    lib.ecl_bloom_add.restype = None
    lib.ecl_bloom_has.argtypes = [u64p, ctypes.c_uint64, u32p,
                                  ctypes.c_size_t, u8p]
    lib.ecl_bloom_has.restype = None
    lib.ecl_list_search.argtypes = [u32p, ctypes.c_size_t, u32p]
    lib.ecl_list_search.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pk_hash160(priv: int, compressed: bool) -> bytes | None:
    """hash160 of priv*G from the C++ oracle; None for priv = 0."""
    k = np.frombuffer(priv.to_bytes(32, "big"), dtype=np.uint8)
    out = np.empty(20, dtype=np.uint8)
    if not _load().ecl_pk_hash160(_ptr(k, ctypes.c_uint8), int(compressed),
                                  _ptr(out, ctypes.c_uint8)):
        return None
    return out.tobytes()


def bloom_add(bits: np.ndarray, hashes: np.ndarray) -> None:
    """bits: (W,) u64, updated in place; hashes: (N, 5) u32."""
    h = np.ascontiguousarray(hashes, dtype=np.uint32)
    _load().ecl_bloom_add(_ptr(bits, ctypes.c_uint64), len(bits),
                          _ptr(h, ctypes.c_uint32), len(h))


def bloom_has(bits: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """All-20-probes membership of (N, 5) u32 hashes -> (N,) bool."""
    h = np.ascontiguousarray(hashes, dtype=np.uint32)
    out = np.empty(len(h), dtype=np.uint8)
    _load().ecl_bloom_has(_ptr(bits, ctypes.c_uint64), len(bits),
                          _ptr(h, ctypes.c_uint32), len(h),
                          _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def list_search(sorted_rows: np.ndarray, h: np.ndarray) -> int:
    """Row index of h (5,) in lexicographically sorted (N, 5) u32 rows,
    -1 if absent."""
    rows = np.ascontiguousarray(sorted_rows, dtype=np.uint32)
    hq = np.ascontiguousarray(h, dtype=np.uint32)
    return int(_load().ecl_list_search(_ptr(rows, ctypes.c_uint32),
                                       len(rows), _ptr(hq, ctypes.c_uint32)))
