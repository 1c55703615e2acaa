"""Build the port's CUDA kernels into one shared library and load it.

All `csrc/*.cu` named in SOURCES are compiled with nvcc for Hopper
(`sm_90a`) into `build/ecloop_tpu_torch/` at the repository root, on
first use, keyed by a hash of the sources and flags: a checkout that
holds only the sources builds everything on its first kernel call.  The
library has a plain C interface, loaded with ctypes; every pointer and
the stream pass as `c_void_p`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("hash160.cu", "inv_batch.cu")
HEADERS = ("field.cuh",)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ecloop_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libecloop_kernels_{_source_key()}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; returns the
    library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(build())
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        cdll.ecl_hash160.argtypes = [vp, vp, vp, ll, ctypes.c_int, vp]
        cdll.ecl_hash160.restype = ctypes.c_int
        cdll.ecl_inv_batch.argtypes = [vp, vp, vp, ll, ll, vp]
        cdll.ecl_inv_batch.restype = ctypes.c_int
        _lib = cdll
    return _lib
