"""Build the port's CUDA kernels into one shared library and load it.

All `csrc/*.cu` named in SOURCES are compiled with nvcc for Hopper
(`sm_90a`) into `build/ecloop_tpu_torch/` at the repository root, on
first use, keyed by a hash of the sources and flags: a checkout that
holds only the sources builds everything on its first kernel call.  One
nvcc per source, all started together, then one link.  What ptxas says
of each kernel (registers, spills) is kept beside the library in
`log_path()`.  The library has a plain C interface, loaded with ctypes;
every pointer and the stream pass as `c_void_p`.
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
SOURCES = ("hash160.cu", "inv_batch.cu", "mixed_add.cu", "add_chords.cu",
           "probe_pack.cu", "hash160_probe.cu")
HEADERS = ("field.cuh", "hash160.cuh", "probe.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ecloop_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def _source_key(flags=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(flags=()) -> str:
    return os.path.join(BUILD_DIR,
                        f"libecloop_kernels_{_source_key(flags)}.so")


def log_path(flags=()) -> str:
    return library_path(flags)[:-len(".so")] + ".log"


def build(flags=()) -> str:
    """Compile the kernels unless this exact build exists; returns the
    library path.  `flags` are added to nvcc's (a measurement's -D
    of a constant; the library the package loads takes none)."""
    path = library_path(flags)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", os.path.join(CSRC, src),
                   "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(log[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", so, *(obj for _c, obj, _p in jobs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        with open(os.path.join(tmp, "lib.log"), "w") as f:
            f.write("\n".join(log))
        os.replace(os.path.join(tmp, "lib.log"), log_path(flags))
        os.replace(so, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def load(path: str) -> ctypes.CDLL:
    """The library at `path` with its entry points' argument types."""
    cdll = ctypes.CDLL(path)
    vp, ll, ull = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong
    cdll.ecl_hash160.argtypes = [vp, vp, vp, ll, ctypes.c_int, vp]
    cdll.ecl_hash160.restype = ctypes.c_int
    cdll.ecl_inv_batch.argtypes = [vp, vp, ll, vp]
    cdll.ecl_inv_batch.restype = ctypes.c_int
    cdll.ecl_inv_batch_block.argtypes = []
    cdll.ecl_inv_batch_block.restype = ctypes.c_int
    cdll.ecl_current_device.argtypes = []
    cdll.ecl_current_device.restype = ctypes.c_int
    cdll.ecl_mixed_add.argtypes = [vp] * 7 + [ll, ctypes.c_int, vp]
    cdll.ecl_mixed_add.restype = ctypes.c_int
    cdll.ecl_chord_dx.argtypes = [vp] * 4 + [ll, ll, vp]
    cdll.ecl_chord_dx.restype = ctypes.c_int
    cdll.ecl_chord_points.argtypes = [vp] * 14 + [ll, ll, vp]
    cdll.ecl_chord_points.restype = ctypes.c_int
    probe = [ctypes.c_int, vp, ull, ull, ctypes.c_int, ctypes.c_int, vp,
             ll]               # mode, bits, m, r, nprobes, log2_bits, fw, nfw
    cdll.ecl_probe_pack.argtypes = [vp, ll, *probe, vp, vp]
    cdll.ecl_probe_pack.restype = ctypes.c_int
    cdll.ecl_hash160_probe.argtypes = [
        ctypes.POINTER(ull), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ll, *probe, vp, vp]
    cdll.ecl_hash160_probe.restype = ctypes.c_int
    return cdll
