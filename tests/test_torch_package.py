"""Package hygiene of the port: nothing of jax or of the JAX package
(`ecloop_tpu`) anywhere in ecloop_tpu_torch or chip_smoke.py, the port's
copies of the golden model and the host oracle source equal the JAX
package's, the kernel wrappers validate their inputs, the build names
existing sources, and chip_smoke.py refuses to run without a GPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecloop_tpu import golden as jgolden
from ecloop_tpu_torch import _build, golden, kernels, native

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ecloop_tpu_torch"
# jax, and every module of the JAX package
JAX_MODULES = ("jax", "ecloop_tpu")


def _imported_modules(path: pathlib.Path, package: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:                    # relative: resolve in package
                base = package.rsplit(".", node.level - 1)[0] if node.level > 1 \
                    else package
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            names.add(mod)
            names.update(f"{mod}.{a.name}" for a in node.names)
    return names


def _is_jax(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in JAX_MODULES)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax(path):
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    bad = sorted(n for n in _imported_modules(path, pkg) if _is_jax(n))
    assert not bad, bad


def test_chip_smoke_imports_no_jax_package():
    names = _imported_modules(ROOT / "chip_smoke.py", "")
    assert not [n for n in names if _is_jax(n)]


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, ecloop_tpu_torch, ecloop_tpu_torch.cli, "
            "ecloop_tpu_torch.search.add, ecloop_tpu_torch.search.mul, "
            "ecloop_tpu_torch.search.rnd, ecloop_tpu_torch.checkpoint, "
            "ecloop_tpu_torch.kernels, ecloop_tpu_torch._build, "
            "ecloop_tpu_torch.benchlib, ecloop_tpu_torch.sol; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'ecloop_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""


def test_build_names_existing_sources():
    for name in _build.SOURCES + _build.HEADERS:
        assert (PKG / "csrc" / name).is_file(), name
    assert set(_build.SOURCES) == {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.relpath(_build.BUILD_DIR, ROOT) == os.path.join(
        "build", "ecloop_tpu_torch")


def _limbs(*shape, dtype=torch.int64):
    return torch.zeros((16,) + shape, dtype=dtype)


@pytest.mark.parametrize("fn", [kernels.addr33_hash_rows,
                                kernels.addr65_hash_rows])
def test_hash_wrappers_reject_bad_inputs(fn):
    with pytest.raises(TypeError):
        fn(_limbs(8, dtype=torch.int32), _limbs(8))
    with pytest.raises(ValueError):
        fn(torch.zeros(15, 8, dtype=torch.int64), _limbs(8))
    with pytest.raises(ValueError):
        fn(_limbs(8), _limbs(9))
    with pytest.raises(TypeError):
        fn([0] * 16, _limbs(8))
    assert fn(_limbs(8), _limbs(8)).shape == (5, 8)


def test_inv_wrapper_rejects_bad_inputs():
    with pytest.raises(TypeError):
        kernels.inv_mod_batch(_limbs(8, dtype=torch.float32))
    with pytest.raises(ValueError):
        kernels.inv_mod_batch(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        kernels.inv_mod_batch(torch.zeros(4, 16, dtype=torch.int64))
    assert torch.equal(kernels.inv_mod_batch(_limbs(3)), _limbs(3))


def test_mixed_add_wrapper_rejects_bad_inputs():
    q = [_limbs(8) for _ in range(5)]
    skip = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        kernels.proj_add_affine(*q, skip.to(torch.int32), True)
    with pytest.raises(ValueError):
        kernels.proj_add_affine(*q, torch.zeros(9, dtype=torch.bool), True)
    with pytest.raises(ValueError):
        kernels.proj_add_affine(*q[:4], _limbs(9), skip, True)
    with pytest.raises(TypeError):
        kernels.proj_add_affine(*q[:4], _limbs(8, dtype=torch.int32), skip,
                                False)
    out = kernels.proj_add_affine(*q, skip, False)
    assert [t.shape for t in out] == [(16, 8)] * 3


def test_cpu_calls_do_not_count_as_launches():
    kernels.reset_launches()
    kernels.addr33_hash_rows(_limbs(4), _limbs(4))
    kernels.inv_mod_batch(_limbs(4))
    kernels.proj_add_affine(*[_limbs(4)] * 5, torch.ones(4, dtype=torch.bool),
                            True)
    assert kernels.LAUNCHES == {"hash160": 0, "inv_mod_batch": 0,
                                "mixed_add": 0, "add_chords": 0,
                                "probe_pack": 0, "hash160_probe": 0}


def test_golden_copy_matches_the_jax_package():
    for name in ("P", "N", "GX", "GY", "G", "LAMBDA1", "LAMBDA2", "BETA1",
                 "BETA2"):
        assert getattr(golden, name) == getattr(jgolden, name), name
    rng = np.random.default_rng(11)
    for _ in range(8):
        a, b = (int.from_bytes(rng.bytes(32), "big") % golden.N
                for _ in range(2))
        pa, pb = golden.point_mul(a), golden.point_mul(b)
        assert pa == jgolden.point_mul(a)
        assert golden.point_add(pa, pb) == jgolden.point_add(pa, pb)
        assert golden.point_dbl(pa) == jgolden.point_dbl(pa)
        assert golden.addr33(pa) == jgolden.addr33(pa)
        assert golden.addr65(pa) == jgolden.addr65(pa)
        assert golden.endo_points(pa) == jgolden.endo_points(pa)
        assert ([golden.endo_priv(a, e) for e in range(6)]
                == [jgolden.endo_priv(a, e) for e in range(6)])
        assert golden.inv_mod(a) == jgolden.inv_mod(a)


def test_host_oracle_source_is_the_jax_packages():
    assert (PKG / "host" / "ecloop_host.cpp").read_bytes() == (
        ROOT / "native" / "ecloop_host.cpp").read_bytes()


def test_host_oracle_builds_outside_native_and_agrees_with_golden():
    if not native.available():
        pytest.skip("no host C++ compiler")
    lib = pathlib.Path(native.library_path())
    assert lib.parent == pathlib.Path(_build.BUILD_DIR) and lib.is_file()
    rng = np.random.default_rng(12)
    for k in [1, 0xC936, golden.N - 1] + [
            int.from_bytes(rng.bytes(32), "big") % golden.N for _ in range(4)]:
        pt = golden.point_mul(k)
        assert native.pk_hash160(k, True) == golden.addr33(pt)
        assert native.pk_hash160(k, False) == golden.addr65(pt)
    assert native.pk_hash160(0, True) is None
