"""Package hygiene of the port: no jax anywhere in ecloop_tpu_torch, the
kernel wrappers validate their inputs, the build names existing sources,
and chip_smoke.py refuses to run without a GPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from ecloop_tpu_torch import _build, kernels

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ecloop_tpu_torch"
# modules of the JAX package that pull in jax when imported
JAX_MODULES = ("jax", "ecloop_tpu.bloom", "ecloop_tpu.filters",
               "ecloop_tpu.search", "ecloop_tpu.fel", "ecloop_tpu.fe",
               "ecloop_tpu.hash160", "ecloop_tpu.ecc",
               "ecloop_tpu.pallas_kernels")


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
    assert not [n for n in names if n.startswith(("jax", "ecloop_tpu."))
                or n == "ecloop_tpu"]


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, ecloop_tpu_torch, ecloop_tpu_torch.cli, "
            "ecloop_tpu_torch.search.add, ecloop_tpu_torch.kernels, "
            "ecloop_tpu_torch._build; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.')))")
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


def test_cpu_calls_do_not_count_as_launches():
    kernels.reset_launches()
    kernels.addr33_hash_rows(_limbs(4), _limbs(4))
    kernels.inv_mod_batch(_limbs(4))
    assert kernels.LAUNCHES == {"hash160": 0, "inv_mod_batch": 0}
