"""Nothing the benchmark loads is JAX or the JAX package, by top-level
names compared whole."""

import os
import subprocess
import sys
import types

from keybench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("ecloop_tpu_torch.x", "ecloop_tpu_tools", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not [m for m in harness.forbidden_modules()
                if m.split(".")[0] != "jax"]
    monkeypatch.setitem(sys.modules, "ecloop_tpu.cli",
                        types.ModuleType("ecloop_tpu.cli"))
    assert "ecloop_tpu.cli" in harness.forbidden_modules()


def test_the_harness_and_the_port_it_drives_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from keybench import harness, faults; "
            "from keybench.reference import judge; "
            "import ecloop_tpu_torch.cli, ecloop_tpu_torch.search.rnd, "
            "ecloop_tpu_torch.search.mul, ecloop_tpu_torch.filters; "
            "[harness.reader(m['name']) for m in harness.load_spec()"
            "['per_layer']]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    env = {k: v for k, v in os.environ.items()}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "keybench/run.py", "--workload",
                          "puzzle71-rnd", "--seed", str(2**31 + 7),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         text=True, capture_output=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_exits_without_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "keybench"), tmp_path / "keybench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "keybench/run.py", "--workload",
                          "puzzle71-rnd", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
