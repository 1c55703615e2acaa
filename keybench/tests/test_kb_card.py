"""A short run of each cell on the card (marked `cuda`; skipped without
one): it prints a correct result naming the card."""

import json
import os
import subprocess
import sys

import pytest

from keybench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    import torch

    chips = harness.cell(harness.load_spec(), cell).workload["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA cards, "
                    f"{torch.cuda.device_count()} visible")
    out = subprocess.run([sys.executable, "keybench/run.py", "--workload",
                          cell, "--seed", str(2**31 + 99), "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == chips
