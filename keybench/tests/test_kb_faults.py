"""A whole run on the CPU, past the harness's look for a card, at a size a
test can hold: sound, it is correct; with the timed path broken by each
fault the cell can have, or with the control in the program's place, the
judge says it is not."""

import time

import pytest

from keybench import faults, harness

SEED = 2**31 + 12345
GEOMETRY = {"ECLOOP_CENTERS": "4", "ECLOOP_GROUP_K": "2048",
            "ECLOOP_STEPS_PER_CALL": "1", "ECLOOP_MUL_BATCH": "2048"}


def _run(monkeypatch, name, fault=None, env=(), seconds=5.0):
    from ecloop_tpu_torch.search import mul

    for k, v in dict(GEOMETRY, **dict(env)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mul, "W", 8)          # a table the CPU builds fast
    c = harness.cell(harness.load_spec(), name)
    c.config["random_hashes"] = 2000
    # every key planted within the first two 8,192-key steps, which a
    # window of a few seconds holds even on a slow CPU
    c.traffic.update(plant_span=2 * 8192, plants_per_subrange=16,
                     subranges=2, pool_lines=6000, plants=16)
    return harness.run_cell(c, SEED, seconds, False, "cpu",
                            time.perf_counter(),
                            fault=faults.FAULTS.get(fault))


def test_sound_range_run_is_correct(monkeypatch):
    r = _run(monkeypatch, "puzzle71-rnd")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 16 and r["failed"] == 0


@pytest.mark.parametrize("fault,check", [
    ("frozen_state", "missed_planted"), ("half_batch", "missed_planted"),
    ("altered_answer", "wrong_found")])
def test_range_faults_are_caught(monkeypatch, fault, check):
    r = _run(monkeypatch, "puzzle71-rnd", fault)
    assert not r["correct"] and r["checks"][check]["value"] > 0


def test_range_control_is_caught(monkeypatch):
    # the pow2 prefilter (more than ECLOOP_CMP_MAX targets) passes about
    # one key in a thousand, so the window holds device candidates
    r = _run(monkeypatch, "puzzle71-rnd", "skip_confirm",
             env={"ECLOOP_CMP_MAX": "0"})
    assert not r["correct"] and r["checks"]["wrong_found"]["value"] > 0


def test_sound_mul_run_is_correct(monkeypatch):
    r = _run(monkeypatch, "funded-mul-raw")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 16 and r["failed"] == 0


@pytest.mark.parametrize("fault,env,check", [
    ("half_batch", {}, "missed_planted"),
    ("altered_answer", {}, "wrong_found"),
    # one device probe: a third of the keys are device candidates
    ("skip_confirm", {"ECLOOP_BLF_PROBES": "1"}, "wrong_found")])
def test_mul_faults_and_control_are_caught(monkeypatch, fault, env, check):
    r = _run(monkeypatch, "funded-mul-raw", fault, env)
    assert not r["correct"] and r["checks"][check]["value"] > 0
