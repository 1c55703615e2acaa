"""A whole run on the CPU, past the harness's look for a card, at a size a
test can hold: sound, it is correct; with the timed path broken by each
fault the cell can have, or with the control in the program's place, the
judge says it is not."""

import itertools
import time
import types

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


# --- a cell over four cards, [cpu] * 4 standing for them -----------------------

# rnd -t 4 over the puzzle preset: out of BENCHMARK.json while its rate
# spreads too widely to bound (PERF.md), its traffic kept for it
X4 = {"name": "puzzle71-rnd-x4", "config": "puzzles-cmp",
      "traffic": "rnd-puzzle71-x4", "chips": 4}


def _cell(name):
    spec = harness.load_spec()
    if name == X4["name"]:
        spec["workloads"].append(X4)
    return harness.cell(spec, name)


def _run_steps(monkeypatch, name, devices, centers, fault=None, env=()):
    """A run whose window ends at its second step boundary: the harness
    reads a clock that moves one second a reading, and the window is 1.5
    s.  Sixteen keys planted across the first two steps of 32,768 keys
    (`centers` a device x 2,048 x `devices`), so across every card."""
    from ecloop_tpu_torch.search import mul

    for k, v in dict(GEOMETRY, ECLOOP_CENTERS=str(centers),
                     **dict(env)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(mul, "W", 8)
    monkeypatch.setattr(harness, "time", types.SimpleNamespace(
        perf_counter=itertools.count().__next__))
    seen = {}
    window = harness._RangeRun.window

    def spy(self, seconds, sampler):
        out = window(self, seconds, sampler)
        seen.update(found=sorted(self.found), k_checked=self.eng.k_checked,
                    done=[(s.lo, s.done) for s in self.subs])
        return out
    monkeypatch.setattr(harness._RangeRun, "window", spy)
    c = _cell(name)
    c.traffic.update(plant_span=2 * 32768, plants_per_subrange=16,
                     subranges=2)
    r = harness.run_cell(c, SEED, 1.5, False, ["cpu"] * devices, 0.0,
                         fault=faults.FAULTS.get(fault))
    return r, seen


def test_four_cards_find_what_one_finds(monkeypatch):
    r4, seen4 = _run_steps(monkeypatch, "puzzle71-rnd-x4", 4, 4)
    assert r4["correct"], r4["checks"]
    assert r4["device"]["count"] == 4 and r4["attempted"] >= 16
    r1, seen1 = _run_steps(monkeypatch, "puzzle71-rnd", 1, 16)
    assert r1["correct"], r1["checks"]
    assert seen4["done"] == seen1["done"] == [(seen1["done"][0][0], 65536)]
    assert seen4["found"] == seen1["found"] and len(seen4["found"]) >= 16
    assert seen4["k_checked"] == seen1["k_checked"]


def test_traffic_and_devices_must_agree_with_chips():
    c = _cell("puzzle71-rnd-x4")
    assert harness.traffic_chips(c.traffic) == c.workload["chips"] == 4
    with pytest.raises(ValueError):
        harness.run_cell(c, SEED, 1.0, False, "cpu", 0.0)
    one = _cell("puzzle71-rnd")
    with pytest.raises(ValueError):
        harness.run_cell(one, SEED, 1.0, False, ["cpu"] * 4, 0.0)


@pytest.mark.parametrize("fault,env,check", [
    ("frozen_state", {}, "missed_planted"),
    ("half_batch", {}, "missed_planted"),
    ("dropped_card", {}, "missed_planted"),
    ("altered_answer", {}, "wrong_found"),
    ("skip_confirm", {"ECLOOP_CMP_MAX": "0"}, "wrong_found")])
def test_four_card_faults_and_control_are_caught(monkeypatch, fault, env,
                                                 check):
    r, _ = _run_steps(monkeypatch, "puzzle71-rnd-x4", 4, 4, fault, env)
    assert not r["correct"] and r["checks"][check]["value"] > 0
