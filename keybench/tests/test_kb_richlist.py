"""The configuration `richlist-10k` and its cell `richlist-rnd-endo-cu`:
the hashes file, the cell as the harness loads it, its five per-layer
metrics' readers on records, the step's least time it is priced at, and
a whole run on the CPU at a size a test can hold."""

import os
import re
import time

import pytest

from ecloop_tpu_torch.search.common import SearchConfig
from keybench import harness

CELL = "richlist-rnd-endo-cu"
NEW = ("prefilter_fp_per_gkey.list", "hash_probe_roofline.endo",
       "chord_inv_roofline.endo", "host_confirm_share.list",
       "device_idle_share.list")
INT_RATE = 64 * 132 * 1980e6


def test_the_hashes_file_holds_10000_unique_hash160s():
    path = os.path.join(harness.HERE, "configs", "richlist-10k-hash")
    with open(path) as f:
        lines = f.read().split("\n")
    assert lines[-1] == "" and len(lines) == 10001
    lines = lines[:-1]
    assert all(re.fullmatch(r"[0-9a-f]{40}", ln) for ln in lines)
    assert len(set(lines)) == 10000


def test_the_cell_loads_with_its_metrics():
    c = harness.cell(harness.load_spec(), CELL)
    assert c.workload["chips"] == 1 == harness.traffic_chips(c.traffic)
    assert c.config["targets"] == "list"
    assert c.config["hashes_file"] == "richlist-10k-hash"
    assert c.traffic["command"] == "rnd"
    assert c.traffic["args"] == ["-endo", "-a", "cu"]
    assert c.traffic["subranges"] * c.traffic["plants_per_subrange"] == 128
    assert [m["name"] for m in c.end_to_end] == ["keys_per_s", "setup_s"]
    assert [m["name"] for m in c.per_layer] == list(NEW)
    assert all(m["moves"] == "keys_per_s" for m in c.per_layer)


def _record(counts=None) -> dict:
    """A traced run's record: two profiled windows of 0.1 s, 25 and 24
    steps, and the least seconds of a step per account term."""
    rec = {"window_s": 51.0,
           "samples": [
               {"wall_s": 0.1, "units": 25, "busy_s": 0.094,
                "device_ops": {"inv_batch_kernel": 0.00075,
                               "chord_dx_kernel": 0.0001,
                               "chord_points_kernel": 0.0011,
                               "hash160_probe_kernel<true, 2>": 0.0039,
                               "hash160_probe_kernel<false, 2>": 0.0032,
                               "Memcpy DtoH": 0.0002},
                "idle": {"launch": 0.004, "drain": 0.002}},
               {"wall_s": 0.1, "units": 24, "busy_s": 0.092,
                "device_ops": {"inv_batch_kernel": 0.0007,
                               "chord_dx_kernel": 0.0001,
                               "chord_points_kernel": 0.001,
                               "hash160_probe_kernel<true, 2>": 0.0037,
                               "hash160_probe_kernel<false, 2>": 0.0031},
                "idle": {"launch": 0.005, "drain": 0.003}}],
           "spans": {"derive_h160": {"s": 0.02, "n": 300},
                     "confirm": {"s": 0.005, "n": 300},
                     "launch": {"s": 3.0, "n": 10000}},
           "least_s": {"chord_dx": 2.6e-6, "chord_points": 2.8e-5,
                       "inv_batch": 5.0e-6, "hash_probe": 1.9e-4}}
    if counts is not None:
        rec["program"] = {"spans": {}, "device": {}, "counts": counts}
    return rec


def test_the_readers_on_records():
    lanes = 130000 * 12 * 131072
    rec = _record({"add.lanes": lanes, "add.candidates": 1100,
                   "add.confirmed": 1000})
    read = {n: harness.reader(n)(rec) for n in NEW}
    assert read["prefilter_fp_per_gkey.list"] == pytest.approx(
        1e9 * 100 / lanes)
    hash_dev = 0.0039 + 0.0032 + 0.0037 + 0.0031
    assert read["hash_probe_roofline.endo"] == pytest.approx(
        100 * 49 * 1.9e-4 / hash_dev)
    chord_dev = 0.00075 + 0.0001 + 0.0011 + 0.0007 + 0.0001 + 0.001
    assert read["chord_inv_roofline.endo"] == pytest.approx(
        100 * 49 * (2.6e-6 + 2.8e-5 + 5.0e-6) / chord_dev)
    assert read["host_confirm_share.list"] == pytest.approx(
        100 * 0.025 / 51.0)
    assert read["device_idle_share.list"] == pytest.approx(
        100 * (1 - 0.186 / 0.2))
    # nothing to read: no tracer counts, no profiled window, no wall
    bare = dict(_record({}), samples=[], least_s={}, window_s=0)
    assert all(harness.reader(n)(bare) is None for n in NEW)


def test_the_step_is_priced_over_12_planes(monkeypatch):
    """-endo -a cu: K4 in its endo form and the hash of 6 addr33 and 6
    addr65 planes, the probe priced as a compare over the list's first
    words (ceil(log2 10,128) = 14 levels)."""
    monkeypatch.setattr(harness, "_int_rate", lambda: INT_RATE)
    su = harness.Setup([], None, [], [], None, None, 10128, None)
    least = harness.step_least_s(SearchConfig(endo=True, addr65=True), su,
                                 ["addr33", "addr65"])
    n = 32 * 4096
    ops = n * (6 * 1474 + 6 * 2449 + 12 * (14 * 3 + 1 + 1))
    assert least["hash_probe"] == pytest.approx(ops / INT_RATE)
    assert least["chord_points"] == pytest.approx(92819712 / 3.35e12)


def test_sound_run_over_the_list_is_correct(monkeypatch):
    """The cell on the CPU at 4 x 2,048 keys a step: the harness's
    targets (10,000 + the planted) take the port's list prefilter, and
    every planted key of the first two steps is found."""
    for k, v in {"ECLOOP_CENTERS": "4", "ECLOOP_GROUP_K": "2048",
                 "ECLOOP_STEPS_PER_CALL": "1"}.items():
        monkeypatch.setenv(k, v)
    c = harness.cell(harness.load_spec(), CELL)
    c.traffic.update(plant_span=2 * 8192, plants_per_subrange=8, subranges=2)
    su = harness.make_targets(c, 2**31 + 19, "cpu")
    su.tmp.cleanup()
    assert len(su.holds.hashes) == 10016 and su.n_first > 2048
    r = harness.run_cell(c, 2**31 + 19, 4.0, False, "cpu",
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 8 and r["failed"] == 0
    assert set(r["metrics"]) == {"keys_per_s", "setup_s"}
