"""The program's tracer (`ecloop_tpu_torch.trace`) on the CPU: off it
records no span and leaves no `ecloop.` event in a profiler trace; on,
the `add` and `mul` engines' spans and counters agree with what the
search did, and the found sets and key counts are the untraced ones;
ECLOOP_PROFILE turns it on for a command and prints its `trace:` line."""

import glob
import json
import os
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ecloop_tpu_torch import cli, filters, golden, trace
from ecloop_tpu_torch.search import add, common, mul
from ecloop_tpu_torch.search.common import SearchConfig

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PUZZLES = os.path.join(ROOT, "data", "btc-puzzles-hash")
BW_PRIV = os.path.join(ROOT, "data", "btc-bw-priv")
BW_HASH = os.path.join(ROOT, "data", "btc-bw-hash")
SMALL = dict(centers=32, group_k=1024, steps_per_call=1)   # test_torch_add's
C936 = [("addr33", 0xC936)]
ONE_STEP = dict(centers=4, group_k=512, steps_per_call=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's own thread pool on
    these small batches only burns the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _c936(endo: bool, range_s=0x8000, range_e=0xFFFF, **geometry):
    cfg = SearchConfig(range_s=range_s, range_e=range_e, endo=endo,
                       **(geometry or SMALL))
    return add.AddSearch(cfg, filters.load_filter(PUZZLES), "cpu")


def _event_names(path) -> set:
    """The names of a Chrome trace's events (parsing the file is much
    faster than the profiler's own event list)."""
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_off_records_no_span_and_no_profiler_event(tmp_path):
    """One step under the profiler (its inversion's plain ops are
    thousands of events): c800:cfff, one claim of 2,048 keys, in one
    4 x 512 step."""
    eng = _c936(False, 0xC800, 0xCFFF, **ONE_STEP)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        found = eng.run_range()
    assert [(f.label, f.priv) for f in found] == C936
    assert eng.k_checked == 2047
    prof.export_chrome_trace(str(tmp_path / "off.json"))
    names = _event_names(tmp_path / "off.json")
    assert "aten::mul" in names
    assert not {n for n in names if n and n.startswith(trace.PREFIX)}
    snap = trace.snapshot()
    assert snap["spans"] == {} and snap["device"] == {}
    # counters stay on
    assert snap["counts"]["add.calls"] == 1


@pytest.mark.parametrize("endo,k_checked", [(False, 32767), (True, 196602)])
def test_add_spans_and_counters_agree_with_the_search(endo, k_checked):
    eng = _c936(endo)
    trace.enable(True)
    found = eng.run_range()
    snap = trace.snapshot()
    assert [(f.label, f.priv) for f in found] == C936
    assert eng.k_checked == k_checked
    spans, counts = snap["spans"], snap["counts"]
    calls = counts["add.calls"]
    assert spans["add.launch"]["n"] == spans["add.drain"]["n"] == calls == 1
    assert spans["add.span_setup"]["n"] == 1
    assert counts["add.steps"] == calls * SMALL["steps_per_call"]
    assert counts["add.lanes"] == (counts["add.steps"] * eng.cfg.keys_per_step
                                   * len(eng.variants))
    # T graph replays and T slot copies, then one mask fetch, per call
    assert counts["add.enqueues"] == counts["add.steps"] * 2 + calls
    assert counts["add.candidates"] >= counts["add.confirmed"] == 1
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["s"], name
    # the drain's children: the mask wait and the one step with a hit
    assert spans["add.wait"]["n"] == 1 and spans["add.hits"]["n"] == 1
    assert spans["add.drain"]["self_s"] == pytest.approx(
        spans["add.drain"]["s"] - spans["add.wait"]["s"]
        - spans["add.hits"]["s"], abs=1e-3)
    assert snap["device"] == {}                       # no marks off the card


class _Clock:
    """Stands in for CUDA timing events on a stream: an event records
    the clock's time (ms) when recorded."""

    now = 0.0

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self, stream):
            self.t = _Clock.now

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return other.t - self.t


def test_device_marks_give_busy_gap_and_wall(monkeypatch):
    """Two streams' calls, drained after the next call is queued as the
    engines do: per kind the busy time, the gap between a stream's calls
    (carried from call to call) and the wall summed over its streams."""
    monkeypatch.setattr(trace.torch.cuda, "Event", _Clock.Event)
    monkeypatch.setattr(trace.torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=d.index))
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert trace.device_mark("add", cuda0) is trace.OFF        # off
    trace.enable(True)
    assert trace.device_mark("add", torch.device("cpu")) is trace.OFF

    def call(dev, t0, t1):
        m = trace.device_mark("add", dev)
        _Clock.now = t0
        m.start()
        _Clock.now = t1
        m.end()
        return m

    a = call(cuda0, 0.0, 5.0)
    b = call(cuda1, 1.0, 4.0)
    c = call(cuda0, 7.0, 12.0)          # 2 ms after a on its stream
    for m in (a, b, c):
        m.done()
    d = call(cuda1, 10.0, 11.0)         # 6 ms after b
    d.done()
    dev = trace.snapshot()["device"]["add"]
    assert dev["calls"] == 4
    assert dev["busy_s"] == pytest.approx((5 + 3 + 5 + 1) / 1e3)
    assert dev["gap_s"] == pytest.approx((2 + 6) / 1e3)
    assert dev["wall_s"] == pytest.approx((12 + 10) / 1e3)
    assert "device gap: add 36.36% of 22.000 ms over 4 calls" in \
        trace.summary()


def test_mul_counters_follow_the_found_set():
    """Targets among the keys and keys that are not: the jobs, lanes,
    keys and confirmed hits are what the found set and the batch imply;
    hex lines hash nothing."""
    keys = open(BW_PRIV).read().split()[:24]
    others = [f"{k:x}" for k in range(1, 9)]          # not among the targets
    filt = filters.load_filter(BW_HASH)
    cfg = SearchConfig(addr33=True, addr65=True)
    eng = mul.MulSearch(cfg, filt, "cpu", w=6, batch=32)
    trace.enable(True)
    found = eng.run_lines(keys + others)
    snap = trace.snapshot()
    want = {int(k, 16) for k in keys}
    assert {f.priv for f in found} == want and eng.k_checked == 32
    counts, spans = snap["counts"], snap["spans"]
    assert counts["mul.jobs"] == 1
    assert counts["mul.lanes"] == 32 * len(eng.labels)
    # the key words' copy, K8, the replay and the mask fetch
    assert counts["mul.enqueues"] == 4
    assert counts["mul.keys"] == 32
    assert counts.get("mul.device_keys", 0) == 0      # K8's CPU form
    assert "mul.sha_blocks" not in counts and "mul.pack_fallback" not in counts
    assert counts["mul.candidates"] >= counts["mul.confirmed"] == len(found)
    for name in ("mul.parse", "mul.digits", "mul.upload", "mul.launch",
                 "mul.drain", "mul.wait", "mul.hits"):
        assert spans[name]["n"] == 1, name
        assert 0 <= spans[name]["self_s"] <= spans[name]["s"], name
    assert all(common.derive_h160(f.priv, f.label == "addr33") == f.h160
               for f in found)


def test_profile_turns_the_tracer_on(tmp_path, monkeypatch, capsys):
    """ECLOOP_PROFILE: the Chrome trace holds the engine's spans, the
    `trace:` line follows the `profile:` line, and the tracer is off
    again after the command."""
    for name, value in (("ECLOOP_CENTERS", "4"), ("ECLOOP_GROUP_K", "512"),
                        ("ECLOOP_STEPS_PER_CALL", "1"),
                        ("ECLOOP_PROFILE", str(tmp_path))):
        monkeypatch.setenv(name, value)
    rc = cli.main(["ecloop", "add", "-f", PUZZLES, "-r", "c800:cfff",
                   "-device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0
    assert (f"addr33: {golden.addr33(golden.point_mul(0xC936)).hex()} <- "
            f"{0xC936:064x}") in out.splitlines()
    line = err.split("\nprofile: ")[1].splitlines()[1]
    assert line.startswith("trace: counts ") and "add.calls=1" in line
    assert "add.launch " in line and "add.confirmed=1" in line
    path, = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert {"ecloop.add.launch", "ecloop.add.drain",
            "ecloop.add.span_setup"} <= _event_names(path)
    assert trace.span("a") is trace.span("b")         # the shared no-op
