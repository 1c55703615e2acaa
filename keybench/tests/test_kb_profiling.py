"""The traced run's arithmetic on a made-up profiler window: device busy
time, the idle time by the innermost harness span, dropped records."""

import types

import pytest
from torch.autograd import DeviceType

from keybench import profiling, readers


def _ev(name, a, b, dev=False, note=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        is_user_annotation=note, time_range=types.SimpleNamespace(start=a, end=b))


def _window():
    return [_ev("ProfilerStep#1", 0, 1000, note=True),
            _ev("keybench.drain", 100, 600), _ev("keybench.confirm", 200, 300),
            _ev("cudaGraphLaunch", 10, 12), _ev("cudaGraphLaunch", 20, 22),
            _ev("k1", 0, 100, dev=True), _ev("k2", 50, 150, dev=True),
            _ev("k1", 400, 500, dev=True), _ev("k3", 900, 1200, dev=True)]


def test_busy_and_idle_by_span():
    s = profiling.summarize(_window(), wall_s=9.0, units=4)
    assert s["wall_s"] == pytest.approx(1000e-6) and s["units"] == 4
    assert s["busy_s"] == pytest.approx(350e-6)        # 0-150, 400-500, 900-1000
    assert s["device_ops"] == pytest.approx({"k1": 200e-6, "k2": 100e-6,
                                             "k3": 100e-6})
    # idle 150-400 (drain 150-200, 300-400; confirm 200-300), 500-900
    # (drain 500-600, then no span)
    assert s["idle"] == pytest.approx({"drain": 250e-6, "confirm": 100e-6,
                                       "outside_spans": 300e-6})


def test_dropped_device_records_are_refused():
    ev = [e for e in _window() if e.name not in ("k1", "k2")]
    assert profiling.summarize(ev, 1.0, 1) is None


def test_readers():
    s = profiling.summarize(_window(), 1.0, 4)
    rec = {"window_s": 2.0, "samples": [s],
           "spans": {"derive_h160": {"s": 0.5, "n": 5},
                     "confirm": {"s": 0.1, "n": 5}},
           "least_s": {"hash_probe": 10e-6, "inv_batch": 5e-6}}
    assert readers.idle_share(rec) == pytest.approx(65.0)
    assert readers.span_share(rec, ("derive_h160", "confirm")) == \
        pytest.approx(30.0)
    # 4 steps x 10 us over k1's 200 us
    assert readers.roofline(rec, ("k1",), ("hash_probe",)) == \
        pytest.approx(20.0)
    assert readers.roofline(dict(rec, least_s={}), ("k1",), ("x",)) is None
