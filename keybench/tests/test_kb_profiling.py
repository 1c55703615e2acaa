"""The traced run's arithmetic on a made-up profiler window: device busy
time, the idle time by the innermost harness span, dropped records, and
the sampler's windows kept and dropped."""

import random
import time
import types

import pytest
from torch.autograd import DeviceType

from keybench import harness, profiling, readers
from keybench.tests import test_kb_cards as cards_


def _ev(name, a, b, dev=False, note=False, card=0):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        device_index=card, is_user_annotation=note, time_range=types.SimpleNamespace(start=a, end=b))


def _window():
    return [_ev("ProfilerStep#1", 0, 1000, note=True),
            _ev("keybench.drain", 100, 600), _ev("keybench.confirm", 200, 300),
            _ev("cudaGraphLaunch", 10, 12), _ev("cudaGraphLaunch", 20, 22),
            _ev("k1", 0, 100, dev=True), _ev("k2", 50, 150, dev=True),
            _ev("k1", 400, 500, dev=True), _ev("k3", 900, 1200, dev=True)]


def test_busy_and_idle_by_span():
    s = profiling.summarize(_window(), units=4)
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
    assert profiling.summarize(ev, 1) is None


def test_readers():
    s = profiling.summarize(_window(), 4)
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


# --- windows without a ProfilerStep# event (torch 2.11 with CUDA records none)

def test_ops_past_the_host_wall_read_busy_and_no_idle():
    """A card never idle: the window's last call ran on past the host's
    last tick (the host measured 800 us, the ops span 1000 us), which
    the host's wall read as busy 1.25 x wall.  Over the ops' extent it
    is all busy."""
    ev = [_ev("keybench.launch", 0, 20), _ev("cudaGraphLaunch", 5, 9),
          _ev("keybench.drain", 20, 800),
          _ev("k1", 40, 400, dev=True), _ev("k2", 400, 900, dev=True),
          _ev("k3", 900, 1040, dev=True)]
    s = profiling.summarize(ev, 3)
    assert s["wall_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == s["wall_s"] and s["idle"] == {}
    assert readers.idle_share({"samples": [s]}) == pytest.approx(0.0)


def test_a_gap_reads_under_the_host_span_open_across_it():
    ev = [_ev("keybench.launch", 0, 30), _ev("keybench.drain", 30, 320),
          _ev("keybench.confirm", 60, 80), _ev("cudaGraphLaunch", 10, 14),
          _ev("k1", 50, 150, dev=True), _ev("k2", 250, 400, dev=True)]
    s = profiling.summarize(ev, 1)
    assert s["wall_s"] == pytest.approx(350e-6)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["idle"] == pytest.approx({"drain": 100e-6})


def _random_window(seed: int, step: bool, cards) -> list:
    """Host spans one after another, some holding a child, and per card
    device ops at random starts and lengths, overlapping at times, some
    past the host's last span; with `step` a ProfilerStep# that cuts the
    first and last ops."""
    rng = random.Random(seed)
    ev, t = [], 0
    while t < 5_000:
        a, b = t + rng.randrange(0, 50), t + rng.randrange(100, 600)
        ev.append(_ev("keybench." + rng.choice(("launch", "drain")), a, b))
        if rng.random() < 0.5:
            c = rng.randrange(a, b)
            ev.append(_ev("keybench.confirm", c, rng.randrange(c, b) + 1))
        t = b
    for c in cards:
        k = rng.randrange(0, 300)
        while k < 5_600:
            d = rng.randrange(10, 400)
            ev.append(_ev("op", k, k + d, dev=True, card=c))
            ev.append(_ev("cudaGraphLaunch", k, k + 1))
            k += d + rng.randrange(-5, 200)
    if step:
        ev.append(_ev("ProfilerStep#1", 200, 5_200, note=True))
    return ev


@pytest.mark.parametrize("cards", [(0,), (0, 1)], ids=["1card", "2cards"])
@pytest.mark.parametrize("step", [False, True], ids=["nostep", "step"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_busy_never_passes_the_wall(seed, step, cards):
    ev = _random_window(seed, step, cards)
    s = profiling.summarize(ev, 7, list(cards))
    ops = [e.time_range for e in ev if e.device_type == DeviceType.CUDA]
    lo, hi = ((200, 5_200) if step else
              (min(r.start for r in ops), max(r.end for r in ops)))
    assert s["wall_s"] == pytest.approx((hi - lo) / 1e6, rel=1e-12)
    assert 0 < s["busy_s"] <= s["wall_s"]
    assert all(0 < b <= s["wall_s"] for b in s["busy_by_device"])
    assert s["wall_s"] == pytest.approx(s["busy_s"] + sum(s["idle"].values()),
                                        rel=1e-12)
    assert 0 <= readers.idle_share({"samples": [s]}) < 100


# The summaries of test_kb_cards' windows without their ProfilerStep#,
# and what every reader but the idle shares read on them, from the
# harness before the wall became the ops' extent.  Only the wall moved.
NO_STEP_OPS = [
    {'inv_batch_kernel': 0.0020080000000000002, 'chord_points_kernel': 0.002111,
     'hash160_probe_kernel<true, 0>': 0.002048, 'Memcpy DtoH': 0.001866},
    {'inv_batch_kernel': 0.002104, 'chord_points_kernel': 0.0019939999999999997,
     'hash160_probe_kernel<true, 0>': 0.001955, 'Memcpy DtoH': 0.0021290000000000002},
    {'inv_batch_kernel': 0.0017190000000000003, 'chord_points_kernel': 0.0017750000000000003,
     'hash160_probe_kernel<true, 0>': 0.001722, 'Memcpy DtoH': 0.001546}]
NO_STEP_BUSY = [0.007598, 0.007838, 0.006751]
NO_STEP_READERS = {'add_step_roofline': 7.115136320632632,
                   'chord_inv_roofline': 8.830987434953997,
                   'hash_probe_roofline': 10.49166696741131,
                   'hash_probe_roofline.endo': 10.49166696741131,
                   'chord_inv_roofline.endo': 8.830987434953997,
                   'host_confirm_share': 2.450980392156863,
                   'host_confirm_share.list': 2.450980392156863,
                   'host_launch_share': 14.215686274509803,
                   'launches_per_step': 2.125,
                   'mul_job_device_ms': 0.4505294117647059,
                   'mul_parse_share': 0.0,
                   'prefilter_fp_per_gkey.mul': None,
                   'prefilter_fp_per_gkey.range': 68.91787052154541,
                   'prefilter_fp_per_gkey.list': 68.91787052154541,
                   'span_setup_ms': 29.032258064516128}


def test_without_a_step_only_the_idle_shares_move():
    samples = []
    for seed, units in cards_.WINDOWS:
        ev = [e for e in cards_.window(seed)
              if not e.name.startswith("ProfilerStep#")]
        samples.append(profiling.summarize(ev, units, [0]))
    assert [s["device_ops"] for s in samples] == NO_STEP_OPS
    assert [s["busy_s"] for s in samples] == NO_STEP_BUSY
    assert [s["units"] for s in samples] == [u for _, u in cards_.WINDOWS]
    rec = cards_.record(samples, cards_.RECORDED["least"]["compare"])
    for name, want in NO_STEP_READERS.items():
        assert harness.reader(name)(rec) == want, name
    wall = sum(s["wall_s"] for s in samples)
    for name in ("device_idle_share.range", "device_idle_share.mul",
                 "device_idle_share.list", "device_idle_share.worst"):
        assert harness.reader(name)(rec) == pytest.approx(
            100 * (1 - sum(NO_STEP_BUSY) / wall), rel=1e-12), name
        assert harness.reader(name)(rec) >= 0


# --- the sampler's windows ---------------------------------------------------

class _Prof:
    """Stands in for torch.profiler.profile: stopping fires the
    sampler's `_ready` as stopping an active window does."""

    def __init__(self, sampler):
        self.sampler, self.steps, self.stopped = sampler, 0, False

    def step(self):
        self.steps += 1

    def stop(self):
        self.stopped = True
        self.sampler._ready(self)

    def events(self):
        return _window()


def _open_sampler(phase: str):
    s = profiling.Sampler(time.perf_counter(), 1.0, window_s=0.0, cards=[0])
    prof = s._prof = _Prof(s)
    s._phase, s._mark, s._units = phase, time.perf_counter(), 2
    return s, prof


def test_a_window_closed_at_its_end_is_kept():
    s, prof = _open_sampler("active")
    s.tick(3)
    assert prof.stopped and s._prof is None and s.short == 0
    assert s.samples == [profiling.summarize(_window(), 5, [0])]


@pytest.mark.parametrize("phase", ["warm", "active"])
def test_close_drops_an_open_window(phase):
    s, prof = _open_sampler("active")
    s.tick(3)
    kept = list(s.samples)
    s._prof = prof = _Prof(s)
    s._phase = phase
    s.close()
    assert prof.stopped and s._prof is None
    assert s.samples == kept and s.short == 0
