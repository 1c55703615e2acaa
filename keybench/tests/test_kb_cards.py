"""A cell over several cards: the profiler's summary per card, the
readers over it, and the step's least time over n shards.  At one card
every number equals what the harness gave before it ran cells on
several cards (`RECORDED`: that harness's output on these same
records)."""

import random
import types

import numpy as np
import pytest
from torch.autograd import DeviceType

from ecloop_tpu_torch.search.common import SearchConfig
from keybench import harness, profiling, readers
from keybench.reference import judge

INT_RATE = 64 * 132 * 1980e6
WINDOWS = ((1, 17), (2, 16), (3, 18))          # (seed, steps) of each window


def _ev(name, a, b, dev=False, note=False, card=0):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if dev else DeviceType.CPU,
        device_index=card, is_user_annotation=note,
        time_range=types.SimpleNamespace(start=a, end=b))


def window(seed: int, cards=(0,), skew: int = 0) -> list:
    """A profiled window of 10,000 us: per call a `launch` span with a
    graph launch per card, then a `drain` span holding a `confirm`; on
    each card the step's kernels back to back after its launch, card c
    started c * skew us later."""
    rng = random.Random(seed)
    ev = [_ev("ProfilerStep#1", 0, 10_000, note=True)]
    t = rng.randrange(50)
    while t < 9_800:
        launch = rng.randrange(150, 300)
        ev.append(_ev("keybench.launch", t, t + launch))
        for c in cards:
            ev.append(_ev("cudaGraphLaunch", t + 5 + c, t + 9 + c))
            k = t + 10 + c * skew
            for name in ("inv_batch_kernel", "chord_points_kernel",
                         "hash160_probe_kernel<true, 0>", "Memcpy DtoH"):
                d = rng.randrange(40, 160)
                ev.append(_ev(name, k, k + d, dev=True, card=c))
                k += d + rng.randrange(0, 4)
        t += launch
        drain = rng.randrange(100, 400)
        ev.append(_ev("keybench.drain", t, t + drain))
        a = t + rng.randrange(drain // 2)
        ev.append(_ev("keybench.confirm", a, a + rng.randrange(1, drain // 2)))
        t += drain + rng.randrange(0, 120)
    return ev


def setups() -> dict:
    """A list cell's and a bloom cell's targets, as step_least_s reads
    them."""
    bits = np.zeros(1 << 20, dtype=np.uint8)
    return {"compare": types.SimpleNamespace(fill=None, n_first=288),
            "bloom": types.SimpleNamespace(
                fill=0.371, n_first=None, holds=judge.Targets(bits=bits))}


def record(samples, least) -> dict:
    """A traced rnd run's record over the windows."""
    return {"window_s": 51.0, "samples": samples,
            "spans": {"launch": {"s": 7.25, "n": 4000},
                      "derive_h160": {"s": 1.0, "n": 3000},
                      "confirm": {"s": 0.25, "n": 3000},
                      "center_points": {"s": 0.9, "n": 31}},
            "least_s": least,
            "program": {"spans": {}, "device": {},
                        "counts": {"add.enqueues": 69632, "add.steps": 32768,
                                   "add.lanes": 32768 * 131072,
                                   "add.candidates": 300,
                                   "add.confirmed": 4}}}


# The harness before this file's change, on the records above (its
# summarize, step_least_s with _int_rate set to INT_RATE, and the
# per-layer readers of BENCHMARK.json at the time).
RECORDED = {'samples': [{'wall_s': 0.01,
                         'units': 17,
                         'busy_s': 0.007467,
                         'device_ops': {'inv_batch_kernel': 0.0020080000000000002,
                                        'chord_points_kernel': 0.002087,
                                        'hash160_probe_kernel<true, 0>': 0.002006,
                                        'Memcpy DtoH': 0.001801},
                         'idle': {'outside_spans': 0.0007090000000000001,
                                  'launch': 0.00018999999999999996,
                                  'confirm': 0.00043900000000000005,
                                  'drain': 0.0011949999999999997}},
                        {'wall_s': 0.01,
                         'units': 16,
                         'busy_s': 0.007838,
                         'device_ops': {'inv_batch_kernel': 0.002104,
                                        'chord_points_kernel': 0.0019939999999999997,
                                        'hash160_probe_kernel<true, 0>': 0.001955,
                                        'Memcpy DtoH': 0.0021290000000000002},
                         'idle': {'outside_spans': 0.0006820000000000001,
                                  'launch': 0.00017099999999999996,
                                  'drain': 0.001247,
                                  'confirm': 6.2e-05}},
                        {'wall_s': 0.01,
                         'units': 18,
                         'busy_s': 0.006751,
                         'device_ops': {'inv_batch_kernel': 0.0017190000000000003,
                                        'chord_points_kernel': 0.0017750000000000003,
                                        'hash160_probe_kernel<true, 0>': 0.001722,
                                        'Memcpy DtoH': 0.001546},
                         'idle': {'outside_spans': 0.0009390000000000001,
                                  'launch': 0.0002179999999999999,
                                  'confirm': 0.0005160000000000001,
                                  'drain': 0.0015760000000000001}}],
            'least': {'compare': {'chord_dx': 2.5847976119402986e-06,
                                  'chord_points': 1.2683004179104478e-05,
                                  'inv_batch': 5.010569552238806e-06,
                                  'hash_probe': 1.1777410468319559e-05},
                      'bloom': {'chord_dx': 2.5847976119402986e-06,
                                'chord_points': 1.2683004179104478e-05,
                                'inv_batch': 5.010569552238806e-06,
                                'hash_probe': 1.1919279174740799e-05}},
            'readers': {'device_idle_share.range': 26.480000000000004,
                        'device_idle_share.mul': 26.480000000000004,
                        'hash_probe_roofline': 10.569205241673368,
                        'chord_inv_roofline': 8.84912243096999,
                        'add_step_roofline': 7.155934834945986,
                        'host_confirm_share': 2.450980392156863,
                        'span_setup_ms': 29.032258064516128,
                        'mul_parse_share': 0.0,
                        'mul_job_device_ms': 0.44796078431372544,
                        'launches_per_step': 2.125,
                        'prefilter_fp_per_gkey.range': 68.91787052154541,
                        'prefilter_fp_per_gkey.mul': None}}


def _samples(cards=(0,), skew=0):
    return [profiling.summarize(window(seed, cards, skew), units,
                                list(cards))
            for seed, units in WINDOWS]


def test_one_card_is_the_recorded_summary():
    for got, want in zip(_samples(), RECORDED["samples"]):
        assert got.pop("busy_by_device") == [want["busy_s"]]
        assert got == want                       # exactly, not approximately
    # the cards default to those that ran an op
    assert profiling.summarize(window(1), 17) == _samples()[0]


def test_one_card_readers_read_as_recorded():
    rec = record(_samples(), RECORDED["least"]["compare"])
    for name, want in RECORDED["readers"].items():
        assert harness.reader(name)(rec) == want, name


@pytest.mark.parametrize("kind", ["compare", "bloom"])
def test_one_shard_least_time_is_the_recorded(monkeypatch, kind):
    monkeypatch.setattr(harness, "_int_rate", lambda: INT_RATE)
    got = harness.step_least_s(SearchConfig(), setups()[kind], ["addr33"])
    assert got == RECORDED["least"][kind]


@pytest.mark.parametrize("kind", ["compare", "bloom"])
def test_least_time_over_n_shards_is_n_times_one_shards(monkeypatch, kind):
    monkeypatch.setattr(harness, "_int_rate", lambda: INT_RATE)
    one = harness.step_least_s(SearchConfig(centers=32), setups()[kind],
                               ["addr33"])
    four = harness.step_least_s(SearchConfig(centers=128), setups()[kind],
                                ["addr33"], shards=4)
    assert four == pytest.approx({k: 4 * v for k, v in one.items()},
                                 rel=1e-15)


def test_two_cards_busy_and_idle_per_card():
    """Card 1 runs the same kernels 700 us later: its busy time is card
    0's less what falls past the window's end, and the summary's busy
    and idle are the two cards' means."""
    two = _samples(cards=(0, 1), skew=700)
    for seed_units, s in zip(WINDOWS, two):
        seed, units = seed_units
        ev = window(seed, (0, 1), 700)
        alone = [profiling.summarize([e for e in ev if not (
            e.device_type == DeviceType.CUDA and e.device_index != c)],
            units, [c]) for c in (0, 1)]
        assert s["busy_by_device"] == [a["busy_s"] for a in alone]
        assert s["busy_by_device"][1] < s["busy_by_device"][0]
        assert s["busy_s"] == pytest.approx(
            (alone[0]["busy_s"] + alone[1]["busy_s"]) / 2)
        for name in set(alone[0]["idle"]) | set(alone[1]["idle"]):
            assert s["idle"][name] == pytest.approx(
                (alone[0]["idle"].get(name, 0) + alone[1]["idle"].get(name, 0))
                / 2)
        for op, v in s["device_ops"].items():
            assert v == pytest.approx(alone[0]["device_ops"][op]
                                      + alone[1]["device_ops"][op])
        assert s["wall_s"] == pytest.approx(sum(s["idle"].values())
                                            + s["busy_s"])


def test_a_card_without_records_drops_the_window():
    ev = [e for e in window(1, (0, 1)) if not (
        e.device_type == DeviceType.CUDA and e.device_index == 1)]
    assert profiling.summarize(ev, 1, [0, 1]) is None
    with pytest.raises(ValueError):
        profiling.summarize(window(1, (0, 1)), 1, [0])


def test_worst_idle_share_and_launch_share_read_the_records():
    two = _samples(cards=(0, 1), skew=700)
    rec = record(two, {})
    wall = sum(s["wall_s"] for s in two)
    per_card = [100 * (1 - sum(s["busy_by_device"][c] for s in two) / wall)
                for c in (0, 1)]
    worst = harness.reader("device_idle_share.worst")(rec)
    assert worst == pytest.approx(max(per_card)) and worst > min(per_card)
    assert readers.idle_share(rec) == pytest.approx(sum(per_card) / 2)
    assert harness.reader("host_launch_share")(rec) == \
        pytest.approx(100 * 7.25 / 51.0)
    one = record(_samples(), {})
    assert harness.reader("device_idle_share.worst")(one) == \
        pytest.approx(readers.idle_share(one), rel=1e-12)
    empty = dict(rec, samples=[])
    assert harness.reader("device_idle_share.worst")(empty) is None
    assert harness.reader("host_launch_share")(dict(rec, window_s=0)) is None
