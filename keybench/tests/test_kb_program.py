"""The readers of the metrics that the port counts itself
(`ecloop_tpu_torch.trace`): from a record that holds the tracer's
snapshot, from the live tracer, and None from a port without one."""

import sys

import pytest

from keybench import harness, program

NEW = {"launches_per_step": "puzzle71-rnd",
       "prefilter_fp_per_gkey.range": "puzzle71-rnd",
       "prefilter_fp_per_gkey.mul": "funded-mul-raw"}


def _rec(program_snap=None) -> dict:
    """A traced run's record as `harness.run_cell` builds it."""
    rec = {"window_s": 51.0, "samples": [], "spans": {}, "least_s": {}}
    if program_snap is not None:
        rec["program"] = program_snap
    return rec


COUNTS = {"add.calls": 4096, "add.steps": 32768, "add.enqueues": 69632,
          "add.lanes": 32768 * 131072, "add.candidates": 300,
          "add.confirmed": 4,
          "mul.jobs": 100, "mul.lanes": 100 * 32768 * 2,
          "mul.candidates": 20, "mul.confirmed": 14}
WANT = {"launches_per_step": 2.125,
        "prefilter_fp_per_gkey.range": 1e9 * 296 / (32768 * 131072),
        "prefilter_fp_per_gkey.mul": 1e9 * 6 / (100 * 32768 * 2)}


def _read(name, rec):
    return harness.reader(name)(rec)


def test_new_metrics_are_listed_for_their_cells():
    spec = harness.load_spec()
    for name, cell in NEW.items():
        assert name in {m["name"] for m in harness.cell(spec, cell).per_layer}


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_from_the_record(name):
    snap = {"spans": {}, "counts": COUNTS, "device": {}}
    assert _read(name, _rec(snap)) == pytest.approx(WANT[name])
    empty = {"spans": {}, "counts": {}, "device": {}}
    assert _read(name, _rec(empty)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_from_the_live_tracer(name):
    from ecloop_tpu_torch import trace

    trace.reset()
    try:
        assert _read(name, _rec()) is None
        for k, v in COUNTS.items():
            trace.count(k, v)
        assert _read(name, _rec()) == pytest.approx(WANT[name])
    finally:
        trace.reset()


def test_a_port_without_a_tracer_reads_none(monkeypatch):
    """The parent's port: `ecloop_tpu_torch.trace` cannot be imported, so
    every new metric of each cell reads None and the run goes on."""
    import ecloop_tpu_torch

    monkeypatch.delattr(ecloop_tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "ecloop_tpu_torch.trace", None)
    with pytest.raises(ImportError):
        from ecloop_tpu_torch import trace  # noqa: F401
    spec = harness.load_spec()
    for cell in sorted(set(NEW.values())):
        names = [m["name"] for m in harness.cell(spec, cell).per_layer
                 if m["name"] in NEW]
        assert names and all(_read(n, _rec()) is None for n in names)
    assert program.snapshot(_rec()) is None
