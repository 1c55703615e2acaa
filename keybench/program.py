"""The port's own counters and spans (`ecloop_tpu_torch.trace`), for the
readers of the metrics that the program records itself.

A record that holds the tracer's snapshot (`rec["program"]`) is read
from there.  Otherwise the snapshot is taken when the reader runs: in
the run's process, after its window.  The counters are always on, so
they then cover the whole run, set-up's warm-up calls (two of tens of
thousands in a range cell, one job of hundreds in `mul`) included; a
ratio per step or per lane does not move with them.  A port without the
module (before it had a tracer) gives None.
"""

from __future__ import annotations


def snapshot(rec: dict) -> dict | None:
    if rec.get("program") is not None:
        return rec["program"]
    try:
        from ecloop_tpu_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


def counts(rec: dict, *names: str) -> list[int] | None:
    """The counters `names`, or None when the port has no tracer or has
    not counted the last of them (the denominator) yet."""
    snap = snapshot(rec)
    if snap is None or not snap["counts"].get(names[-1]):
        return None
    return [snap["counts"].get(n, 0) for n in names]


def fp_per_gkey(rec: dict, engine: str) -> float | None:
    """Device prefilter candidates that the host's exact check refused,
    per 10^9 candidate lanes hashed (`<engine>.candidates`,
    `.confirmed`, `.lanes`)."""
    c = counts(rec, f"{engine}.candidates", f"{engine}.confirmed",
               f"{engine}.lanes")
    if c is None:
        return None
    cand, conf, lanes = c
    return 1e9 * (cand - conf) / lanes
