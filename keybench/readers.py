"""What the per-layer metrics' readers (`metrics/<name>.py`) share.  A
reader takes the traced run's record and returns a number, or None when
it finds nothing to read; the harness then leaves the metric out.

The record: `window_s` (the measured window's host wall), `spans`
({span: {"s": host seconds, "n": calls}} over the window), `samples`
(the profiled windows: `wall_s`, `units` of work done in it, `busy_s`,
`device_ops` {name: device seconds}, `idle` {span: idle seconds}) and
`least_s` ({account term: least seconds of one add step}).
"""

from __future__ import annotations


def span_share(rec: dict, names) -> float | None:
    """% of the window's wall spent inside the spans `names`."""
    if not rec["window_s"]:
        return None
    s = sum(rec["spans"].get(n, {"s": 0.0})["s"] for n in names)
    return 100.0 * s / rec["window_s"]


def idle_share(rec: dict) -> float | None:
    """% of the profiled windows' wall in which no device op ran."""
    wall = sum(s["wall_s"] for s in rec["samples"])
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s["busy_s"] for s in rec["samples"]) / wall)


def device_s(sample: dict, kernels=None) -> float:
    """Device seconds of the ops whose name holds one of `kernels` (all
    ops when None)."""
    return sum(v for k, v in sample["device_ops"].items()
               if kernels is None or any(n in k for n in kernels))


def roofline(rec: dict, kernels, terms) -> float | None:
    """% of the named kernels' device time that the least time of the
    steps' work in the account `terms` would take: steps (units) done in
    the profiled windows x the terms' least seconds per step."""
    if not rec["least_s"] or not rec["samples"]:
        return None
    dev = sum(device_s(s, kernels) for s in rec["samples"])
    steps = sum(s["units"] for s in rec["samples"])
    if not dev or not steps:
        return None
    return 100.0 * steps * sum(rec["least_s"][t] for t in terms) / dev
