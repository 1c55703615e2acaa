"""The program's own tracing: spans, counters and device call marks.

One tracer per process, off by default.  `cli.whole_command_trace`
(ECLOOP_PROFILE) turns it on for a command; a benchmark turns it on
through `enable`.

- `span(name)`: a host span.  Off, it returns one shared no-op object.
  On, it times the block with `time.perf_counter_ns`, keeps a stack so
  that each name aggregates its total seconds, its self seconds (the
  span minus its child spans) and its calls.  While a torch profiler
  records, it also opens `torch.profiler.record_function("ecloop." +
  name)`, so the span sits on the device's timeline in the profiler's
  trace (opening one costs ~10 us, so not otherwise).  Only aggregates
  are kept; the timeline lives in a profiler trace, when one is open.
- `count(name, n)`: plain int counters, always on; the engines bump
  them per call, job or hit, never per key.
- `device_mark(kind, device)`: timing events recorded on the device's
  current stream around one call (or job) of an engine (`add`, `mul`):
  `start()` right before its first enqueue, `end()` after its mask
  fetch, `done()` once the host has waited for that fetch, when both
  events have completed.  Per kind the tracer sums the calls, the device busy
  time (end - start), the device gap (start - the previous end on the
  same stream, across spans and runs) and the wall (last end - first
  start, summed over the kind's streams).  Only when on, only on CUDA.

The spans nest on one thread: the engines run on the caller's thread.
"""

from __future__ import annotations

import time

import torch

PREFIX = "ecloop."


class _Tracer:
    def __init__(self):
        self.on = False
        self.stack: list[_Span] = []
        self.reset()

    def reset(self) -> None:
        """Aggregates only: spans still open stay on the stack."""
        self.spans: dict[str, list[int]] = {}     # name -> [ns, self ns, n]
        self.counts: dict[str, int] = {}
        self.device: dict[str, list[float]] = {}  # kind -> [calls, busy ms, gap ms]
        self.streams: dict[tuple, list] = {}      # (kind, stream) -> [first start, last end]


_T = _Tracer()


class _Off:
    """The span and the device mark of a tracer that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def start(self) -> None:
        return None

    end = done = start


OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "child", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = (torch.profiler.record_function(PREFIX + self.name)
                   if torch.autograd._profiler_enabled() else OFF)
        self.rf.__enter__()
        self.child = 0
        _T.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter_ns() - self.t0
        _T.stack.pop()
        if _T.stack:
            _T.stack[-1].child += dt
        agg = _T.spans.setdefault(self.name, [0, 0, 0])
        agg[0] += dt
        agg[1] += dt - self.child
        agg[2] += 1
        self.rf.__exit__(*exc)


class _Mark:
    __slots__ = ("kind", "stream", "t0", "t1")

    def __init__(self, kind: str, device: torch.device):
        self.kind = kind
        self.stream = torch.cuda.current_stream(device)

    def _record(self) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def start(self) -> None:
        self.t0 = self._record()

    def end(self) -> None:
        self.t1 = self._record()

    def done(self) -> None:
        self.t1.synchronize()
        agg = _T.device.setdefault(self.kind, [0, 0.0, 0.0])
        agg[0] += 1
        agg[1] += self.t0.elapsed_time(self.t1)
        edges = _T.streams.get((self.kind, self.stream.cuda_stream))
        if edges is None:
            _T.streams[(self.kind, self.stream.cuda_stream)] = [self.t0,
                                                                self.t1]
            return
        agg[2] += edges[1].elapsed_time(self.t0)
        edges[1] = self.t1


def enable(flag: bool) -> None:
    """Turn the spans and the device marks on or off (counters stay on)."""
    _T.on = bool(flag)


def reset() -> None:
    """Forget every aggregate: spans, counters and device marks."""
    _T.reset()


def span(name: str):
    """A context manager timing the block as span `name` (when on)."""
    return _Span(name) if _T.on else OFF


def count(name: str, n: int = 1) -> None:
    _T.counts[name] = _T.counts.get(name, 0) + n


def device_mark(kind: str, device: torch.device):
    """A call's device mark on `device`'s current stream: `start()` right
    before its first enqueue, `end()` after its last, `done()` after the
    host waited for it.  OFF when off or off the card."""
    if not _T.on or device.type != "cuda":
        return OFF
    return _Mark(kind, device)


def snapshot() -> dict:
    """{"spans": {name: {"s", "self_s", "n"}}, "counts": {name: int},
    "device": {kind: {"calls", "busy_s", "gap_s", "wall_s"}}}."""
    wall: dict[str, float] = {}
    for (kind, _), (first, last) in _T.streams.items():
        wall[kind] = wall.get(kind, 0.0) + first.elapsed_time(last)
    return {
        "spans": {k: {"s": v[0] / 1e9, "self_s": v[1] / 1e9, "n": v[2]}
                  for k, v in _T.spans.items()},
        "counts": dict(_T.counts),
        "device": {k: {"calls": v[0], "busy_s": v[1] / 1e3,
                       "gap_s": v[2] / 1e3, "wall_s": wall.get(k, 0.0) / 1e3}
                   for k, v in _T.device.items()}}


def summary() -> str:
    """One line: the counters, each span's total and self ms and calls,
    and per engine kind the device gap's share of the marked wall."""
    snap = snapshot()
    counts = " ".join(f"{k}={v}" for k, v in sorted(snap["counts"].items()))
    spans = ", ".join(f"{k} {v['s'] * 1e3:.3f}/{v['self_s'] * 1e3:.3f} x{v['n']}"
                      for k, v in sorted(snap["spans"].items()))
    dev = ", ".join(
        f"{k} {100 * v['gap_s'] / v['wall_s']:.2f}% of {v['wall_s'] * 1e3:.3f} ms"
        f" over {v['calls']} calls" if v["wall_s"] else f"{k} -"
        for k, v in sorted(snap["device"].items()))
    return (f"trace: counts {counts or '-'}; spans ms total/self: "
            f"{spans or '-'}; device gap: {dev or '-'}")
