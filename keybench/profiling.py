"""What a traced run (`--trace 1`) records: the harness's spans around
calls into the port, and a few short torch.profiler windows inside the
measured window, never the whole of it.

The profiler method is chip_smoke.py's (`kernel_time`, `device_ms`):
each kept window follows a warm-up window of the same length (the
schedule's warmup step, traced and thrown away), device time is summed
from the events whose device is CUDA, and a window in which the
profiler dropped the device records (fewer device ops than graph
launches on the host) is taken again later.
"""

from __future__ import annotations

import collections
import functools
import time

SPAN_PREFIX = "keybench."
TRIES = 3                        # extra windows allowed for dropped records


class Spans:
    """Host wall seconds and calls per span name.  `wrap` replaces a
    function or method of the port with one that times each call and
    marks it for the profiler (torch.profiler.record_function);
    `restore` puts the originals back."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._saved = []

    def wrap(self, owner, attr: str, name: str) -> None:
        from torch.profiler import record_function

        fn = getattr(owner, attr)
        self._saved.append((owner, attr, vars(owner).get(attr, fn)))

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                with record_function(SPAN_PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1
        setattr(owner, attr, timed)

    def restore(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)


class Sampler:
    """Profiled windows of `window_s` host seconds at the given shares of
    the measured window [t0, t0 + seconds), each summarized over the
    `cards` (CUDA device indices) of the run.  `tick(units)` is called at
    each boundary of the work (a step, a job) with the units done since
    the last call; windows open and close only there."""

    def __init__(self, t0: float, seconds: float, window_s: float,
                 at=(0.2, 0.5, 0.8), cards=None):
        self.window_s = window_s
        self.cards = cards
        self.starts = [t0 + f * seconds - window_s for f in at]
        self.samples: list[dict] = []
        self.short = 0
        self._prof = None
        self._phase = None
        self._mark = 0.0
        self._units = 0

    def tick(self, units: int = 1) -> None:
        now = time.perf_counter()
        if self._prof is None:
            if self.starts and now >= self.starts[0]:
                self.starts.pop(0)
                self._open()
            return
        if self._phase == "warm" and now - self._mark >= self.window_s:
            self._prof.step()
            self._phase, self._mark, self._units = "active", now, 0
        elif self._phase == "active":
            self._units += units
            if now - self._mark >= self.window_s:
                self._phase = "kept"          # `_ready` summarizes it
                self._prof.step()
                self._prof.stop()
                self._prof = None

    def close(self) -> None:
        """Drop a window still open when the measured window ends: its
        profiler stops, and `_ready`, which stopping an active window
        fires, summarizes only a window that `tick` closed."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=self._ready)
        self._prof.start()
        self._phase, self._mark = "warm", time.perf_counter()

    def _ready(self, prof) -> None:
        if self._phase != "kept":
            return
        sample = summarize(prof.events(), self._units, self.cards)
        if sample is None:
            self.short += 1
            if self.short <= TRIES:
                self.starts.insert(0, time.perf_counter() + self.window_s)
            return
        self.samples.append(sample)


def warm_up(cards) -> None:
    """Start and stop the profiler once, with an op on each card: its
    first start takes seconds (CUPTI's set-up), which must not fall
    inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for d in cards:
            torch.zeros(1, device=d).add_(1)
            torch.cuda.synchronize(d)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, lo: float, hi: float) -> list:
    """[lo, hi] cut into (start, end, name) pieces by the innermost host
    span open in each ("outside_spans" where none is); the spans come
    from one thread, so they nest."""
    out, stack, t = [], [], lo

    def emit(until):
        nonlocal t
        until = min(until, hi)
        if until > t:
            out.append((t, until, stack[-1][2] if stack else "outside_spans"))
            t = until

    for a, b, name in sorted(spans):
        while stack and stack[-1][1] <= a:
            emit(stack[-1][1])
            stack.pop()
        emit(a)
        stack.append((a, b, name))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    emit(hi)
    return out


def _idle_by_span(busy, segs, lo: float, hi: float) -> dict:
    """Seconds of [lo, hi] outside the `busy` intervals, by the span of
    the host pieces `segs` (`_innermost`) they fall in."""
    gaps = collections.defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    i = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b, name = segs[j]
            if min(b, g1) > max(a, g0):
                gaps[name] += (min(b, g1) - max(a, g0)) / 1e6
            j += 1
    return gaps


def summarize(events, units: int, cards=None) -> dict | None:
    """One kept window: its wall, units of work, and per card of `cards`
    (the CUDA device indices of the run; those with device ops by
    default) the device's busy seconds (the union of its ops' intervals
    inside the wall) and its idle seconds by the innermost harness span
    open on the host meanwhile.  The wall is the profiler step's span on
    the host, else (torch 2.11 with CUDA records no `ProfilerStep#`) the
    extent of the window's device ops over the cards, first start to
    last end: the interval busy time is measured over, so busy_s <=
    wall_s == busy_s + sum(idle).  Not the host's wall between ticks:
    the window's last call runs on the card after it.  `busy_s` and
    `idle` are the means over the cards, `busy_by_device` each card's
    busy seconds in the order of `cards`, `device_ops` the device
    seconds per op name summed over the cards.
    None when the profiler dropped the window's device records, or all
    of one card's."""
    from torch.autograd import DeviceType

    dev, host_spans, step, launches = collections.defaultdict(list), [], None, 0
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev[e.device_index].append((tr.start, tr.end, e.name))
        elif e.name.startswith("ProfilerStep#"):
            step = (tr.start, tr.end)
        elif e.name.startswith(SPAN_PREFIX):
            host_spans.append((tr.start, tr.end, e.name[len(SPAN_PREFIX):]))
        elif e.name == "cudaGraphLaunch":
            launches += 1
    n_ops = sum(len(v) for v in dev.values())
    if not n_ops or n_ops < launches:
        return None
    cards = sorted(dev) if cards is None else list(cards)
    if set(dev) - set(cards):
        raise ValueError(f"device ops on cards {sorted(dev)}, the run's "
                         f"are {cards}")
    if not all(dev[c] for c in cards):
        return None
    every = [d for c in cards for d in dev[c]]
    lo, hi = (step if step else (min(d[0] for d in every),
                                 max(d[1] for d in every)))
    segs = _innermost(host_spans, lo, hi)
    per_op = collections.defaultdict(float)
    busy, gaps = [], collections.defaultdict(float)
    for c in cards:
        clipped = []
        for a, b, name in dev[c]:
            a, b = max(a, lo), min(b, hi)
            if b > a:
                clipped.append((a, b))
                per_op[name] += (b - a) / 1e6
        union = _union(clipped)
        busy.append(sum(b - a for a, b in union) / 1e6)
        for name, s in _idle_by_span(union, segs, lo, hi).items():
            gaps[name] += s / len(cards)
    return {"wall_s": (hi - lo) / 1e6, "units": units,
            "busy_s": sum(busy) / len(cards), "busy_by_device": busy,
            "device_ops": dict(per_op), "idle": dict(gaps)}
