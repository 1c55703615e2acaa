"""Breaks in the timed path, for the judge's own checks: each must turn
`correct` false.  Every one patches the port before its engines are
built, so that a CUDA graph captures the broken step too, and puts the
original back on exit.

  skip_confirm    the control: every device candidate reported without
                  the host's exact filter check (the guarantee that a
                  report is a target, or a member of all 20 probes)
  frozen_state    a step that leaves its group centers where they were
  half_batch      the second half of every hit mask left out
  altered_answer  each reported key altered where the report is made
  dropped_card    the last card's hit masks of every call never read (a
                  cell over several cards)
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    saved = getattr(owner, attr)
    setattr(owner, attr, make(saved))
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def skip_confirm():
    from ecloop_tpu_torch.filters import Filter

    return _patched(Filter, "confirm", lambda fn: lambda self, h160: True)


def frozen_state():
    from ecloop_tpu_torch import kernels

    def make(fn):
        def chord_points(cx, cy, *args):
            xs, ys, _, _ = fn(cx, cy, *args)
            return xs, ys, cx.clone(), cy.clone()
        return chord_points
    return _patched(kernels, "chord_points", make)


def half_batch():
    from ecloop_tpu_torch import kernels

    def make(fn):
        def hash160_probe(*args):
            out = fn(*args)
            out[:, out.shape[1] // 2:] = 0
            return out
        return hash160_probe
    return _patched(kernels, "hash160_probe", make)


@contextlib.contextmanager
def altered_answer():
    from ecloop_tpu_torch.search import add, common, mul

    def found(label, h160, priv):
        return common.Found(label=label, h160=h160, priv=(priv + 1) % common.N)
    with _patched(add, "Found", lambda fn: found), \
            _patched(mul, "Found", lambda fn: found):
        yield


def dropped_card():
    from ecloop_tpu_torch.search.add import AddSearch

    def make(fn):
        def _drain(self, t0, fetches, *args):
            return fn(self, t0, fetches[:-1], *args)
        return _drain
    return _patched(AddSearch, "_drain", make)


FAULTS = {f.__name__: f for f in (skip_confirm, frozen_state, half_batch,
                                  altered_answer, dropped_card)}
