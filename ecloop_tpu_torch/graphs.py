"""One CUDA graph per call: the port's counterpart of the JAX package's
jit dispatch (`jax.jit` of a step, with `lax.scan` over the steps of a
call).

A search step is thousands of small plain-torch ops around the three
kernels; launched one by one from the host, the card waits on the
launches.  `Graph` captures a body once and replays it with one launch.
Every tensor the body reads or writes must keep its address: the
caller allocates its inputs and outputs before the capture and writes
new inputs into them in place.
"""

from __future__ import annotations

import time

import torch

from . import kernels


class Graph:
    """body(0), ..., body(iters - 1) as one call on `device`.

    On a CUDA device the body runs once on a side stream first (that
    fills `fel.const`'s cache and loads the kernel library), then its
    `iters` iterations are captured into one CUDA graph on that stream,
    with `device` current and in the graph's own memory pool; a body
    that cannot be captured raises there.  A call replays the graph on
    `device`'s current stream and counts the kernel launches the
    capture recorded (`launches`, as (kernel, width) pairs).  On the CPU
    a call runs the iterations eagerly.  `capture_s` is the host time of
    the warm-up and the capture."""

    def __init__(self, body, device, iters: int = 1):
        self.body, self.iters = body, iters
        self.device = torch.device(device)
        self.graph = None
        self.launches: list = []
        self.capture_s = 0.0
        if self.device.type != "cuda":
            return
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body(0)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with kernels.recording() as rec, torch.cuda.graph(
                    self.graph, stream=side):
                for i in range(iters):
                    body(i)
            torch.cuda.synchronize()
        self.launches = rec
        self.capture_s = time.perf_counter() - t0

    def __call__(self) -> None:
        if self.graph is None:
            for i in range(self.iters):
                self.body(i)
            return
        with torch.cuda.device(self.device):
            self.graph.replay()
        kernels.count_launches(self.launches)
