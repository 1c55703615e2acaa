"""Searches split over a list of devices (the counterpart of
`ecloop_tpu.parallel.mesh`).

The device list is the mesh.  `search.add.AddSearch` and
`search.mul.MulSearch` take one device or a list of n and hold one shard
per device: each holds its own copy of the table, the advance point and
the filter bits, owns a disjoint contiguous block of every step's keys
or every job's keys, and never talks to the others during a search:
the only parallelism the workload admits is over the keyspace.  One
device is the case n = 1 of the same layout, so the found set and the
key count do not depend on n.

In a run of several processes (`parallel.multihost`) every process
builds the same global device list and runs only the shards it owns;
each found key is reported by the one process that owns its shard.
"""

from __future__ import annotations

import torch


def make_devices(devices=None) -> list[torch.device]:
    """The devices of a search: every visible CUDA device by default,
    one device (or its name), or a list; on the CPU a caller passes
    [torch.device("cpu")] * n."""
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(devices, (list, tuple)):
        return [torch.device(d) for d in devices]
    return [torch.device(devices)]


def owned_shards(owned, n: int) -> list[int]:
    """The sorted shard indices a process runs out of n: all of them
    when `owned` is None."""
    owned = list(range(n)) if owned is None else sorted(owned)
    if not owned or owned[0] < 0 or owned[-1] >= n:
        raise ValueError(f"owned shards {owned} out of range for {n} "
                         f"devices")
    return owned
