"""Runs of several processes (the counterpart of
`ecloop_tpu.parallel.multihost`): every process joins one
`torch.distributed` group over gloo and searches its own block of the
global device list, with no manual splitting of ranges.

Launch (the same command on every host, i = 0 .. P-1):

    ECLOOP_COORDINATOR=host0:1234 ECLOOP_NUM_PROCS=P ECLOOP_PROC_ID=$i \\
        python -m ecloop_tpu_torch add -f targets.blf -r ...:... -o found_$i.txt

The group carries only a few host integers, at start-up: the device
counts and the agreed resume position.  No collective runs during a
search, so a process cannot hang its peers mid-range.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

ENV = ("ECLOOP_COORDINATOR", "ECLOOP_NUM_PROCS", "ECLOOP_PROC_ID")
# how long a process waits for its peers at the start-up rendezvous and
# at each collective before it fails: a peer that died before the
# gather ends the run in minutes, not after gloo's default half hour
TIMEOUT_S = 300


def init_from_env() -> bool:
    """Join the gloo group that ECLOOP_COORDINATOR=host:port,
    ECLOOP_NUM_PROCS and ECLOOP_PROC_ID describe; True when it has more
    than one process.  ECLOOP_DISTRIBUTED=1 alone (the JAX package's
    TPU-pod autodetection) has no counterpart here and raises, as do
    missing or malformed variables."""
    coord = os.environ.get("ECLOOP_COORDINATOR")
    if not coord:
        if os.environ.get("ECLOOP_DISTRIBUTED") == "1":
            raise ValueError("ECLOOP_DISTRIBUTED=1 relies on TPU-pod "
                             "autodetection, which this package lacks; set "
                             + ", ".join(ENV))
        return False
    try:
        procs = int(os.environ["ECLOOP_NUM_PROCS"])
        rank = int(os.environ["ECLOOP_PROC_ID"])
    except (KeyError, ValueError):
        raise ValueError(f"ECLOOP_COORDINATOR needs integer "
                         f"ECLOOP_NUM_PROCS and ECLOOP_PROC_ID (set "
                         f"{', '.join(ENV)})") from None
    if not 0 <= rank < procs:
        raise ValueError(f"ECLOOP_PROC_ID={rank} is not below "
                         f"ECLOOP_NUM_PROCS={procs}")
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=procs, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return procs > 1


def leave() -> None:
    """Leave the group, if this process joined one.  A process that
    exits while still in it can abort at shutdown ("terminate called
    without an active exception") once a peer has gone."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def all_gather(obj) -> list:
    """Every process's `obj`, in rank order (one collective; [obj]
    without a group)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def global_devices(local: list[torch.device]):
    """(devices, owned): the global device list, each process's local
    devices in rank order, and the indices of this process's own block,
    as a JAX process owns its addressable shards."""
    blocks = all_gather([str(d) for d in local])
    start = sum(len(b) for b in blocks[:process_index()])
    devices = [torch.device(d) for b in blocks for d in b]
    return devices, list(range(start, start + len(local)))


def process_banner(n_local: int) -> str:
    n_global = sum(all_gather(n_local))
    return (f"process {process_index()}/{process_count()} ~ local devices: "
            f"{n_local} / global: {n_global}")
