"""Cursor checkpoint and resume for `add -c` and `rnd -c` (the port of
`ecloop_tpu.checkpoint`).

A small JSON file, written atomically (tmp + rename) at most every
`min_interval` seconds unless forced, holds the next key offset of an
`add` run (`cursor`) or the finished iterations of a seeded `rnd` run
(`iters`), and the counters.  It is keyed by the search's configuration,
so a file of another search refuses to resume instead of skipping keys.
The keys and the layout are the JAX package's: each package resumes
from the other's files.  In a run of several processes each keeps its
own file (`path.pN`), and all of them resume from the least position
any of them saved (`reconcile_multihost`).
"""

from __future__ import annotations

import glob
import json
import os
import time

from .parallel import multihost


class Checkpoint:
    def __init__(self, path: str, config_key: dict, min_interval: float = 5.0):
        self.path = path
        self.config_key = dict(config_key)
        self.min_interval = min_interval
        self._last_write = 0.0
        self.cursor = None          # next key offset to search
        self.k_checked = 0
        self.k_found = 0
        self.iters = 0              # rnd: finished iterations

    def try_resume(self) -> bool:
        """Load the file, if any.  True when it belongs to this search
        and holds a position; raises ValueError when it belongs to
        another search or a position or counter is not a count."""
        if not os.path.exists(self.path):
            return False
        with open(self.path) as f:
            st = json.load(f)
        if not isinstance(st, dict):
            raise ValueError(f"checkpoint {self.path} is not a checkpoint")
        if st.get("config") != self.config_key:
            raise ValueError(
                f"checkpoint {self.path} belongs to a different search "
                f"(config mismatch); delete it or use another -c path")
        for name in ("cursor", "k_checked", "k_found", "iters"):
            v = st.get(name)
            if v is not None and (type(v) is not int or v < 0):
                raise ValueError(f"checkpoint {self.path}: {name} {v!r} is "
                                 f"not a count")
        self.cursor = st.get("cursor")
        self.k_checked = st.get("k_checked") or 0
        self.k_found = st.get("k_found") or 0
        self.iters = st.get("iters") or 0
        return self.cursor is not None or self.iters > 0

    def save(self, cursor: int | None = None, k_checked: int | None = None,
             k_found: int | None = None, iters: int | None = None,
             force: bool = False) -> None:
        """Update the state; write it when forced or when min_interval
        has passed since the last write."""
        if cursor is not None:
            self.cursor = cursor
        if k_checked is not None:
            self.k_checked = k_checked
        if k_found is not None:
            self.k_found = k_found
        if iters is not None:
            self.iters = iters
        now = time.monotonic()
        if not force and now - self._last_write < self.min_interval:
            return
        self._last_write = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "version": 1,
                "config": self.config_key,
                "cursor": self.cursor,
                "k_checked": self.k_checked,
                "k_found": self.k_found,
                "iters": self.iters,
                "ts": time.time(),
            }, f)
        os.replace(tmp, self.path)


def config_key_for(cmd: str, cfg, filter_path: str | None,
                   seed: str | None = None) -> dict:
    """What identifies a search: command, range, stride, address forms,
    endo, filter and seed (batch geometry does not), and the number of
    processes when there are several: the cursor is global, but another
    process count would split the keyspace otherwise."""
    key = {
        "cmd": cmd,
        "range_s": f"{cfg.range_s:x}",
        "range_e": f"{cfg.range_e:x}",
        "stride_offs": cfg.stride_offs,
        "addr33": cfg.addr33,
        "addr65": cfg.addr65,
        "endo": cfg.endo,
        "filter": os.path.abspath(filter_path) if filter_path else None,
        "seed": seed,
    }
    if multihost.process_count() > 1:
        key["procs"] = multihost.process_count()
    return key


def process_local_path(path: str) -> str:
    """This process's checkpoint file: `path.pN` for process N of a run
    of several (two processes must not race tmp + rename on one file),
    else `path` itself.  A single-process run refuses when only
    per-process siblings exist, since resuming from `path` would
    restart the range from 0."""
    if multihost.process_count() > 1:
        return f"{path}.p{multihost.process_index()}"
    stale = sorted(glob.glob(glob.escape(path) + ".p*"))
    if stale and not os.path.exists(path):
        raise ValueError(
            f"checkpoint {path} has per-process siblings from a "
            f"multi-host run ({', '.join(os.path.basename(s) for s in stale)}); "
            f"resuming single-process would restart from 0 — delete them "
            f"or re-run with the original process topology")
    return path


def reconcile_multihost(position: int, k_checked: int = 0, k_found: int = 0,
                        error: str | None = None) -> tuple[int, int, int]:
    """The resume state every process adopts: each process's files are
    saved on their own cadence and may disagree after a crash, so all of
    them take the (position, k_checked, k_found) of the least position;
    searching a few keys again is harmless, skipping keys is not.  A
    process without a checkpoint brings 0, which restarts everyone.

    `error` is this process's failure to load its checkpoint.  It still
    takes part in the gather, so that its peers do not wait for it
    forever; then every process raises ValueError with every message.
    The identity for a single process without an error."""
    rows = multihost.all_gather((position, k_checked, k_found, error))
    errors = [f"process {i}: {r[3]}" if len(rows) > 1 else r[3]
              for i, r in enumerate(rows) if r[3] is not None]
    if errors:
        raise ValueError("; ".join(errors))
    return min(rows, key=lambda r: r[0])[:3]
