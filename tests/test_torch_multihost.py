"""The port's runs of several processes (`ecloop_tpu_torch.parallel.multihost`
and the multi-process half of `checkpoint`): two CLI processes joined
over gloo on the CPU, on tests/test_multihost.py's vector, split the
range between them; a resume adopts the smaller of their cursors; a
checkpoint that fails to load in one process stops both instead of
hanging the other; `mul` and unseeded `rnd` refuse to run split.  In a
single process the checkpoint keys and paths are the JAX package's."""

import json
import os
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from ecloop_tpu import checkpoint as jcheckpoint
from ecloop_tpu.search.common import SearchConfig as JSearchConfig
from ecloop_tpu_torch import checkpoint
from ecloop_tpu_torch.parallel import multihost
from ecloop_tpu_torch.search import common
from ecloop_tpu_torch.search.common import SearchConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# planted keys inside [0x80000, 0x80400)
TARGETS = [0x80123, 0x80234, 0x803F7]
RANGE = ["-r", "80000:80400"]
# 4 centers x 128 keys per device: over the two processes' devices
# 1,024 keys a step, two steps for the 2,048-key claim, 512 keys of each
# step on each process's CPU device
GEOM = {"ECLOOP_CENTERS": "4", "ECLOOP_GROUP_K": "128",
        "ECLOOP_STEPS_PER_CALL": "1", "OMP_NUM_THREADS": "1"}
TIMEOUT = 120
FOUND = re.compile(r"^addr33: [0-9a-f]{40} <- ([0-9a-f]{64})$", re.M)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def targets_file(tmp_path):
    path = tmp_path / "targets"
    path.write_text("".join(common.derive_h160(k, True) + "\n"
                            for k in TARGETS))
    return str(path)


def _run_pair(argv):
    """Run `python -m ecloop_tpu_torch <argv>` as processes 0 and 1 of
    one gloo group on the CPU; [(rc, stdout, stderr)] in rank order."""
    env = {**os.environ, **GEOM, "ECLOOP_COORDINATOR":
           f"127.0.0.1:{_free_port()}", "ECLOOP_NUM_PROCS": "2"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ecloop_tpu_torch", *argv, "-device", "cpu"],
        cwd=ROOT, env={**env, "ECLOOP_PROC_ID": str(i)},
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for i in range(2)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, o, e.replace("\r", "\n")))
    except subprocess.TimeoutExpired:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except OSError:
                pass
            p.communicate()
        pytest.fail(f"the two processes did not end within {TIMEOUT} s")
    return out


def _found(stdout: str) -> set[int]:
    return {int(k, 16) for k in FOUND.findall(stdout)}


def _k_checked(stderr: str) -> int:
    last = [ln for ln in stderr.splitlines() if " Mkeys/s ~ " in ln][-1]
    return int(last.rsplit(" / ", 1)[1].split()[0].replace(",", ""))


@pytest.mark.parametrize("cmd", [["add"], ["rnd", "-seed", "s"]])
def test_two_processes_split_the_range(targets_file, cmd):
    """`add`, and a seeded `rnd` whose 2^20-key window covers the range
    in one pass."""
    runs = _run_pair([*cmd, "-f", targets_file, *RANGE])
    for i, (rc, out, err) in enumerate(runs):
        assert rc == 0, err[-2000:]
        assert out.startswith("devices: 2 ~ ")
        assert f"process {i}/2 ~ local devices: 1 / global: 2" in err
        assert _k_checked(err) == 0x400
    sets = [_found(out) for _, out, _ in runs]
    assert sets[0].isdisjoint(sets[1])
    assert sets[0] | sets[1] == set(TARGETS)
    # process 0 owns the first 512 keys of each step
    assert sets == [{0x80123}, {0x80234, 0x803F7}]


def _config_key(targets_file):
    cfg = SearchConfig(range_s=0x80000, range_e=0x80400)
    return {**checkpoint.config_key_for("add", cfg, targets_file), "procs": 2}


def test_resume_takes_the_smaller_cursor(targets_file, tmp_path):
    path = str(tmp_path / "state.json")
    for rank, cursor in ((0, 0x300), (1, 0x200)):
        checkpoint.Checkpoint(f"{path}.p{rank}", _config_key(targets_file)
                              ).save(cursor=cursor, force=True)
    runs = _run_pair(["add", "-f", targets_file, *RANGE, "-c", path])
    for rank, (rc, out, err) in enumerate(runs):
        assert rc == 0, err[-2000:]
        assert "resuming from checkpoint: offset 512 keys" in out
        assert _k_checked(err) == 0x400
        with open(f"{path}.p{rank}") as f:
            assert json.load(f)["cursor"] == 0x800
    sets = [_found(out) for _, out, _ in runs]
    assert sets[0].isdisjoint(sets[1])
    assert sets[0] | sets[1] == {0x80234, 0x803F7}


@pytest.mark.parametrize("bad", ["json", "field"])
def test_corrupt_checkpoint_stops_both_processes(targets_file, tmp_path, bad):
    """Process 0's file is not JSON, or is this search's with a cursor
    that is not a count: both processes exit 1 with process 0's error."""
    path = str(tmp_path / "state.json")
    with open(f"{path}.p0", "w") as f:
        f.write("{not json" if bad == "json" else json.dumps(
            {"version": 1, "config": _config_key(targets_file),
             "cursor": [512], "k_checked": 0, "k_found": 0, "iters": 0}))
    runs = _run_pair(["add", "-f", targets_file, *RANGE, "-c", path])
    for rc, out, err in runs:
        assert rc == 1
        assert "process 0: " in err and not _found(out)
        assert bad == "json" or "cursor [512] is not a count" in err
    assert not os.path.exists(f"{path}.p1")


@pytest.mark.parametrize("field,value", [("cursor", [1]), ("k_checked", "7"),
                                         ("iters", -1), ("k_found", 1.5)])
def test_checkpoint_field_that_is_not_a_count(tmp_path, field, value):
    path = str(tmp_path / "c.json")
    key = checkpoint.config_key_for("add", SearchConfig(), None)
    checkpoint.Checkpoint(path, key).save(cursor=3, force=True)
    with open(path) as f:
        st = json.load(f)
    st[field] = value
    with open(path, "w") as f:
        json.dump(st, f)
    with pytest.raises(ValueError, match=f"{field} .* is not a count"):
        checkpoint.Checkpoint(path, key).try_resume()


@pytest.mark.parametrize("argv,message", [
    (["mul", "-f", os.path.join(ROOT, "data", "btc-bw-hash")],
     "mul runs in one process"),
    (["rnd", "-f", os.path.join(ROOT, "data", "btc-puzzles-hash"), *RANGE],
     "needs -seed"),
])
def test_mul_and_unseeded_rnd_refuse_several_processes(argv, message):
    for rc, out, err in _run_pair(argv):
        assert rc == 1 and message in err
        assert not _found(out)


def test_single_process_keys_and_paths_match_jax(tmp_path):
    assert multihost.process_count() == 1 and not multihost.init_from_env()
    for kw in (dict(range_s=0x8000, range_e=0xFFFF),
               dict(range_s=0x70000, range_e=0x70400, stride_offs=3,
                    addr65=True, endo=True)):
        for args in (("add", "f.txt"), ("rnd", None, "seed")):
            assert (checkpoint.config_key_for(args[0], SearchConfig(**kw),
                                              *args[1:])
                    == jcheckpoint.config_key_for(args[0], JSearchConfig(**kw),
                                                  *args[1:]))
    path = str(tmp_path / "c.json")
    assert checkpoint.process_local_path(path) == \
        jcheckpoint.process_local_path(path) == path
    (tmp_path / "c.json.p1").write_text("{}")
    for mod in (checkpoint, jcheckpoint):
        with pytest.raises(ValueError, match="per-process siblings"):
            mod.process_local_path(path)


def test_single_process_reconcile():
    assert checkpoint.reconcile_multihost(7, 8, 9) == (7, 8, 9)
    assert checkpoint.reconcile_multihost(7, 8, 9) == \
        jcheckpoint.reconcile_multihost(7, 8, 9)
    with pytest.raises(ValueError, match="^bad file$"):
        checkpoint.reconcile_multihost(0, error="bad file")


def test_env_without_coordinator(monkeypatch):
    for name in multihost.ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ECLOOP_DISTRIBUTED", "1")
    with pytest.raises(ValueError, match="ECLOOP_COORDINATOR, "
                       "ECLOOP_NUM_PROCS, ECLOOP_PROC_ID"):
        multihost.init_from_env()
    monkeypatch.setenv("ECLOOP_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("ECLOOP_NUM_PROCS", "2")
    monkeypatch.setenv("ECLOOP_PROC_ID", "2")
    with pytest.raises(ValueError, match="not below"):
        multihost.init_from_env()
    assert np.array_equal(multihost.all_gather(np.arange(3))[0], np.arange(3))
