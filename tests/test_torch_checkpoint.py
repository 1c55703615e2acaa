"""The port's checkpoint against the JAX package's: the same file layout
and config key, so each package resumes from the other's files; atomic,
throttled saves; refusal of another search's file and of stale
per-process siblings.  `run_range`'s resume cursor finds exactly the
keys past it with the reference's key count, and its range override
equals an engine built for those bounds; `add -c` and `rnd -c` resume
through the CLI."""

import json

import numpy as np
import pytest
import torch

from ecloop_tpu import checkpoint as jcheckpoint
from ecloop_tpu.search import common as jcommon
from ecloop_tpu.search.common import SearchConfig as JSearchConfig
from ecloop_tpu_torch import checkpoint, cli, filters
from ecloop_tpu_torch.search import add, common
from ecloop_tpu_torch.search.common import SearchConfig

# one step covers the 2,048-key span of these ranges (see test_torch_rnd)
SMALL = dict(centers=4, group_k=2048, steps_per_call=1)
RS, RE = 0x70000, 0x70400
EARLY, LATE = RS + 5, RS + 0x300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hash_row(key):
    return np.frombuffer(bytes.fromhex(common.derive_h160(key, True)),
                         dtype=">u4").astype(np.uint32)


def _filter_for(keys):
    return filters.filter_from_hashes(np.stack([_hash_row(k) for k in keys]))


def test_checkpoint_roundtrip_and_mismatch(tmp_path):
    path = str(tmp_path / "c.json")
    key = {"cmd": "add", "range_s": "8000"}
    c = checkpoint.Checkpoint(path, key, min_interval=0)
    assert not c.try_resume()
    c.save(cursor=1024, k_checked=4096, k_found=1, force=True)
    c2 = checkpoint.Checkpoint(path, key)
    assert c2.try_resume()
    assert (c2.cursor, c2.k_checked, c2.k_found, c2.iters) == (1024, 4096, 1, 0)
    with pytest.raises(ValueError, match="different search"):
        checkpoint.Checkpoint(path, {"cmd": "add", "range_s": "9000"}
                              ).try_resume()
    for i in range(10):
        c2.save(cursor=i, force=True)
    with open(path) as f:
        assert json.load(f)["cursor"] == 9
    assert not (tmp_path / "c.json.tmp").exists()


def test_checkpoint_throttling(tmp_path):
    path = str(tmp_path / "c.json")
    c = checkpoint.Checkpoint(path, {}, min_interval=9999)
    c.save(cursor=1, force=True)
    c.save(cursor=2)
    with open(path) as f:
        assert json.load(f)["cursor"] == 1
    assert c.cursor == 2
    c.save(force=True)
    with open(path) as f:
        assert json.load(f)["cursor"] == 2


def test_refuses_stale_per_process_siblings(tmp_path):
    base = tmp_path / "state.json"
    (tmp_path / "state.json.p0").write_text("{}")
    (tmp_path / "state.json.p1").write_text("{}")
    with pytest.raises(ValueError, match="per-process siblings"):
        checkpoint.process_local_path(str(base))
    base.write_text("{}")
    assert checkpoint.process_local_path(str(base)) == str(base)
    assert checkpoint.process_local_path(str(tmp_path / "x")) == str(
        tmp_path / "x")


@pytest.mark.parametrize("cmd,seed,endo", [("add", None, False),
                                           ("add", None, True),
                                           ("rnd", "s", False)])
def test_files_resume_across_packages(tmp_path, cmd, seed, endo):
    fields = dict(range_s=0x8000, range_e=0xFFFFFF, stride_offs=3,
                  addr33=True, addr65=True, endo=endo)
    key = checkpoint.config_key_for(cmd, SearchConfig(**fields), "t.txt",
                                    seed=seed)
    jkey = jcheckpoint.config_key_for(cmd, JSearchConfig(**fields), "t.txt",
                                      seed=seed)
    assert key == jkey
    ours, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    checkpoint.Checkpoint(ours, key).save(cursor=0x7F8000, k_checked=123,
                                          k_found=2, iters=4, force=True)
    jcheckpoint.Checkpoint(theirs, jkey).save(cursor=77, k_checked=456,
                                              k_found=3, iters=5, force=True)
    with open(ours) as f, open(theirs) as g:
        assert set(json.load(f)) == set(json.load(g))
    j = jcheckpoint.Checkpoint(ours, jkey)
    assert j.try_resume()
    assert (j.cursor, j.k_checked, j.k_found, j.iters) == (0x7F8000, 123, 2, 4)
    p = checkpoint.Checkpoint(theirs, key)
    assert p.try_resume()
    assert (p.cursor, p.k_checked, p.k_found, p.iters) == (77, 456, 3, 5)


def _claimed(rs, re_):
    job = jcommon.derive_job_size(rs, re_)
    return sum(c.job for c in jcommon.plan_claims(rs, re_, job, 1))


def test_run_range_resume_finds_the_keys_past_the_cursor():
    filt = _filter_for([EARLY, LATE])
    cfg = SearchConfig(range_s=RS, range_e=RE, **SMALL)
    eng = add.AddSearch(cfg, filt, "cpu")
    steps = []
    assert {f.priv for f in eng.run_range(on_step=steps.append)} == {
        EARLY, LATE}
    assert steps[-1] == 2048 and eng.k_checked == _claimed(RS, RE)

    cursor = 0x100
    eng = add.AddSearch(cfg, filt, "cpu")
    steps = []
    got = eng.run_range(start_offset=cursor, on_step=steps.append)
    assert [f.priv for f in got] == [LATE]
    assert steps == [2048]              # progress counts the skipped keys
    assert eng.k_checked == _claimed(RS, RE) == 0x400

    eng = add.AddSearch(cfg, filt, "cpu")
    assert eng.run_range(start_offset=2048) == []
    assert eng.k_checked == 0x400


def test_run_range_override_equals_a_fresh_engine():
    lo, hi = 0x52000, 0x52800
    filt = _filter_for([lo + 7, lo + 0x5FF, hi - 1, EARLY])
    shared = add.AddSearch(SearchConfig(range_s=RS, range_e=RE, **SMALL),
                           filt, "cpu")
    got = shared.run_range(range_s=lo, range_e=hi)
    fresh = add.AddSearch(SearchConfig(range_s=lo, range_e=hi, **SMALL),
                          filt, "cpu")
    want = fresh.run_range()
    assert got == want
    assert {f.priv for f in got} == {lo + 7, lo + 0x5FF, hi - 1}
    assert shared.k_checked == fresh.k_checked == _claimed(lo, hi)


def test_cli_add_resumes_from_checkpoint(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_CENTERS", str(SMALL["centers"]))
    monkeypatch.setenv("ECLOOP_GROUP_K", str(SMALL["group_k"]))
    monkeypatch.setenv("ECLOOP_STEPS_PER_CALL", "1")
    targets = tmp_path / "targets.txt"
    targets.write_text("".join(common.derive_h160(k, True) + "\n"
                               for k in (EARLY, LATE)))
    state = str(tmp_path / "state.json")
    key = checkpoint.config_key_for(
        "add", SearchConfig(range_s=RS, range_e=RE), str(targets))
    checkpoint.Checkpoint(state, key).save(cursor=0x100, k_found=1,
                                           force=True)
    argv = ["ecloop", "add", "-f", str(targets), "-r", "70000:70400",
            "-device", "cpu", "-c", state]
    run = cli.run_add(cli.Args(argv))
    out = capsys.readouterr()
    assert "resuming from checkpoint: offset 256 keys" in out.out
    assert [f.priv for f in run.found] == [LATE]
    assert run.k_checked == 0x400
    assert out.err.rstrip().endswith("2 / 1,024")
    with open(state) as f:
        st = json.load(f)
    assert (st["cursor"], st["k_checked"], st["k_found"]) == (2048, 1024, 2)

    # another search's file is refused, with exit code 1
    with pytest.raises(SystemExit) as exc:
        cli.run_add(cli.Args(argv[:-2] + ["-endo", "-c", state]))
    assert exc.value.code == 1
    assert "different search" in capsys.readouterr().err


@pytest.mark.parametrize("seed", ["s", None])
def test_cli_rnd_resumes_from_checkpoint(tmp_path, monkeypatch, capsys, seed):
    """rnd -c saves after every iteration; a rerun skips the saved draws
    and keeps the saved counters (a one-pass range: nothing is left)."""
    monkeypatch.setenv("ECLOOP_CENTERS", str(SMALL["centers"]))
    monkeypatch.setenv("ECLOOP_GROUP_K", str(SMALL["group_k"]))
    monkeypatch.setenv("ECLOOP_STEPS_PER_CALL", "1")
    targets = tmp_path / "targets.txt"
    targets.write_text(common.derive_h160(LATE, True) + "\n")
    state = str(tmp_path / "state.json")
    argv = ["ecloop", "rnd", "-f", str(targets), "-r", "70000:70400",
            "-d", "0:20", "-device", "cpu", "-c", state]
    argv += ["-seed", seed] if seed else []
    run = cli.run_rnd(cli.Args(argv))
    assert [f.priv for f in run.found] == [LATE] and run.k_checked == 0x400
    with open(state) as f:
        st = json.load(f)
    assert (st["iters"], st["k_checked"], st["k_found"]) == (1, 0x400, 1)
    assert st["config"]["seed"] == seed
    capsys.readouterr()

    run = cli.run_rnd(cli.Args(argv))
    out = capsys.readouterr()
    assert "resuming from checkpoint: iteration 1" in out.out
    assert ("note: unseeded rnd draws fresh ranges" in out.err) == (
        seed is None)
    assert run.found == [] and run.k_checked == 0x400
    assert out.err.rstrip().endswith("1 / 1,024")
