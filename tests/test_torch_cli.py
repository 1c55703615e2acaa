"""The port's `blf-gen` and `blf-check` against the JAX package's CLI:
the same stdin gives byte-identical .blf files and the same lines and
exit codes, fresh and incremental, FOUND and NOT FOUND, and the same
error exits.  The port adds hashes in batches; the JAX package tests and
adds them one at a time."""

import io
import sys

import numpy as np
import pytest

from ecloop_tpu import cli as jcli
from ecloop_tpu_torch import bloom, cli

RNG = np.random.default_rng(4)
HASHES = ["".join(f"{int(w):08x}" for w in row) for row in
          RNG.integers(0, 1 << 32, size=(400, 5), dtype=np.uint64)]


def _run(main, argv, stdin=""):
    """(exit code, stdout) of main(argv) with `stdin`; SystemExit's
    code stands for the exit code."""
    old_in, old_out = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = io.StringIO(stdin), io.StringIO()
    try:
        try:
            rc = main(["ecloop"] + argv)
        except SystemExit as e:
            rc = e.code
        return rc, sys.stdout.getvalue()
    finally:
        sys.stdin, sys.stdout = old_in, old_out


def _both(tmp_path, argv, stdin="", blf=None):
    """Run the port and the JAX CLI on their own copies of the file."""
    out = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        path = str(tmp_path / name / "f.blf")
        (tmp_path / name).mkdir(exist_ok=True)
        if blf is not None:
            with open(path, "wb") as f:
                f.write(blf)
        args = [path if a == "{blf}" else a for a in argv]
        rc, text = _run(main, args, stdin)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            data = None
        out.append((rc, text, data))
    return out


@pytest.mark.parametrize("n,lines", [
    (64, HASHES[:2] + HASHES[:1]),               # the reference's example
    (1000, HASHES + HASHES[::3]),                # duplicates everywhere
    (8, HASHES[:300]),                           # overfull: false positives
    (1, HASHES[:40]),
    (64, []),
    (64, ["zz" * 20, HASHES[5][:39], "", HASHES[5].upper(),
          " " + HASHES[6] + " ", HASHES[5]]),    # bad and odd lines
], ids=["example", "dups", "overfull", "n1", "empty", "odd-lines"])
def test_blf_gen_equals_jax(tmp_path, n, lines):
    stdin = "\n".join(lines) + "\n"
    (prc, pout, pdata), (jrc, jout, jdata) = _both(
        tmp_path, ["blf-gen", "-n", str(n), "-o", "{blf}"], stdin)
    assert (prc, pout) == (jrc, jout) == (0, jout)
    assert jout.startswith("added ")
    assert pdata == jdata


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("n,lines", [
    (1000, HASHES + HASHES[::3]),
    (8, HASHES[:300]),
], ids=["dups", "overfull"])
def test_blf_gen_across_chunks_equals_jax(tmp_path, monkeypatch, chunk, n,
                                          lines):
    """The port's batches span many chunks of add_new: a duplicate or a
    false positive of a hash in an earlier chunk counts as the reference's
    one-at-a-time loop counts it."""
    monkeypatch.setattr(bloom, "ADD_CHUNK", chunk)
    stdin = "\n".join(lines) + "\n"
    (prc, pout, pdata), (jrc, jout, jdata) = _both(
        tmp_path, ["blf-gen", "-n", str(n), "-o", "{blf}"], stdin)
    assert (prc, pout) == (jrc, jout) == (0, jout)
    assert pdata == jdata


def test_blf_gen_incremental_update_equals_jax(tmp_path):
    first = "\n".join(HASHES[:150]) + "\n"
    (_, _, blf), _ = _both(tmp_path, ["blf-gen", "-n", "200", "-o", "{blf}"],
                           first)
    more = "\n".join(HASHES[100:250]) + "\n"      # 50 already present
    (prc, pout, pdata), (jrc, jout, jdata) = _both(
        tmp_path, ["blf-gen", "-n", "200", "-o", "{blf}"], more, blf=blf)
    assert (prc, pout) == (jrc, jout)
    assert pout.startswith("added 100 hashes (50 duplicates)")
    assert pdata == jdata != blf
    # another -n: the size differs, and both refuse to update
    (prc, pout, pdata), (jrc, jout, jdata) = _both(
        tmp_path, ["blf-gen", "-n", "5000", "-o", "{blf}"], more, blf=blf)
    assert prc == jrc == 1 and pdata == jdata == blf


@pytest.mark.parametrize("argv,stdin", [
    (["blf-check", "-f", "{blf}"] + HASHES[:3], ""),
    (["blf-check", "-f", "{blf}", HASHES[0]], ""),
    (["blf-check", "-f", "{blf}"], "\n".join(HASHES[95:105]) + "\n"),
    (["blf-check", "-f", "{blf}"], "\n".join(HASHES[200:203]) + "\n"),
    (["blf-check", "-f", "{blf}", "zz" * 20, HASHES[1]], ""),
    (["blf-check", "-f", "{blf}"], "short\n" + "zz" * 20 + "\n"),
], ids=["args-found", "arg-found", "stdin-mixed", "stdin-not-found",
        "args-bad-hex", "stdin-none-valid"])
def test_blf_check_equals_jax(tmp_path, argv, stdin):
    (_, _, blf), _ = _both(tmp_path, ["blf-gen", "-n", "100", "-o", "{blf}"],
                           "\n".join(HASHES[:100]) + "\n")
    (prc, pout, _), (jrc, jout, _) = _both(tmp_path, argv, stdin, blf=blf)
    assert (prc, pout) == (jrc, jout)
    found = [ln for ln in pout.splitlines()
             if ln.endswith(" FOUND") and "NOT FOUND" not in ln]
    assert prc == (0 if len(found) == len(pout.splitlines()) else 1)


@pytest.mark.parametrize("argv", [
    ["blf-gen", "-o", "x.blf"],
    ["blf-gen", "-n", "0", "-o", "x.blf"],
    ["blf-gen", "-n", "abc", "-o", "x.blf"],
    ["blf-gen", "-n", "64"],
    ["blf-gen", "-n", "64", "-o", "x.txt"],
    ["blf-check"],
    ["blf-check", "-f", "x.txt"],
])
def test_blf_error_exits_equal_jax(tmp_path, monkeypatch, capsys, argv):
    monkeypatch.chdir(tmp_path)
    prc, pout = _run(cli.main, argv)
    perr = capsys.readouterr().err
    jrc, jout = _run(jcli.main, argv)
    jerr = capsys.readouterr().err
    assert (prc, pout, perr) == (jrc, jout, jerr)
    assert prc == 1 and perr
    assert not (tmp_path / "x.blf").exists()
