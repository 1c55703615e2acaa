"""The port's `mul` search against the JAX package's: the window add (the
body of K3) in both forms, the gtable, and one device step on the same
inputs must be bit-identical; the engine and the CLI must find planted
and vector keys in both address forms."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import bloom as jbloom
from ecloop_tpu import ecc as jecc
from ecloop_tpu import fe as jfe
from ecloop_tpu import fel as jfel
from ecloop_tpu import filters as jfilters
from ecloop_tpu import golden
from ecloop_tpu.search import mul as jmul
from ecloop_tpu.search.common import SearchConfig as JSearchConfig
from ecloop_tpu_torch import bloom, cli, fel, filters, kernels, trace
from ecloop_tpu_torch.search import mul
from ecloop_tpu_torch.search.common import SearchConfig, derive_h160

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BW_PRIV = os.path.join(ROOT, "data", "btc-bw-priv")
BW_HASH = os.path.join(ROOT, "data", "btc-bw-hash")
W, BATCH = 8, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers; torch's own thread pool on
    these small batches only burns the cores the other workers need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_table(tmp_path_factory):
    """The JAX package's host-built w=8 table (its disk cache kept in a
    temporary directory)."""
    os.environ["ECLOOP_CACHE_DIR"] = str(tmp_path_factory.mktemp("cache"))
    try:
        tx, ty = jmul.build_gtable(W, how="host")
    finally:
        del os.environ["ECLOOP_CACHE_DIR"]
    return np.asarray(tx), np.asarray(ty)


def _h160s(keys, compressed=True):
    """hash160 of a few keys' pubkeys, from the JAX package's golden."""
    out = []
    for k in keys:
        pt = golden.point_mul(k)
        h = golden.addr33(pt) if compressed else golden.addr65(pt)
        out.append(np.frombuffer(h, dtype=">u4").astype(np.uint32))
    return np.stack(out)


@functools.cache
def _window_lanes(n=64, seed=7):
    """Accumulator and table points with the special lanes: 0 infinity,
    1 P == Q, 2 P == -Q, 3 and 40 skipped, others consecutive multiples
    of G from two random keys, with a random z."""
    rng = np.random.default_rng(seed)
    k0, k1 = (int.from_bytes(rng.bytes(32), "big") % golden.N or 1
              for _ in range(2))
    zs = [int.from_bytes(rng.bytes(32), "big") % golden.P or 1
          for _ in range(n)]

    def run(k):                      # k G, (k + 1) G, ...: one add each
        pts = [golden.point_mul(k)]
        while len(pts) < n:
            pts.append(golden.point_add(pts[-1], golden.G))
        return pts
    q, g = run(k0), run(k1)
    q[1] = g[1]
    q[2] = golden.point_neg(g[2])
    qx = [0 if i == 0 else q[i][0] * zs[i] % golden.P for i in range(n)]
    qy = [1 if i == 0 else q[i][1] * zs[i] % golden.P for i in range(n)]
    qz = [0 if i == 0 else zs[i] for i in range(n)]
    skip = np.zeros(n, bool)
    skip[[3, 40]] = True
    return (qx, qy, qz, [p[0] for p in g], [p[1] for p in g]), skip


@pytest.mark.parametrize("complete", [True, False])
def test_window_add_matches_jax(complete):
    vals, skip = _window_lanes()
    ours = kernels.proj_add_affine(
        *(fel.ints_to_tensor(v, "cpu") for v in vals),
        torch.from_numpy(skip), complete)
    rows = [jfel.from_last(jnp.asarray(jfe.ints_to_limbs(v))) for v in vals]
    nx, ny, nz = jecc.proj_add_affine_rows(*rows, complete=complete)
    jskip = jnp.asarray(skip)
    for got, new, old in zip(ours, (nx, ny, nz), rows[:3]):
        want = np.asarray(jfel.to_last(jfel.select(jskip, old, new)))
        np.testing.assert_array_equal(fel.to_last(got), want)
    # the doubling lane differs between the forms, infinity on the other
    z = fel.tensor_to_ints(ours[2])
    assert (z[1] != 0) == complete
    assert z[2] == 0 and z[0] == 1


@pytest.mark.parametrize("w", [4, 8])
def test_gtable_matches_jax(w, jax_table, tmp_path, monkeypatch):
    if w == W:
        tx, ty = jax_table
    else:
        monkeypatch.setenv("ECLOOP_CACHE_DIR", str(tmp_path))
        tx, ty = (np.asarray(a) for a in jmul.build_gtable(w, how="host"))
    table = mul.build_gtable(w, torch.device("cpu"))
    assert torch.equal(table, mul.gtable_from_numpy(tx, ty, "cpu"))


def test_host_helpers_match_jax():
    rng = np.random.default_rng(3)
    keys = [0, 1, golden.N - 1, golden.N, golden.N + 5, (1 << 256) - 1]
    keys += [int.from_bytes(rng.bytes(32), "big") for _ in range(40)]
    words = mul.keys_to_words(keys)
    np.testing.assert_array_equal(words, jmul.keys_to_words(keys))
    red = mul.words_mod_n(words)
    np.testing.assert_array_equal(red, jmul.words_mod_n(words))
    assert [mul.word_to_int(r) for r in red] == [k % golden.N for k in keys]
    for w in (4, 8, 14, 18):
        np.testing.assert_array_equal(mul.window_digits(keys, w),
                                      jmul.window_digits(keys, w))
    lines = ["ab" * 32, "0f", "hello"]
    assert mul.parse_keys(lines, True) == jmul.parse_keys(lines, True)
    assert mul.parse_keys(lines[:2], False) == jmul.parse_keys(lines[:2],
                                                                False)


def test_bulk_hex_parse_takes_only_plain_short_lines():
    lines = ["c936", "FF" * 32]
    np.testing.assert_array_equal(
        mul.parse_hex_words(lines),
        mul.words_mod_n(mul.keys_to_words([0xC936, (1 << 256) - 1])))
    # longer than 64 digits, or whitespace fromhex would skip: per-line path
    assert mul.parse_hex_words(["1" + "0" * 64]) is None
    assert mul.parse_hex_words(["ab  cd"] * 32) is None


def _step_inputs(keys):
    """The keys' (d, BATCH) digits padded with zero lanes."""
    dig = np.zeros((mul.n_windows(W), BATCH), dtype=np.uint16)
    dig[:, :len(keys)] = mul.window_digits(keys, W).T
    return dig


@pytest.mark.parametrize("mode", ["list", "bloom"])
def test_mul_step_matches_jax(mode, jax_table, tmp_path):
    planted = [3, 0x123456789ABCDEF, golden.N - 5]
    keys = planted + [golden.N, 0xDEADBEEF, 1 << 200] + list(range(7, 27))
    assert len(keys) < BATCH                     # a padded tail
    if mode == "list":
        jfilt = jfilters.filter_from_hashes(np.concatenate(
            [_h160s(planted[:2]), _h160s(planted[2:], compressed=False)]))
        filt = filters.filter_from_hashes(jfilt.targets)
    else:
        blf = jbloom.BloomFilter.for_count(16)
        blf.add_many(np.concatenate([_h160s(planted),
                                     _h160s(planted, compressed=False)]))
        path = str(tmp_path / "t.blf")
        blf.save(path)
        jfilt, filt = jfilters.load_filter(path), filters.load_filter(path)
    jcfg = JSearchConfig(addr33=True, addr65=True, lanes=BATCH)
    cfg = SearchConfig(addr33=True, addr65=True)
    dig = _step_inputs(keys)
    jmasks = jmul.make_mul_step(jcfg, jfilt, W, BATCH)(
        jnp.asarray(dig), jmul.interleave_gtable(*map(jnp.asarray, jax_table)),
        jnp.asarray(jfilt.device_bits))
    table = mul.gtable_from_numpy(*jax_table, "cpu")
    step = mul.make_mul_step(cfg, filt, W, BATCH, "cpu")
    masks = step(torch.from_numpy(dig.astype(np.int32)), table,
                 bloom.bits_tensor(filt.device_bits, "cpu"))
    np.testing.assert_array_equal(masks.numpy(),
                                  np.asarray(jmasks).astype(np.int64))
    bits = mul.unpack_mask(masks.numpy()[0])
    assert bits[:2].all() and mul.unpack_mask(masks.numpy()[1])[2]


def _engine(filt, addr33=True, addr65=False, raw=False, devices="cpu",
            batch=BATCH):
    return mul.MulSearch(SearchConfig(addr33=addr33, addr65=addr65), filt,
                         devices, w=W, batch=batch, raw=raw)


def test_mul_search_finds_keys_both_addr_types():
    keys = [3, 0xDEADBEEF, 0x123456789ABCDEF, golden.N - 5]
    eng = _engine(filters.filter_from_hashes(_h160s(keys)))
    found = eng.run_keys(keys + [0x999, 0x777])
    assert sorted(f.priv for f in found) == sorted(keys)
    assert eng.k_checked == 6

    eng = _engine(filters.filter_from_hashes(_h160s(keys, compressed=False)),
                  addr33=True, addr65=True)
    found = eng.run_keys(keys)
    assert sorted(f.priv for f in found) == sorted(keys)
    assert all(f.label == "addr65" for f in found)


def test_mul_search_raw_mode_and_long_lines():
    lines = ["hello", "bitcoin is worth it", "x"]
    keys = [k % golden.N for k in mul.parse_keys(lines, raw=True)]
    eng = _engine(filters.filter_from_hashes(_h160s(keys)), raw=True)
    assert sorted(f.priv for f in eng.run_lines(lines)) == sorted(keys)
    # a line longer than 64 hex digits is reduced mod n, as int(line, 16)
    long_line = f"{golden.N + 0xC936:x}"
    eng = _engine(filters.filter_from_hashes(_h160s([0xC936])))
    assert [f.priv for f in eng.run_lines([long_line, "c936"])] == [0xC936] * 2


def test_mul_search_bloom_filter(tmp_path):
    keys = [11111, 22222]
    blf = bloom.BloomFilter.for_count(16)
    blf.add_many(_h160s(keys))
    path = str(tmp_path / "t.blf")
    blf.save(path)
    filt = filters.load_filter(path)
    assert filt.mode == "bloom"
    found = _engine(filt).run_keys(keys + [333])
    assert sorted(f.priv for f in found) == sorted(keys)


def test_cli_mul_on_cpu_finds_the_vector_head(monkeypatch, capsys):
    with open(BW_PRIV) as f:
        lines = f.read().splitlines()[:64]
    with open(BW_HASH) as f:
        targets = set(f.read().split())
    want = set()
    # the port's host oracle, not the device path: its source is pinned
    # byte for byte to the JAX package's (test_torch_package), and the 64
    # hits are checked against data/btc-bw-hash
    for ln in lines:
        for label, is33 in (("addr33", True), ("addr65", False)):
            if derive_h160(int(ln, 16), is33) in targets:
                want.add((label, int(ln, 16)))
    assert len(want) == 64
    monkeypatch.setattr(mul, "W", W)          # w=14 is too slow to build here
    monkeypatch.setenv("ECLOOP_MUL_BATCH", "64")
    run = cli.run_mul(cli.Args(["ecloop", "mul", "-f", BW_HASH, "-a", "cu",
                                "-device", "cpu"]), lines)
    assert {(f.label, f.priv) for f in run.found} == want
    assert run.k_checked == 64 and run.device.type == "cpu"
    out = capsys.readouterr()
    assert sum(ln.startswith("addr") for ln in out.out.splitlines()) == 64
    assert out.err.rstrip().endswith("64 / 64")


# K8's lengths at the SHA-256 block edges: one block holds up to 55 bytes
EDGE_LENGTHS = (1, 55, 56, 63, 64, 119, 120, 1000)
# multi-byte UTF-8, some of it across the 55/56-byte edge
UTF8 = ["passwört", "日本語のパスワード", "\U0001F511" * 14, "é" * 28,
        "a" * 54 + "é", "ß"]


def _edge_lines(seed=11):
    rng = np.random.default_rng(seed)
    return ["".join(map(chr, rng.integers(33, 127, size=n)))
            for n in EDGE_LENGTHS]


def _raw_keys(lines):
    """The JAX package's -raw keys, reduced mod n."""
    return [k % golden.N for k in jmul.parse_keys(lines, True)]


def _jax_digits(keys, lanes):
    """The JAX package's (d, lanes) digits of keys, zeros past them."""
    want = np.zeros((mul.n_windows(W), lanes), dtype=np.int32)
    if keys:
        want[:, :len(keys)] = jmul.window_digits(keys, W).T
    return want


LINE_CASES = {"edge_lengths": (_edge_lines(), 0), "utf8": (UTF8, 0),
              "newline_inside": (["ab", "c\nd", "e\n\nf", "g"], 1)}


@pytest.mark.parametrize("case", sorted(LINE_CASES))
def test_k8_lines_cpu_form_matches_jax(case):
    """pack_lines' slices are the lines' own UTF-8 bytes (line by line
    where a line holds "\n"), and K8's plain form writes the JAX
    package's digits of their SHA-256 keys, zeros over stale lanes."""
    lines, fallback = LINE_CASES[case]
    trace.reset()
    job = mul.pack_lines(lines)
    assert trace.snapshot()["counts"].get("mul.pack_fallback", 0) == fallback
    assert len(job) == len(lines)
    assert [job.buf[job.offs[e]:job.offs[e + 1] - 1].tobytes()
            for e in range(len(job))] == [ln.encode() for ln in lines]
    keys = _raw_keys(lines)
    assert [job.key(e) for e in range(len(job))] == keys
    assert job.sha_blocks() == sum((len(ln.encode()) + 9 + 63) // 64
                                   for ln in lines)
    dig = torch.full((mul.n_windows(W), BATCH), 7, dtype=torch.int32)
    out = kernels.mul_keys_lines(torch.from_numpy(job.buf.copy()),
                                 torch.from_numpy(job.offs), dig, W)
    assert out is dig
    np.testing.assert_array_equal(dig.numpy(), _jax_digits(keys, BATCH))


@pytest.mark.parametrize("keys", [[0, 1, golden.N - 1, golden.N, golden.N + 1,
                                   (1 << 256) - 1], []])
def test_k8_words_cpu_form_matches_jax(keys):
    """K8's words entry reduces any key below 2^256 mod n (n itself to
    0) and cuts the JAX package's digits; no keys zeroes every lane."""
    words = mul.keys_to_words(keys).view(np.int64) if keys else \
        np.zeros((0, 4), np.int64)
    dig = torch.full((mul.n_windows(W), BATCH), 7, dtype=torch.int32)
    kernels.mul_keys_words(torch.from_numpy(words.copy()), dig, W)
    np.testing.assert_array_equal(
        dig.numpy(), _jax_digits([k % golden.N for k in keys], BATCH))


def test_k8_wrappers_reject_bad_inputs():
    dig = torch.zeros((mul.n_windows(W), BATCH), dtype=torch.int32)
    words = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(ValueError):                     # d of another w
        kernels.mul_keys_words(words, dig, W + 1)
    with pytest.raises(ValueError):                     # more keys than lanes
        kernels.mul_keys_words(torch.zeros((BATCH + 1, 4), dtype=torch.int64),
                               dig, W)
    with pytest.raises(TypeError):
        kernels.mul_keys_words(words.to(torch.int32), dig, W)
    with pytest.raises(TypeError):
        kernels.mul_keys_lines(torch.zeros(4, dtype=torch.int8),
                               torch.tensor([0, 5]), dig, W)
    with pytest.raises(ValueError):
        kernels.mul_keys_lines(torch.zeros(4, dtype=torch.uint8),
                               torch.tensor([0, 5]), dig.to(torch.int64), W)


RAW_CASES = {"one_shard": (1, 0), "two_shards": (2, 0),
             "newline_inside": (1, 1)}
RAW_BATCH = 64           # two shards of 32 lanes


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_mul_raw_engine_matches_jax(case):
    """`-raw` through the engine: a full job then a short one on the same
    engine (its padding lanes zeroed, none of the full job's digits
    left; over two shards the second gets no key), over one or two
    shards: the planted lines' keys found, every line counted, and the
    counters the jobs imply."""
    shards, fallback = RAW_CASES[case]
    b = RAW_BATCH
    lines = _edge_lines() + UTF8 + [f"pool line {i}" for i in range(80)]
    if fallback:
        lines[b + 3] = "two\nlines"                 # in the short job
    keys = _raw_keys(lines)
    planted = [keys[i] for i in (0, 9, 20, b + 3, len(lines) - 1)]
    eng = _engine(filters.filter_from_hashes(_h160s(planted)), raw=True,
                  devices=["cpu"] * shards, batch=b)
    trace.reset()
    found = eng.run_lines(lines[:b] + ["", "  "] + lines[b:])
    assert sorted(f.priv for f in found) == sorted(planted)
    assert all(f.h160 == derive_h160(f.priv, True) for f in found)
    assert eng.k_checked == len(lines) and b < len(lines) <= b + b // 2
    counts = trace.snapshot()["counts"]
    assert counts["mul.jobs"] == 2
    assert counts["mul.keys"] == len(lines)
    assert counts.get("mul.device_keys", 0) == 0          # the CPU form
    assert counts["mul.sha_blocks"] == sum((len(ln.encode()) + 72) // 64
                                           for ln in lines)
    assert counts.get("mul.pack_fallback", 0) == fallback
    assert counts["mul.enqueues"] == 4 * 2 * shards
    dig = torch.cat([s.call.dig for s in eng.shards], dim=1)
    np.testing.assert_array_equal(dig.numpy(), _jax_digits(keys[b:], b))
