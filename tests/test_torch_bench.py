"""`bench`, `bench-gtable` and `mult-verify` of the port on the CPU
(`-device cpu`), and its speed-of-light account (`ecloop_tpu_torch.sol`)
against the JAX package's where a term is the same.  Budgets are tiny
(row filters, a w=4 sweep, 64 scalars at w=8)."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from ecloop_tpu import sol as jsol
from ecloop_tpu.search.common import SearchConfig as JaxConfig
from ecloop_tpu_torch import benchlib, cli, fel, sol
from ecloop_tpu_torch.search import mul
from ecloop_tpu_torch.search.common import SearchConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
# a fixed leaf dict (ops per element) for the budget functions of both
LEAF = {"mul_mod": 100.0, "sqr_mod": 90.0, "add_mod": 10.0, "sub_mod": 12.0,
        "chord_add": 400.0, "addr33": 1500.0, "addr65": 2500.0,
        "probe_pow2": 20.0, "probe_cmp": 160.0, "bloom_probe": 1000.0,
        "bloom_probe_k3": 200.0, "proj_add_affine": 900.0,
        "proj_add_affine_complete": 1700.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def peaks(monkeypatch):
    """Both packages' peak overrides at the same (made-up) rates."""
    for k, v in (("ECLOOP_INT_PEAK", "2e13"), ("ECLOOP_VPU_PEAK", "2e13"),
                 ("ECLOOP_HBM_PEAK", "3e12")):
        monkeypatch.setenv(k, v)
    return 2e13, 3e12


def test_bench_cli_runs_filtered_rows(monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_BENCH_B", "1024")
    monkeypatch.setenv("ECLOOP_BENCH_R", "2")
    monkeypatch.setenv("ECLOOP_BENCH_ONLY", "fe_mul,bloom")
    monkeypatch.setenv("ECLOOP_BENCH_SOL", "0")
    assert cli.main(["ecloop", "bench", "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = [ln.split(":")[0].strip() for ln in out.splitlines()
            if "M it/s" in ln]
    assert rows == ["fe_mul (rows)", "bloom probe_pow2 (2 probes, rows)"]
    assert "addr33" not in out and "speed-of-light" not in out
    assert "B=1024 R=2" in out


def _jax_row_names() -> list[str]:
    """The first argument of every bench(...) call in the JAX package's
    run_bench, in order: f-strings with {} for their fields, and the
    `gname` template."""
    tree = ast.parse((ROOT / "ecloop_tpu" / "benchlib.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_bench")
    names = {}
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.BinOp)
                and isinstance(node.value.left, ast.Constant)):
            names[node.targets[0].id] = node.value.left.value
    out = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "bench"):
            a = node.args[0]
            if isinstance(a, ast.Constant):
                out.append((node.lineno, a.value))
            elif isinstance(a, ast.JoinedStr):
                out.append((node.lineno, "".join(
                    v.value if isinstance(v, ast.Constant) else "{}"
                    for v in a.values)))
            else:
                out.append((node.lineno, names[a.id]))
    return [name for _, name in sorted(out)]


def test_row_names_and_order_are_the_jax_benchs():
    jax_names = _jax_row_names()
    assert len(jax_names) == len(benchlib.ROW_NAMES) == 14
    for i, (j, p) in enumerate(zip(jax_names, benchlib.ROW_NAMES)):
        if j.startswith("fe_grpinv"):              # the TPU's lanes=...
            assert j == "fe_grpinv (batched, lanes={})" and i == 3
            assert p.format(sol.K2_BLOCK) == "fe_grpinv (batched, K2 blocks of 128)"
        else:
            assert p == j


def test_bench_gtable_cli_sweep(monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_GTABLE_WS", "4")
    monkeypatch.setenv("ECLOOP_BENCH_B", "64")
    assert cli.main(["ecloop", "bench-gtable", "-device", "cpu"]) == 0
    out = capsys.readouterr().out
    header, row = out.splitlines()[:2]
    assert [c.strip() for c in header.split("|")] == [
        "W", "G_SIZE", "MEM", "BUILD_T", "MUL_RATE", "CEILING", "BOUND", "PEAK"]
    cols = [c.strip() for c in row.split("|")]
    assert cols[0] == "4" and cols[1].replace(",", "") == "960"  # 64 x 15
    assert cols[2] == f"{960 * 256 / 2**20:.1f}MB"     # 16+16 int64 limbs
    assert not mul.build_gtable.cache_info().currsize


def test_window_index_is_the_steps_layout():
    """The bench's and mult-verify's digits are (d, B) and contiguous, as
    the `mul` step's are: K3 takes only a contiguous skip row."""
    keys = benchlib.verify_keys(5)
    idx, skip = benchlib._window_index(keys, 8, "cpu")
    assert idx.shape == skip.shape == (32, 5)
    assert skip.is_contiguous() and all(r.is_contiguous() for r in skip)
    dig = torch.from_numpy(mul.window_digits(keys, 8).T.astype("int64"))
    assert torch.equal(idx, (dig + mul.window_offsets(8, "cpu")).clamp(min=0))
    assert torch.equal(skip, dig == 0)


def test_mult_verify_cli(monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_VERIFY_N", "64")
    monkeypatch.setenv("ECLOOP_VERIFY_W", "8")
    assert cli.main(["ecloop", "mult-verify", "-device", "cpu"]) == 0
    assert "OK: all multiplications verified" in capsys.readouterr().out


def test_mult_verify_catches_mismatch(monkeypatch, capsys):
    """Flip a bit of every window-0 entry's x: every key with a nonzero
    low byte gathers a wrong point, and mult-verify exits 1."""
    monkeypatch.setenv("ECLOOP_VERIFY_N", "64")
    monkeypatch.setenv("ECLOOP_VERIFY_W", "8")
    bad = mul.build_gtable(8, "cpu").clone()
    bad[0, :255] ^= 1
    assert benchlib.mult_verify("cpu", table=bad) == 1
    assert "FAILED" in capsys.readouterr().out


def test_bound_is_the_larger_time():
    assert sol.bound(3.35e9, 1e9, 1e13) == pytest.approx((1.0, "bytes"))
    assert sol.bound(1e6, 2e13, 1e13) == pytest.approx((2000.0, "operations"))
    assert sol.bound(3e9, 0, 1e13, mem_bps=3e12)[0] == pytest.approx(1.0)


def test_peaks_override_and_no_device(monkeypatch, peaks):
    assert sol.peaks() == peaks
    monkeypatch.delenv("ECLOOP_HBM_PEAK")
    assert sol.peaks() == (peaks[0], sol.MEM_BPS)
    if not torch.cuda.is_available():
        monkeypatch.delenv("ECLOOP_INT_PEAK")
        with pytest.raises(RuntimeError):
            sol.peaks()


def test_leaf_budgets_and_accounts_are_pinned():
    leaf = sol.leaf_budgets()
    assert (leaf["mul_mod"], leaf["sqr_mod"], leaf["add_mod"],
            leaf["sub_mod"]) == (74, 74, 16, 16)
    assert leaf["chord_add"] == 3 * 74 + 5 * 16       # 2 mul, 1 sqr, 5 sub
    assert (leaf["addr33"], leaf["addr65"]) == (1474, 2449)
    assert leaf["proj_add_affine"] == 12 * 74 + 18
    assert leaf["probe_pow2"] == 23 and leaf["probe_cmp"] == 160
    assert sol.inv_account(1000) == (1000 * 256, (3000 + 270) * 74)
    assert sol.mixed_add_account(10, 7) == (10 * 1025, 7 * 906)
    # the scan: per lane and window a 256-byte point, an 8-byte index and
    # a skip byte; per lane the accumulator in and out once
    assert sol.scan_account(10, 19, 150) == (10 * (19 * 265 + 768), 150 * 906)
    assert sol.hash_account(4, True, {"alu": 10, "either": 30}) == (
        4 * 22 * 8, 4 * 20)
    a = fel.ints_to_tensor([3, 5], "cpu")
    assert sol.ops_per_element(lambda x: fel.inv_mod(x), a, elems=2) == 270 * 74
    assert sol.ops_per_element(lambda x: fel.inv_mod_batch(x), a,
                               elems=2) == (6 + 270) * 74 / 2


def test_chord_and_probe_accounts_by_hand():
    """K4 and K5 at one width against counts made by hand: 4 centers x
    64 keys (32 pairs each, 132 inverses), 128 bytes per element."""
    acc = sol.chord_account(4, 64, need_beta=True, need_neg=True)
    # chord_dx: cx (4), tx (32), D.x (1) in, 132 differences out; a sub each
    assert acc["chord_dx"] == ((4 + 32 + 1 + 132) * 128, 132 * 16)
    # chord_points: both coordinates of those and the 132 inverses in;
    # x, y, beta x, beta^2 x, -y of 256 keys and 2 x 4 centers out.  Per
    # chord 2 mul + 1 sqr + 5 sub = 302: 2 x 128 pairs and 4 advances;
    # -T.y once per table entry (32), 2 mul and 1 neg per key
    assert acc["chord_points"] == (
        (2 * 37 + 132 + 5 * 256 + 8) * 128,
        32 * 16 + (256 + 4) * 302 + 256 * (2 * 74 + 16))
    plain = sol.chord_account(4, 64, need_beta=False, need_neg=False)
    assert plain["chord_points"] == ((2 * 37 + 132 + 2 * 256 + 8) * 128,
                                     32 * 16 + 260 * 302)
    # K5: the search of 160 first words has 8 levels of 3 ops, then a
    # compare and a vote per key; 8 bytes of hash per key, the list once
    # and a word per 32 keys
    assert sol.probe_pack_account(4096, "compare", n_first=160) == (
        4096 * 8 + 160 * 8 + 128 * 8, 4096 * (8 * 3 + 1 + 1))
    assert sol.probe_pack_account(4096, "compare", n_first=0) == (
        4096 * 8 + 128 * 8, 4096)
    # exact: 40 bytes of hash per key, 4 per bit word read (at most the
    # filter once), 29 ops per probe read: the pow2 probe's 11, the high
    # index word's 2 and the multiply-high remainder's 16
    assert sol.PROBE_EXACT_OPS == 29
    assert sol.probe_pack_account(4096, "exact", reads=5000,
                                  bits_words=1000) == (
        4096 * 40 + 4 * 1000 + 128 * 8, 5000 * 29 + 4096)
    assert sol.probe_pack_account(64, "pow2", reads=100,
                                  bits_words=1 << 20) == (
        64 * 40 + 400 + 16, 100 * 11 + 64)


def test_hash_probe_account_by_hand():
    """K1 with K5 as its epilogue over 64 keys per plane: K1's limb reads
    (each row the planes name once; a y row that only addr33 planes read
    costs its parity limb), the probe's reads and the mask words, no hash
    rows; K1's operations per key and plane and the probe's."""
    counts = {True: {"alu": 100, "either": 60}, False: {"alu": 200,
                                                       "either": 500}}
    # one addr33 plane, compare at 160 first words: x (16 limbs) and y's
    # parity (1) per key, the list once, 2 mask words; K1's 100 ALU ops
    # (more than (100 + 60) / 2) and the search's 8 levels, compare, vote
    assert sol.hash_probe_account(64, [(0, 0, True)], "compare", n_first=160,
                                  counts=counts) == (
        64 * 17 * 8 + 160 * 8 + 2 * 8, 64 * 100 + 64 * (8 * 3 + 1 + 1))
    # -endo -a cu (12 planes over 3 x and 2 y rows), exact: 3 x rows and 2
    # full y rows, 4 bytes per bit word read up to the filter's 300 words,
    # 24 mask words; addr65's ops are (200 + 500) / 2 = 350 per key
    planes = [(x, y, f) for x in range(3) for y in range(2)
              for f in (True, False)]
    assert sol.hash_probe_account(64, planes, "exact", reads=1000,
                                  bits_words=300, counts=counts) == (
        64 * (3 * 16 + 2 * 16) * 8 + 4 * 300 + 12 * 2 * 8,
        64 * 6 * (100 + 350) + 1000 * 29 + 12 * 64)
    # -endo addr33: y and -y read for their parity only; pow2
    endo33 = [(x, y, True) for x in range(3) for y in range(2)]
    assert sol.hash_probe_account(64, endo33, "pow2", reads=100,
                                  bits_words=1 << 20, counts=counts) == (
        64 * (3 * 16 + 2) * 8 + 400 + 6 * 2 * 8,
        64 * 6 * 100 + 100 * 11 + 6 * 64)
    # against K1 and K5 apart: the same operations, without the hash rows
    # that K1 wrote and K5 read back
    k1 = sol.hash_account(64, True, counts[True])
    k5 = sol.probe_pack_account(64, "compare", n_first=160)
    fused = sol.hash_probe_account(64, [(0, 0, True)], "compare",
                                   n_first=160, counts=counts)
    assert fused[1] == k1[1] + k5[1]
    assert fused[0] == k1[0] + k5[0] - 64 * 5 * 8 - 64 * 8


def test_probe_reads_stop_at_the_first_clear_bit():
    from ecloop_tpu_torch import bloom, filters

    h = torch.randint(0, 1 << 32, (5, 64), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(1))
    ones = torch.full((1 << 11,), -1, dtype=torch.int32)
    pow2 = filters.Filter(mode="list", targets=np.zeros((1, 5), np.uint32),
                          blf=None, device_bits=None, pow2_log2=16)
    assert sol.probe_reads(pow2, h, ones, torch.zeros(1, dtype=torch.int64)) == 0
    assert sol.probe_reads(pow2, h, ones) == 2 * 64
    assert sol.probe_reads(pow2, h, torch.zeros_like(ones)) == 64
    blf = filters.Filter(mode="bloom", targets=None,
                         blf=bloom.BloomFilter(1 << 10), device_bits=None,
                         pow2_log2=None, blf_probes=3)
    assert sol.probe_reads(blf, h, ones) == 3 * 64
    half = ones.clone()
    half[::2] = 0                        # every other bit word clear
    want = 64 + sum(int(bloom.probe_exact(h, half, 1 << 16, p).sum())
                    for p in (1, 2))
    assert sol.probe_reads(blf, h, half) == want


@pytest.mark.parametrize("endo,addr65", [(False, False), (True, False),
                                         (True, True)])
def test_step_budget_against_jax(endo, addr65):
    cfg = SearchConfig(endo=endo, addr65=addr65)
    got = sol.step_budget(cfg, LEAF)
    want = jsol.step_budget(JaxConfig(endo=endo, addr65=addr65), LEAF)
    for term in ("dx sub", "chord add", "endo synth"):
        assert got["per_key"][term] == pytest.approx(want["per_key"][term])
    if not addr65:              # JAX prices every variant as addr33
        assert got["per_key"]["hash+probe"] == pytest.approx(
            want["per_key"]["hash+probe"])
    inv_elems = cfg.keys_per_step / 2 + cfg.centers
    assert got["per_key"]["batch inverse"] == pytest.approx(
        (3 * 100 + 270 * 100 / 128) * inv_elems / cfg.keys_per_step)
    assert got["checked_mult"] == want["checked_mult"]
    assert got["ops_per_checked_key"] == pytest.approx(
        got["total_ops_per_point"] / got["checked_mult"])


@pytest.mark.parametrize("w", [8, 14, 22])
def test_mul_budget_and_ceiling_against_jax(w, peaks):
    cfg, jcfg = SearchConfig(addr65=True), JaxConfig(addr65=True)
    got = sol.mul_step_budget(cfg, w, LEAF)
    want = jsol.mul_step_budget(jcfg, w, LEAF)
    assert got["windows"] == want["windows"] == 255 // w + 1
    assert got["per_key"]["window adds"] == want["per_key"]["window adds"]
    assert got["gather_bytes_per_key"] == 2 * want["gather_bytes_per_key"]
    d = got["windows"]
    assert got["scan_bytes_per_key"] == d * (256 + 8 + 1) + 2 * 48 * 8
    assert got["scan_bytes_per_key"] == sol.scan_account(1, d, d)[0]
    assert got["per_key"]["batch inverse"] == pytest.approx(
        3 * 100 + 270 * 100 / 128 + 2 * 100)
    assert got["per_key"]["hash+probe"] == 1500 + 2500 + 2 * 20
    c = sol.mul_ceiling(cfg, w, LEAF, scan_only=True)
    j = jsol.mul_ceiling(jcfg, w, LEAF, scan_only=True)
    assert c["ops_bound_keys_per_s"] == pytest.approx(j["vpu_bound_keys_per_s"])
    # the bench's ec_gtable_mul row prices the scan the same way
    assert c["bytes_bound_keys_per_s"] == pytest.approx(
        peaks[1] / got["scan_bytes_per_key"])
    assert c["ceiling_keys_per_s"] == min(c["ops_bound_keys_per_s"],
                                          c["bytes_bound_keys_per_s"])
    assert c["binding"] == ("operations" if c["ops_bound_keys_per_s"]
                            <= c["bytes_bound_keys_per_s"] else "bytes")


def test_report_prints_the_step(peaks):
    text = sol.report(SearchConfig(endo=True))
    assert "20.000 T 32-bit integer ops/s" in text
    for term in ("mul_mod", "addr33", "batch inverse", "hash+probe", "TOTAL",
                 "speed-of-light"):
        assert term in text
