"""The list prefilter of a hash160 list past the compare path
(`bloom.pow2_sizing`, `filters.filter_from_hashes`): every target passes
it, its estimated false-positive rate is at most 1e-9 and random hashes
pass its probes as often as its fill says, a short list keeps the
compare path's arguments, the kernels take the filter's probe count,
the tracer counts the sizing, and a small `rnd -endo -a cu` search over
a list past 2,048 targets finds what the benchmark's plain reference
(`keybench/reference`) and the JAX package find."""

import math
import os

import numpy as np
import pytest
import torch

from ecloop_tpu import filters as jfilters
from ecloop_tpu.search import rnd as jrnd
from ecloop_tpu.search.common import SearchConfig as JSearchConfig
from ecloop_tpu_torch import bloom, filters, kernels, trace
from ecloop_tpu_torch.search import rnd
from ecloop_tpu_torch.search.common import SearchConfig
from keybench.reference import judge, secp

PUZZLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "data", "btc-puzzles-hash")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hashes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, 5), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [2049, 10128, 40000])
def test_every_target_passes_the_sized_prefilter(n):
    filt = filters.filter_from_hashes(_hashes(n, n))
    assert not filt.use_cmp()
    assert (filt.pow2_log2, filt.pow2_probes) == bloom.pow2_sizing(n)
    assert filt.device_bits.size == 1 << (filt.pow2_log2 - 5)
    h = torch.from_numpy(filt.targets.T.astype(np.int64))
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    assert bool(filt.device_probe(h, bits).all())


@pytest.mark.parametrize("n", [1, 10, 160, 2048, 2049, 10128, 10 ** 5,
                               10 ** 6, 5 * 10 ** 7])
def test_the_rules_estimate_is_at_most_1e9(n):
    log2_bits, probes = bloom.pow2_sizing(n)
    assert 16 <= log2_bits <= 37 and 1 <= probes <= 20
    assert (1 << log2_bits) >= min(128 * n, 1 << 37)
    assert bloom.pow2_fp(n, log2_bits, probes) <= bloom.POW2_FP
    # the fewest probes that reach it
    assert probes == 1 or bloom.pow2_fp(n, log2_bits, probes - 1) > 1e-9


def test_the_rule_for_the_rich_list():
    """10,000 targets and the traffic's 128 planted keys: 2^21 bits (256
    KB, resident in the card's L2) and 6 probes, ~5.4e-10."""
    assert bloom.pow2_sizing(10128) == (21, 6)
    assert bloom.pow2_fp(10128, 21, 6) == pytest.approx(5.43e-10, rel=1e-2)


def test_random_hashes_pass_as_the_fill_says():
    """2^20 seeded random hashes against the rich list's prefilter.  Each
    probe alone passes a share within five standard deviations of the
    fill.  The rate of passing all six is measured as the product of
    the shares of probes 1-4 and of probes 0 and 5 together: the probes
    read disjoint bits of the hash but for 0 and 5 (the shifts 24 and 28
    of one u64), so the product counts their correlation, and it
    resolves a rate near 1e-9 that 2^20 trials of all six at once could
    not (~0.001 expected passes).  It lies below 1e-9 by more than five
    times its sampling error."""
    n, q = 10128, 1 << 20
    filt = filters.filter_from_hashes(_hashes(n, 3))
    fill = float(np.unpackbits(filt.device_bits.view(np.uint8)).mean())
    assert fill == pytest.approx(1 - math.exp(-6 * n / (1 << 21)), rel=0.02)
    h = torch.from_numpy(_hashes(q, 4).T.astype(np.int64))
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    low = (1 << filt.pow2_log2) - 1
    hit = [bloom._bit(bits, (lo & low) >> 5, lo & 31) == 1
           for _, lo in bloom._probe_pairs(h, filt.pow2_probes)]
    for p in hit:
        assert abs(int(p.sum()) - q * fill) <= 5 * math.sqrt(q * fill)
    counts = [int((hit[0] & hit[5]).sum())] + [int(p.sum()) for p in hit[1:5]]
    rate = math.prod(c / q for c in counts)
    err = rate * math.sqrt(sum(1 / c for c in counts))
    assert rate + 5 * err <= bloom.POW2_FP
    assert counts[0] > q * fill ** 2      # 5 follows 0 more often than fill


def test_a_short_list_keeps_the_compare_path():
    """The 160 puzzle hashes: compared on the device with the first
    words as before, and a pow2 prefilter built as the JAX package
    builds it (probed only where ECLOOP_CMP_MAX is lowered)."""
    ours = filters.load_filter(PUZZLES)
    theirs = jfilters.load_filter(PUZZLES)
    assert ours.use_cmp() and ours.count == 160
    assert (ours.pow2_log2, ours.pow2_probes) == (theirs.pow2_log2, 2)
    np.testing.assert_array_equal(ours.device_bits, theirs.device_bits)
    fw = ours.first_words("cpu")
    bits = bloom.bits_tensor(ours.device_bits, "cpu")
    assert torch.equal(fw, torch.from_numpy(
        np.unique(ours.targets[:, 0]).astype(np.int64)))
    assert kernels._probe_args(ours, bits, fw) == (
        0, bits.data_ptr(), 0, 0, 0, 0, fw.data_ptr(), 160)


def test_the_kernels_take_the_filters_probes():
    filt = filters.filter_from_hashes(_hashes(10128, 5))
    assert filt.first_words("cpu") is None
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    assert kernels._probe_args(filt, bits, None) == (
        2, bits.data_ptr(), 0, 0, 6, 21, None, 0)
    filt.pow2_probes = 21
    with pytest.raises(ValueError):
        kernels._probe_args(filt, bits, None)


def test_the_tracer_counts_the_sizing():
    trace.reset()
    trace.enable(True)
    try:
        filters.filter_from_hashes(_hashes(10128, 6))
        filters.filter_from_hashes(_hashes(20, 7))
        snap = trace.snapshot()
    finally:
        trace.enable(False)
        trace.reset()
    assert snap["spans"]["filter.build"]["n"] == 2
    assert {k: v for k, v in snap["counts"].items()
            if k.startswith("filter.")} == {
        "filter.list_targets": 10128 + 20, "filter.list_log2_bits": 21 + 16,
        "filter.list_probes": 6 + 2}


# --- a small rnd -endo -a cu search over a list past the compare path -----------

RS, STRIDE = 0x10000, 16
# one pass: a 2^20-bit window at offset 4 over a 256-key range takes the
# whole range, and ecloop's claim of 256 keys at stride 16 hashes a whole
# group of 2,048, RS + 16 i for i < 2048: one step of 4 x 512 keys
SMALL = dict(range_s=RS, range_e=RS + 256, stride_offs=4, centers=4,
             group_k=512, steps_per_call=1, endo=True, addr33=True,
             addr65=True)
# (priv, label): GLV images of keys in the range at stride 16, each form
PLANTED = [(secp.endo_priv(RS + 7 * STRIDE, 3), "addr33"),
           (secp.endo_priv(RS + 100 * STRIDE, 0), "addr65"),
           (secp.endo_priv(RS + 200 * STRIDE, 4), "addr33"),
           (secp.endo_priv(RS + 255 * STRIDE, 5), "addr65")]
# the JAX package's RndSearch on the same targets and arguments
# (test_jax_finds_the_same, which takes minutes on the CPU, recomputes it)
JAX_FOUND = sorted(PLANTED)
JAX_K_CHECKED = 1536


def _targets():
    rows = [np.frombuffer(secp.pubkey_hash160(k, label == "addr33"),
                          dtype=">u4").astype(np.uint32)
            for k, label in PLANTED]
    return np.concatenate([_hashes(2100, 8), np.stack(rows)])


def test_rnd_endo_cu_finds_what_the_reference_finds():
    filt = filters.filter_from_hashes(_targets())
    assert filt.count == 2104 and not filt.use_cmp()
    assert filt.pow2_probes == bloom.pow2_sizing(2104)[1]
    eng = rnd.RndSearch(SearchConfig(**SMALL), filt, "cpu", seed="list",
                        offs=4, size=20)
    ranges = []
    trace.reset()
    found = eng.run(max_iters=2, on_range=lambda lo, hi: ranges.append(
        (lo, hi)))
    counts = trace.snapshot()["counts"]
    trace.reset()
    assert ranges == [(SMALL["range_s"], SMALL["range_e"])]
    got = sorted((f.priv, f.label) for f in found)
    assert got == JAX_FOUND
    assert eng.engine.k_checked == JAX_K_CHECKED
    # no device false positive: every candidate is a target
    assert counts["add.candidates"] == counts["add.confirmed"] == 4
    sub = judge.Subrange(RS, SMALL["range_e"], STRIDE, 2048, True,
                         eng.engine.k_checked)
    held = judge.Targets(hashes={r.astype(">u4").tobytes()
                                 for r in _targets()})
    planted = [(k, lb, 0, (secp.endo_base(k, e) - RS) // STRIDE)
               for (k, lb), e in zip(PLANTED, (3, 0, 4, 5))]
    verdict = judge.judge_range([(f.label, f.h160, f.priv) for f in found],
                                [sub], planted, held, endo=True)
    assert verdict["correct"], verdict["checks"]
    assert verdict["attempted"] == 8


def test_jax_finds_the_same():
    """The JAX package's RndSearch over the same list (its own pow2
    sizing, 2 probes) finds JAX_FOUND and counts JAX_K_CHECKED; its
    eager -endo step compiles for minutes on the CPU."""
    if os.environ.get("ECLOOP_RUN_SLOW") != "1":
        pytest.skip("the JAX package's eager -endo search takes minutes; "
                    "set ECLOOP_RUN_SLOW=1")
    filt = jfilters.filter_from_hashes(_targets())
    cfg = JSearchConfig(**SMALL)
    eng = jrnd.RndSearch(cfg, filt, seed="list", offs=4, size=20)
    found = eng.run(max_iters=2)
    assert sorted((f.priv, f.label) for f in found) == JAX_FOUND
    assert eng.engine.k_checked == JAX_K_CHECKED
