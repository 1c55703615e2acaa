"""The frozen accounts equal ecloop_tpu_torch/sol.py's at the commit that
froze them."""

import numpy as np
import pytest

from ecloop_tpu_torch import bloom as port_bloom
from ecloop_tpu_torch import sol
from keybench import accounts
from keybench.harness import _planes

ACC = accounts.frozen()


def test_constants():
    assert ACC["mem_bps"] == sol.MEM_BPS
    assert ACC["int_lane_ops_per_clk"] == sol.INT_LANE_OPS_PER_CLK
    assert ACC["limb_bytes"] == sol.LIMB_BYTES
    assert ACC["probe_exact_ops"] == sol.PROBE_EXACT_OPS
    assert ACC["probe_pow2_ops"] == sol.PROBE_POW2_OPS
    assert ACC["probe_search_ops"] == sol.PROBE_SEARCH_OPS
    assert ACC["pack_ops"] == sol.PACK_OPS
    for form, is33 in (("addr33", True), ("addr65", False)):
        assert ACC["hash_ops_per_key"][form] == \
            sol.hash_ops_per_key(sol.hash_counts(is33))


@pytest.mark.parametrize("endo", [False, True])
def test_step_accounts(endo):
    got = accounts.chord_inv(ACC, 32, 4096, endo)
    want = sol.chord_account(32, 4096, endo, endo)
    assert got["chord_dx"] == want["chord_dx"]
    assert got["chord_points"] == want["chord_points"]
    assert got["inv_batch"] == sol.inv_account(32 * 2048 + 32)


@pytest.mark.parametrize("endo,forms,mode", [
    (False, ["addr33"], "compare"), (True, ["addr33", "addr65"], "exact"),
    (False, ["addr33", "addr65"], "pow2")])
def test_hash_probe_account(endo, forms, mode):
    planes = _planes(endo, forms)
    kw = dict(reads=123456, n_first=288, bits_words=1 << 26)
    assert accounts.hash_probe(ACC, 131072, planes, mode, **kw) == \
        sol.hash_probe_account(131072, planes, mode, **kw)


@pytest.mark.parametrize("fill", [0.05, 0.371, 0.5, 0.9])
def test_device_probes_is_the_adaptive_count(fill):
    bits = (np.random.default_rng(1).random(1 << 16) < fill)
    words = np.packbits(bits, bitorder="little").view(np.uint64)
    real = np.unpackbits(words.view(np.uint8)).mean()
    assert accounts.device_probes(real) == port_bloom.adaptive_probe_count(words)


def test_probe_reads_per_key_counts_reads_up_to_the_first_clear_bit():
    # sol.probe_reads: each key reads its probes in order up to its first
    # clear bit; over uniform hashes that is sum(fill^p, p < probes)
    assert accounts.probe_reads_per_key(0.5, 3) == pytest.approx(1.75)
    assert accounts.probe_reads_per_key(1.0, 14) == 14
