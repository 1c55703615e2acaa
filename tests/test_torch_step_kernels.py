"""The plain forms of K4 (the `add` step's chords, csrc/add_chords.cu) and
K5 (the prefilter probe with its mask packing, csrc/probe_pack.cu)
against the JAX package and the golden model, bit for bit, and their
wrappers' checks.  On the CPU the wrappers run these plain forms;
`tests/test_torch_kernels_cuda.py` holds the kernels to them on the card.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecloop_tpu import bloom as jbloom
from ecloop_tpu import filters as jfilters
from ecloop_tpu.search import add as jadd
from ecloop_tpu_torch import bloom, ecc, fel, filters, golden, kernels
from ecloop_tpu_torch.search import add
from ecloop_tpu_torch.search.common import SearchConfig

CSRC = os.path.join(os.path.dirname(__file__), "..", "ecloop_tpu_torch",
                    "csrc")
P = golden.P
M, K = 4, 64                     # centers x keys per center
BASE = 0x1234567


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step_inputs(base=BASE):
    """The step's (16, M) centers, (16, K/2) table and (16,) advance
    point for keys base, base + 1, ... (stride 1)."""
    cfg = SearchConfig(range_s=base, range_e=base + 4 * M * K, centers=M,
                       group_k=K)
    cx, cy = add.center_points(cfg, base)
    table = add._cached_table(cfg.stride, K, cfg.keys_per_step)
    return [fel.from_last(a, "cpu") for a in (cx, cy, *table)]


def _ints(t):
    return fel.tensor_to_ints(t)


def test_chord_dx_plain_is_the_chords_denominators():
    cx, _, tx, _, dpx, _ = _step_inputs()
    got = _ints(ecc.chord_dx_plain(cx, tx, dpx))
    cxs, txs, d = _ints(cx), _ints(tx), _ints(dpx[:, None])[0]
    want = [(t - c) % P for c in cxs for t in txs] + [(d - c) % P for c in cxs]
    assert got == want


@pytest.mark.parametrize("need_beta,need_neg", [(False, False), (True, True)])
def test_chord_points_plain_are_the_steps_keys(need_beta, need_neg):
    """Key m*K + i of the flat layout is (BASE + m*K + i)*G, the advanced
    center m is C[m] + M*K*G, and the endo rows are golden.endo_points's
    coordinates."""
    cx, cy, tx, ty, dpx, dpy = _step_inputs()
    inv = fel.inv_mod_batch(ecc.chord_dx_plain(cx, tx, dpx))
    xs, ys, ncx, ncy = ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv,
                                              need_beta, need_neg)
    assert len(xs) == 1 + 2 * need_beta and len(ys) == 1 + need_neg
    assert all(t.shape == (16, M * K) for t in xs + ys)
    pts = [golden.point_mul(BASE + j) for j in range(M * K)]
    assert list(zip(_ints(xs[0]), _ints(ys[0]))) == pts
    if need_beta:
        endo = [golden.endo_points(p) for p in pts]
        assert _ints(xs[1]) == [e[2][0] for e in endo]
        assert _ints(xs[2]) == [e[4][0] for e in endo]
    if need_neg:
        assert _ints(ys[1]) == [(-p[1]) % P for p in pts]
    assert list(zip(_ints(ncx), _ints(ncy))) == [
        golden.point_mul(BASE + m * K + K // 2 + M * K) for m in range(M)]


def _chord_int(px, py, qx, qy, inv):
    lam = (qy - py) * inv % P
    rx = (lam * lam - px - qx) % P
    return rx, (lam * (px - rx) - py) % P


def test_chord_points_plain_on_inputs_that_mean_nothing():
    """A center stored as (0, 0) (a center at infinity) and zero
    inverses: the plain form computes its formulas on them all the same
    (K4 must give the same limbs)."""
    rng = np.random.default_rng(3)
    cx, cy, tx, ty, dpx, dpy = _step_inputs()
    cx[:, 1], cy[:, 1] = 0, 0
    inv = torch.from_numpy(fel.random_limbs(rng, M * K // 2 + M))
    inv[:, [0, 5, M * K // 2 + 1]] = 0
    xs, ys, ncx, ncy = ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv,
                                              True, True)
    c = list(zip(_ints(cx), _ints(cy)))
    t = list(zip(_ints(tx), _ints(ty)))
    d = (_ints(dpx[:, None])[0], _ints(dpy[:, None])[0])
    iv = _ints(inv)
    h, x, y, bx, ny = K // 2, _ints(xs[0]), _ints(ys[0]), _ints(xs[1]), _ints(ys[1])
    for m in (0, 1):
        for j in (0, 4, h - 1):
            i = iv[m * h + j]
            minus = _chord_int(*c[m], t[j][0], (-t[j][1]) % P, i)
            assert (x[m * K + h - 1 - j], y[m * K + h - 1 - j]) == minus
            if j < h - 1:
                plus = _chord_int(*c[m], *t[j], i)
                assert (x[m * K + h + 1 + j], y[m * K + h + 1 + j]) == plus
        assert (x[m * K + h], y[m * K + h]) == c[m]
        assert (_ints(ncx)[m], _ints(ncy)[m]) == _chord_int(
            *c[m], *d, iv[M * h + m])
    assert bx == [v * golden.BETA1 % P for v in x]
    assert ny == [(-v) % P for v in y]


def test_kernel_beta_constants_are_golden():
    with open(os.path.join(CSRC, "add_chords.cu")) as f:
        src = f.read()
    table = src[src.index("BETA[2][8]"):src.index("};", src.index("BETA[2][8]"))]
    words = [int(w, 16) for w in re.findall(r"0x([0-9A-F]{8})u", table)]
    assert len(words) == 16
    for b, ws in zip((golden.BETA1, golden.BETA2), (words[:8], words[8:])):
        assert sum(w << (32 * i) for i, w in enumerate(ws)) == b


# --- K5's plain form against the JAX probe and _pack_mask ------------------------

def _hashes(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 5), dtype=np.uint64).astype(
        np.uint32)


def _probe_inputs(targets, n=8192, seed=4):
    """Hash words with every target and a near miss of each (the same
    first word) among random ones."""
    hs = _hashes(n, seed)
    t = targets[:n // 2]
    hs[:len(t)] = t
    near = t.copy()
    near[:, 4] ^= 1
    hs[len(t):2 * len(t)] = near
    return hs


def _compare_filters(n):
    targets = _hashes(n, 10 + n)
    ours, theirs = filters.filter_from_hashes(targets), \
        jfilters.filter_from_hashes(targets)
    assert ours.use_cmp() and theirs._use_cmp()
    return ours, theirs, _probe_inputs(ours.targets)


def _pow2_filters(log2, dense):
    targets = _hashes(160, 11)
    bits, _ = bloom.build_pow2(targets, log2)
    if dense:
        bits = np.random.default_rng(12).integers(
            0, 1 << 32, size=bits.size, dtype=np.uint64).astype(np.uint32)
    ours = filters.Filter(mode="list", targets=filters._sorted_unique(targets),
                          blf=None, device_bits=bits, pow2_log2=log2)
    theirs = jfilters.Filter(mode="list", targets=ours.targets, blf=None,
                             device_bits=bits, pow2_log2=log2)
    return ours, theirs, _probe_inputs(ours.targets)


def _bloom_filters(probes):
    """A 64,000-bit filter (not a power of two) three quarters full, so
    that keys pass every count of probes, with the targets added."""
    rng = np.random.default_rng(13)
    size = 1000
    bits = (rng.integers(0, 1 << 63, size=size, dtype=np.uint64)
            | rng.integers(0, 1 << 63, size=size, dtype=np.uint64))
    targets = _hashes(100, 14)
    blf = bloom.BloomFilter(size, bits.copy())
    blf.add_many(targets)
    jblf = jbloom.BloomFilter(size, blf.bits.copy())
    ours = filters.Filter(mode="bloom", targets=None, blf=blf,
                          device_bits=blf.as_u32(), pow2_log2=None,
                          blf_probes=probes)
    theirs = jfilters.Filter(mode="bloom", targets=None, blf=jblf,
                             device_bits=jblf.as_u32(), pow2_log2=None,
                             blf_probes=probes)
    return ours, theirs, _probe_inputs(targets)


@pytest.mark.parametrize("mode,arg", [
    ("compare", 0), ("compare", 1), ("compare", 160), ("compare", 2048),
    ("pow2", 16), ("pow2", 24),
    ("bloom", 1), ("bloom", 3), ("bloom", 20)])
def test_probe_pack_plain_against_jax(mode, arg, monkeypatch):
    """Compare lists of 0-2,048 first words, pow2 at log2_bits 16 (dense
    random bits) and 24 (built from the targets), bloom at 1, 3 and 20
    probes; log2_bits above 32 needs a 1 GiB bit array and is held on
    the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).  A list
    of 160 targets is compared unless ECLOOP_CMP_MAX is below it, in
    both packages, so the pow2 cases set it to 0."""
    if mode == "compare":
        ours, theirs, hs = _compare_filters(arg)
    elif mode == "pow2":
        monkeypatch.setenv("ECLOOP_CMP_MAX", "0")
        ours, theirs, hs = _pow2_filters(arg, dense=arg == 16)
        assert ours.first_words("cpu") is None and not theirs._use_cmp()
    else:
        ours, theirs, hs = _bloom_filters(arg)
    h = torch.from_numpy(hs.T.astype(np.int64))
    bits = bloom.bits_tensor(ours.device_bits, "cpu")
    got = filters.probe_pack_plain(ours, h, bits, ours.first_words("cpu"))
    want = np.asarray(jadd._pack_mask(theirs.device_probe(jnp.asarray(hs))))
    assert got.dtype == torch.int64 and got.shape == (len(hs) // 32,)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    hits = int(np.unpackbits(want.astype("<u4").view(np.uint8)).sum())
    if (mode, arg) != ("compare", 0):
        assert 0 < hits < len(hs)            # both outcomes occur
    else:
        assert hits == 0
    # the wrapper on a CPU tensor is the plain form
    assert torch.equal(kernels.probe_pack(ours, h, bits,
                                          ours.first_words("cpu")), got)


# --- the wrappers' checks ---------------------------------------------------------

def test_wrappers_run_the_plain_forms_on_the_cpu_and_count_nothing():
    cx, cy, tx, ty, dpx, dpy = _step_inputs()
    kernels.reset_launches()
    dx = kernels.chord_dx(cx, tx, dpx)
    assert torch.equal(dx, ecc.chord_dx_plain(cx, tx, dpx))
    inv = kernels.inv_mod_batch(dx)
    got = kernels.chord_points(cx, cy, tx, ty, dpx, dpy, inv, True, False)
    want = ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv, True, False)
    for a, b in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["add_chords"] == kernels.LAUNCHES["probe_pack"] == 0


def test_chord_wrappers_reject_bad_inputs():
    cx, cy, tx, ty, dpx, dpy = _step_inputs()
    inv = kernels.inv_mod_batch(kernels.chord_dx(cx, tx, dpx))
    with pytest.raises(ValueError):
        kernels.chord_dx(cx[:, :, None], tx, dpx)            # 3-D centers
    with pytest.raises(ValueError):
        kernels.chord_dx(cx, tx, dpx[:, None])               # 2-D advance point
    with pytest.raises(TypeError):
        kernels.chord_dx(cx.to(torch.int32), tx, dpx)
    with pytest.raises(ValueError):
        kernels.chord_points(cx, cy[:, :2], tx, ty, dpx, dpy, inv, False, False)
    with pytest.raises(ValueError):
        kernels.chord_points(cx, cy, tx, ty[:, :4], dpx, dpy, inv, False, False)
    with pytest.raises(ValueError):
        kernels.chord_points(cx, cy, tx, ty, dpx, dpy, inv[:, 1:], False, False)
    with pytest.raises(ValueError):
        kernels.chord_points(cx, cy, tx, ty, dpx, dpy, inv[:8], False, False)


def test_probe_wrapper_rejects_bad_inputs():
    filt = filters.filter_from_hashes(_hashes(10, 15))
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    fw = filt.first_words("cpu")
    h = torch.from_numpy(_hashes(64, 16).T.astype(np.int64)).contiguous()
    with pytest.raises(ValueError, match="multiple of 32"):
        kernels.probe_pack(filt, h[:, :48], bits, fw)
    with pytest.raises(ValueError):
        kernels.probe_pack(filt, h[:4], bits, fw)
    with pytest.raises(TypeError):
        kernels.probe_pack(filt, h.to(torch.int32), bits, fw)
    with pytest.raises(TypeError):
        kernels.probe_pack(filt, h, bits.to(torch.int64), fw)
    with pytest.raises(TypeError):
        kernels.probe_pack(filt, h, bits, fw.to(torch.int32))
    assert kernels.probe_pack(filt, h, bits, fw).shape == (2,)
