"""K1 with K5 as its epilogue (`kernels.hash160_probe`,
csrc/hash160_probe.cu) and the exact probe's multiply-high remainder
(csrc/probe.cuh), on the CPU: the reduction's integer steps against
`%`, the fused wrapper's plain form against K1's and K5's plain forms
and the JAX package's probe and packing, its checks, and the searches'
steps calling it.  `tests/test_torch_kernels_cuda.py` holds the kernels
to these plain forms on the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ecloop_tpu import bloom as jbloom
from ecloop_tpu import filters as jfilters
from ecloop_tpu.search import add as jadd
from ecloop_tpu_torch import bloom, fel, filters, hash160, kernels
from ecloop_tpu_torch.search import add, mul
from ecloop_tpu_torch.search.common import SearchConfig

B = 64                               # keys per plane
M64 = (1 << 64) - 1
# the planes of the searches' steps: addr33; -a cu; -endo; -endo -a cu
PLANE_SETS = {
    1: [(0, 0, True)],
    2: [(0, 0, True), (0, 0, False)],
    6: [(*add.EMAP[e], True) for e in range(6)],
    12: [(*add.EMAP[e], f) for e in range(6) for f in (True, False)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the exact probe's remainder ------------------------------------------------

@settings(max_examples=400, deadline=None)
@given(idx=st.integers(0, M64), m=st.integers(1, 1 << 31))
def test_exact_bit_is_the_remainder(idx, m):
    nbits = 64 * m
    assert bloom.exact_bit(idx, nbits, bloom.exact_reciprocal(nbits)) \
        == idx % nbits


@pytest.mark.parametrize("m", [1, 2, 3, 1000, (1 << 25), (1 << 31) - 1,
                               1 << 31, 3 * (1 << 26) + 1])
def test_exact_bit_edges(m):
    """m = 1 and 2^31, idx = 0 and 2^64 - 1, multiples of nbits and their
    neighbours, where q = umulhi(a, r) is one short most often."""
    nbits = 64 * m
    r = bloom.exact_reciprocal(nbits)
    top = M64 - M64 % nbits                   # the largest multiple
    for idx in (0, 1, 63, 64, nbits - 1, nbits, nbits + 1, 7 * nbits,
                top - 1, top, M64 - 1, M64, (M64 >> 6) << 6):
        assert bloom.exact_bit(idx, nbits, r) == idx % nbits, idx


def test_exact_reciprocal_refuses_what_the_kernel_cannot_take():
    assert bloom.exact_reciprocal(64) == M64
    assert bloom.exact_reciprocal(1 << 37) == M64 // (1 << 31)
    for nbits in (0, 32, 65, 96, (1 << 37) + 64):
        with pytest.raises(ValueError):
            bloom.exact_reciprocal(nbits)


# --- the fused wrapper's plain form -------------------------------------------------

def _hashes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n, 5), dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def rows():
    """Three x and two y rows of B keys and every plane's plain K1 rows."""
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(fel.random_limbs(rng, B)) for _ in range(3)]
    ys = [torch.from_numpy(fel.random_limbs(rng, B)) for _ in range(2)]
    return xs, ys, {p: (hash160.addr33_hash_rows if p[2]
                        else hash160.addr65_hash_rows)(xs[p[0]], ys[p[1]])
                    for p in PLANE_SETS[12]}


def _filters(mode, arg, words):
    """Both packages' filter of a case; `words` are (N, 5) u32 hashes of
    the keys, some of which become members or targets."""
    if mode == "compare":
        targets = np.concatenate([_hashes(max(arg - 1, 0), 20 + arg),
                                  words[:min(arg, 1)]])
        ours = filters.filter_from_hashes(targets)
        theirs = jfilters.filter_from_hashes(targets)
        return ours, theirs
    if mode == "pow2":
        targets = np.concatenate([_hashes(40, 21), words[::9]])
        ours = filters.filter_from_hashes(targets)
        theirs = jfilters.filter_from_hashes(targets)
        assert ours.pow2_log2 == theirs.pow2_log2 == 16
        return ours, theirs
    rng = np.random.default_rng(22)
    size = 1000                              # 64,000 bits: not a power of two
    bits = (rng.integers(0, 1 << 63, size=size, dtype=np.uint64)
            | rng.integers(0, 1 << 63, size=size, dtype=np.uint64))
    blf = bloom.BloomFilter(size, bits.copy())
    blf.add_many(words[::5])
    return (filters.Filter(mode="bloom", targets=None, blf=blf,
                           device_bits=blf.as_u32(), pow2_log2=None,
                           blf_probes=arg),
            jfilters.Filter(mode="bloom", targets=None,
                            blf=jbloom.BloomFilter(size, blf.bits.copy()),
                            device_bits=blf.as_u32(), pow2_log2=None,
                            blf_probes=arg))


CASES = [("compare", 0), ("compare", 1), ("compare", 160), ("exact", 1),
         ("exact", 3), ("exact", 20), ("pow2", 16)]


@pytest.fixture(scope="module")
def jax_masks(rows):
    """Per case: both filters and the JAX package's device_probe and
    _pack_mask over every plane's hash words in one call (B is a
    multiple of 32, so plane v's words are the v-th B/32 of them)."""
    _, _, hrows = rows
    planes = PLANE_SETS[12]
    words = np.concatenate([hrows[p].numpy().T.astype(np.uint32)
                            for p in planes])
    out = {}

    def get(mode, arg):
        if (mode, arg) not in out:
            ours, theirs = _filters(mode, arg, words)
            with pytest.MonkeyPatch.context() as mp:
                if mode == "pow2":     # a list this short is compared
                    mp.setenv("ECLOOP_CMP_MAX", "0")
                packed = np.asarray(jadd._pack_mask(theirs.device_probe(
                    jnp.asarray(words)))).astype(np.int64).reshape(
                        len(planes), -1)
            out[mode, arg] = ours, {p: torch.from_numpy(packed[v])
                                    for v, p in enumerate(planes)}
        return out[mode, arg]
    return get


@pytest.mark.parametrize("count", sorted(PLANE_SETS))
@pytest.mark.parametrize("mode,arg", CASES)
def test_fused_plain_form_is_k1_then_k5_and_the_jax_probe(rows, jax_masks,
                                                           mode, arg, count):
    """The wrapper on CPU tensors: per plane K1's plain rows probed and
    packed by K5's plain form, bit-identical to the JAX package's
    device_probe and _pack_mask of the same hash words, in compare (0,
    1 and 160 first words), exact (1, 3 and 20 probes over 64,000 bits)
    and pow2 modes, for 1, 2, 6 and 12 planes."""
    xs, ys, hrows = rows
    filt, want = jax_masks(mode, arg)
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    fw = filt.first_words("cpu") if mode == "compare" else None
    planes = PLANE_SETS[count]
    out = torch.full((count, B // 32), -1, dtype=torch.int64)
    kernels.reset_launches()
    got = kernels.hash160_probe(filt, xs, ys, planes, bits, fw, out)
    assert got is out and kernels.LAUNCHES["hash160_probe"] == 0
    for v, p in enumerate(planes):
        assert torch.equal(out[v], filters.probe_pack_plain(filt, hrows[p],
                                                            bits, fw))
        assert torch.equal(out[v], want[p])
    hits = int(np.unpackbits(out.numpy().astype("<u4").view(np.uint8)).sum())
    assert (hits == 0) == (mode == "compare" and arg == 0)


def test_fused_wrapper_rejects_bad_inputs(rows):
    xs, ys, _ = rows
    filt = filters.filter_from_hashes(_hashes(10, 23))
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    fw = filt.first_words("cpu")
    out = torch.empty((1, B // 32), dtype=torch.int64)
    one = PLANE_SETS[1]
    call = kernels.hash160_probe
    with pytest.raises(ValueError, match="x rows"):
        call(filt, xs + xs[:1], ys, one, bits, fw, out)          # 4 x rows
    with pytest.raises(ValueError, match="x rows"):
        call(filt, xs, ys + ys[:1], one, bits, fw, out)          # 3 y rows
    with pytest.raises(ValueError, match="multiple of 32"):
        call(filt, [x[:, :48] for x in xs], [y[:, :48] for y in ys], one,
             bits, fw, torch.empty((1, 1), dtype=torch.int64))
    with pytest.raises(ValueError):
        call(filt, xs, [ys[0][:, :32], ys[1]], one, bits, fw, out)  # shapes
    with pytest.raises(TypeError):
        call(filt, [xs[0].to(torch.int32)], ys, one, bits, fw, out)
    with pytest.raises(ValueError):
        call(filt, [xs[0][:, :, None]], ys, one, bits, fw, out)   # 3-D rows
    with pytest.raises(ValueError, match="planes"):
        call(filt, xs[:1], ys, [(1, 0, True)], bits, fw, out)     # no x row 1
    with pytest.raises(ValueError, match="planes"):
        call(filt, xs, ys[:1], [(0, 1, True)], bits, fw, out)     # no y row 1
    with pytest.raises(ValueError, match="planes"):
        call(filt, xs, ys, [], bits, fw, torch.empty((0, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="more than 6"):
        call(filt, xs, ys, PLANE_SETS[6] + [(0, 0, True)], bits, fw,
             torch.empty((7, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="out"):
        call(filt, xs, ys, PLANE_SETS[2], bits, fw, out)          # 1 row, 2 planes
    with pytest.raises(ValueError, match="out"):
        call(filt, xs, ys, one, bits, fw, out.to(torch.int32))
    with pytest.raises(TypeError):
        call(filt, xs, ys, one, bits.to(torch.int64), fw, out)
    with pytest.raises(TypeError):
        call(filt, xs, ys, one, bits, fw.to(torch.int32), out)
    assert call(filt, xs, ys, one, bits, fw, out) is out


def test_probe_launch_arguments():
    """What the wrappers hand the kernels (csrc/probe.cuh), built on CPU
    tensors: mode, bits, m, r, nprobes, log2_bits, first words, count."""
    words = torch.zeros(2048, dtype=torch.int32)
    blf = filters.Filter(mode="bloom", targets=None,
                         blf=bloom.BloomFilter(1000), device_bits=None,
                         pow2_log2=None, blf_probes=14)
    args = kernels._probe_args(blf, words, None)
    assert args == (1, words.data_ptr(), 1000, M64 // 1000, 14, 0, None, 0)
    pow2 = filters.Filter(mode="list", targets=None, blf=None,
                          device_bits=None, pow2_log2=16)
    assert kernels._probe_args(pow2, words, None)[0::4] == (2, 2)
    assert kernels._probe_args(pow2, words, None)[5] == 16
    fw = torch.arange(5, dtype=torch.int64)
    assert kernels._probe_args(pow2, words, fw) == (
        0, words.data_ptr(), 0, 0, 0, 0, fw.data_ptr(), 5)
    with pytest.raises(ValueError, match="reads"):
        kernels._probe_args(blf, words[:1999], None)            # 63,968 bits
    with pytest.raises(ValueError, match="reads"):
        kernels._probe_args(pow2, words[:2047], None)
    blf.blf_probes = 21
    with pytest.raises(ValueError, match="probes"):
        kernels._probe_args(blf, words, None)
    blf.blf_probes, blf.blf = 1, types.SimpleNamespace(nbits=1 << 38)
    with pytest.raises(ValueError, match="unsupported"):
        kernels._probe_args(blf, words, None)
    with pytest.raises(ValueError, match="contiguous"):
        kernels._probe_args(pow2, words, torch.arange(10)[::2])


# --- the steps ---------------------------------------------------------------------

def _recorded(monkeypatch):
    """Record every hash160_probe call's planes and refuse K1 or K5 alone."""
    calls = []
    fused = kernels.hash160_probe

    def record(filt, xs, ys, planes, bits, fw, out):
        calls.append((len(xs), len(ys), list(planes), tuple(out.shape)))
        return fused(filt, xs, ys, planes, bits, fw, out)

    def refuse(*args, **kwargs):
        raise AssertionError("K1 or K5 called alone")
    monkeypatch.setattr(kernels, "hash160_probe", record)
    for name in ("addr33_hash_rows", "addr65_hash_rows", "probe_pack"):
        monkeypatch.setattr(kernels, name, refuse)
    return calls


def test_add_step_probes_through_the_fused_entry(monkeypatch):
    """One `add` step with -endo and both forms: one hash160_probe call
    over its 12 planes in _variants's order, writing the step's masks."""
    filt = filters.filter_from_hashes(_hashes(3, 24))
    cfg = SearchConfig(range_s=0x8000, range_e=0x9000, endo=True,
                       addr65=True, centers=2, group_k=32)
    table = add._cached_table(cfg.stride, cfg.group_k, cfg.keys_per_step)
    cx, cy = add.center_points(cfg, 0x8000)
    state = add.state_from_numpy(cx, cy, *table, filt.device_bits, "cpu")
    calls = _recorded(monkeypatch)
    masks = add.make_step(cfg, filt, "cpu")(*state)[2]
    assert calls == [(3, 2, [(*add.EMAP[e], f) for e, f in add._variants(cfg)],
                      (12, 2))]
    assert masks.shape == (12, 2) and masks.dtype == torch.int64


def test_mul_step_probes_through_the_fused_entry(monkeypatch):
    filt = filters.filter_from_hashes(_hashes(3, 25))
    cfg = mul.SearchConfig(addr33=True, addr65=True)
    w, batch = 4, 32
    dig = np.zeros((mul.n_windows(w), batch), dtype=np.int32)
    dig[:, :3] = mul.window_digits([5, 6, 7], w).T
    table = mul.build_gtable(w, torch.device("cpu"))
    bits = bloom.bits_tensor(filt.device_bits, "cpu")
    calls = _recorded(monkeypatch)
    masks = mul.make_mul_step(cfg, filt, w, batch, "cpu")(
        torch.from_numpy(dig), table, bits)
    assert calls == [(1, 1, [(0, 0, True), (0, 0, False)], (2, 1))]
    assert masks.shape == (2, 1)
