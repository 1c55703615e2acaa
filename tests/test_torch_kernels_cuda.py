"""The CUDA kernels against their plain versions on the card (bit-exact).
Needs a CUDA GPU; skipped without one.  Imports no jax, so it also runs
where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from ecloop_tpu_torch import benchlib, bloom, ecc, fel, filters, golden, graphs, hash160
from ecloop_tpu_torch import kernels
from ecloop_tpu_torch.search import add, mul
from ecloop_tpu_torch.search.common import SearchConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _limbs(n, seed, dev):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    a[15] = rng.integers(0, 0xFFFF, size=n)
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("n", [131072, 1031, 1])
def test_hash160_kernel_matches_plain(dev, n):
    x, y = _limbs(n, 1, dev), _limbs(n, 2, dev)
    before = kernels.LAUNCHES["hash160"]
    for k, p in ((kernels.addr33_hash_rows, hash160.addr33_hash_rows),
                 (kernels.addr65_hash_rows, hash160.addr65_hash_rows)):
        assert torch.equal(k(x, y), p(x, y))
    assert kernels.LAUNCHES["hash160"] == before + 2


@pytest.mark.parametrize("n", [65568, 32768, 155629, 1000, 33, 1])
def test_inv_kernel_matches_plain(dev, n):
    """The main path's K2 widths (an `add` step, a `mul` job, the widest
    table-build round) and ragged ones, with zeros first and, where the
    batch spans several blocks, across a block edge, over one whole block
    and last."""
    x = _limbs(n, 3, dev)
    x[:, : min(n, 3)] = 0
    blk = kernels.inv_block_elements()
    if n > 4 * blk:
        x[:, blk - 5:blk + 5] = 0
        x[:, 2 * blk:3 * blk] = 0
        x[:, -3:] = 0
    before = kernels.LAUNCHES["inv_mod_batch"]
    got = kernels.inv_mod_batch(x)
    assert kernels.LAUNCHES["inv_mod_batch"] == before + 1
    assert torch.equal(got, fel.inv_mod_batch(x))
    v = fel.tensor_to_ints(x[:, -4:-3] if n > 4 * blk else x[:, -1:])[0]
    w = fel.tensor_to_ints(got[:, -4:-3] if n > 4 * blk else got[:, -1:])[0]
    assert w == (pow(v, fel.P - 2, fel.P) if v else 0)


def test_inv_kernel_all_zero(dev):
    x = torch.zeros((16, 1000), dtype=torch.int64, device=dev)
    assert torch.equal(kernels.inv_mod_batch(x), x)


def test_kernel_rejects_non_contiguous(dev):
    x = _limbs(64, 4, dev)[:, ::2]
    with pytest.raises(ValueError):
        kernels.inv_mod_batch(x)


def test_step_on_card_matches_cpu(dev):
    filt = filters.load_filter(os.path.join(os.path.dirname(__file__), "..", "data",
                                           "btc-puzzles-hash"))
    cfg = SearchConfig(range_s=0x8000, range_e=0x10000, endo=True,
                       addr65=True, centers=8, group_k=256)
    tx, ty, dpx, dpy = add._cached_table(cfg.stride, cfg.group_k,
                                         cfg.keys_per_step)
    cx, cy = add.center_points(cfg, 0x8000)
    outs = []
    for d in ("cpu", dev):
        step = add.make_step(cfg, filt, d)
        state = add.state_from_numpy(cx, cy, tx, ty, dpx, dpy,
                                     filt.device_bits, d)
        outs.append([t.cpu() for t in step(*state)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [32768, 1000, 1])
@pytest.mark.parametrize("complete", [True, False])
def test_mixed_add_kernel_matches_plain(dev, n, complete):
    q = [_limbs(n, s, dev) for s in (5, 6, 7)]
    gx, gy = _limbs(n, 8, dev), _limbs(n, 9, dev)
    keys = [3, 0xC936, golden.N - 2]
    px, py = (fel.from_last(a, dev) for a in ecc.points_host(keys))
    m = min(n, 3)
    q[0][:, :m], q[1][:, :m], gx[:, :m], gy[:, :m] = px[:, :m], py[:, :m], \
        px[:, :m], py[:, :m]                          # P == Q lanes
    q[2][:, :m] = fel.const(1, q[2])
    if n > 3:
        q[2][:, 3] = 0                                # infinity accumulator
    skip = torch.from_numpy(np.random.default_rng(10).random(n) < 0.1).to(dev)
    before = kernels.LAUNCHES["mixed_add"]
    got = kernels.proj_add_affine(*q, gx, gy, skip, complete)
    nx, ny, nz = ecc.proj_add_affine_rows(*q, gx, gy, complete)
    for g, p, old in zip(got, (nx, ny, nz), q):
        assert torch.equal(g, fel.select(skip, old, p))
    assert kernels.LAUNCHES["mixed_add"] == before + 1


def test_mul_step_on_card_matches_cpu(dev):
    filt = filters.load_filter(os.path.join(os.path.dirname(__file__), "..",
                                            "data", "btc-bw-hash"))
    with open(os.path.join(os.path.dirname(__file__), "..", "data",
                           "btc-bw-priv")) as f:
        keys = [int(ln, 16) for ln in f.read().split()[:1000]]
    cfg = mul.SearchConfig(addr33=True, addr65=True)
    w, batch = 8, 1024
    dig = np.zeros((mul.n_windows(w), batch), dtype=np.int32)
    dig[:, :len(keys)] = mul.window_digits(keys, w).T
    table = mul.build_gtable(w, torch.device("cpu"))
    outs = []
    for d in ("cpu", dev):
        step = mul.make_mul_step(cfg, filt, w, batch, d)
        bits = torch.from_numpy(filt.device_bits.view(np.int32)).to(d)
        outs.append(step(torch.from_numpy(dig).to(d), table.to(d), bits).cpu())
    assert torch.equal(outs[0], outs[1])
    assert int(np.unpackbits(outs[0].numpy().astype("<u4").view(np.uint8)
                             ).sum()) >= len(keys)


def test_kernels_replay_from_a_graph(dev):
    """K1, K2 and K3 launched from a captured CUDA graph's replay give what
    their eager launches give; a chain of 4 captured K1 iterations (the
    bench's fold) equals 4 eager ones."""
    n = 32768
    x, y = _limbs(n, 11, dev), _limbs(n, 12, dev)
    q = [_limbs(n, s, dev) for s in (13, 14, 15, 16, 17)]
    skip = torch.from_numpy(np.random.default_rng(18).random(n) < 0.1).to(dev)
    calls = [lambda: (kernels.addr33_hash_rows(x, y),),
             lambda: (kernels.addr65_hash_rows(x, y),),
             lambda: (kernels.inv_mod_batch(x),),
             lambda: kernels.proj_add_affine(*q, skip, False),
             lambda: kernels.proj_add_affine(*q, skip, True)]
    for call in calls:
        want = call()
        loop = benchlib.Loop(lambda *_: call(),
                             [torch.empty_like(t) for t in want])
        loop()
        torch.cuda.synchronize()
        for s, w in zip(loop.state, want):
            assert torch.equal(s, w)

    def fold(x, y):
        x[0].bitwise_xor_(kernels.addr33_hash_rows(x, y)[0] & 0xFFFF)
        return x, y
    eager = x.clone()
    for _ in range(4):
        fold(eager, y)
    chained = x.clone()
    loop = benchlib.Loop(fold, (chained, y), iters=4)
    chained.copy_(x)                     # undo the warm-up's iteration
    loop()
    torch.cuda.synchronize()
    assert torch.equal(chained, eager)


def test_mult_verify_on_card(dev, monkeypatch, capsys):
    monkeypatch.setenv("ECLOOP_VERIFY_W", "8")
    assert benchlib.mult_verify(dev, count=256) == 0
    assert "OK: all multiplications verified" in capsys.readouterr().out


def test_window_scan_gives_the_mul_steps_masks(dev):
    """The factored window scan, reduced (K2), hashed (K1) and probed by
    hand, gives make_mul_step's masks at 32,768 lanes; its points are k*G."""
    filt = filters.load_filter(os.path.join(os.path.dirname(__file__), "..",
                                            "data", "btc-bw-hash"))
    cfg = mul.SearchConfig(addr33=True, addr65=True)
    w, batch = 8, 32768
    keys = benchlib.verify_keys(batch)
    dig = torch.from_numpy(np.ascontiguousarray(mul.window_digits(keys, w).T,
                                                dtype=np.int32)).to(dev)
    table = mul.build_gtable(w, dev)
    bits = torch.from_numpy(filt.device_bits.view(np.int32)).to(dev)
    masks = mul.make_mul_step(cfg, filt, w, batch, dev)(dig, table, bits)
    idx, skip = mul.window_index(dig, mul.window_offsets(w, dev))
    zero = torch.zeros((16, batch), dtype=torch.int64, device=dev)
    one = fel.const(1, zero).expand(16, batch).contiguous()
    qx, qy, qz = mul.window_scan(table, idx, skip, (zero, one, zero))
    ax, ay = ecc.proj_to_affine_rows(qx, qy, qz, inv=kernels.inv_mod_batch)
    fw = filt.first_words(dev)
    want = torch.stack([filters.pack_mask(filt.device_probe(k(ax, ay), bits, fw))
                        for k in (kernels.addr33_hash_rows,
                                  kernels.addr65_hash_rows)])
    assert torch.equal(masks, want)
    got = list(zip(fel.tensor_to_ints(ax[:, :8]), fel.tensor_to_ints(ay[:, :8])))
    assert got == [golden.point_mul(k) for k in keys[:8]]


def _puzzles():
    return filters.load_filter(os.path.join(os.path.dirname(__file__), "..",
                                            "data", "btc-puzzles-hash"))


def test_graph_call_equals_eager_steps(dev):
    """`build_step_fn`'s graph replay equals T eager steps, over two
    calls, with the centers re-seeded between them (`rnd`'s case), in
    -endo with both address forms; each step launches the fused hash and
    probe once per address form, and no K1 or K5 alone."""
    cfg = SearchConfig(range_s=0x8000, range_e=0x10000, endo=True,
                       addr65=True, centers=8, group_k=256, steps_per_call=3)
    call = add.build_step_fn(cfg, _puzzles(), dev)
    assert call.graph.graph is not None
    v = len(add._variants(cfg))
    kernels.reset_launches()
    for base in (0x8000, 0x9000):
        cx, cy = (fel.from_last(a, dev) for a in add.center_points(cfg, base))
        call.seed(cx, cy)
        call()
        masks = []
        for _ in range(cfg.steps_per_call):
            cx, cy, m = call.step(cx, cy, *call.table, call.bits)
            masks.append(m)
        assert torch.equal(call.masks, torch.stack(masks))
        assert torch.equal(call.cx, cx) and torch.equal(call.cy, cy)
    n = 2 + 2          # two replays, then the eager steps' own launches
    # one hash160_probe launch per address form over its 6 endo planes
    assert v == 12
    assert kernels.LAUNCHES["hash160_probe"] == n * cfg.steps_per_call * 2
    assert kernels.LAUNCHES["hash160"] == kernels.LAUNCHES["probe_pack"] == 0
    assert kernels.LAUNCHES["inv_mod_batch"] == n * cfg.steps_per_call
    assert kernels.LAUNCHES["add_chords"] == 2 * n * cfg.steps_per_call


def test_mul_graph_job_equals_eager(dev):
    """`build_mul_step`'s replay equals the eager job, twice over, with
    the digits uploaded between replays."""
    filt = filters.load_filter(os.path.join(os.path.dirname(__file__), "..",
                                            "data", "btc-bw-hash"))
    with open(os.path.join(os.path.dirname(__file__), "..", "data",
                           "btc-bw-priv")) as f:
        keys = [int(ln, 16) for ln in f.read().split()[:1000]]
    cfg = mul.SearchConfig(addr33=True, addr65=True)
    w, batch = 8, 1024
    call = mul.build_mul_step(cfg, filt, w, batch, dev)
    for ks in (keys, keys[::-1][:batch // 2]):
        dig = np.zeros((mul.n_windows(w), batch), dtype=np.int32)
        dig[:, :len(ks)] = mul.window_digits(ks, w).T
        call.upload(dig)
        call()
        want = call.step(torch.from_numpy(dig).to(dev), call.txy, call.bits)
        assert torch.equal(call.masks, want)
        assert int(np.unpackbits(want.cpu().numpy().astype("<u4").view(
            np.uint8)).sum()) >= len(ks)


def test_engines_launch_only_through_graph_replays(dev, monkeypatch):
    """Once built, `AddSearch` and `MulSearch` over [dev] x 2 launch no
    kernel through the wrappers: each call is one replay per shard, and
    the launches counted are the replays' recorded ones."""
    targets = [0x70005, 0x702A0, 0x707F0]
    filt = filters.filter_from_hashes(np.stack([np.frombuffer(
        golden.addr33(golden.point_mul(k)), dtype=">u4").astype(np.uint32)
        for k in targets]))
    cfg = SearchConfig(range_s=0x70000, range_e=0x70800, centers=8,
                       group_k=256, steps_per_call=2)
    eng = add.AddSearch(cfg, filt, [dev, dev])
    meng = mul.MulSearch(mul.SearchConfig(), filt, [dev, dev], w=8, batch=512)

    def refuse(*args):
        raise AssertionError("a kernel launched outside a graph replay")
    monkeypatch.setattr(kernels, "_launch", refuse)
    kernels.reset_launches()
    assert {f.priv for f in eng.run_range()} == set(targets)
    # 0x800 keys at 8 x 256 per step: one step, so one call per shard
    assert kernels.LAUNCHES == {"hash160": 0, "inv_mod_batch": 2 * 2,
                                "mixed_add": 0, "add_chords": 2 * 2 * 2,
                                "probe_pack": 0, "hash160_probe": 2 * 2}
    kernels.reset_launches()
    assert {f.priv for f in meng.run_keys(targets + [5, 6])} == set(targets)
    assert kernels.LAUNCHES == {"hash160": 0, "inv_mod_batch": 2,
                                "mixed_add": 2 * mul.n_windows(8),
                                "add_chords": 0, "probe_pack": 0,
                                "hash160_probe": 2}


def _sharded_add_parity(devices):
    """A sharded `add` over `devices` against `AddSearch` on the first:
    the same found set and key count on a range with planted keys, and
    the same step masks joined in shard order."""
    targets = [0x70005, 0x702A0, 0x707F0]
    filt = filters.filter_from_hashes(np.stack([np.frombuffer(
        golden.addr33(golden.point_mul(k)), dtype=">u4").astype(np.uint32)
        for k in targets]))
    cfg = SearchConfig(range_s=0x70000, range_e=0x70800, centers=8,
                       group_k=256)
    single = add.AddSearch(cfg, filt, devices[0])
    sharded = add.AddSearch(cfg, filt, devices)
    kernels.reset_launches()
    got = {(f.label, f.priv) for f in sharded.run_range()}
    assert min(kernels.LAUNCHES["hash160_probe"],
               kernels.LAUNCHES["inv_mod_batch"]) >= len(devices)
    assert got == {(f.label, f.priv) for f in single.run_range()} == {
        ("addr33", k) for k in targets}
    assert sharded.k_checked == single.k_checked == 0x800
    cx, cy = (fel.from_last(a, devices[0])
              for a in add.center_points(cfg, 0x70000))
    want = single.shards[0].step(cx, cy)[2]
    masks = [s.step(*c)[2].to(devices[0]) for s, c in
             zip(sharded.shards, sharded.shard_centers(0x70000))]
    assert torch.equal(torch.cat(masks, dim=1), want)


def test_sharded_add_on_one_card(dev):
    _sharded_add_parity([dev, dev])


def test_sharded_add_over_two_cards():
    """Shards on cuda:0 and cuda:1 with cuda:0 current: every wrapper
    launches on its data's card (the kernel library's runtime follows
    torch's current device), and the masks of cuda:1 come back through
    an event recorded on cuda:1's stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    from ecloop_tpu_torch.search import common

    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(d0)
    x, y = _limbs(4096, 1, d1), _limbs(4096, 2, d1)
    assert torch.equal(kernels.addr33_hash_rows(x, y).cpu(),
                       hash160.addr33_hash_rows(x.cpu(), y.cpu()))
    assert torch.equal(kernels.inv_mod_batch(x).cpu(),
                       fel.inv_mod_batch(x.cpu()))
    host, done = common.fetch_async(x)
    assert done.device == d1
    assert np.array_equal(common.fetched((host, done)), x.cpu().numpy())
    _sharded_add_parity([d0, d1])


def _step_inputs(m, k, dev, base=0x8000):
    cfg = SearchConfig(range_s=base, range_e=base + m * k, centers=m,
                       group_k=k)
    cx, cy = add.center_points(cfg, base)
    table = add._cached_table(cfg.stride, k, cfg.keys_per_step)
    return [fel.from_last(a, dev) for a in (cx, cy, *table)]


@pytest.mark.parametrize("m,k", [(32, 4096), (512, 4096), (4, 64)])
@pytest.mark.parametrize("endo", [False, True])
def test_chord_kernels_match_plain(dev, m, k, endo):
    """K4 at the searches' widths (every shard of the searches runs 32 x
    4096, the wide call 512 x 4096), with a center stored as (0, 0) and
    zero inverses among real ones; endo writes beta x, beta^2 x and -y."""
    cx, cy, tx, ty, dpx, dpy = _step_inputs(m, k, dev)
    cx[:, 1], cy[:, 1] = 0, 0
    before = kernels.LAUNCHES["add_chords"]
    dx = kernels.chord_dx(cx, tx, dpx)
    assert torch.equal(dx, ecc.chord_dx_plain(cx, tx, dpx))
    inv = kernels.inv_mod_batch(dx)
    inv[:, [0, 7, m * k // 2 - 1, m * k // 2 + 2]] = 0
    got = kernels.chord_points(cx, cy, tx, ty, dpx, dpy, inv, endo, endo)
    want = ecc.chord_points_plain(cx, cy, tx, ty, dpx, dpy, inv, endo, endo)
    assert kernels.LAUNCHES["add_chords"] == before + 2
    assert len(got[0]) == len(want[0]) and len(got[1]) == len(want[1])
    for a, b in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert torch.equal(a, b)
    assert got[2].data_ptr() != cx.data_ptr()


def _probe_case(mode, arg, dev):
    """(filter, bits, first words) of a K5 case; dense random bits for
    the bloom and pow2 modes, so that both outcomes occur.  A compare list
    longer than ECLOOP_CMP_MAX's default (4,096 first words) is above
    the kernels' shared-memory cap of 2,048."""
    g = torch.Generator(device=dev).manual_seed(arg)
    if mode == "compare":
        targets = np.random.default_rng(arg).integers(
            0, 1 << 32, size=(arg, 5), dtype=np.uint64).astype(np.uint32)
        filt = filters.filter_from_hashes(targets)
        fw = torch.from_numpy(np.unique(filt.targets[:, 0]).astype(
            np.int64)).to(dev)
        return filt, torch.zeros(1, dtype=torch.int32, device=dev), fw
    if mode == "pow2":
        filt = filters.Filter(mode="list", targets=None, blf=None,
                              device_bits=None, pow2_log2=arg)
        words = 1 << (arg - 5)
    else:
        nbits = 64 * 1000 if arg <= 20 else 3 * (1 << 32) + 64
        filt = filters.Filter(mode="bloom", targets=None,
                              blf=bloom.BloomFilter(nbits // 64),
                              device_bits=None, pow2_log2=None,
                              blf_probes=min(arg, 20))
        words = nbits // 32
    bits = torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32,
                         device=dev, generator=g)
    bits |= torch.randint(-(1 << 31), 1 << 31, (words,), dtype=torch.int32,
                          device=dev, generator=g)
    return filt, bits, None


PROBE_CASES = [
    ("compare", 0), ("compare", 1), ("compare", 160), ("compare", 2048),
    ("compare", 4096), ("exact", 1), ("exact", 3), ("exact", 20),
    ("exact", 21), ("pow2", 32), ("pow2", 33)]


@pytest.mark.parametrize("n", [131072, 2097152, 32768])
@pytest.mark.parametrize("mode,arg", PROBE_CASES)
def test_probe_pack_kernel_matches_plain(dev, mode, arg, n):
    """K5 at the searches' key counts (an `add` step, the wide call, a
    `mul` job) in every mode: compare lists of 0-4,096 first words (hits
    planted; 4,096 is above the shared-memory cap), bloom at 1, 3 and 20
    probes and at 20 over a 3 x 2^32 + 64 bit filter ("exact", 21), pow2
    on each side of log2_bits 32."""
    filt, bits, fw = _probe_case(mode, arg, dev)
    h = torch.randint(0, 1 << 32, (5, n), dtype=torch.int64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(n))
    if fw is not None and fw.numel():
        h[0, :n // 4] = fw[torch.arange(n // 4, device=dev) % fw.numel()]
    before = kernels.LAUNCHES["probe_pack"]
    got = kernels.probe_pack(filt, h, bits, fw)
    want = filters.probe_pack_plain(filt, h, bits, fw)
    assert kernels.LAUNCHES["probe_pack"] == before + 1
    assert torch.equal(got, want)
    hits = int(np.unpackbits(got.cpu().numpy().astype("<u4").view(
        np.uint8)).sum())
    assert (hits == 0) == (mode == "compare" and arg == 0)


# the planes of the searches' steps: addr33; -a cu; -endo; -endo -a cu
# (search/add._variants's order, (x row, y row, is33))
PLANE_SETS = {
    1: [(0, 0, True)],
    2: [(0, 0, True), (0, 0, False)],
    6: [(*add.EMAP[e], True) for e in range(6)],
    12: [(*add.EMAP[e], f) for e in range(6) for f in (True, False)],
}


@pytest.fixture(scope="module")
def plain_hashes():
    """(xs, ys, {(x row, y row, is33): plain hash rows}) per key count:
    three x and two y rows of random limbs, hashed once by the plain form
    for every test of the fused entry."""
    cache = {}

    def get(n, dev):
        if n not in cache:
            xs = [_limbs(n, 30 + i, dev) for i in range(3)]
            ys = [_limbs(n, 40 + i, dev) for i in range(2)]
            rows = {(i, j, f): (hash160.addr33_hash_rows if f
                                else hash160.addr65_hash_rows)(xs[i], ys[j])
                    for i, j, f in PLANE_SETS[12]}
            cache[n] = (xs, ys, rows)
        return cache[n]
    return get


@pytest.mark.parametrize("n", [131072, 32768])
@pytest.mark.parametrize("count", sorted(PLANE_SETS))
@pytest.mark.parametrize("mode,arg", PROBE_CASES)
def test_hash160_probe_kernel_matches_plain(dev, plain_hashes, mode, arg,
                                            count, n):
    """The fused hash and probe (K1 with K5 as its epilogue) equals the
    plain hash rows probed and packed by the plain form, plane by plane,
    in every probe case, for the plane sets of addr33, -a cu, -endo and
    -endo -a cu; one launch per address form."""
    filt, bits, fw = _probe_case(mode, arg, dev)
    xs, ys, rows = plain_hashes(n, dev)
    planes = PLANE_SETS[count]
    if fw is not None and fw.numel():
        # plant hits: a quarter of the list (at least one word) becomes
        # first words of plane 0's keys
        k = max(1, fw.numel() // 4)
        fw = torch.unique(torch.cat([fw[k:], rows[planes[0]][0, :k]]))
    out = torch.full((count, n // 32), -1, dtype=torch.int64, device=dev)
    before = kernels.LAUNCHES["hash160_probe"]
    kernels.hash160_probe(filt, xs, ys, planes, bits, fw, out)
    assert kernels.LAUNCHES["hash160_probe"] == before + len(
        {f for *_, f in planes})
    want = torch.stack([filters.probe_pack_plain(filt, rows[p], bits, fw)
                        for p in planes])
    assert torch.equal(out, want)


def test_hash160_probe_at_the_wide_width(dev):
    """At the wide `add` call's 2,097,152 keys, -endo, compare mode: the
    fused entry equals K1's plain rows probed by the plain form."""
    n = 2097152
    xs = [_limbs(n, 50 + i, dev) for i in range(3)]
    ys = [_limbs(n, 60 + i, dev) for i in range(2)]
    planes = PLANE_SETS[6]
    rows = [hash160.addr33_hash_rows(xs[i], ys[j]) for i, j, _ in planes]
    filt, bits, _ = _probe_case("compare", 160, dev)
    fw = torch.unique(torch.cat([rows[3][0, :96], rows[5][0, -64:]]))
    out = torch.empty((6, n // 32), dtype=torch.int64, device=dev)
    kernels.hash160_probe(filt, xs, ys, planes, bits, fw, out)
    want = torch.stack([filters.probe_pack_plain(filt, h, bits, fw)
                        for h in rows])
    assert torch.equal(out, want) and int(want.count_nonzero()) >= 4


def test_failed_capture_raises(dev):
    """A body that syncs with the host cannot be captured: building its
    graph raises, with no eager fallback."""
    x = torch.ones(4, device=dev)
    with pytest.raises(RuntimeError):
        graphs.Graph(lambda _: x.sum().item(), dev)
    torch.cuda.synchronize()
    assert float(x.sum()) == 4.0
