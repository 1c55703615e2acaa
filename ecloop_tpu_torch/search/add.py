"""`add` mode: sequential batch-addition search over a contiguous range.

The port of `ecloop_tpu.search.add`.  M group centers advance in
lockstep, each with K neighbours from a shared table, so one step covers
M*K keys with one batched inversion (K2) for all the chords; every
candidate pubkey then goes through hash160 and the filter's device
prefilter in one kernel (K1 with K5 as its epilogue), and the host
receives only packed hit masks.  Hits are
confirmed and re-derived on the host.

Key layout per step t (stride s = 2^offs, h = K/2):
  flat index j = m*K + i  ->  private key  base + (t*M*K + j) * s
  lane (m, i) point       =  C_m + (i - h) * s * G,   C_m advancing by MKs*G
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import bloom, fel, golden, graphs, kernels
from ..filters import Filter
from ..parallel import mesh
from . import common
from .common import Found, SearchConfig

N = golden.N
NLIMBS = fel.NLIMBS
# endo index -> (x variant, y variant): x, beta*x, beta^2*x and y, -y
# (golden.endo_points)
EMAP = {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1), 4: (2, 0), 5: (2, 1)}


def _variants(cfg: SearchConfig) -> list[tuple[int, bool]]:
    """Candidate variants in mask-plane order: (endo_idx, is_addr33)."""
    out = []
    for e in range(6) if cfg.endo else range(1):
        if cfg.addr33:
            out.append((e, True))
        if cfg.addr65:
            out.append((e, False))
    return out


def unpack_mask(words: np.ndarray) -> np.ndarray:
    """Packed words (any integer dtype, values < 2^32) -> flat bits."""
    w = np.ascontiguousarray(np.asarray(words).astype("<u4"))
    return np.unpackbits(w.view(np.uint8), bitorder="little")


@functools.lru_cache(maxsize=8)
def _cached_table(stride: int, k: int, mk: int):
    """Positive-half table T[j] = (j+1)*stride*G (j < K/2) and the
    advance point D = M*K*stride*G, built on the host with the golden
    model: ((K/2, 16), (K/2, 16), (16,), (16,)) uint32 limbs."""
    step = golden.point_mul(stride)
    p = step
    pts = []
    for _ in range(k // 2):
        pts.append(p)
        p = golden.point_add(p, step)
    pts.append(golden.point_mul((mk * stride) % N))
    ax = fel.ints_to_limbs([q[0] for q in pts])
    ay = fel.ints_to_limbs([q[1] for q in pts])
    for a in (ax, ay):
        a.setflags(write=False)
    return ax[:-1], ay[:-1], ax[-1], ay[-1]


def center_points(cfg: SearchConfig, base: int):
    """(M, 16) limbs of x and of y of the M group centers of a span
    starting at base: the first center by one point_mul, the others by
    adding the step K*s*G (a second point_mul), M-1 affine adds in all.
    A center at infinity maps to (0, 0), as ecc.points_host maps key 0."""
    first = golden.point_mul(base + cfg.group_k // 2 * cfg.stride)
    step = golden.point_mul(cfg.group_k * cfg.stride)
    pts = [first]
    for _ in range(cfg.centers - 1):
        pts.append(golden.point_add(pts[-1], step))
    pts = [(0, 0) if p is None else p for p in pts]
    return (fel.ints_to_limbs([p[0] for p in pts]),
            fel.ints_to_limbs([p[1] for p in pts]))


def state_from_numpy(cx, cy, tx, ty, dpx, dpy, bits, device):
    """The step's inputs as the JAX package holds them (numpy: limbs last,
    u32 filter bits) -> the port's tensors on `device`, in step order:
    (16, M) centers, (16, K/2) table, (16,) advance point, int32 bits."""
    limbs = [fel.from_last(a, device) for a in (cx, cy, tx, ty, dpx, dpy)]
    return (*limbs, bloom.bits_tensor(np.asarray(bits, dtype=np.uint32),
                                      device))


def check_no_degenerate(cfg: SearchConfig, base: int, n_keys: int) -> None:
    """The chord formula needs P != +-Q.  A center key c collides exactly
    when c = +-(i - K/2)*s (a table point) or c = +-M*K*s (the advance
    point) mod N; centers sit at flat offsets k with k % K == K/2, so the
    check is exact and O(K)."""
    s = cfg.stride
    k_ = cfg.group_k
    mk = cfg.keys_per_step
    s_inv = pow(s, -1, N)
    bad = {(j * s) % N for j in range(-(k_ // 2), k_ // 2 + 1)}
    bad |= {(mk * s) % N, (-mk * s) % N}
    span = -(-n_keys // mk) * mk
    for v in bad:
        k = ((v - base) * s_inv) % N
        if k < span and k % k_ == k_ // 2:
            raise ValueError(
                f"invalid search range: key {v:#x} inside the span "
                f"collides with the batch geometry (K={k_}, M="
                f"{cfg.centers}, stride=2^{cfg.stride_offs}); shift "
                f"the range start or change geometry")


def make_step(cfg: SearchConfig, filt: Filter, device):
    """The device step: (cx, cy, tx, ty, dpx, dpy, bits) -> (cx', cy',
    masks), tensors as `state_from_numpy` makes them; masks is (V, M*K/32)
    int64, one packed hit plane per candidate variant.

    The table holds only the positive multiples T[j] = (j+1)*s*G; the
    mirror neighbours C - T[j] share T[j].x, so one inverted dx serves the
    +- pair.  Four kernels: the chords' denominators (K4, `chord_dx`),
    their batch inversion (K2), the chords, the center advance and the
    endo rows (K4, `chord_points`), then hash160 with the probe and its
    mask packing as the epilogue (K1 + K5, `hash160_probe`: one launch
    per address form over its endo planes)."""
    variants = _variants(cfg)
    need_beta = any(e >= 2 for e, _ in variants)
    need_neg = any(e % 2 for e, _ in variants)
    planes = [(*EMAP[e], is33) for e, is33 in variants]
    first_words = filt.first_words(device)

    def step(cx, cy, tx, ty, dpx, dpy, bits):
        inv = kernels.inv_mod_batch(kernels.chord_dx(cx, tx, dpx))
        xs, ys, ncx, ncy = kernels.chord_points(cx, cy, tx, ty, dpx, dpy, inv,
                                                need_beta, need_neg)
        masks = torch.empty((len(planes), cfg.keys_per_step // 32),
                            dtype=torch.int64, device=cx.device)
        kernels.hash160_probe(filt, xs, ys, planes, bits, first_words, masks)
        return ncx, ncy, masks

    return step


class StepCall:
    """`cfg.steps_per_call` steps of `make_step` as one call (the
    counterpart of the JAX package's `build_step_fn`).  On a CUDA device
    one step is captured once as a `graphs.Graph` and a call replays it
    T times; on the CPU the steps run eagerly.  (A graph of all T steps,
    the shape of the JAX package's `lax.scan`, took 5-10x as long to
    capture and replayed no faster: PERF.md, section 5.)

    Its tensors keep their addresses: `cx`, `cy` (16, M) hold the
    centers, which a call advances in place; `masks` (T, V, M*K/32)
    receives each step's packed hit planes, overwritten by the next
    call; `table` and `bits` are the step's other inputs.  `table` is
    (tx, ty, dpx, dpy) as `_cached_table` gives it, the cfg's own by
    default.  `step` is the eager single step."""

    def __init__(self, cfg: SearchConfig, filt: Filter, device, table=None):
        device = torch.device(device)
        if table is None:
            table = _cached_table(cfg.stride, cfg.group_k, cfg.keys_per_step)
        self.step = make_step(cfg, filt, device)
        self.table = tuple(fel.from_last(a, device) for a in table)
        self.bits = bloom.bits_tensor(filt.device_bits, device)
        self.cx = torch.zeros((NLIMBS, cfg.centers), dtype=torch.int64,
                              device=device)
        self.cy = torch.zeros_like(self.cx)
        self.masks = torch.zeros((max(1, cfg.steps_per_call),
                                  len(_variants(cfg)), cfg.keys_per_step // 32),
                                 dtype=torch.int64, device=device)
        self._out = torch.empty_like(self.masks[0])

        def body(_):
            cx, cy, m = self.step(self.cx, self.cy, *self.table, self.bits)
            self.cx.copy_(cx)
            self.cy.copy_(cy)
            self._out.copy_(m)
        self.graph = graphs.Graph(body, device)

    def seed(self, cx: torch.Tensor, cy: torch.Tensor) -> None:
        """Set the centers that the next call starts from."""
        self.cx.copy_(cx)
        self.cy.copy_(cy)

    def __call__(self) -> None:
        for slot in self.masks:
            self.graph()
            slot.copy_(self._out)


build_step_fn = StepCall          # the JAX package's name for it


class AddShard:
    """One device's block of every step's centers: the M' = local_cfg's
    centers of global index [index*M', (index+1)*M'), stepped with
    `make_step` at M' centers, T steps per call (`StepCall`).  The table
    and the advance point are the whole geometry's (`cfg`): every center
    advances by the global M*K*s*G, or the blocks would overlap and
    leave keys unsearched.  A step's hit bit j is the key at offset
    `offset` + j within the step."""

    def __init__(self, index: int, device, cfg: SearchConfig,
                 local_cfg: SearchConfig, filt: Filter):
        self.device = torch.device(device)
        self.centers = slice(index * local_cfg.centers,
                             (index + 1) * local_cfg.centers)
        self.offset = index * local_cfg.keys_per_step
        self.call = StepCall(local_cfg, filt, self.device, _cached_table(
            cfg.stride, cfg.group_k, cfg.keys_per_step))

    def step(self, cx: torch.Tensor, cy: torch.Tensor):
        """One eager step: (cx, cy) -> (cx', cy', masks) for this block's
        centers (the reference the graph is held to)."""
        return self.call.step(cx, cy, *self.call.table, self.call.bits)


class AddSearch:
    """The `add` engine over one device or a list of n (reference
    cmd_add / cmd_add_worker, main.c:405-454): claim planning, coverage
    rounding and counter accounting over [range_s, range_e), the
    `AddShard`s that step the keys, and the host's handling of their hit
    masks.

    Shard d of n advances the global centers [d*M/n, (d+1)*M/n), so its
    hit in step t, bit j is the key at flat offset t*M*K + d*(M/n)*K + j:
    the key layout, and so the found set and the key count, do not
    depend on n.  `owned` holds the shard indices this process runs (all
    by default; `parallel.multihost`).  The counters are claim-based, so
    every process counts the whole range."""

    def __init__(self, cfg: SearchConfig, filt: Filter, devices,
                 owned=None):
        devices = mesh.make_devices(devices)
        n = len(devices)
        if n < 1 or cfg.centers % n:
            raise ValueError(f"centers ({cfg.centers}) must divide over "
                             f"{n} devices")
        local = dataclasses.replace(cfg, centers=cfg.centers // n)
        if local.keys_per_step % 32:
            raise ValueError(f"a shard's {local.keys_per_step} keys per step "
                             f"(centers {local.centers} x group_k "
                             f"{cfg.group_k}) must be a multiple of 32")
        self.cfg = cfg
        self.filt = filt
        self.devices = devices
        self.variants = _variants(cfg)
        self.shards = [AddShard(d, devices[d], cfg, local, filt)
                       for d in mesh.owned_shards(owned, n)]
        self.k_checked = 0
        self.k_found = 0

    def run_range(self, on_found=None, on_step=None, start_offset: int = 0,
                  range_s: int | None = None,
                  range_e: int | None = None) -> list[Found]:
        """Search [range_s, range_e), cfg's bounds unless given (`rnd`'s
        sub-ranges: one engine serves them all).  k_checked grows by each
        claim's job, x6 with endo, over the whole range whatever the
        cursor.  start_offset (the resume cursor) skips the first keys
        of the span; on_step(keys_done) reports progress in keys from
        range_s, the skipped ones included."""
        cfg = self.cfg
        rs = cfg.range_s if range_s is None else range_s
        re_ = cfg.range_e if range_e is None else range_e
        job = common.derive_job_size(rs, re_)
        claims = list(common.plan_claims(rs, re_, job, cfg.stride))
        if not claims:
            return []
        span_keys = 0
        windows = []
        for c in claims:
            off = (c.start - rs) // cfg.stride
            windows.append((off, off + c.coverage))
            span_keys = max(span_keys, off + c.coverage)
            self.k_checked += c.job * (6 if cfg.endo else 1)
        if start_offset >= span_keys:
            return []

        def valid(off):
            return any(a <= off + start_offset < b for a, b in windows)

        return self.run_span(
            (rs + start_offset * cfg.stride) % N, span_keys - start_offset,
            hit_offsets_valid=valid, on_found=on_found,
            on_step=(lambda done: on_step(start_offset + done))
            if on_step else None)

    def shard_centers(self, base: int) -> list[tuple[torch.Tensor, ...]]:
        """The (16, M') x and y limbs of each shard's first centers for
        a span from `base`, on the shard's device."""
        cx, cy = center_points(self.cfg, base)
        return [(fel.from_last(cx[s.centers], s.device),
                 fel.from_last(cy[s.centers], s.device)) for s in self.shards]

    def run_span(self, base: int, n_keys: int, hit_offsets_valid,
                 on_found=None, on_step=None) -> list[Found]:
        """Search keys base + i*stride for i in [0, n_keys); a hit at
        offset i counts only where hit_offsets_valid(i) holds.

        The span's first centers go into each shard's `StepCall`; each
        call runs the steps_per_call steps of every shard (on the card
        one step's graph replayed T times per shard), then starts an asynchronous copy
        of each shard's masks into pinned host memory, queued before the
        next call overwrites them.  A call's masks are drained only
        after the next call is queued, so the host's hit handling
        overlaps the devices' work."""
        cfg = self.cfg
        mk = cfg.keys_per_step
        t_ = max(1, cfg.steps_per_call)
        calls = -(-(-(-n_keys // mk)) // t_)
        check_no_degenerate(cfg, base, calls * t_ * mk)
        for shard, (cx, cy) in zip(self.shards, self.shard_centers(base)):
            shard.call.seed(cx, cy)
        found = []
        pending = None
        for c in range(calls):
            fetches = []
            for shard in self.shards:
                shard.call()
                fetches.append((shard.offset,
                                common.fetch_async(shard.call.masks)))
            if pending is not None:
                found.extend(self._drain(*pending, base, n_keys,
                                         hit_offsets_valid, on_found, on_step))
            pending = (c * t_, fetches)
        if pending is not None:
            found.extend(self._drain(*pending, base, n_keys,
                                     hit_offsets_valid, on_found, on_step))
        return found

    def _drain(self, t0, fetches, base, n_keys, hit_offsets_valid, on_found,
               on_step) -> list[Found]:
        """Handle the hits of one call's steps t0, t0+1, ...: `fetches`
        holds, per shard of a step's keys, the shard's first key offset
        within the step and the `fetch_async` handle of its (steps, V,
        words) masks.  Steps go in order, shards in the order given;
        on_step follows each step."""
        planes = [(off, common.fetched(f)) for off, f in fetches]
        mk = self.cfg.keys_per_step
        out = []
        for tt in range(planes[0][1].shape[0]):
            t = t0 + tt
            for off, masks_np in planes:
                if masks_np[tt].any():
                    out.extend(self._handle_hits(
                        base, t * mk + off, n_keys, masks_np[tt],
                        hit_offsets_valid, on_found))
            if on_step:
                on_step(min((t + 1) * mk, n_keys))
        return out

    def _handle_hits(self, base, step_off, n_keys, masks_np,
                     hit_offsets_valid, on_found) -> list[Found]:
        """Confirm and re-derive the hits of (V, words) masks whose bit j
        is the key at offset step_off + j."""
        out = []
        for v, (e, is33) in enumerate(self.variants):
            for j in np.nonzero(unpack_mask(masks_np[v]))[0]:
                off = step_off + int(j)
                if off >= n_keys:
                    continue                      # step overshoot
                if not hit_offsets_valid(off):
                    continue
                priv = common.recover_priv(base, off, self.cfg.stride, e)
                label = "addr33" if is33 else "addr65"
                h = common.derive_h160(priv, is33)
                if not self.filt.confirm(bytes.fromhex(h)):
                    continue                      # device prefilter false positive
                common.verify_found(priv, label, h)
                f = Found(label=label, h160=h, priv=priv)
                out.append(f)
                self.k_found += 1
                if on_found:
                    on_found(f)
        return out

