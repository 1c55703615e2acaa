"""`add` mode: sequential batch-addition search over a contiguous range.

The port of `ecloop_tpu.search.add`.  M group centers advance in
lockstep, each with K neighbours from a shared table, so one step covers
M*K keys with one batched inversion (K2) for all the chords; every
candidate pubkey then goes through hash160 (K1) and the filter's device
prefilter, and the host receives only packed hit masks.  Hits are
confirmed and re-derived on the host.

Key layout per step t (stride s = 2^offs, h = K/2):
  flat index j = m*K + i  ->  private key  base + (t*M*K + j) * s
  lane (m, i) point       =  C_m + (i - h) * s * G,   C_m advancing by MKs*G
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ecloop_tpu import golden

from .. import bloom, ecc, fel, kernels
from ..filters import Filter
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


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """bool bits (flat order kept) -> (B//32,) int64 words < 2^32,
    little-endian bit order."""
    b = bits.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    return (b << shifts).sum(dim=-1)


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
    """(M, 16) limbs of the M group centers of a span starting at base."""
    h = cfg.group_k // 2
    return ecc.points_host([(base + (m * cfg.group_k + h) * cfg.stride) % N
                            for m in range(cfg.centers)])


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
    +- pair."""
    m_, k_ = cfg.centers, cfg.group_k
    k2 = k_ // 2
    nh = m_ * k2
    variants = _variants(cfg)
    need_beta = any(e >= 2 for e, _ in variants)
    need_neg = any(e % 2 for e, _ in variants)
    first_words = filt.first_words(device)

    def step(cx, cy, tx, ty, dpx, dpy, bits):
        cxb, cyb = cx[:, :, None], cy[:, :, None]           # (16, M, 1)
        txb, tyb = tx[:, None, :], ty[:, None, :]           # (16, 1, K/2)
        dpxb, dpyb = dpx[:, None], dpy[:, None]             # (16, 1)

        # batch affine chords C[m] +- T[j], plus the center advance
        dx = fel.sub_mod(txb, cxb)                          # (16, M, K/2)
        dxc = fel.sub_mod(dpxb, cx)                         # (16, M)
        inv = kernels.inv_mod_batch(torch.cat([dx.reshape(NLIMBS, nh), dxc],
                                              dim=1))
        idx = inv[:, :nh].reshape(NLIMBS, m_, k2)
        xp, yp = ecc.affine_add_rows(cxb, cyb, txb, tyb, idx)
        xm, ym = ecc.affine_add_rows(cxb, cyb, txb, fel.neg_mod(tyb), idx)
        # offsets 0..K-1, center at h = K/2:
        #   [flip(minus: h-1..0), center, plus[:-1]: h+1..K-1]
        px = torch.cat([xm.flip(2), cxb, xp[:, :, :k2 - 1]],
                       dim=2).reshape(NLIMBS, -1)
        py = torch.cat([ym.flip(2), cyb, yp[:, :, :k2 - 1]],
                       dim=2).reshape(NLIMBS, -1)
        ncx, ncy = ecc.affine_add_rows(cx, cy, dpxb, dpyb, inv[:, nh:])

        # endo point synthesis: (x, beta*x, beta^2*x) x (y, -y) as needed
        xs, ys = {0: px}, {0: py}
        if need_beta:
            xs[1] = fel.mul_mod(px, fel.const(golden.BETA1, px))
            xs[2] = fel.mul_mod(px, fel.const(golden.BETA2, px))
        if need_neg:
            ys[1] = fel.neg_mod(py)

        masks = []
        for e, is33 in variants:
            xv, yv = EMAP[e]
            hw = (kernels.addr33_hash_rows if is33
                  else kernels.addr65_hash_rows)(xs[xv], ys[yv])
            masks.append(pack_mask(filt.device_probe(hw, bits, first_words)))
        return ncx, ncy, torch.stack(masks)

    return step


class RangeDriver:
    """Reference `add` semantics over [range_s, range_e): claim planning,
    coverage rounding and counter accounting (cmd_add / cmd_add_worker,
    main.c:405-454); subclasses provide run_span()."""

    cfg: SearchConfig
    k_checked: int

    def run_span(self, base, n_keys, hit_offsets_valid, on_found=None,
                 on_step=None):
        raise NotImplementedError

    def run_range(self, on_found=None, on_step=None) -> list[Found]:
        """Search [range_s, range_e); k_checked grows by each claim's job,
        x6 with endo.  on_step(keys_done) reports progress."""
        cfg = self.cfg
        rs, re_ = cfg.range_s, cfg.range_e
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

        def valid(off):
            return any(a <= off < b for a, b in windows)

        return self.run_span(rs, span_keys, hit_offsets_valid=valid,
                             on_found=on_found, on_step=on_step)


class AddSearch(RangeDriver):
    """Single-device add-mode engine."""

    def __init__(self, cfg: SearchConfig, filt: Filter, device):
        self.cfg = cfg
        self.filt = filt
        self.device = torch.device(device)
        self.step_fn = make_step(cfg, filt, self.device)
        self.variants = _variants(cfg)
        self.table = tuple(fel.from_last(a, self.device) for a in _cached_table(
            cfg.stride, cfg.group_k, cfg.keys_per_step))
        self.bits = bloom.bits_tensor(filt.device_bits, self.device)
        self.k_checked = 0
        self.k_found = 0

    def run_span(self, base: int, n_keys: int, hit_offsets_valid,
                 on_found=None, on_step=None) -> list[Found]:
        """Search keys base + i*stride for i in [0, n_keys); a hit at
        offset i counts only where hit_offsets_valid(i) holds.

        Each call of steps_per_call steps ends with an asynchronous copy of
        its masks into pinned host memory; that call's masks are drained
        only after the next call's steps are queued, so the host's hit
        handling overlaps the device's work."""
        cfg = self.cfg
        mk = cfg.keys_per_step
        t_ = max(1, cfg.steps_per_call)
        calls = -(-(-(-n_keys // mk)) // t_)
        check_no_degenerate(cfg, base, calls * t_ * mk)
        cx, cy = (fel.from_last(a, self.device)
                  for a in center_points(cfg, base))
        found = []
        pending = None
        for c in range(calls):
            masks = []
            for _ in range(t_):
                cx, cy, m = self.step_fn(cx, cy, *self.table, self.bits)
                masks.append(m)
            fetch = self._fetch(torch.stack(masks))
            if pending is not None:
                found.extend(self._drain(pending, base, n_keys,
                                         hit_offsets_valid, on_found, on_step))
            pending = (c * t_, fetch)
        if pending is not None:
            found.extend(self._drain(pending, base, n_keys,
                                     hit_offsets_valid, on_found, on_step))
        return found

    @staticmethod
    def _fetch(masks: torch.Tensor):
        """Start the device-to-host copy of a call's masks."""
        if masks.device.type != "cuda":
            return masks, None
        host = torch.empty(masks.shape, dtype=masks.dtype, pin_memory=True)
        host.copy_(masks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _drain(self, pending, base, n_keys, hit_offsets_valid, on_found,
               on_step):
        t0, (host, done) = pending
        if done is not None:
            done.synchronize()
        masks_np = host.numpy()
        mk = self.cfg.keys_per_step
        out = []
        for tt in range(masks_np.shape[0]):
            t = t0 + tt
            if masks_np[tt].any():
                out.extend(self._handle_hits(base, t * mk, n_keys,
                                             masks_np[tt], hit_offsets_valid,
                                             on_found))
            if on_step:
                on_step(min((t + 1) * mk, n_keys))
        return out

    def _handle_hits(self, base, step_off, n_keys, masks_np,
                     hit_offsets_valid, on_found) -> list[Found]:
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
