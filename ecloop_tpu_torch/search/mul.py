"""`mul` mode: scalar multiplication of arbitrary private keys (stdin
lists) through a windowed table of multiples of G.

The port of `ecloop_tpu.search.mul`.  With w-bit windows a key has
d = 255 // w + 1 digits; row i of the table holds j * 2^(w*i) * G for
j = 1 .. 2^w - 1, so k*G is the sum of at most d table points and no
doublings.  Per job of B keys the host cuts the digits, the device adds
one gathered table point per window into a projective accumulator (K3),
reduces to affine with one batched inversion (K2), hashes (K1) and
probes the filter; only packed hit masks come back, and the host
confirms every hit with exact filter semantics.

Table layout: flat index (2^w - 1) * i + j - 1 holds j * 2^(w*i) * G,
as one (32, N) int64 tensor, x limbs over y limbs (the counterpart of
`interleave_gtable`), so one gather serves both coordinates.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os

import numpy as np
import torch

from .. import bloom, ecc, fel, golden, graphs, kernels, trace
from ..filters import Filter
from ..parallel import mesh
from . import common
from .add import unpack_mask
from .common import Found, SearchConfig

N = golden.N
NLIMBS = fel.NLIMBS
W = 14                   # window width: 19 windows, 311,277 table points
INFLIGHT = 4             # default of ECLOOP_MUL_INFLIGHT: jobs queued before
                         # the oldest drains
BUILD_CHUNK = 1 << 21    # chords per K2 call of the table build


def n_windows(w: int) -> int:
    return 255 // w + 1


def _labels(cfg: SearchConfig) -> list[tuple[str, bool]]:
    """Mask planes in order: (label, is_addr33)."""
    return ([("addr33", True)] if cfg.addr33 else []) + \
           ([("addr65", False)] if cfg.addr65 else [])


# --- host: keys and window digits (numpy) ----------------------------------------

def keys_to_words(keys: list[int]) -> np.ndarray:
    """Python ints < 2^256 -> (B, 4) u64 little-endian word rows."""
    raw = b"".join(k.to_bytes(32, "little") for k in keys)
    return np.frombuffer(raw, dtype="<u8").reshape(len(keys), 4)


def word_to_int(row: np.ndarray) -> int:
    return int.from_bytes(row.tobytes(), "little")


_N_WORDS = np.frombuffer(N.to_bytes(32, "little"), dtype="<u8").copy()


def words_mod_n(words: np.ndarray) -> np.ndarray:
    """(B, 4) u64 key words mod the curve order.  Keys are < 2^256 and
    n > 2^255, so one conditional subtraction suffices."""
    ge = np.zeros(len(words), bool)
    eq = np.ones(len(words), bool)
    for i in (3, 2, 1, 0):
        gt = eq & (words[:, i] > _N_WORDS[i])
        lt = eq & (words[:, i] < _N_WORDS[i])
        ge |= gt
        eq &= ~(gt | lt)
    ge |= eq                      # == n reduces to 0 as well
    if not ge.any():
        return words
    words = words.copy()
    r = words[ge]
    borrow = np.zeros(r.shape[0], np.uint64)
    for i in range(4):
        ni = _N_WORDS[i]
        wi = r[:, i].copy()
        nb = (wi < ni) | ((wi == ni) & (borrow == np.uint64(1)))
        r[:, i] = wi - ni - borrow
        borrow = nb.astype(np.uint64)
    words[ge] = r
    return words


def window_digits_words(words: np.ndarray, w: int) -> np.ndarray:
    """(B, 4) u64 key words -> (B, d) window digits (uint16 for w <= 16,
    uint32 above); digit 0 means the window adds nothing."""
    n = 1 << w
    d = n_windows(w)
    out = np.empty((len(words), d), dtype=np.uint16 if w <= 16 else np.uint32)
    for i in range(d):
        j, sh = divmod(w * i, 64)
        lo = words[:, j] >> np.uint64(sh)
        if sh and j + 1 < 4:
            lo = lo | (words[:, j + 1] << np.uint64(64 - sh))
        out[:, i] = (lo & np.uint64(n - 1)).astype(out.dtype)
    return out


def window_digits(keys: list[int], w: int) -> np.ndarray:
    return window_digits_words(keys_to_words(keys), w)


def parse_keys(lines: list[str], raw: bool) -> list[int]:
    """Hex private keys mod n, or with -raw the SHA-256 of each line."""
    if raw:
        return [int.from_bytes(hashlib.sha256(ln.encode()).digest(), "big")
                for ln in lines]
    return [int(ln, 16) % N for ln in lines]


def parse_hex_words(lines: list[str]) -> np.ndarray | None:
    """Bulk parse of hex keys of at most 64 digits -> (B, 4) u64 words
    mod n; None when any line is longer or is not plain hex (those go
    through parse_keys, whose int(line, 16) % n takes any length)."""
    if any(len(ln) > 64 for ln in lines):
        return None
    try:
        b = bytes.fromhex("".join(ln.zfill(64) for ln in lines))
    except ValueError:
        return None
    if len(b) != 32 * len(lines):         # fromhex skipped whitespace
        return None
    arr = np.frombuffer(b, np.uint8).reshape(-1, 32)[:, ::-1]
    return words_mod_n(np.ascontiguousarray(arr).view("<u8"))


# --- the table -----------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def build_gtable(w: int = W, device="cuda") -> torch.Tensor:
    """The (32, d * (2^w - 1)) table on `device`, built there.

    The host makes the d*w base points 2^r * 2^(w*i) * G by doubling.
    Then every row grows in w - 1 lockstep rounds: round r fills the
    columns of j in (2^r, 2^(r+1)) as T[j] = T[j - 2^r] + T[2^r], one
    batch of chord additions with one K2 inversion for all rows (in
    slices of at most BUILD_CHUNK chords, which bounds the plain
    product's temporaries; up to w = 18 a round is one slice).  The
    two scalars are (j - 2^r) * 2^(w*i) and 2^r * 2^(w*i) with
    0 < j - 2^r < 2^r, and n is prime, so P != +-Q always holds: the
    chord formula is valid and the affine result is canonical, equal to
    the JAX package's host-built table."""
    device = torch.device(device)
    n1 = (1 << w) - 1
    d = n_windows(w)
    pts = []
    p = golden.G
    for _ in range(d * w):
        pts.append(p)
        p = golden.point_dbl(p)
    txy = torch.empty((2 * NLIMBS, d * n1), dtype=torch.int64, device=device)
    tx = txy[:NLIMBS].view(NLIMBS, d, n1)
    ty = txy[NLIMBS:].view(NLIMBS, d, n1)
    pow2 = [(1 << r) - 1 for r in range(w)]            # column of j = 2^r
    tx[:, :, pow2] = fel.ints_to_tensor([q[0] for q in pts], device).reshape(
        NLIMBS, d, w)
    ty[:, :, pow2] = fel.ints_to_tensor([q[1] for q in pts], device).reshape(
        NLIMBS, d, w)
    step = max(1, BUILD_CHUNK // d)
    for r in range(1, w):
        lo = 1 << r
        qx, qy = tx[:, :, lo - 1:lo], ty[:, :, lo - 1:lo]
        for a in range(0, lo - 1, step):               # j - 2^r = a+1 .. b
            b = min(lo - 1, a + step)
            px, py = tx[:, :, a:b], ty[:, :, a:b]
            dx = fel.sub_mod(qx, px)
            inv = kernels.inv_mod_batch(dx.reshape(NLIMBS, -1)).reshape(
                dx.shape)
            rx, ry = ecc.affine_add_rows(px, py, qx, qy, inv)
            tx[:, :, lo + a:lo + b] = rx
            ty[:, :, lo + a:lo + b] = ry
    return txy


def gtable_from_numpy(tx: np.ndarray, ty: np.ndarray, device) -> torch.Tensor:
    """The JAX package's (N, 16) x and y tables -> the port's (32, N)."""
    return torch.cat([fel.from_last(tx, device), fel.from_last(ty, device)])


# --- the device step -------------------------------------------------------------

def window_offsets(w: int, device) -> torch.Tensor:
    """(d, 1) offsets that turn window digits into flat table indices."""
    return (torch.arange(n_windows(w), dtype=torch.int64, device=device)
            * ((1 << w) - 1) - 1)[:, None]


def window_index(dig: torch.Tensor, offs: torch.Tensor):
    """(d, B) window digits -> (flat table indices, skip mask): digit j
    of window i reads column (2^w - 1) * i + j - 1, digit 0 skips."""
    return (dig.to(torch.int64) + offs).clamp_(min=0), dig == 0


def window_scan(txy: torch.Tensor, idx: torch.Tensor, skip: torch.Tensor,
                q):
    """The production window scan: from the projective accumulator q,
    add the gathered table point of every window (K3), skipping digit-0
    lanes.  idx and skip are `window_index`'s; returns (x, y, z).

    Windows 0 .. d-2 use K3's incomplete form: there the accumulator's
    scalar is below 2^(w*i) and the table point's is digit * 2^(w*i), so
    they never match.  The top window's table points wrap mod n, so it
    takes the complete form."""
    qx, qy, qz = q
    d = idx.shape[0]
    for i in range(d):
        g = txy.index_select(1, idx[i])
        qx, qy, qz = kernels.proj_add_affine(
            qx, qy, qz, g[:NLIMBS], g[NLIMBS:], skip[i],
            complete=(i == d - 1))
    return qx, qy, qz


def make_mul_step(cfg: SearchConfig, filt: Filter, w: int, batch: int,
                  device):
    """The device step: (dig, txy, bits) -> masks.  dig is the (d, batch)
    int32 window digits, txy the table, bits the filter's device bits;
    masks is (V, batch/32) int64, one packed hit plane per address form.
    The window scan (`window_scan`) starts at infinity; one K2 call
    reduces to affine, then K1 hashes with K5's probe and mask packing as
    its epilogue (`hash160_probe`)."""
    device = torch.device(device)
    d = n_windows(w)
    planes = [(0, 0, is33) for _, is33 in _labels(cfg)]
    first_words = filt.first_words(device)
    offs = window_offsets(w, device)
    zero = torch.zeros((NLIMBS, batch), dtype=torch.int64, device=device)
    one = fel.const(1, zero).expand(NLIMBS, batch).contiguous()

    def step(dig, txy, bits):
        if tuple(dig.shape) != (d, batch):
            raise ValueError(f"digits {tuple(dig.shape)}, expected {(d, batch)}")
        idx, skip = window_index(dig, offs)
        qx, qy, qz = window_scan(txy, idx, skip, (zero, one, zero))
        ax, ay = ecc.proj_to_affine_rows(qx, qy, qz, inv=kernels.inv_mod_batch)
        masks = torch.empty((len(planes), batch // 32), dtype=torch.int64,
                            device=device)
        return kernels.hash160_probe(filt, (ax,), (ay,), planes, bits,
                                     first_words, masks)

    return step


class MulCall:
    """One `mul` job as one call (the counterpart of the JAX package's
    `build_mul_step`): on a CUDA device one `graphs.Graph` of
    `make_mul_step`, replayed once per job; on the CPU the step runs
    eagerly.  Its tensors keep their addresses: `dig` (d, batch) int32
    takes the job's window digits (`upload`), `masks` (V, batch/32)
    receives its hit planes, overwritten by the next call; `txy` is the
    table (`build_gtable(w, device)` by default) and `bits` the filter's
    device bits."""

    def __init__(self, cfg: SearchConfig, filt: Filter, w: int, batch: int,
                 device, table: torch.Tensor | None = None):
        device = torch.device(device)
        self.step = make_mul_step(cfg, filt, w, batch, device)
        self.txy = build_gtable(w, device) if table is None else table
        self.bits = bloom.bits_tensor(filt.device_bits, device)
        self.dig = torch.zeros((n_windows(w), batch), dtype=torch.int32,
                               device=device)
        self.masks = torch.zeros((len(_labels(cfg)), batch // 32),
                                 dtype=torch.int64, device=device)

        def body(_):
            self.masks.copy_(self.step(self.dig, self.txy, self.bits))
        self.graph = graphs.Graph(body, device)

    def upload(self, dig: np.ndarray, mark=trace.OFF) -> None:
        """Copy (d, batch) digits into `dig` through pinned memory, queued
        on the current stream of `dig`'s device (whichever device is
        current), where the replay that reads them runs too: the host
        does not wait.  The job's device mark starts at the copy."""
        with trace.span("mul.upload"):
            src = torch.from_numpy(dig)
            if self.dig.is_cuda:
                src = src.pin_memory()
            mark.start()
            self.dig.copy_(src, non_blocking=True)

    def __call__(self) -> None:
        self.graph()


build_mul_step = MulCall          # the JAX package's name for it


class MulShard:
    """One device's block of every job: the table, the filter bits and
    the job call (`MulCall`) at the block's width, on its device."""

    def __init__(self, device, cfg: SearchConfig, filt: Filter, w: int,
                 batch: int):
        self.device = torch.device(device)
        self.call = MulCall(cfg, filt, w, batch, self.device)

    def launch(self, dig: np.ndarray, mark=trace.OFF):
        """Queue the job on the block's (d, batch) digits; returns the
        `common.fetch_async` handle of its (V, batch/32) masks.  `mark`
        (`trace.device_mark`) starts at the job's first enqueue."""
        self.call.upload(dig, mark)
        with trace.span("mul.launch"):
            self.call()
            trace.count("mul.enqueues", 3)        # upload, replay, fetch
            return common.fetch_async(self.call.masks)


class MulSearch:
    """Key-list search engine (reference cmd_mul) over one device or a
    list of n.

    Keys go to the devices in jobs of `batch`: key j of a job on shard
    j // (batch/n), so the found set is the one-device engine's.  Up to
    ECLOOP_MUL_INFLIGHT jobs (INFLIGHT unless set; read here, at build)
    stay queued, one depth for all shards, while the host cuts the next
    job's digits, and each job's masks come back through pinned memory
    (common.fetch_async).  Any depth is safe: every upload and every
    fetch takes a pinned block of its own, which the caching host
    allocator hands out again only once the copy queued on it is done."""

    def __init__(self, cfg: SearchConfig, filt: Filter, devices, w: int = W,
                 batch: int = 32768, raw: bool = False):
        devices = mesh.make_devices(devices)
        n = len(devices)
        if n < 1 or batch < 32 * n or batch % (32 * n):
            raise ValueError(f"mul batch ({batch}) must divide over {n} "
                             f"devices into blocks of a multiple of 32")
        self.cfg = cfg
        self.filt = filt
        self.w = w
        self.batch = batch
        self.raw = raw
        self.labels = _labels(cfg)
        self.devices = devices
        self.shards = [MulShard(d, cfg, filt, w, batch // n) for d in devices]
        self.k_checked = 0
        self.k_found = 0
        self.depth = int(os.environ.get("ECLOOP_MUL_INFLIGHT", INFLIGHT))
        self._pending = collections.deque()

    def _launch(self, dig: np.ndarray) -> list:
        """Queue one job from its (d, batch) digits, each shard's block on
        its device; returns the shards' mask handles, each with the job's
        device mark on that shard."""
        b = self.batch // len(self.shards)
        out = []
        for i, s in enumerate(self.shards):
            mark = trace.device_mark("mul", s.device)
            block = np.ascontiguousarray(dig[:, i * b:(i + 1) * b])
            out.append((s.launch(block, mark), mark))
            mark.end()
        trace.count("mul.jobs")
        trace.count("mul.lanes", self.batch * len(self.labels))
        return out

    def _masks(self, handles: list) -> np.ndarray:
        """The job's (V, batch/32) host masks, the shards' in key order."""
        masks = np.concatenate([common.fetched(h) for h, _ in handles], axis=1)
        for _, mark in handles:
            mark.done()
        return masks

    def run_keys(self, keys: list[int], on_found=None,
                 drain: bool = True) -> list[Found]:
        """Search Python-int keys (< 2^256)."""
        return self.run_words(words_mod_n(keys_to_words(keys)),
                              on_found=on_found, drain=drain)

    def run_lines(self, lines, on_found=None,
                  drain: bool = True) -> list[Found]:
        """Search key lines: hex, or with -raw any text (SHA-256)."""
        with trace.span("mul.parse"):
            lines = [ln.strip() for ln in lines]
            lines = [ln for ln in lines if ln]
            words = None if self.raw else parse_hex_words(lines)
            if words is None:
                words = words_mod_n(keys_to_words(parse_keys(lines, self.raw)))
        return self.run_words(words, on_found=on_found, drain=drain)

    def run_words(self, words: np.ndarray, on_found=None,
                  drain: bool = True) -> list[Found]:
        """Queue jobs of `batch` keys given as (B, 4) u64 word rows
        reduced mod n.  With drain=False up to `depth` jobs
        (ECLOOP_MUL_INFLIGHT) stay queued across calls; the caller ends
        with flush()."""
        found = []
        d = n_windows(self.w)
        for off in range(0, len(words), self.batch):
            job = words[off:off + self.batch]
            # padding lanes have digit 0 in every window: they stay at
            # infinity and are dropped by _handle_hits
            with trace.span("mul.digits"):
                dig = np.zeros((d, self.batch), dtype=np.int32)
                dig[:, :len(job)] = window_digits_words(job, self.w).T
            self._pending.append((job, self._launch(dig), on_found))
            while len(self._pending) > self.depth:
                found.extend(self._drain_one())
        if drain:
            found.extend(self.flush())
        return found

    def flush(self) -> list[Found]:
        """Drain every queued job; returns their finds."""
        found = []
        while self._pending:
            found.extend(self._drain_one())
        return found

    def _drain_one(self) -> list[Found]:
        job, handle, on_found = self._pending.popleft()
        with trace.span("mul.drain"):
            with trace.span("mul.wait"):
                masks = self._masks(handle)
            with trace.span("mul.hits"):
                found = self._handle_hits(job, masks, on_found)
        self.k_checked += len(job)
        return found

    def _handle_hits(self, job, masks_np, on_found) -> list[Found]:
        out = []
        for v, (label, is33) in enumerate(self.labels):
            bits = np.nonzero(unpack_mask(masks_np[v]))[0]
            trace.count("mul.candidates", len(bits))
            for j in bits:
                if j >= len(job):
                    continue                      # padding lane
                priv = word_to_int(job[int(j)])
                if priv == 0:
                    continue                      # 0*G has no pubkey
                h = common.derive_h160(priv, is33)
                if not self.filt.confirm(bytes.fromhex(h)):
                    continue                      # device prefilter false positive
                trace.count("mul.confirmed")
                f = Found(label=label, h160=h, priv=priv)
                out.append(f)
                self.k_found += 1
                if on_found:
                    on_found(f)
        return out
