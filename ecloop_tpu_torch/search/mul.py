"""`mul` mode: scalar multiplication of arbitrary private keys (stdin
lists) through a windowed table of multiples of G.

The port of `ecloop_tpu.search.mul`.  With w-bit windows a key has
d = 255 // w + 1 digits; row i of the table holds j * 2^(w*i) * G for
j = 1 .. 2^w - 1, so k*G is the sum of at most d table points and no
doublings.  Per job of B keys the host sends the job's lines (`-raw`)
or key words, K8 derives the keys and cuts their digits on the device,
which then adds one gathered table point per window into a projective
accumulator (K3), reduces to affine with one batched inversion (K2),
hashes (K1) and probes the filter; only packed hit masks come back, and
the host confirms every hit with exact filter semantics.

Table layout: flat index (2^w - 1) * i + j - 1 holds j * 2^(w*i) * G,
as one (32, N) int64 tensor, x limbs over y limbs (the counterpart of
`interleave_gtable`), so one gather serves both coordinates.
"""

from __future__ import annotations

import collections
import functools
import os

import numpy as np
import torch

from .. import bloom, ecc, fel, golden, graphs, kernels, trace
from ..filters import Filter
from ..keys import (keys_to_words, parse_keys, window_digits_words,
                    word_to_int, words_mod_n)
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

def window_digits(keys: list[int], w: int) -> np.ndarray:
    return window_digits_words(keys_to_words(keys), w)


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


class LineJob:
    """A job's `-raw` lines packed for K8: `buf` (uint8) holds each line's
    UTF-8 bytes followed by one separator byte (the last line's is left
    out), `offs` (n + 1,) int64 their offsets: line e is
    buf[offs[e]:offs[e + 1] - 1].  The engine's job interface, which
    `WordsJob` shares: len, a slice of lanes, a lane's key, the SHA-256
    blocks hashed, the host block to upload and K8 on its device copy."""

    def __init__(self, buf: np.ndarray, offs: np.ndarray):
        self.buf, self.offs = buf, offs

    def __len__(self) -> int:
        return len(self.offs) - 1

    def __getitem__(self, s: slice) -> "LineJob":
        """Lines [s.start, s.stop) as a job of their own (a shard's)."""
        lo, hi, _ = s.indices(len(self))
        o = self.offs[lo:max(lo, hi) + 1]
        return LineJob(self.buf[o[0]:max(o[0], o[-1] - 1)], o - o[0])

    def key(self, e: int) -> int:
        """Line e's private key: parse_keys' -raw key mod n."""
        line = self.buf[self.offs[e]:self.offs[e + 1] - 1].tobytes().decode()
        return parse_keys([line], True)[0] % N

    def sha_blocks(self) -> int:
        """SHA-256 blocks of the lines: ceil((len + 9) / 64) each."""
        return int(((np.diff(self.offs) - 1 + 72) // 64).sum())

    def host(self, pin: bool) -> torch.Tensor:
        """The offsets, then the bytes, in one uint8 block of its own."""
        head = 8 * len(self.offs)
        out = torch.empty(head + len(self.buf), dtype=torch.uint8,
                          pin_memory=pin)
        flat = out.numpy()
        flat[:head] = self.offs.view(np.uint8)
        flat[head:] = self.buf
        return out

    def derive(self, src: torch.Tensor, dig: torch.Tensor, w: int) -> None:
        """K8 on `host()`'s copy on dig's device."""
        head = 8 * len(self.offs)
        kernels.mul_keys_lines(src[head:], src[:head].view(torch.int64), dig, w)


class WordsJob:
    """A job's keys as (n, 4) u64 little-endian word rows (hex lines,
    run_keys), with `LineJob`'s interface."""

    def __init__(self, words: np.ndarray):
        self.words = words

    def __len__(self) -> int:
        return len(self.words)

    def __getitem__(self, s: slice) -> "WordsJob":
        return WordsJob(self.words[s])

    def key(self, e: int) -> int:
        return word_to_int(self.words[e]) % N

    def sha_blocks(self) -> int:
        return 0

    def host(self, pin: bool) -> torch.Tensor:
        out = torch.empty((len(self.words), 4), dtype=torch.int64,
                          pin_memory=pin)
        out.numpy()[:] = self.words.view(np.int64)
        return out

    def derive(self, src: torch.Tensor, dig: torch.Tensor, w: int) -> None:
        kernels.mul_keys_words(src, dig, w)


def pack_lines(lines: list[str]) -> LineJob:
    """Stripped, non-empty lines -> their LineJob, in O(1) Python calls:
    one join and encode, the offsets from one newline scan.  UTF-8 puts
    byte 0x0A only where the text has "\n", so each slice is the line's
    own encoding; a line that holds "\n" itself (from an API caller,
    never from the CLI) sends the job down a line-by-line pack."""
    buf = np.frombuffer("\n".join(lines).encode(), np.uint8)
    nl = np.flatnonzero(buf == 0x0A)
    if len(nl) == max(len(lines) - 1, 0):
        offs = np.empty(len(lines) + 1, np.int64)
        offs[-1] = len(buf) + 1
        offs[0] = 0
        offs[1:-1] = nl + 1
        return LineJob(buf, offs)
    trace.count("mul.pack_fallback")
    enc = [ln.encode() for ln in lines]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(b) + 1 for b in enc], out=offs[1:])
    return LineJob(np.frombuffer(b"\n".join(enc), np.uint8), offs)


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
        self.w = w
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

    def upload(self, job, mark=trace.OFF) -> None:
        """Put the digits of a job of at most batch keys into `dig`: the
        job (a LineJob or a WordsJob) goes to the device in one copy
        through pinned memory of its own, then K8 cuts the digits there,
        zeros past the job's keys.  Both are queued on the current stream
        of `dig`'s device, where the replay that reads them runs too: the
        host does not wait.  The job's device mark starts at the copy.
        On the CPU, K8's plain form cuts them."""
        dev = self.dig.device
        with trace.span("mul.upload"):
            host = job.host(pin=dev.type == "cuda")
            mark.start()
            src = host.to(dev, non_blocking=True)
            with trace.span("mul.digits") if dev.type == "cpu" else trace.OFF:
                job.derive(src, self.dig, self.w)
        if dev.type == "cuda":
            trace.count("mul.device_keys", len(job))

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

    def launch(self, job, mark=trace.OFF):
        """Queue the job on the block's keys (a LineJob or a WordsJob of
        n <= batch keys); returns the `common.fetch_async` handle of its
        (V, batch/32) masks.  `mark` (`trace.device_mark`) starts at the
        job's first enqueue."""
        self.call.upload(job, mark)
        with trace.span("mul.launch"):
            self.call()
            trace.count("mul.enqueues", 4)    # copy, K8, replay, fetch
            return common.fetch_async(self.call.masks)


class MulSearch:
    """Key-list search engine (reference cmd_mul) over one device or a
    list of n.

    Keys go to the devices in jobs of `batch`: key j of a job on shard
    j // (batch/n), so the found set is the one-device engine's.  Up to
    ECLOOP_MUL_INFLIGHT jobs (INFLIGHT unless set; read here, at build)
    stay queued, one depth for all shards, while the host packs the next
    job, and each job's masks come back through pinned memory
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

    def _launch(self, job) -> list:
        """Queue one job (a LineJob or a WordsJob, n <= batch keys), each
        shard's block of keys on its device; returns the shards' mask
        handles, each with the job's device mark on that shard."""
        b = self.batch // len(self.shards)
        out = []
        for i, s in enumerate(self.shards):
            mark = trace.device_mark("mul", s.device)
            out.append((s.launch(job[i * b:(i + 1) * b], mark), mark))
            mark.end()
        trace.count("mul.jobs")
        trace.count("mul.lanes", self.batch * len(self.labels))
        trace.count("mul.keys", len(job))
        blocks = job.sha_blocks()
        if blocks:
            trace.count("mul.sha_blocks", blocks)
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
        """Search key lines: hex, or with -raw any text (SHA-256 of its
        UTF-8 bytes, on the device).  Every line is stripped and the empty
        ones dropped."""
        with trace.span("mul.parse"):
            lines = [ln for ln in map(str.strip, lines) if ln]
            if not self.raw:
                words = parse_hex_words(lines)
                if words is None:
                    words = words_mod_n(keys_to_words(parse_keys(lines,
                                                                 False)))
        if not self.raw:
            return self.run_words(words, on_found=on_found, drain=drain)

        def jobs():
            for off in range(0, len(lines), self.batch):
                with trace.span("mul.parse"):
                    job = pack_lines(lines[off:off + self.batch])
                yield job
        return self._run(jobs(), on_found, drain)

    def run_words(self, words: np.ndarray, on_found=None,
                  drain: bool = True) -> list[Found]:
        """Queue jobs of `batch` keys given as (B, 4) u64 word rows
        reduced mod n.  With drain=False up to `depth` jobs
        (ECLOOP_MUL_INFLIGHT) stay queued across calls; the caller ends
        with flush()."""
        return self._run((WordsJob(words[off:off + self.batch])
                          for off in range(0, len(words), self.batch)),
                         on_found, drain)

    def _run(self, jobs, on_found, drain: bool) -> list[Found]:
        """Queue the jobs in turn, draining the oldest past `depth`.  A
        short job's padding lanes get digit 0 in every window (K8): they
        stay at infinity and _handle_hits drops them."""
        found = []
        for job in jobs:
            self._pending.append((job, self._launch(job), on_found))
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
                priv = job.key(int(j))
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
