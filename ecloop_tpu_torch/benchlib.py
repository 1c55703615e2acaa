"""Microbenchmarks and the scalar-mul cross-check (the counterpart of
`ecloop_tpu.benchlib`; reference lib/bench.c: run_bench 17-112,
run_bench_gtable 114-141, mult_verify 143-166).

On the card every bench row runs R iterations of its body, each
depending on the last, inside a CUDA graph: all R iterations in one
graph when the body is a few kernels, one iteration replayed R times
when it is plain torch glue of thousands of ops.  The graph takes the
place of the JAX bench's jit(fori_loop): without the host's launch cost
a row reads the device's rate.  Times are CUDA events around replays
after a warm-up replay.  Kernel launches count at the warm-up and at
every replay (`kernels.LAUNCHES`, `graphs.Graph`).  On the CPU the same
bodies run eagerly, once: a check of the path, not a measurement.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from . import bloom, ecc, fel, filters, golden, graphs, kernels, sol
from .search import mul
from .search.common import SearchConfig

TIME_WINDOW_S = 0.5      # a card timing runs calls until at least this long
M16 = 0xFFFF
VERIFY_BATCH = {"cuda": 16384, "cpu": 2048}
# the JAX bench's rows, in its order; a name stating a TPU geometry
# (`fe_grpinv (batched, lanes=...)`) states the port's
ROW_NAMES = (
    "fe_mul (rows)", "fe_sqr (rows)", "fe_inv (fermat chain)",
    "fe_grpinv (batched, K2 blocks of {})", "ec_affine_add pair (chord, rows)",
    "ec_proj_add (v1)", "ec_proj_dbl (v1)", "ec_jac_add (v2)",
    "ec_jac_dbl (v2)", "ec_scalar_mul (double-and-add)",
    "ec_gtable_mul (w=%d, rows)", "addr33 (hash160 compressed, rows)",
    "addr65 (hash160 uncompressed, rows)", "bloom probe_pow2 (2 probes, rows)")


class Loop:
    """`iters` iterations of body(*state) -> new state, each writing the
    new state into the state tensors (a tensor the body returns as it
    is, updated in place, is not copied): on a CUDA device one
    `graphs.Graph` of all iterations, which each call replays, after a
    warm-up iteration at set-up."""

    def __init__(self, body, state, iters: int = 1):
        self.state = tuple(state)

        def step(_):
            for s, o in zip(self.state, body(*self.state)):
                if o is not s:
                    s.copy_(o)
        self.graph = graphs.Graph(step, self.state[0].device, iters)

    def __call__(self) -> None:
        self.graph()


class ScalarMul:
    """ecc.scalar_mul(k) for a fixed scalar tensor k.  On the card one
    bit step (`ecc.scalar_mul_step`, bit index in a device tensor) is
    captured once and replayed for each of the 256 bits; on the CPU it is
    the plain loop."""

    def __init__(self, k: torch.Tensor):
        self.k = k
        self.loop = None
        if k.is_cuda:
            acc, base, i = ecc.scalar_mul_start(k)
            self.start = (*acc, *base, i)
            self.state = [t.clone(memory_format=torch.contiguous_format)
                          for t in self.start]

            def body(ax, ay, az, bx, by, bz, i):
                a, b = ecc.scalar_mul_step((ax, ay, az), (bx, by, bz), k, i)
                return (*a, *b, i + 1)
            self.loop = Loop(body, self.state)

    def __call__(self):
        """k * G as projective (x, y, z); on the card the tensors are
        the loop's state, overwritten by the next call."""
        if self.loop is None:
            return ecc.scalar_mul(self.k)
        for s, v in zip(self.state, self.start):
            s.copy_(v)
        for _ in range(ecc.SCALAR_BITS):
            self.loop()
        return tuple(self.state[:3])


def seconds_per_call(run, device: torch.device) -> float:
    """On the card: one warm-up call, then CUDA events around runs of
    1, 2, 4, ... calls until one lasts TIME_WINDOW_S.  On the CPU: one
    call on the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    run()
    n = 1
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        if ms >= TIME_WINDOW_S * 1e3:
            return ms / n / 1e3
        n *= 2


def rand_limbs(rng: np.random.Generator, n: int, device) -> torch.Tensor:
    return torch.from_numpy(fel.random_limbs(rng, n)).to(device)


def _keys(rng: np.random.Generator, n: int) -> list[int]:
    return [int.from_bytes(rng.bytes(32), "little") % golden.N
            for _ in range(n)]


def _window_index(keys: list[int], w: int, device):
    """Flat table indices and skip mask of the keys' window digits, (d, B)
    and contiguous as the `mul` step makes them."""
    dig = np.ascontiguousarray(mul.window_digits(keys, w).T, dtype=np.int32)
    return mul.window_index(torch.from_numpy(dig).to(device),
                            mul.window_offsets(w, device))


def _ops(body, *state) -> float:
    """Priced field operations per element of one iteration of body,
    counted on copies of the first 4 lanes on the CPU."""
    small = [t[..., :4].cpu().clone() for t in state]
    return sol.ops_per_element(body, *small, elems=4)


def bench_rows(device, B: int | None = None, R: int | None = None,
               only: list[str] | None = None, emit=print) -> list[dict]:
    """Measure the bench rows on `device` and print each as it is
    measured.  Each row: its name, M it/s, the form (graph or eager),
    iterations and elements per iteration, seconds per iteration, and on
    the card its bound (M it/s, what binds it, the share measured/bound)
    and the kernel launches made while it was set up and timed."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    B = B or int(os.environ.get("ECLOOP_BENCH_B", 131072 if on_card else 2048))
    R = R or int(os.environ.get("ECLOOP_BENCH_R", 512 if on_card else 4))
    B = max(1024, B - B % 1024)
    if only is None:
        only = [s.strip() for s in os.environ.get(
            "ECLOOP_BENCH_ONLY", "").split(",") if s.strip()]
    rng = np.random.default_rng(42)
    int_ops, mem_bps = sol.peaks() if on_card else (None, None)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    emit(f"# device: {kind} x{torch.cuda.device_count() if on_card else 1} "
         f"~ B={B} R={R} ({'CUDA graphs' if on_card else 'eager, CPU'}; "
         f"production forms)")
    rows = []

    def want(name: str) -> bool:
        return not only or any(s in name for s in only)

    def bench(name, body, state, r, elems, account, unroll=False,
              run=None):
        """One row: r iterations of body over state (or `run`, one
        iteration, where a row is not one Loop), elems elements per
        iteration, account = (bytes, operations) per iteration."""
        t0 = time.perf_counter()
        before = dict(kernels.LAUNCHES)
        if run is None:
            loop = Loop(body, state, iters=r if unroll else 1)
            calls = 1 if unroll else r

            def run():
                for _ in range(calls):
                    loop()
            form = (f"graph of {r} iterations" if unroll else
                    f"graph of 1 iteration x {r}") if on_card else "eager"
        else:
            one = run

            def run():
                for _ in range(r):
                    one()
            form = "graph per bit step" if on_card else "eager"
        sec = seconds_per_call(run, device) / r
        launches = {k: n - before[k] for k, n in kernels.LAUNCHES.items()}
        row = {"name": name, "mits": elems / sec / 1e6, "form": form,
               "iters": r, "elems": elems, "s_per_iter": sec,
               "launches": launches}
        text = f"{name:42s}: {row['mits']:10.3f} M it/s"
        if int_ops:
            b_ms, by = sol.bound(*account, int_ops, mem_bps)
            row.update(bound_mits=elems / b_ms / 1e3, bound_by=by,
                       share=b_ms / 1e3 / sec)
            text += (f"  [bound {row['bound_mits']:10.3f} M it/s by {by}"
                     f" ~ {row['share']:7.2%}; {form}]")
        else:
            text += f"  [{form}]"
        rows.append(row)
        emit(text)
        if os.environ.get("ECLOOP_BENCH_VERBOSE"):
            emit(f"  [{name}: total {time.perf_counter() - t0:.1f}s]")

    limb = sol.LIMB_BYTES
    a, b = rand_limbs(rng, B, device), rand_limbs(rng, B, device)

    name = ROW_NAMES[0]
    if want(name):
        body = lambda a, b: (fel.mul_mod(a, b), b)  # noqa: E731
        bench(name, body, (a, b), R, B,
              (B * 48 * limb, B * _ops(body, a, b)))
    name = ROW_NAMES[1]
    if want(name):
        body = lambda a: (fel.sqr_mod(a),)  # noqa: E731
        bench(name, body, (a,), R, B, (B * 32 * limb, B * _ops(body, a)))
    name = ROW_NAMES[2]
    if want(name):
        body = lambda a: (fel.inv_mod(a),)  # noqa: E731
        bench(name, body, (a,), max(1, R // 64), B,
              (B * 32 * limb, B * _ops(body, a)))
    name = ROW_NAMES[3].format(sol.K2_BLOCK)
    if want(name):
        bench(name, lambda a: (kernels.inv_mod_batch(a),), (a,),
              max(1, R // 16), B, sol.inv_account(B), unroll=True)

    # the production chord pair (search/add.make_step's K4): chord_dx and
    # chord_points of one step of B keys (m centers x k, k = 4096 where B
    # allows; the denominators stand in for their inverses), each
    # iteration's advanced centers feeding the next; elements are keys
    name = ROW_NAMES[4]
    if want(name):
        k = math.gcd(B, 4096)
        m = B // k
        tx, ty = rand_limbs(rng, k // 2, device), rand_limbs(rng, k // 2, device)
        dpx, dpy = (rand_limbs(rng, 1, device)[:, 0].contiguous()
                    for _ in range(2))

        def chord(cx, cy):
            dx = kernels.chord_dx(cx, tx, dpx)
            _, _, ncx, ncy = kernels.chord_points(cx, cy, tx, ty, dpx, dpy, dx,
                                                  False, False)
            return ncx, ncy
        acc = sol.chord_account(m, k, False, False)
        bench(name, chord, (rand_limbs(rng, m, device),
                            rand_limbs(rng, m, device)), R, B,
              tuple(a + b for a, b in zip(acc["chord_dx"],
                                          acc["chord_points"])), unroll=True)

    # projective / Jacobian comparison rows (reference bench.c:24-36)
    bf = max(1024, B // 16)
    rf = max(1, R // 8)
    if any(want(n) for n in ROW_NAMES[5:9]):
        px, py = (fel.from_last(np.tile(c, (bf // 64, 1)), device)
                  for c in ecc.points_host(range(2, 66)))
        qx, qy = px.roll(1, 1), py.roll(1, 1)
        one = fel.const(1, px).expand_as(px).contiguous()
        forms = {ROW_NAMES[5]: ecc.proj_add, ROW_NAMES[6]: ecc.proj_dbl_rows,
                 ROW_NAMES[7]: ecc.jac_add, ROW_NAMES[8]: ecc.jac_dbl}
        for name, form in forms.items():
            if not want(name):
                continue
            if form in (ecc.proj_add, ecc.jac_add):
                body = (lambda ax, ay, az, bx, by, add=form:
                        (*add(ax, ay, az, bx, by, az), bx, by))
                st = tuple(t.clone() for t in (px, py, one, qx, qy))
                limbs = 128
            else:
                body, limbs = form, 96
                st = tuple(t.clone() for t in (px, py, one))
            bench(name, body, st, rf, bf,
                  (bf * limbs * limb, bf * _ops(body, *st)))

    name = ROW_NAMES[9]
    if want(name):
        k = fel.ints_to_tensor(_keys(rng, bf), device)
        smul = ScalarMul(k)

        def daa_iter():
            x = smul()[0]
            k.copy_(fel.select((x[0] & 1) == 1, k, k.roll(1, 1)))
        step = lambda ax, ay, az, bx, by, bz, kk, i: ecc.scalar_mul_step(  # noqa: E731
            (ax, ay, az), (bx, by, bz), kk, i)
        acc, base, i = ecc.scalar_mul_start(k[..., :4].cpu())
        with sol.count_field_ops() as calls:
            step(*acc, *base, k[..., :4].cpu(), i)
        ops = ecc.SCALAR_BITS * sol.price(calls) / 4 + sol.FE_TEST_OPS
        bench(name, None, None, max(1, R // 256), bf,
              (bf * 32 * limb, bf * ops), run=daa_iter)

    # the production window scan (search/mul.window_scan): K3 per window
    w = int(os.environ.get("ECLOOP_GTABLE_W", mul.W))
    name = ROW_NAMES[10] % w
    if want(name):
        txy = mul.build_gtable(w, device)
        idx, skip = _window_index(_keys(rng, B), w, device)
        st = (a.clone(), b.clone(), rand_limbs(rng, B, device))
        account = sol.scan_account(B, idx.shape[0], int((~skip).sum()))
        bench(name, lambda qx, qy, qz: mul.window_scan(txy, idx, skip,
                                                       (qx, qy, qz)),
              st, max(1, R // 128), B, account, unroll=True)

    for name, k1, is33 in ((ROW_NAMES[11], kernels.addr33_hash_rows, True),
                           (ROW_NAMES[12], kernels.addr65_hash_rows, False)):
        if want(name):
            def fold(x, y, k1=k1):
                x[0].bitwise_xor_(k1(x, y)[0] & M16)
                return x, y
            bench(name, fold, (a.clone(), b.clone()), R, B,
                  sol.hash_account(B, is33, sol.hash_counts(is33)),
                  unroll=True)

    # the hash-list prefilter probe (K5, pow2 over a 2^16-bit array), each
    # iteration's hit words folded into the next one's first hash words;
    # the bit words read are those of the first iteration's data
    name = ROW_NAMES[13]
    if want(name):
        bits = bloom.bits_tensor(rng.integers(0, 1 << 32, size=1 << 11,
                                              dtype=np.uint64).astype(
                                                  np.uint32), device)
        filt = filters.Filter(mode="list", targets=None, blf=None,
                              device_bits=None, pow2_log2=16)

        def probe(h):
            h[0, :B // 32].bitwise_xor_(kernels.probe_pack(filt, h, bits))
            return (h,)
        h = a[:5].clone()
        bench(name, probe, (h,), R, B, sol.probe_pack_account(
            B, "pow2", sol.probe_reads(filt, h, bits), bits_words=bits.numel()),
            unroll=True)
    return rows


def run_bench(device) -> int:
    """`bench`: the rows, then the `add` step's speed-of-light budget
    (ECLOOP_BENCH_SOL=0 leaves it out; on the CPU it needs the peak
    overrides of `sol.peaks`)."""
    bench_rows(device)
    if os.environ.get("ECLOOP_BENCH_SOL", "1") == "1":
        try:
            text = sol.report(SearchConfig(endo=True))
        except RuntimeError as e:
            text = f"# speed-of-light budget: {e}"
        print()
        print(text)
    return 0


def gtable_sweep(device, ws: list[int] | None = None,
                 emit=print) -> list[dict]:
    """Window-width sweep (reference bench.c:114-141): per width the
    table's size and memory (the port's int64 layout: 256 bytes a
    point), its build time on `device`, the window scan's rate over
    ECLOOP_BENCH_B keys (32,768 on the card), its ceiling (`sol.mul_ceiling`, scan only) and the device's
    peak memory over build and scan."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if ws is None:
        ws = [int(w) for w in os.environ.get(
            "ECLOOP_GTABLE_WS", "8 10 12 14 16 18 20 22" if on_card
            else "8 10 12 14").split()]
    B = int(os.environ.get("ECLOOP_BENCH_B", 32768 if on_card else 1024))
    rng = np.random.default_rng(7)
    keys = _keys(rng, B)
    cfg = SearchConfig(addr33=True, addr65=False)
    try:
        leaf = sol.leaf_budgets()
        sol.peaks()
    except RuntimeError:
        leaf = None
    emit(f"{'W':>3} | {'G_SIZE':>10} | {'MEM':>9} | {'BUILD_T':>8} |"
         f" {'MUL_RATE':>12} | {'CEILING':>10} | {'BOUND':>10} | {'PEAK':>9}")
    rows = []
    for w in ws:
        npoints = mul.n_windows(w) * ((1 << w) - 1)
        mem_mb = npoints * 32 * sol.LIMB_BYTES / 2**20
        mul.build_gtable.cache_clear()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            txy = mul.build_gtable(w, device)
            if on_card:
                torch.cuda.synchronize(device)
        except torch.cuda.OutOfMemoryError as e:
            emit(f"{w:>3} | {npoints:>10,} | {mem_mb:>7.1f}MB | "
                 f"build failed: {type(e).__name__}")
            rows.append({"w": w, "g_size": npoints, "mem_mb": mem_mb,
                         "failed": type(e).__name__})
            continue
        build_s = time.perf_counter() - t0
        idx, skip = _window_index(keys, w, device)
        zero = torch.zeros((fel.NLIMBS, B), dtype=torch.int64, device=device)
        one = fel.const(1, zero).expand(fel.NLIMBS, B).contiguous()
        loop = Loop(lambda *q: mul.window_scan(txy, idx, skip,
                                               (zero, one, zero)),
                    [torch.empty_like(zero) for _ in range(3)])
        rate = B / seconds_per_call(loop, device) / 1e6
        row = {"w": w, "g_size": npoints, "mem_mb": mem_mb,
               "build_s": build_s, "mul_rate_mkeys": rate}
        ceil_txt, binding = "n/a", ""
        if leaf:
            c = sol.mul_ceiling(cfg, w, leaf, scan_only=True)
            row.update(ceiling_mkeys=c["ceiling_keys_per_s"] / 1e6,
                       binding=c["binding"])
            ceil_txt = f"{row['ceiling_mkeys']:7.2f} M/s"
            binding = c["binding"]
        peak = "n/a"
        if on_card:
            row["peak_mb"] = torch.cuda.max_memory_allocated(device) / 2**20
            peak = f"{row['peak_mb']:7.0f}MB"
        rows.append(row)
        emit(f"{w:>3} | {npoints:>10,} | {mem_mb:>7.1f}MB | {build_s:>7.2f}s"
             f" | {rate:>8.3f} M/s | {ceil_txt:>10} | {binding:>10} | "
             f"{peak:>9}")
        del txy, loop
    mul.build_gtable.cache_clear()
    return rows


def run_bench_gtable(device) -> int:
    gtable_sweep(device)
    return 0


def verify_keys(count: int) -> list[int]:
    """mult-verify's seeded scalars, in [1, n - 1]."""
    rng = np.random.default_rng(1337)
    return [1 + int.from_bytes(rng.bytes(32), "little") % (golden.N - 1)
            for _ in range(count)]


def mult_verify(device, count: int | None = None,
                table: torch.Tensor | None = None) -> int:
    """Cross-check the production window scan (`mul.window_scan`, K3)
    with curve membership on seeded scalars (reference mult_verify,
    bench.c:143-166): on the card against the plain double-and-add
    (`ecc.scalar_mul`), both reduced to affine by K2; on the CPU against
    the golden model.  Prints `OK: ...` and returns 0, or a `FAILED:`
    line and 1.  ECLOOP_VERIFY_N scalars (16,000), window width
    ECLOOP_VERIFY_W (14); `table` replaces the built table."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    count = count or int(os.environ.get("ECLOOP_VERIFY_N", 16000))
    w = int(os.environ.get("ECLOOP_VERIFY_W", 14))
    txy = mul.build_gtable(w, device) if table is None else table
    keys_all = verify_keys(count)
    batch = min(count, VERIFY_BATCH[device.type])
    done = 0
    t0 = time.perf_counter()
    while done < count:
        keys = keys_all[done:done + batch]
        n = len(keys)
        idx, skip = _window_index(keys, w, device)
        q = ecc.proj_infinity(torch.empty((fel.NLIMBS, n), dtype=torch.int64,
                                          device=device))
        q = tuple(t.contiguous() for t in q)
        gx, gy, gz = mul.window_scan(txy, idx, skip, q)
        if on_card:
            bx, by = ecc.proj_to_affine_rows(gx, gy, gz,
                                             inv=kernels.inv_mod_batch)
            kl = fel.ints_to_tensor(keys, device)
            ax, ay = ecc.proj_to_affine_rows(*ScalarMul(kl)(),
                                             inv=kernels.inv_mod_batch)
            if not bool((ecc.on_curve(ax, ay) & ecc.on_curve(bx, by)).all()):
                print("FAILED: point off curve")
                return 1
            if not (torch.equal(ax, bx) and torch.equal(ay, by)):
                print("FAILED: gtable vs double-and-add mismatch")
                return 1
        else:
            xs, ys, zs = (fel.tensor_to_ints(t) for t in (gx, gy, gz))
            for k, x, y, z in zip(keys, xs, ys, zs):
                zi = pow(z, -1, golden.P) if z else 0
                pt = (x * zi % golden.P, y * zi % golden.P)
                if not golden.on_curve(pt):
                    print("FAILED: point off curve")
                    return 1
                if pt != golden.point_mul(k):
                    print("FAILED: gtable vs golden-oracle mismatch")
                    return 1
        done += n
        dt = time.perf_counter() - t0
        print(f"\r{done:,} / {count:,} ~ {done / dt / 1000:.1f} K/s",
              end="", flush=True)
    print("\nOK: all multiplications verified")
    return 0
