// K4: the chords of one `add` step, with the center advance and the
// endomorphism rows, in two launches around K2.
//
// Ports the compiled body of ecloop_tpu/search/add.py:make_step around its
// two Pallas kernels (the chords and the endo synthesis, which XLA fuses
// on the TPU); the plain forms are ecloop_tpu_torch/ecc.py:chord_dx_plain
// and chord_points_plain.  Geometry: M centers C[m], a table of K/2
// positive multiples T[j] = (j+1)*s*G, the advance point D, h = K/2.
//
//   chord_dx_kernel      K2's input, one (16, M*K/2 + M) buffer:
//                        element m*K/2 + j is T[j].x - C[m].x, element
//                        M*K/2 + m is D.x - C[m].x.
//   chord_points_kernel  thread m*K/2 + j (one per pair) computes C + T[j]
//                        and C - T[j] with their shared inverse and writes
//                        them to the flat layout of center m's K keys,
//                        [flip(minus), center, plus[:-1]]: minus j at
//                        offset h-1-j, plus j at h+1+j (dropped for
//                        j = K/2-1).  Thread M*K/2 + m writes the center
//                        at offset h and its advance C + D into ncx, ncy.
//                        Every point written also gets, as asked, its
//                        rows beta*x and beta^2*x and -y.
//
// Every value is canonical (< p): field.cuh's fe_sub and fe_mul reduce
// fully, so each output equals the plain form's bit for bit, also for
// the inputs that mean nothing (a center at infinity stored as (0, 0), a
// zero inverse).  Centers are read from cx, cy and the advanced ones
// written to their own buffer, never in place.
//
// Bound: at 32 x 4096 without endo about 42 MB of limbs per step (the
// two (16, M*K) output planes dominate), against ~6 modular products per
// pair, so bytes; with beta rows the two extra products per key and
// planes keep it there.  One thread per pair holds the center, the table
// point and the chord in registers; the 16-bit int64 limbs are converted
// only at the edges (fe_load16, fe_store16), coalesced across the warp.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using ecl::fe;

// golden.BETA1 and golden.BETA2 = BETA1^2 mod p, little-endian words
__constant__ uint32_t BETA[2][8] = {
    {0x719501EEu, 0xC1396C28u, 0x12F58995u, 0x9CF04975u, 0xAC3434E9u, 0x6E64479Eu,
     0x657C0710u, 0x7AE96A2Bu},
    {0x8E6AFA40u, 0x3EC693D6u, 0xED0A766Au, 0x630FB68Au, 0x53CBCB16u, 0x919BB861u,
     0x9A83F8EFu, 0x851695D4u}};

struct Rows {  // the (16, M*K) output planes; bx1, bx2, ny may be null
  int64_t* x;
  int64_t* y;
  int64_t* bx1;
  int64_t* bx2;
  int64_t* ny;
};

// (rx, ry) = P + Q with inv = 1/(qx - px): ecc.affine_add_rows
__device__ __forceinline__ void chord(fe& rx, fe& ry, const fe& px, const fe& py,
                                      const fe& qx, const fe& qy, const fe& inv) {
  fe lam, t;
  ecl::fe_sub(lam, qy, py);
  ecl::fe_mul(lam, lam, inv);
  ecl::fe_mul(t, lam, lam);
  ecl::fe_sub(t, t, px);
  ecl::fe_sub(rx, t, qx);
  ecl::fe_sub(t, px, rx);
  ecl::fe_mul(t, lam, t);
  ecl::fe_sub(ry, t, py);
}

// the point (x, y) at flat key e of n, with its endo rows
__device__ __forceinline__ void store_point(const Rows& o, int64_t n, int64_t e, const fe& x,
                                            const fe& y) {
  ecl::fe_store16(o.x, n, e, x);
  ecl::fe_store16(o.y, n, e, y);
  if (o.bx1) {
    fe b, t;
#pragma unroll
    for (int i = 0; i < 8; ++i) b.v[i] = BETA[0][i];
    ecl::fe_mul(t, x, b);
    ecl::fe_store16(o.bx1, n, e, t);
#pragma unroll
    for (int i = 0; i < 8; ++i) b.v[i] = BETA[1][i];
    ecl::fe_mul(t, x, b);
    ecl::fe_store16(o.bx2, n, e, t);
  }
  if (o.ny) {
    fe z, t;
    ecl::fe_set(z, 0);
    ecl::fe_sub(t, z, y);
    ecl::fe_store16(o.ny, n, e, t);
  }
}

__global__ void __launch_bounds__(128)
    chord_dx_kernel(const int64_t* __restrict__ cx, const int64_t* __restrict__ tx,
                    const int64_t* __restrict__ dpx, int64_t m_, int64_t k2,
                    int64_t* __restrict__ out) {
  const int64_t nh = m_ * k2, total = nh + m_;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  fe a, c;
  if (t < nh) {
    ecl::fe_load16(a, tx, k2, t % k2);
    ecl::fe_load16(c, cx, m_, t / k2);
  } else {
    ecl::fe_load16(a, dpx, 1, 0);
    ecl::fe_load16(c, cx, m_, t - nh);
  }
  ecl::fe_sub(a, a, c);
  ecl::fe_store16(out, total, t, a);
}

__global__ void __launch_bounds__(128)
    chord_points_kernel(const int64_t* __restrict__ cx, const int64_t* __restrict__ cy,
                        const int64_t* __restrict__ tx, const int64_t* __restrict__ ty,
                        const int64_t* __restrict__ dpx, const int64_t* __restrict__ dpy,
                        const int64_t* __restrict__ inv, int64_t m_, int64_t k2, Rows o,
                        int64_t* __restrict__ ncx, int64_t* __restrict__ ncy) {
  const int64_t nh = m_ * k2, total = nh + m_, n = 2 * nh;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  fe x0, y0, ix;
  ecl::fe_load16(ix, inv, total, t);
  if (t < nh) {  // the pair C[m] +- T[j]
    const int64_t m = t / k2, j = t % k2;
    fe x1, y1, rx, ry;
    ecl::fe_load16(x0, cx, m_, m);
    ecl::fe_load16(y0, cy, m_, m);
    ecl::fe_load16(x1, tx, k2, j);
    ecl::fe_load16(y1, ty, k2, j);
    const int64_t base = m * 2 * k2 + k2;  // center m's key at offset h
    if (j < k2 - 1) {
      chord(rx, ry, x0, y0, x1, y1, ix);
      store_point(o, n, base + 1 + j, rx, ry);
    }
    fe z;
    ecl::fe_set(z, 0);
    ecl::fe_sub(y1, z, y1);  // C - T[j] = C + (T.x, -T.y)
    chord(rx, ry, x0, y0, x1, y1, ix);
    store_point(o, n, base - 1 - j, rx, ry);
  } else {  // the center itself, and its advance by D
    const int64_t m = t - nh;
    fe x1, y1, rx, ry;
    ecl::fe_load16(x0, cx, m_, m);
    ecl::fe_load16(y0, cy, m_, m);
    store_point(o, n, m * 2 * k2 + k2, x0, y0);
    ecl::fe_load16(x1, dpx, 1, 0);
    ecl::fe_load16(y1, dpy, 1, 0);
    chord(rx, ry, x0, y0, x1, y1, ix);
    ecl::fe_store16(ncx, m_, m, rx);
    ecl::fe_store16(ncy, m_, m, ry);
  }
}

unsigned blocks_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

// cx: (16, m) int64 limbs, tx: (16, k2), dpx: (16,); out: (16, m*k2 + m).
// Returns cudaGetLastError() after the launch.
extern "C" int ecl_chord_dx(const void* cx, const void* tx, const void* dpx, void* out,
                            long long m, long long k2, void* stream) {
  if (m <= 0 || k2 <= 0) return 0;
  const int threads = 128;
  chord_dx_kernel<<<blocks_for(m * k2 + m, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)cx, (const int64_t*)tx, (const int64_t*)dpx, (int64_t)m, (int64_t)k2,
      (int64_t*)out);
  return (int)cudaGetLastError();
}

// cx, cy: (16, m); tx, ty: (16, k2); dpx, dpy: (16,); inv: (16, m*k2 + m),
// K2's output on chord_dx's buffer.  x, y (and bx1, bx2, ny where not
// null): (16, 2*m*k2) planes; ncx, ncy: (16, m), not aliasing cx, cy.
// Returns cudaGetLastError() after the launch.
extern "C" int ecl_chord_points(const void* cx, const void* cy, const void* tx, const void* ty,
                                const void* dpx, const void* dpy, const void* inv, void* x,
                                void* y, void* bx1, void* bx2, void* ny, void* ncx, void* ncy,
                                long long m, long long k2, void* stream) {
  if (m <= 0 || k2 <= 0) return 0;
  const int threads = 128;
  const Rows o{(int64_t*)x, (int64_t*)y, (int64_t*)bx1, (int64_t*)bx2, (int64_t*)ny};
  chord_points_kernel<<<blocks_for(m * k2 + m, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)cx, (const int64_t*)cy, (const int64_t*)tx, (const int64_t*)ty,
      (const int64_t*)dpx, (const int64_t*)dpy, (const int64_t*)inv, (int64_t)m, (int64_t)k2, o,
      (int64_t*)ncx, (int64_t*)ncy);
  return (int)cudaGetLastError();
}
