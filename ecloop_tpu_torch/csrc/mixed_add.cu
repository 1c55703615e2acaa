// K3: one window step of the `mul` gtable scan, a mixed projective +
// affine point addition with a skip passthrough.
//
// Replaces ecloop_tpu/pallas_kernels.py:_mixed_add_kernel (with
// _build_mixed_add and proj_add_affine_pallas).  Contract, per lane e:
//   out[e] = q[e]              where skip[e]
//          = q[e] + g[e]       otherwise,
// with q = (qx : qy : qz) homogeneous projective (qz = 0 is infinity),
// g = (gx, gy) affine, and the sum in the formulas of
// ecloop_tpu/ecc.py:proj_add_affine_rows, op for op: X:Y:Z is not a
// canonical form, so only the same formulas give the same limbs as the
// plain version (ecloop_tpu_torch/ecc.py).  COMPLETE adds the doubling
// for q == g; the incomplete form is compiled without it.  P = inf gives
// (gx : gy : 1); P == -g gives z = 0.
//
// One thread per lane holds the five coordinates as 8 x 32-bit words in
// registers and converts from and to the port's 16-bit int64 limbs only
// at its edges.  Where the TPU evaluates every branch and selects, a
// thread here takes only its own branch: skip and infinity lanes store
// and leave, and the doubling runs only on a lane that needs it.
//
// Bound: 32-bit integer multiplies.  The incomplete add is 12 modular
// multiplies (64 mul.wide.u32 each, plus the fold) and a few add/sub per
// lane; memory traffic is 80 input limbs, 1 skip byte and 48 output
// limbs per lane, 1,033 bytes.
//
// Launches on the given stream, allocates nothing, does not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using ecl::fe;

// (x3 : y3 : z3) = 2 (x1 : y1 : z1), the formulas of
// ecloop_tpu/ecc.py:proj_dbl_rows.
__device__ __forceinline__ void proj_dbl(fe& x3, fe& y3, fe& z3, const fe& x1,
                                         const fe& y1, const fe& z1) {
  fe w, s, b, h, t, u;
  ecl::fe_mul(w, x1, x1);
  ecl::fe_mul_small(w, w, 3);
  ecl::fe_mul(s, y1, z1);
  ecl::fe_mul(b, x1, y1);
  ecl::fe_mul(b, b, s);
  ecl::fe_mul(h, w, w);
  ecl::fe_mul_small(t, b, 8);
  ecl::fe_sub(h, h, t);
  ecl::fe_mul_small(t, h, 2);
  ecl::fe_mul(x3, t, s);
  ecl::fe_mul_small(t, b, 4);
  ecl::fe_sub(t, t, h);
  ecl::fe_mul(t, w, t);
  ecl::fe_mul(u, y1, s);
  ecl::fe_mul(u, u, u);
  ecl::fe_mul_small(u, u, 8);
  ecl::fe_sub(y3, t, u);
  ecl::fe_mul(t, s, s);
  ecl::fe_mul(t, t, s);
  ecl::fe_mul_small(z3, t, 8);
}

template <bool COMPLETE>
__global__ void __launch_bounds__(128)
    mixed_add_kernel(const int64_t* __restrict__ qx, const int64_t* __restrict__ qy,
                     const int64_t* __restrict__ qz, const int64_t* __restrict__ gx,
                     const int64_t* __restrict__ gy, const uint8_t* __restrict__ skip,
                     int64_t* __restrict__ out, int64_t n) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  int64_t* ox = out;
  int64_t* oy = out + 16 * n;
  int64_t* oz = out + 32 * n;

  fe x1, y1, z1;
  ecl::fe_load16(x1, qx, n, e);
  ecl::fe_load16(y1, qy, n, e);
  ecl::fe_load16(z1, qz, n, e);
  if (skip[e]) {
    ecl::fe_store16(ox, n, e, x1);
    ecl::fe_store16(oy, n, e, y1);
    ecl::fe_store16(oz, n, e, z1);
    return;
  }
  fe x2, y2;
  ecl::fe_load16(x2, gx, n, e);
  ecl::fe_load16(y2, gy, n, e);
  if (ecl::fe_is_zero(z1)) {  // P = inf: the table point itself
    fe one;
    ecl::fe_set(one, 1);
    ecl::fe_store16(ox, n, e, x2);
    ecl::fe_store16(oy, n, e, y2);
    ecl::fe_store16(oz, n, e, one);
    return;
  }

  fe u, v;
  ecl::fe_mul(u, y2, z1);
  ecl::fe_sub(u, u, y1);
  ecl::fe_mul(v, x2, z1);
  ecl::fe_sub(v, v, x1);
  fe x3, y3, z3;
  if (COMPLETE && ecl::fe_is_zero(v) && ecl::fe_is_zero(u)) {  // P == Q
    proj_dbl(x3, y3, z3, x1, y1, z1);
  } else {
    fe vsq, vcu, vx, a, t;
    ecl::fe_mul(vsq, v, v);
    ecl::fe_mul(vcu, vsq, v);
    ecl::fe_mul(vx, vsq, x1);
    ecl::fe_mul(a, u, u);
    ecl::fe_mul(a, a, z1);
    ecl::fe_sub(a, a, vcu);
    ecl::fe_mul_small(t, vx, 2);
    ecl::fe_sub(a, a, t);
    ecl::fe_mul(x3, v, a);
    ecl::fe_sub(t, vx, a);
    ecl::fe_mul(t, u, t);
    ecl::fe_mul(y3, vcu, y1);
    ecl::fe_sub(y3, t, y3);
    ecl::fe_mul(z3, vcu, z1);
  }
  ecl::fe_store16(ox, n, e, x3);
  ecl::fe_store16(oy, n, e, y3);
  ecl::fe_store16(oz, n, e, z3);
}

}  // namespace

// qx, qy, qz, gx, gy: (16, n) int64 limbs; skip: n bytes (0 or 1); out:
// (48, n) int64, the x, y and z limbs of the result.  Returns
// cudaGetLastError() after the launch.
extern "C" int ecl_mixed_add(const void* qx, const void* qy, const void* qz,
                             const void* gx, const void* gy, const void* skip, void* out,
                             long long n, int complete, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  auto kern = complete ? mixed_add_kernel<true> : mixed_add_kernel<false>;
  kern<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)qx, (const int64_t*)qy, (const int64_t*)qz, (const int64_t*)gx,
      (const int64_t*)gy, (const uint8_t*)skip, (int64_t*)out, (int64_t)n);
  return (int)cudaGetLastError();
}
