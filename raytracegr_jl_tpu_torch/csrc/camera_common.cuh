// Device code of the camera frame, shared by K5 (shading.cu: the camera
// observer's frequency of the redshift shading) and K8/K9 (camera.cu: the
// null normalization of the pixel batch and its VJP): the Kerr-Schild
// metric at a point with its intermediate parts, the contraction
// u^a g_ab v^b, the 3x3 minors and column 0 of the metric's inverse. M, a
// and the clamp constants are arguments, so the callers read them from
// where they keep them (K5 from its constant parameter block, K8/K9 from
// device memory). Each follows the plain PyTorch version operation by
// operation (build with --fmad=false): ops/metrics.py kerr_schild,
// models/camera.py quad, ops/geometry.py det3 and inv4_column0.

#pragma once

#include "geodesic_common.cuh"

namespace {

// Kerr-Schild's parts at x, as ops/metrics.py kerr_schild (with
// clamped_rho2 and kerr_schild_radius) computes them; K9 runs them in
// reverse (models/camera.py pixel_rays_vjp names the same values).
template <typename T>
struct KerrParts {
  T aa, rho2_raw, floor, half, inner0, s, h, r, r2, r3, two_m, dn, f, denom;
  T k[4];
};

template <typename T>
__device__ __forceinline__ void kerr_parts(T M, T a, T eps2, T eps2_half,
                                           int r_mode, const T* x,
                                           KerrParts<T>& q) {
  const T xs = x[1], ys = x[2], zs = x[3];
  q.aa = a * a;
  q.rho2_raw = xs * xs + ys * ys + zs * zs;
  q.floor = r_mode == R_AS_WRITTEN ? q.aa + eps2 : eps2;
  const T rho2 = nmax(q.rho2_raw, q.floor);
  q.half = (rho2 - q.aa) * T(0.5);
  q.inner0 = sqrt(q.aa * zs * zs + q.half * q.half);
  if (r_mode == R_AS_WRITTEN) {
    q.s = sqrt(rho2 - q.aa);
    q.r = q.s * T(0.5) + q.inner0;
  } else if (r_mode == R_TEXTBOOK) {
    q.h = q.half + nmax(q.inner0, eps2_half);
    q.r = sqrt(nmax(q.h, eps2));
  } else {
    q.h = q.half + q.inner0;
    q.r = sqrt(q.h);
  }
  q.r2 = q.r * q.r;
  q.r3 = q.r * q.r2;
  q.two_m = T(2) * M;
  q.dn = q.r2 * q.r2 + q.aa * zs * zs;
  q.f = q.two_m * q.r3 / q.dn;
  q.denom = q.r2 + q.aa;
  q.k[0] = T(1);
  q.k[1] = (q.r * xs + a * ys) / q.denom;
  q.k[2] = (q.r * ys - a * xs) / q.denom;
  q.k[3] = zs / q.r;
}

// Minkowski's eta_ab.
template <typename T>
__device__ __forceinline__ void eta(T g[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      g[a][b] = a != b ? T(0) : (a == 0 ? T(-1) : T(1));
}

// g_ab = eta_ab + (f k_a) k_b.
template <typename T>
__device__ __forceinline__ void kerr_metric(const KerrParts<T>& q,
                                            T g[4][4]) {
  eta(g);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = g[i][j] + q.f * q.k[i] * q.k[j];
}

// The metric at x (Kerr-Schild, or Minkowski where KERR is false).
template <typename T, bool KERR>
__device__ __forceinline__ void metric_at(T M, T a, T eps2, T eps2_half,
                                          int r_mode, const T* x,
                                          T g[4][4]) {
  if constexpr (!KERR) {
    eta(g);
  } else {
    KerrParts<T> q;
    kerr_parts(M, a, eps2, eps2_half, r_mode, x, q);
    kerr_metric(q, g);
  }
}

// u^a g_ab v^b, the inner sums over b.
template <typename T>
__device__ __forceinline__ T quad(const T* u, const T g[4][4], const T* v) {
  T acc = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const T gv = g[a][0] * v[0] + g[a][1] * v[1] + g[a][2] * v[2]
                 + g[a][3] * v[3];
    acc = a == 0 ? u[a] * gv : acc + u[a] * gv;
  }
  return acc;
}

// The determinant of the 3x3 minor of m without row r and column c.
template <typename T>
__device__ __forceinline__ T det3(const T m[4][4], int r, int c) {
  int rs[3], cs[3];
  for (int i = 0, n = 0; i < 4; ++i)
    if (i != r) rs[n++] = i;
  for (int j = 0, n = 0; j < 4; ++j)
    if (j != c) cs[n++] = j;
  const T a = m[rs[0]][cs[0]], b = m[rs[0]][cs[1]], c0 = m[rs[0]][cs[2]];
  const T d = m[rs[1]][cs[0]], e = m[rs[1]][cs[1]], f = m[rs[1]][cs[2]];
  const T g = m[rs[2]][cs[0]], h = m[rs[2]][cs[1]], i = m[rs[2]][cs[2]];
  return a * (e * i - f * h) - b * (d * i - f * g) + c0 * (d * h - e * g);
}

// Column 0 of the metric's inverse, t = g^-1 (1, 0, 0, 0): row 0's
// cofactors cof over the determinant det, clamped away from 0 by det_min
// (ops/geometry.py inv4_column0). Returns det unclamped; inv_det is
// 1 / clamp(det).
template <typename T>
__device__ __forceinline__ T time_column(const T g[4][4], T det_min,
                                         T cof[4], T& inv_det, T t[4]) {
  T det = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cof[c] = (c % 2 ? T(-1) : T(1)) * det3(g, 0, c);
    det = det + g[0][c] * cof[c];
  }
  inv_det = T(1) / (det < T(0) ? nmin(det, -det_min) : nmax(det, det_min));
#pragma unroll
  for (int c = 0; c < 4; ++c) t[c] = cof[c] * inv_det;
  return det;
}

}  // namespace
