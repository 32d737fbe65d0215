// K8 and K9: the camera of the differentiable path on NVIDIA Hopper
// (sm_90a), one thread per ray.
//
// Replace no TPU kernel: they are the port's counterpart of the XLA fusion
// that the JAX package makes of its camera (raytracegr_jl_tpu/models/
// camera.py pixel_rays, "a single fused XLA kernel") and of the camera's
// AD inside its jitted training step. The plain PyTorch versions are
// models/camera.py pixel_rays_plain (K8) and pixel_rays_vjp (K9), ~150 and
// ~500 elementwise launches over [B] tensors; each kernel reads a ray's
// position and tilted normal (and K9 its cotangent) and writes its u (K8)
// or its (M_bar, a_bar) (K9), so both are bound by those bytes.
//
// K8, per ray: the metric at x (Kerr-Schild as ops/metrics.py kerr_schild
// computes it, or Minkowski), t = g^-1 (1, 0, 0, 0) from row 0's four
// cofactors over the clamped determinant (the other twelve are never
// read), t.g.t and n.g.n, and u = (t / sqrt(-t.g.t) + n / sqrt(n.g.n)) /
// sqrt(2). K9, per ray: that forward again, keeping its parts, then its
// reverse for the cotangent of u: the normalization, the two contractions,
// the cofactors and the determinant (no cotangent where the clamp bites),
// the metric's outer product, k, f and the radius through the floors and
// clamps of clamped_rho2 and kerr_schild_radius. The pixel batch takes no
// cotangent.
//
// M and a are read by pointer from device memory, one value (stride 0) or
// one per ray (stride 1), not from a constant parameter block: a captured
// graph's replay reads the live parameters, and the library has no launch
// state to serialize.
//
// Rounding: each operation as the plain version evaluates it on the card,
// built with --fmad=false: the contractions as left-to-right sums (quad),
// the division by sqrt(2) as PyTorch's multiplication by the reciprocal
// (1 / sqrt(2) rounded in the working type), 1 / clamp(det) as
// reciprocal, sums started from their first term (so a zero keeps its
// sign). K8 and K9 are bitwise equal to their plain versions.

#include "camera_common.cuh"

namespace {

// PyTorch's CUDA division by a python scalar b: a * (1 / b), the
// reciprocal rounded in the working type.
template <typename T>
__device__ __forceinline__ T inv_sqrt2() {
  return T(1) / T(1.4142135623730951);
}

template <typename T, bool KERR>
__global__ void __launch_bounds__(MAX_THREADS)
k8_kernel(const T* __restrict__ pos, const T* __restrict__ nrm,
          const T* __restrict__ Mp, const T* __restrict__ ap,
          T* __restrict__ u, int n, int m_stride, int a_stride, int r_mode,
          T eps2, T eps2_half, T det_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x[4], v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = pos[4 * i + c];
    v[c] = nrm[4 * i + c];
  }
  T g[4][4], cof[4], inv_det, t[4];
  metric_at<T, KERR>(Mp[i * m_stride], ap[i * a_stride], eps2, eps2_half,
                     r_mode, x, g);
  time_column(g, det_min, cof, inv_det, t);
  const T st = sqrt(-quad(t, g, t));
  const T sn = sqrt(quad(v, g, v));
#pragma unroll
  for (int c = 0; c < 4; ++c)
    u[4 * i + c] = (t[c] / st + v[c] / sn) * inv_sqrt2<T>();
}

// The reverse of det3(g, 0, c) (rows 1, 2, 3 without column c) for its
// cotangent d, added into gb.
template <typename T>
__device__ __forceinline__ void det3_vjp(const T g[4][4], int c, T d,
                                         T gb[4][4]) {
  int cs[3];
  for (int j = 0, m = 0; j < 4; ++j)
    if (j != c) cs[m++] = j;
  const T A = g[1][cs[0]], B = g[1][cs[1]], C = g[1][cs[2]];
  const T D = g[2][cs[0]], E = g[2][cs[1]], F = g[2][cs[2]];
  const T G = g[3][cs[0]], H = g[3][cs[1]], I = g[3][cs[2]];
  gb[1][cs[0]] = gb[1][cs[0]] + d * (E * I - F * H);
  gb[1][cs[1]] = gb[1][cs[1]] + -(d * (D * I - F * G));
  gb[1][cs[2]] = gb[1][cs[2]] + d * (D * H - E * G);
  const T p1b = d * A, p2b = -(d * B), p3b = d * C;
  gb[2][cs[0]] = gb[2][cs[0]] + (p2b * I + p3b * H);
  gb[2][cs[1]] = gb[2][cs[1]] + (p1b * I - p3b * G);
  gb[2][cs[2]] = gb[2][cs[2]] + -(p1b * H + p2b * G);
  gb[3][cs[0]] = gb[3][cs[0]] + -(p2b * F + p3b * E);
  gb[3][cs[1]] = gb[3][cs[1]] + (p3b * D - p1b * F);
  gb[3][cs[2]] = gb[3][cs[2]] + (p1b * E + p2b * D);
}

// pbar [2, n]: row 0 M_bar, row 1 a_bar, per ray. The cotangent is read
// through its two strides, as the caller holds it (the training path's is
// a view of its [8, B] planes' gradient): no copy before the launch.
template <typename T, bool KERR>
__global__ void __launch_bounds__(MAX_THREADS)
k9_kernel(const T* __restrict__ pos, const T* __restrict__ nrm,
          const T* __restrict__ Mp, const T* __restrict__ ap,
          const T* __restrict__ ct, T* __restrict__ pbar, int n,
          int m_stride, int a_stride, long long sct, long long sctc,
          int r_mode, T eps2, T eps2_half, T det_min) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (!KERR) {
    pbar[i] = T(0);
    pbar[n + i] = T(0);
    return;
  }
  T x[4], v[4], cu[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = pos[4 * i + c];
    v[c] = nrm[4 * i + c];
    cu[c] = ct[i * sct + c * sctc];
  }
  const T a = ap[i * a_stride];
  KerrParts<T> q;
  kerr_parts(Mp[i * m_stride], a, eps2, eps2_half, r_mode, x, q);
  T g[4][4], cof[4], inv_det, t[4];
  kerr_metric(q, g);
  const T det = time_column(g, det_min, cof, inv_det, t);
  const T st = sqrt(-quad(t, g, t));
  const T sn = sqrt(quad(v, g, v));

  // u = (that + nhat) / sqrt(2); nhat = n / sn, that = t / st.
  T sb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) sb[c] = cu[c] * inv_sqrt2<T>();
  T p = sb[0] * (v[0] / sn) + sb[1] * (v[1] / sn) + sb[2] * (v[2] / sn)
        + sb[3] * (v[3] / sn);
  const T n2b = (-p / sn) / (T(2) * sn);
  p = sb[0] * (t[0] / st) + sb[1] * (t[1] / st) + sb[2] * (t[2] / st)
      + sb[3] * (t[3] / st);
  const T t2b = p / st / (T(2) * st);
  T tb[4], ta[4], na[4], gb[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    tb[c] = sb[c] / st;
    ta[c] = t2b * t[c];
    na[c] = n2b * v[c];
  }
  // The two contractions.
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) gb[r][c] = ta[r] * t[c] + na[r] * v[c];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const T gvt = g[b][0] * t[0] + g[b][1] * t[1] + g[b][2] * t[2]
                  + g[b][3] * t[3];
    tb[b] = tb[b] + t2b * gvt;
#pragma unroll
    for (int r = 0; r < 4; ++r) tb[b] = tb[b] + ta[r] * g[r][b];
  }
  // t = cof / clamp(det), det = g[0] . cof.
  T cb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) cb[c] = tb[c] * inv_det;
  p = tb[0] * cof[0] + tb[1] * cof[1] + tb[2] * cof[2] + tb[3] * cof[3];
  const T dcb = -(p * (inv_det * inv_det));
  const bool passes = det < T(0) ? det <= -det_min : det >= det_min;
  const T detb = passes ? dcb : T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    gb[0][c] = gb[0][c] + detb * cof[c];
    cb[c] = cb[c] + detb * g[0][c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) det3_vjp(g, c, c % 2 ? -cb[c] : cb[c], gb);

  // g = eta + (f k_r) k_c, k_0 = 1.
  T fb = T(0), kb[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const T fk = q.f * q.k[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T qb = gb[r][c] * q.k[c];
      fb = (r == 0 && c == 0) ? qb * q.k[r] : fb + qb * q.k[r];
      if (r > 0) kb[r] = kb[r] + qb * q.f;
      if (c > 0) kb[c] = r == 0 ? gb[r][c] * fk : kb[c] + gb[r][c] * fk;
    }
  }
  // k = (1, (r x + a y) / denom, (r y - a x) / denom, z / r).
  const T xs = x[1], ys = x[2], zs = x[3];
  const T k1b = kb[1] / q.denom, k2b = kb[2] / q.denom;
  const T denomb = -(kb[1] * q.k[1] + kb[2] * q.k[2]) / q.denom;
  T rb = -(kb[3] * q.k[3]) / q.r;
  rb = rb + k1b * xs + k2b * ys;
  T ab = k1b * ys - k2b * xs;
  // f = 2 M r^3 / (r2^2 + a^2 z^2), denom = r2 + a^2.
  const T numb = fb / q.dn;
  const T dnb = -(fb * q.f) / q.dn;
  const T mb = numb * q.r3 * T(2);
  const T r3b = numb * q.two_m;
  rb = rb + r3b * q.r2;
  T r2b = denomb + r3b * q.r;
  r2b = r2b + dnb * q.r2 * T(2);
  T aab = denomb + dnb * zs * zs;
  rb = rb + r2b * q.r * T(2);
  // The radius.
  T wb, halfb, vb = T(0);
  if (r_mode == R_AS_WRITTEN) {
    vb = rb * T(0.25) / q.s;
    wb = rb * T(0.5) / q.inner0;
    halfb = wb * q.half * T(2);
  } else {
    T hb = rb * T(0.5) / q.r;
    T ib = hb;
    if (r_mode == R_TEXTBOOK) {
      hb = q.h >= eps2 ? hb : T(0);
      ib = q.inner0 >= eps2_half ? hb : T(0);
    }
    wb = ib * T(0.5) / q.inner0;
    halfb = hb + wb * q.half * T(2);
  }
  aab = aab + wb * zs * zs;
  aab = aab - halfb * T(0.5);
  if (r_mode == R_AS_WRITTEN) {
    // torch.maximum(rho2_raw, a^2 + eps2): the floor's share, half on a tie.
    const T rho2b = vb + halfb * T(0.5);
    aab = aab - vb;
    aab = aab + (q.rho2_raw > q.floor
                     ? T(0)
                     : (q.rho2_raw == q.floor ? rho2b * T(0.5) : rho2b));
  }
  ab = ab + aab * a * T(2);
  pbar[i] = mb;
  pbar[n + i] = ab;
}

template <typename T>
int launch_camera(const void* pos, const void* nrm, const void* M,
                  const void* a, const void* ct, void* out, int n,
                  int m_stride, int a_stride, long long sct, long long sctc,
                  int kerr, int r_mode, double eps2, double eps2_half,
                  double det_min, void* stream) {
  if (n < 1 || m_stride < 0 || m_stride > 1 || a_stride < 0 || a_stride > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* p = static_cast<const T*>(pos);
  const T* nv = static_cast<const T*>(nrm);
  const T* Mp = static_cast<const T*>(M);
  const T* ap = static_cast<const T*>(a);
  const T e2 = static_cast<T>(eps2), e2h = static_cast<T>(eps2_half);
  const T dm = static_cast<T>(det_min);
  if (ct == nullptr) {
    RTGR_BOOL(kerr, KERR_,
              k8_kernel<T, KERR_><<<blocks, MAX_THREADS, 0, st>>>(
                  p, nv, Mp, ap, static_cast<T*>(out), n, m_stride, a_stride,
                  r_mode, e2, e2h, dm))
  } else {
    RTGR_BOOL(kerr, KERR_,
              k9_kernel<T, KERR_><<<blocks, MAX_THREADS, 0, st>>>(
                  p, nv, Mp, ap, static_cast<const T*>(ct),
                  static_cast<T*>(out), n, m_stride, a_stride, sct, sctc,
                  r_mode, e2, e2h, dm))
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: (pos, normal, M, a, u; n, M's stride, a's stride, kerr, r_mode;
// eps2, eps2 / 2, det_min; stream). K9: the same with the cotangent ct
// after a, pbar [2, n] in place of u, and ct's ray and component strides
// (long long) after a's stride.
#define RTGR_CAMERA_ENTRIES(T, SUFFIX)                                       \
  extern "C" int rtgr_k8_##SUFFIX(                                           \
      const void* pos, const void* nrm, const void* M, const void* a,        \
      void* u, int n, int m_stride, int a_stride, int kerr, int r_mode,      \
      double eps2, double eps2_half, double det_min, void* stream) {         \
    return launch_camera<T>(pos, nrm, M, a, nullptr, u, n, m_stride,         \
                            a_stride, 0, 0, kerr, r_mode, eps2, eps2_half,   \
                            det_min, stream);                                \
  }                                                                          \
  extern "C" int rtgr_k9_##SUFFIX(                                           \
      const void* pos, const void* nrm, const void* M, const void* a,        \
      const void* ct, void* pbar, int n, int m_stride, int a_stride,         \
      long long sct, long long sctc, int kerr, int r_mode, double eps2,      \
      double eps2_half, double det_min, void* stream) {                      \
    return launch_camera<T>(pos, nrm, M, a, ct, pbar, n, m_stride,           \
                            a_stride, sct, sctc, kerr, r_mode, eps2,         \
                            eps2_half, det_min, stream);                     \
  }

#if RTGR_F32
RTGR_CAMERA_ENTRIES(float, f32)
#endif

#if RTGR_F64
RTGR_CAMERA_ENTRIES(double, f64)
#endif
