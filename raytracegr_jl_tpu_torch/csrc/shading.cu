// K5: gravitational-redshift shading of a traced ray batch on NVIDIA Hopper
// (sm_90a), one thread per ray.
//
// Replaces no TPU kernel: it is the port's counterpart of the XLA fusion
// that the JAX package's fast_epilogue makes of shade_redshift
// (raytracegr_jl_tpu/compaction.py, make_compact_renderer, jax.jit of the
// shading). The plain PyTorch version is models/shading.py shade_redshift,
// ~100 elementwise launches over [B, N, 4, 4] intermediates; this kernel
// reads each ray's launch state y0 and end state y (16 values) and writes
// its colour (3). Its bound is those bytes, but a hit ray's ~20 IEEE
// divisions, ~8 square roots, two metrics, atan2, acos and pow (under
// --fmad=false, as the plain version rounds) take longer: on the 1024x1024
// disk a miss costs what a copy of its bytes costs and a hit ~1.6 times
// that, so the hit path's instructions set the time. Shading in the
// impact-parameter order was slower (its warps mix the disk and the sky),
// as were staged stores and fewer registers (spills).
//
// Per ray: the objects' signed distances (object_distance of
// geodesic_common.cuh, the kernels' scene event), the nearest object (the
// earliest index on ties) and whether it lies within hit_dmin; that
// object's base colour (sphere: the 12x12 latitude/longitude checker; plane:
// green; disk: radial and azimuthal checker; the nearest-object loop
// and the colour are objects_common.cuh's, shared with K11), the metric
// at the hit and at the launch point (Kerr-Schild g = eta + f k k as
// ops/metrics.py kerr_schild writes it, or Minkowski), the camera observer's frequency
// (the normalised raised time covector, from the closed-form inverse's
// first column, ops/geometry.py inv4_column0; these device functions are
// csrc/camera_common.cuh's, shared with K8 and K9), the emitter's 4-velocity (Keplerian
// for a disk, the stored vel otherwise, normalised with the local metric),
// the g-factor, and the colour scaled by clip(exposure g^beaming, 0, 1);
// black on a miss. Only the nearest object's colour and g-factor are
// computed: the plain version computes every object's and gathers one.
//
// Rounding: each operation is written as the plain version evaluates it on
// the card (a python-scalar divisor is a multiplication by its reciprocal,
// torch.remainder is fmod plus a sign fix, the contractions u^a g_ab v^b
// are models/camera.py quad's left-to-right sums, the f64 pow is
// csrc/pow64.cu's), built with --fmad=false, so the colours equal the
// plain version's bit for bit.
//
// Layout: y0 is read as [B, 8] rows; y as rows too or, where PLANES, as
// the compacted render holds it: [8, B] planes transposed, plane c at
// y + c * ps, so that the wrapper copies nothing and each warp's reads of a
// plane are contiguous. Every load is issued first, so that their latencies
// overlap (a miss needs only its position: 4% of the disk's rays).

#include "camera_common.cuh"
#include "objects_common.cuh"

namespace {

// v / sqrt(max(-g(v, v), 1e-6)): a unit timelike vector (models/shading.py
// normalize_timelike).
template <typename T>
__device__ __forceinline__ void normalize_timelike(const T g[4][4], T* v) {
  const T n2 = -quad(v, g, v);
  const T s = sqrt(nmax(n2, T(1e-6)));
#pragma unroll
  for (int a = 0; a < 4; ++a) v[a] = v[a] / s;
}

template <typename T, bool KERR, bool PLANES>
__global__ void __launch_bounds__(MAX_THREADS)
k5_kernel(const T* __restrict__ y0, const T* __restrict__ y, long long ps,
          const T* __restrict__ vel, T* __restrict__ rgb, int n, int r_mode,
          int n_obj, T hit_dmin, T beaming, T exposure) {
  const Params<T>& p = cparams<T>();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x[4], k[4], x0[4], k0[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = PLANES ? y[c * ps + i] : y[8 * i + c];
    k[c] = PLANES ? y[(4 + c) * ps + i] : y[8 * i + 4 + c];
    x0[c] = y0[8 * i + c];
    k0[c] = y0[8 * i + 4 + c];
  }
  // The nearest object and its base colour (objects_common.cuh, shared
  // with K11).
  T dmin;
  const int o = nearest_object(
      n_obj, [&](int j) { return object_distance(p, j, p.kind[j], x); },
      dmin);
  T out[3] = {T(0), T(0), T(0)};
  if (dmin < hit_dmin) {
    const T* ob = &p.obj[o * OBJ_STRIDE];
    const int kind = p.kind[o];
    const T xx = x[1] - ob[0], yy = x[2] - ob[1], zz = x[3] - ob[2];
    T base[3];
    base_colour<T, false>(kind, xx, yy, zz, T(12), base);
    // The emitter's 4-velocity in the metric at the hit.
    T g[4][4], u[4];
    metric_at<T, KERR>(p.cfg[P_M], p.cfg[P_A], p.cfg[P_EPS2],
                       p.cfg[P_EPS2_HALF], r_mode, x, g);
    if (kind == KIND_DISK) {
      const T rho = sqrt(nmax(xx * xx + yy * yy, T(1e-6)));
      const T sqrtM = sqrt(nmax(p.cfg[P_M], T(0)));
      const T omega = sqrtM / (rho * sqrt(rho) + p.cfg[P_A] * sqrtM);
      u[0] = T(1);
      u[1] = -omega * yy;
      u[2] = omega * xx;
      u[3] = T(0);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) u[c] = vel[4 * o + c];
    }
    normalize_timelike(g, u);
    const T w_emit = nmax(quad(u, g, k), T(1e-3));
    // The camera observer's frequency at the launch point.
    T g0[4][4], cof[4], inv_det, t[4];
    metric_at<T, KERR>(p.cfg[P_M], p.cfg[P_A], p.cfg[P_EPS2],
                       p.cfg[P_EPS2_HALF], r_mode, x0, g0);
    time_column(g0, p.cfg[P_DET_MIN], cof, inv_det, t);
    normalize_timelike(g0, t);
    const T w_obs = -quad(t, g0, k0);
    const T gf = w_obs / w_emit;
    const T s = clip(exposure * tpow(gf, beaming), T(0), T(1));
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = base[c] * s;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[3 * i + c] = out[c];
}

template <typename T>
int launch_k5(const void* y0, const void* y, long long ps, const void* vel,
              void* rgb, const void* prm, int n, int kerr, int r_mode,
              int n_obj, double hit_dmin, double beaming, double exposure,
              void* stream) {
  if (n < 1 || n_obj < 1 || n_obj > MAX_OBJ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    RTGR_BOOL(kerr, KERR_, RTGR_BOOL(ps > 0, PLANES_,
              k5_kernel<T, KERR_, PLANES_><<<blocks, MAX_THREADS, 0, st>>>(
                  static_cast<const T*>(y0), static_cast<const T*>(y), ps,
                  static_cast<const T*>(vel), static_cast<T*>(rgb), n, r_mode,
                  n_obj, static_cast<T>(hit_dmin), static_cast<T>(beaming),
                  static_cast<T>(exposure))))
    return cudaGetLastError();
  }));
}

}  // namespace

#if RTGR_F32
extern "C" int rtgr_k5_f32(const void* y0, const void* y, long long ps,
                           const void* vel, void* rgb, const void* prm, int n,
                           int kerr, int r_mode, int n_obj, double hit_dmin,
                           double beaming, double exposure, void* stream) {
  return launch_k5<float>(y0, y, ps, vel, rgb, prm, n, kerr, r_mode, n_obj,
                          hit_dmin, beaming, exposure, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k5_f64(const void* y0, const void* y, long long ps,
                           const void* vel, void* rgb, const void* prm, int n,
                           int kerr, int r_mode, int n_obj, double hit_dmin,
                           double beaming, double exposure, void* stream) {
  return launch_k5<double>(y0, y, ps, vel, rgb, prm, n, kerr, r_mode, n_obj,
                          hit_dmin, beaming, exposure, stream);
}
#endif
