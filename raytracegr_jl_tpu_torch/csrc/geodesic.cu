// K1: geodesic integration of a ray batch on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of raytracegr_jl_tpu/ops/pallas_geodesic.py
// (integrate_rays_pallas, kernel body _make_kernel). Per ray: adaptive Tsit5
// with the PI controller (or fixed-step RK4) on the closed-form Kerr-Schild
// right-hand side (or Minkowski, udot = 0), the dense-output event sweep every
// step, capture-stop, and for a ray that hit the bisection and Newton polish
// of the crossing. The plain PyTorch version is ops/geodesic_cm.py
// (integrate_rays_cm); this file follows it operation by operation (build
// with --fmad=false).
//
// Design: one thread per ray, the whole loop in registers. The work is
// arithmetic on a few hundred bytes of state per ray, with a data-dependent
// trip count (about 20 to thousands of steps), so the card is bound by
// floating-point throughput and by divergence, not by memory: each ray reads
// 9 values and writes 11. A thread runs while its own ray is active, which
// gives per-ray results identical to the TPU tile's masked loop; a warp of 32
// rays pays for divergence where the TPU paid per 1024-ray tile. The loop is
// the make_step_cm body of geodesic_common.cuh (body_step, on the RayState
// that K2 and K3 stream through memory), and a hit ray is localized after
// its loop from its event record (ray_result), as the plain version and K2
// do: the step is rebuilt once with k1 = rhs(ev_y0), which equals the FSAL
// stage the step carried bit for bit. So one step body and one localization
// serve K1, K2, K3 and K4.
//
// Parameters arrive as the bytes of Params<T> (geodesic_common.cuh), packed
// in double on the host and rounded to the working type
// (ops/geodesic_cm.py pack_params): the configuration block, 8 fields per
// object (pos1, pos2, pos3, radius, time, r_in, r_out, half), per detection
// sample its dense-output weights and theta, and the object kinds. They are
// copied into constant memory on the launch's stream before the launch.
// Known ulp source: CUDA's pow is not correctly rounded, so the controller's
// q_pi may differ from a host libm by an ulp.
//
// The launch as a whole: render_fn keeps the packed parameter block of its
// fixed scene and configuration, so a launch reads nothing back from
// the card, and with dt0 null the kernel takes each ray's initial step in
// its prologue (initial_step: Hairer's heuristic for Tsit5, one more rhs per
// ray beside init_state's k1), which render.initial_dt otherwise runs as
// ~500 eager launches of the plain RHS. The result equals the plain initial_dt
// followed by this kernel bit for bit.

#include "geodesic_common.cuh"

namespace {

// The fixed scenes of this library's main paths: example2's render and the
// disk's single launch.
constexpr int FIXED_SCENES = (1 << SC_SPS9) | (1 << SC_SD9);

template <typename T, bool KERR, bool TSIT5, int SC>
__global__ void __launch_bounds__(MAX_THREADS)
k1_kernel(const T* __restrict__ y0, const T* __restrict__ dt0,
          T* __restrict__ y_out, T* __restrict__ lam_out,
          int* __restrict__ hit_out, int* __restrict__ steps_out, int n,
          int r_mode, int max_steps, int n_obj, int npts, int bisect_iters) {
  const Params<T>& p = cparams<T>();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RayState<T> r;
  init_state<T, KERR>(p, r_mode, y0, dt0, n, i, r);
  if (dt0 == nullptr)
    r.dt = initial_step<T, KERR, TSIT5>(p, r_mode, r.y, r.k1);
  for (int it = 0; it < max_steps && r.active > T(0); ++it) {
    T dt_try;
    bool hit_now;
    body_step<T, KERR, TSIT5, SC>(p, r_mode, n_obj, npts, r, dt_try,
                                  hit_now);
  }
  T ys[8], lam;
  ray_result<T, KERR, TSIT5, SC>(p, r_mode, n_obj, bisect_iters, r, ys, lam);
#pragma unroll
  for (int c = 0; c < 8; ++c) y_out[c * n + i] = ys[c];
  lam_out[i] = lam;
  hit_out[i] = r.hit > T(0);
  steps_out[i] = static_cast<int>(r.steps);
}

template <typename T>
int launch(const void* y0, const void* dt0, void* y, void* lam, void* hit,
           void* steps, const void* prm, int n, int kerr, int tsit5,
           int r_mode, int scene, int max_steps, int n_obj, int npts,
           int bisect_iters, void* stream) {
  if (!launch_ok(FIXED_SCENES, scene, n, n_obj, npts, MAX_THREADS))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    bool ok;
    RTGR_DISPATCH(ok, T, kerr, tsit5, scene,
                  k1_kernel<T, KERR_, TSIT5_, SC_>
                  <<<blocks, MAX_THREADS, 0, st>>>(
                      static_cast<const T*>(y0), static_cast<const T*>(dt0),
                      static_cast<T*>(y), static_cast<T*>(lam),
                      static_cast<int*>(hit), static_cast<int*>(steps), n,
                      r_mode, max_steps, n_obj, npts, bisect_iters))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  }));
}

}  // namespace

#if RTGR_F32
extern "C" int rtgr_k1_f32(const void* y0, const void* dt0, void* y, void* lam,
                           void* hit, void* steps, const void* prm, int n,
                           int kerr, int tsit5, int r_mode, int scene,
                           int max_steps, int n_obj, int npts,
                           int bisect_iters, void* stream) {
  return launch<float>(y0, dt0, y, lam, hit, steps, prm, n, kerr, tsit5,
                       r_mode, scene, max_steps, n_obj, npts, bisect_iters,
                       stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k1_f64(const void* y0, const void* dt0, void* y, void* lam,
                           void* hit, void* steps, const void* prm, int n,
                           int kerr, int tsit5, int r_mode, int scene,
                           int max_steps, int n_obj, int npts,
                           int bisect_iters, void* stream) {
  return launch<double>(y0, dt0, y, lam, hit, steps, prm, n, kerr, tsit5,
                        r_mode, scene, max_steps, n_obj, npts, bisect_iters,
                        stream);
}
#endif
