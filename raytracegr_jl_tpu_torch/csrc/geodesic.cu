// K1: geodesic integration of a ray batch on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of raytracegr_jl_tpu/ops/pallas_geodesic.py
// (integrate_rays_pallas, kernel body _make_kernel). Per ray: adaptive Tsit5
// with the PI controller (or fixed-step RK4) on the closed-form Kerr-Schild
// right-hand side (or Minkowski, udot = 0), the dense-output event sweep every
// step, capture-stop, and on the first hit the bisection and Newton polish of
// the crossing. The plain PyTorch version is ops/geodesic_cm.py; this file
// follows it operation by operation (build with --fmad=false).
//
// Design: one thread per ray, the whole loop in registers. The work is
// arithmetic on a few hundred bytes of state per ray, with a data-dependent
// trip count (about 20 to thousands of steps), so the card is bound by
// floating-point throughput and by divergence, not by memory: each ray reads
// 9 values and writes 11. A thread runs while its own ray is active, which
// gives per-ray results identical to the TPU tile's masked loop; a warp of 32
// rays pays for divergence where the TPU paid per 1024-ray tile. Where the
// TPU deferred localization to one pass after the loop, a thread localizes at
// its hit with the stages still in registers: the recorded replay of the JAX
// package recomputes exactly these values (FSAL: k1 == rhs(y)).
//
// Parameters arrive in one array of the working type, filled in double on
// the host (kernel_params in ops/geodesic_cm.py): the configuration block,
// 8 fields per object (pos1, pos2, pos3, radius, time, r_in, r_out, half),
// and per detection sample its dense-output weights and theta. Object kinds
// come as ints. Known ulp source: CUDA's pow is not correctly rounded, so
// the controller's q_pi may differ from a host libm by an ulp.

#include "geodesic_common.cuh"

namespace {

template <typename T, bool KERR, bool TSIT5>
__global__ void __launch_bounds__(THREADS)
k1_kernel(const T* __restrict__ y0, const T* __restrict__ dt0,
          T* __restrict__ y_out, T* __restrict__ lam_out,
          int* __restrict__ hit_out, int* __restrict__ steps_out,
          const T* __restrict__ prm, const int* __restrict__ kinds, int n,
          int r_mode, int max_steps, int n_obj, int npts, int bisect_iters) {
  __shared__ Params<T> p;
  const int n_prm = N_CFG + n_obj * OBJ_STRIDE + npts * SMP_STRIDE;
  for (int j = threadIdx.x; j < n_prm; j += blockDim.x) {
    const T v = prm[j];
    if (j < N_CFG) p.cfg[j] = v;
    else if (j < N_CFG + n_obj * OBJ_STRIDE) p.obj[j - N_CFG] = v;
    else p.smp[j - N_CFG - n_obj * OBJ_STRIDE] = v;
  }
  for (int j = threadIdx.x; j < n_obj; j += blockDim.x) p.kind[j] = kinds[j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  StepData<T, TSIT5> s;
#pragma unroll
  for (int c = 0; c < 8; ++c) s.y0[c] = y0[c * n + i];
  rhs<T, KERR>(p, r_mode, s.y0, s.k[0]);
  T dt = dt0[i], lam = T(0), err_old = p.cfg[P_QOLD_INIT];
  int steps = 0, hit = 0;
  const T dt_min = p.cfg[P_DT_MIN], lam_max = p.cfg[P_LAM_MAX];

  for (int it = 0; it < max_steps; ++it) {
    T dt_try = nmax(nmin(dt, lam_max - lam), dt_min);
    if (!isfinite(dt_try)) dt_try = dt_min;
    s.dt = dt_try;
    bool accept, dead, fin = true;
    T en = T(1), dt_next;
    if constexpr (TSIT5) {
      T err[8];
      tsit5_step<T, KERR>(p, r_mode, s, err);
      const T rtol = p.cfg[P_RTOL], atol = p.cfg[P_ATOL];
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        fin = fin && isfinite(s.y1[c]);
        const T sc = atol + rtol * nmax(fabs(s.y0[c]), fabs(s.y1[c]));
        const T ratio = clip(err[c] / sc, T(-1e15), T(1e15));
        acc = c == 0 ? ratio * ratio : acc + ratio * ratio;
      }
      en = sqrt(nmax(acc / T(8), T(1e-30)));
      const bool bad = !isfinite(en) || !fin;
      if (bad) en = T(1e30);  // ERR_BIG
      accept = en <= T(1);
      const T en_c = nmax(en, T(1e-10));
      const T safety = p.cfg[P_SAFETY];
      const T q_pi = safety * pow(en_c, p.cfg[P_NEG_BETA1])
                     * pow(nmax(err_old, p.cfg[P_QOLD_INIT]), p.cfg[P_BETA2]);
      const T q_rej = safety * pow(en_c, T(-0.2));
      T q = accept ? q_pi : nmin(q_rej, T(1));
      q = clip(q, p.cfg[P_QMIN], p.cfg[P_QMAX]);
      dt_next = clip(dt_try * q, dt_min, lam_max);
      dead = (bad || !accept) && dt_try <= p.cfg[P_DT_DEAD];
    } else {
      rk4_step<T, KERR>(p, r_mode, s);
#pragma unroll
      for (int c = 0; c < 8; ++c) fin = fin && isfinite(s.y1[c]);
      accept = fin;
      dt_next = p.cfg[P_RK4_DT];
      dead = !fin;
    }
    const T rho2 = s.y1[1] * s.y1[1] + s.y1[2] * s.y1[2] + s.y1[3] * s.y1[3];
    dead = dead || rho2 < p.cfg[P_STOP_RHO2];

    if (accept) {  // accepted steps are finite
      ++steps;
      T th_lo, th_hi;
      if (detect<T, TSIT5>(p, n_obj, npts, s, th_lo, th_hi)) {
        const T th = localize<T, TSIT5>(p, n_obj, bisect_iters, s, th_lo,
                                        th_hi);
        T ys[8];
        interp<T, TSIT5, 8>(s, th, ys);
#pragma unroll
        for (int c = 0; c < 8; ++c) s.y0[c] = ys[c];
        lam = lam + th * dt_try;
        hit = 1;
        break;
      }
      const T lam_acc = lam + dt_try;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s.y0[c] = s.y1[c];
        s.k[0][c] = s.k[6][c];
      }
      lam = lam_acc;
      err_old = nmax(en, p.cfg[P_QOLD_INIT]);
      if (lam_acc >= p.cfg[P_LAM_END] || dead) break;
    } else if (dead) {
      break;
    }
    dt = dt_next;
  }

#pragma unroll
  for (int c = 0; c < 8; ++c) y_out[c * n + i] = s.y0[c];
  lam_out[i] = lam;
  hit_out[i] = hit;
  steps_out[i] = steps;
}

template <typename T, bool KERR, bool TSIT5>
void launch_one(const void* y0, const void* dt0, void* y, void* lam, void* hit,
                void* steps, const void* prm, const void* kinds, int n,
                int r_mode, int max_steps, int n_obj, int npts,
                int bisect_iters, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  k1_kernel<T, KERR, TSIT5><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(y0), static_cast<const T*>(dt0),
      static_cast<T*>(y), static_cast<T*>(lam), static_cast<int*>(hit),
      static_cast<int*>(steps), static_cast<const T*>(prm),
      static_cast<const int*>(kinds), n, r_mode, max_steps, n_obj, npts,
      bisect_iters);
}

template <typename T>
int launch(const void* y0, const void* dt0, void* y, void* lam, void* hit,
           void* steps, const void* prm, const void* kinds, int n, int kerr,
           int tsit5, int r_mode, int max_steps, int n_obj, int npts,
           int bisect_iters, void* stream) {
  if (n_obj < 1 || n_obj > MAX_OBJ || npts < 1 || npts > MAX_SMP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kerr && tsit5)
    launch_one<T, true, true>(y0, dt0, y, lam, hit, steps, prm, kinds, n,
                              r_mode, max_steps, n_obj, npts, bisect_iters, st);
  else if (kerr)
    launch_one<T, true, false>(y0, dt0, y, lam, hit, steps, prm, kinds, n,
                               r_mode, max_steps, n_obj, npts, bisect_iters, st);
  else if (tsit5)
    launch_one<T, false, true>(y0, dt0, y, lam, hit, steps, prm, kinds, n,
                               r_mode, max_steps, n_obj, npts, bisect_iters, st);
  else
    launch_one<T, false, false>(y0, dt0, y, lam, hit, steps, prm, kinds, n,
                                r_mode, max_steps, n_obj, npts, bisect_iters, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtgr_k1_f32(const void* y0, const void* dt0, void* y, void* lam,
                           void* hit, void* steps, const void* prm,
                           const void* kinds, int n, int kerr, int tsit5,
                           int r_mode, int max_steps, int n_obj, int npts,
                           int bisect_iters, void* stream) {
  return launch<float>(y0, dt0, y, lam, hit, steps, prm, kinds, n, kerr, tsit5,
                       r_mode, max_steps, n_obj, npts, bisect_iters, stream);
}

extern "C" int rtgr_k1_f64(const void* y0, const void* dt0, void* y, void* lam,
                           void* hit, void* steps, const void* prm,
                           const void* kinds, int n, int kerr, int tsit5,
                           int r_mode, int max_steps, int n_obj, int npts,
                           int bisect_iters, void* stream) {
  return launch<double>(y0, dt0, y, lam, hit, steps, prm, kinds, n, kerr, tsit5,
                        r_mode, max_steps, n_obj, npts, bisect_iters, stream);
}
