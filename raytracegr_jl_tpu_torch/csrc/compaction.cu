// K2: one chunk of the resumable geodesic integration on NVIDIA Hopper
// (sm_90a), for the compacted render (compaction.py).
//
// Replaces the Pallas TPU kernel of raytracegr_jl_tpu/compaction.py
// (make_chunk_launcher, kernel body _chunk_kernel). Per ray: at most
// `budget` iterations of the make_step_cm body while the ray is active, with
// the loop state streamed in and out as the 34 packed planes of K3
// (geodesic_common.cuh, enum Plane), so that a ray's evolution is bit for bit
// the same whether it runs in one launch or across many. With INIT the
// kernel reads y0 [8, n] and dt0 [n] and builds the state itself (k1 =
// rhs(y0)), as K1 and the plain make_step_cm init do. After the loop every
// hit ray is localized from its event record (localize_record), every other
// ray returns its current y and lam; localization is a pure function of the
// record, so re-running it for rays that hit in an earlier chunk rewrites
// the same values. The plain PyTorch version is compaction.chunk_plain; this
// file follows it operation by operation (build with --fmad=false).
//
// Design: one thread per ray, as K1 and K3, with their step body
// (body_step). The work is arithmetic with a data-dependent trip count, so
// the card is bound by floating-point throughput and divergence; a chunk
// moves 34 planes in and out and 9 result planes per ray. Compaction is the
// host loop's job: between launches it packs the active rays to the front
// of a smaller batch, so late chunks launch few warps that are mostly busy.
// On the TPU a 1024-lane tile ran until its slowest ray finished; here a
// thread exits when its own ray does, and a warp of 32 pays for divergence.

#include "geodesic_common.cuh"

namespace {

template <typename T, bool KERR, bool TSIT5, bool INIT>
__global__ void __launch_bounds__(THREADS)
k2_kernel(const T* __restrict__ P_in, const T* __restrict__ y0,
          const T* __restrict__ dt0, T* __restrict__ P_out,
          T* __restrict__ y_fin, T* __restrict__ lam_fin,
          const T* __restrict__ prm, const int* __restrict__ kinds, int n,
          int r_mode, int n_obj, int npts, int bisect_iters, int budget) {
  __shared__ Params<T> p;
  load_params(p, prm, kinds, n_obj, npts);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RayState<T> r;
  if constexpr (INIT) init_state<T, KERR>(p, r_mode, y0, dt0, n, i, r);
  else load_state(P_in, n, i, r);
  for (int it = 0; it < budget && r.active > T(0); ++it) {
    T dt_try;
    bool hit_now;
    body_step<T, KERR, TSIT5>(p, r_mode, n_obj, npts, r, dt_try, hit_now);
  }
  store_state(P_out, n, i, r);
  T ys[8], lam;
  ray_result<T, KERR, TSIT5>(p, r_mode, n_obj, bisect_iters, r, ys, lam);
#pragma unroll
  for (int c = 0; c < 8; ++c) y_fin[c * n + i] = ys[c];
  lam_fin[i] = lam;
}

template <typename T, bool INIT>
void launch_variant(const T* P_in, const T* y0, const T* dt0, T* P_out,
                    T* y_fin, T* lam_fin, const T* prm, const int* kinds,
                    int n, int kerr, int tsit5, int r_mode, int n_obj,
                    int npts, int bisect_iters, int budget, cudaStream_t st) {
  const int blocks = (n + THREADS - 1) / THREADS;
#define K2_LAUNCH(KERR, TS)                                                 \
  k2_kernel<T, KERR, TS, INIT><<<blocks, THREADS, 0, st>>>(                 \
      P_in, y0, dt0, P_out, y_fin, lam_fin, prm, kinds, n, r_mode, n_obj,   \
      npts, bisect_iters, budget)
  if (kerr && tsit5) K2_LAUNCH(true, true);
  else if (kerr) K2_LAUNCH(true, false);
  else if (tsit5) K2_LAUNCH(false, true);
  else K2_LAUNCH(false, false);
#undef K2_LAUNCH
}

template <typename T>
int launch_k2(const void* P_in, const void* y0, const void* dt0, void* P_out,
              void* y_fin, void* lam_fin, const void* prm, const void* kinds,
              int n, int kerr, int tsit5, int r_mode, int n_obj, int npts,
              int bisect_iters, int budget, int init, void* stream) {
  if (n_obj < 1 || n_obj > MAX_OBJ || npts < 1 || npts > MAX_SMP || n < 1 ||
      budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* in = static_cast<const T*>(P_in);
  const T* y = static_cast<const T*>(y0);
  const T* d = static_cast<const T*>(dt0);
  T* out = static_cast<T*>(P_out);
  T* yf = static_cast<T*>(y_fin);
  T* lf = static_cast<T*>(lam_fin);
  const T* pr = static_cast<const T*>(prm);
  const int* kd = static_cast<const int*>(kinds);
  if (init)
    launch_variant<T, true>(in, y, d, out, yf, lf, pr, kd, n, kerr, tsit5,
                            r_mode, n_obj, npts, bisect_iters, budget, st);
  else
    launch_variant<T, false>(in, y, d, out, yf, lf, pr, kd, n, kerr, tsit5,
                             r_mode, n_obj, npts, bisect_iters, budget, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rtgr_k2_f32(const void* P_in, const void* y0, const void* dt0,
                           void* P_out, void* y_fin, void* lam_fin,
                           const void* prm, const void* kinds, int n, int kerr,
                           int tsit5, int r_mode, int n_obj, int npts,
                           int bisect_iters, int budget, int init,
                           void* stream) {
  return launch_k2<float>(P_in, y0, dt0, P_out, y_fin, lam_fin, prm, kinds, n,
                          kerr, tsit5, r_mode, n_obj, npts, bisect_iters,
                          budget, init, stream);
}

extern "C" int rtgr_k2_f64(const void* P_in, const void* y0, const void* dt0,
                           void* P_out, void* y_fin, void* lam_fin,
                           const void* prm, const void* kinds, int n, int kerr,
                           int tsit5, int r_mode, int n_obj, int npts,
                           int bisect_iters, int budget, int init,
                           void* stream) {
  return launch_k2<double>(P_in, y0, dt0, P_out, y_fin, lam_fin, prm, kinds,
                           n, kerr, tsit5, r_mode, n_obj, npts, bisect_iters,
                           budget, init, stream);
}
