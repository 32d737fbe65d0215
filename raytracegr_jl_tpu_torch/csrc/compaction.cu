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
// rhs(y0)), as K1 and the plain make_step_cm init do; with dt0 null it also
// takes each ray's initial step (initial_step, as K1's prologue does: equal
// bit for bit to the plain initial_dt, which the render would otherwise run
// as ~500 eager launches before the first chunk). After the loop every
// hit ray is localized from its event record (localize_record), every other
// ray returns its current y and lam; localization is a pure function of the
// record, so re-running it for rays that hit in an earlier chunk rewrites
// the same values. The plain PyTorch version is compaction.chunk_plain; this
// file follows it operation by operation (build with --fmad=false).
//
// Design: one thread per ray, as K1 and K3, with their step body
// (body_step). Compaction is the host loop's job: between launches it packs
// the active rays to the front of a smaller batch. On the disk the late
// chunks are the photon-ring rays, ~44k of them at ~14k steps each, packed
// into ~1,400 warps: about 11 per SM, nearly uniform, so the chunk is bound
// neither by memory (34 planes in and out per ray per chunk) nor by
// divergence but by one step's serial chain on few warps, where issue
// already limits (PERF.md: half the tail's rays take 0.71x the time of all
// of them, twice the rays 1.79x). So the step sheds what it can
// (geodesic_common.cuh): its parameters are constant-bank operands
// (c_params_*, filled by launch_with_params in stream order before the
// launch), the disk's scene is compile-time (SC_SD9: the sweep and the
// event unrolled, no branch on a kind), clamps are single FMNMX
// instructions, and 128 registers leave room for 16 warps per SM. The block
// size is the caller's: compaction.py launches MAX_THREADS (128), and
// chip_smoke.py's diagnosis also 32 and 64, which measured no faster on
// the tail. Two lanes per ray were not built: with issue
// limiting at the tail's occupancy, doubling the warps and repeating the
// step body on both lanes would add more instructions than the split sweep
// saves.

#include "geodesic_common.cuh"

namespace {

// The fixed scenes of this library's main paths: the accretion disk.
constexpr int FIXED_SCENES = 1 << SC_SD9;

template <typename T, bool KERR, bool TSIT5, bool INIT, int SC>
__global__ void __launch_bounds__(MAX_THREADS)
k2_kernel(const T* __restrict__ P_in, const T* __restrict__ y0,
          const T* __restrict__ dt0, T* __restrict__ P_out,
          T* __restrict__ y_fin, T* __restrict__ lam_fin, int n, int r_mode,
          int n_obj, int npts, int bisect_iters, int budget) {
  const Params<T>& p = cparams<T>();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  RayState<T> r;
  if constexpr (INIT) {
    init_state<T, KERR>(p, r_mode, y0, dt0, n, i, r);
    if (dt0 == nullptr)
      r.dt = initial_step<T, KERR, TSIT5>(p, r_mode, r.y, r.k1);
  } else {
    load_state(P_in, n, i, r);
  }
  for (int it = 0; it < budget && r.active > T(0); ++it) {
    T dt_try;
    bool hit_now;
    body_step<T, KERR, TSIT5, SC>(p, r_mode, n_obj, npts, r, dt_try,
                                  hit_now);
  }
  store_state(P_out, n, i, r);
  T ys[8], lam;
  ray_result<T, KERR, TSIT5, SC>(p, r_mode, n_obj, bisect_iters, r, ys, lam);
#pragma unroll
  for (int c = 0; c < 8; ++c) y_fin[c * n + i] = ys[c];
  lam_fin[i] = lam;
}

template <typename T, bool INIT>
bool launch_variant(const T* P_in, const T* y0, const T* dt0, T* P_out,
                    T* y_fin, T* lam_fin, int n, int kerr, int tsit5,
                    int r_mode, int scene, int n_obj, int npts,
                    int bisect_iters, int budget, int threads,
                    cudaStream_t st) {
  const int blocks = (n + threads - 1) / threads;
  bool ok;
  RTGR_DISPATCH(ok, T, kerr, tsit5, scene,
                k2_kernel<T, KERR_, TSIT5_, INIT, SC_>
                <<<blocks, threads, 0, st>>>(P_in, y0, dt0, P_out, y_fin,
                                             lam_fin, n, r_mode, n_obj, npts,
                                             bisect_iters, budget))
  return ok;
}

template <typename T>
int launch_k2(const void* P_in, const void* y0, const void* dt0, void* P_out,
              void* y_fin, void* lam_fin, const void* prm, int n, int kerr,
              int tsit5, int r_mode, int scene, int n_obj, int npts,
              int bisect_iters, int budget, int init, int threads,
              void* stream) {
  if (!launch_ok(FIXED_SCENES, scene, n, n_obj, npts, threads) || budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* in = static_cast<const T*>(P_in);
  const T* y = static_cast<const T*>(y0);
  const T* d = static_cast<const T*>(dt0);
  T* out = static_cast<T*>(P_out);
  T* yf = static_cast<T*>(y_fin);
  T* lf = static_cast<T*>(lam_fin);
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    const bool ok =
        init ? launch_variant<T, true>(in, y, d, out, yf, lf, n, kerr, tsit5,
                                       r_mode, scene, n_obj, npts,
                                       bisect_iters, budget, threads, st)
             : launch_variant<T, false>(in, y, d, out, yf, lf, n, kerr,
                                        tsit5, r_mode, scene, n_obj, npts,
                                        bisect_iters, budget, threads, st);
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  }));
}

}  // namespace

#if RTGR_F32
extern "C" int rtgr_k2_f32(const void* P_in, const void* y0, const void* dt0,
                           void* P_out, void* y_fin, void* lam_fin,
                           const void* prm, int n, int kerr, int tsit5,
                           int r_mode, int scene, int n_obj, int npts,
                           int bisect_iters, int budget, int init, int threads,
                           void* stream) {
  return launch_k2<float>(P_in, y0, dt0, P_out, y_fin, lam_fin, prm, n, kerr,
                          tsit5, r_mode, scene, n_obj, npts, bisect_iters,
                          budget, init, threads, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k2_f64(const void* P_in, const void* y0, const void* dt0,
                           void* P_out, void* y_fin, void* lam_fin,
                           const void* prm, int n, int kerr, int tsit5,
                           int r_mode, int scene, int n_obj, int npts,
                           int bisect_iters, int budget, int init, int threads,
                           void* stream) {
  return launch_k2<double>(P_in, y0, dt0, P_out, y_fin, lam_fin, prm, n, kerr,
                           tsit5, r_mode, scene, n_obj, npts, bisect_iters,
                           budget, init, threads, stream);
}
#endif
