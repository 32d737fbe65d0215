// K3 and K4: the checkpointed adjoint of the geodesic integration on NVIDIA
// Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel _fwd_seg_launch of
// raytracegr_jl_tpu/ops/pallas_adjoint.py, which the JAX package launches
// once per checkpoint segment: at most seg_len steps of the make_step_cm
// body per ray, the 34-plane state read at the start and written at the end.
// Here one launch runs the whole forward pass: each ray walks its segments
// and writes each checkpoint itself, since a ray's next checkpoint depends
// only on its own last one; the per-segment launches' grid-wide barriers,
// their host syncs and their launch costs are gone (k3_kernel, k3_close).
// Unlike K1 it does not localize: on a hit it records the crossing step
// (ev_y0, ev_dt, ev_lam, ev_lo, ev_hi) and the ray stops; K6 localizes
// afterwards, and K7 differentiates the localization (localize.cu).
//
// K4 replaces _run_bwd of the same file: the whole backward pass in one
// launch. Per ray, its segments in reverse from its end segment e_i (K3's
// ends[i]; a segment at or past it is the identity for the ray, as JAX's
// kernel skips a dead tile of every one of its n_seg segments); a warp
// walks them in step from its largest e_i, the lanes past their own end
// idle, so that its lanes replay the same segment together (a walk from
// each lane's own end was slower at tsit5/48 on the H100, PERF.md); each
// is replayed from its checkpoint, each accepted step's (y, k1, dt_try, hit)
// kept in local memory, and then walked back with the hand-written adjoint
// of the step (step_vjp) and of the right-hand side (rhs_vjp). CUDA has no
// autodiff inside a kernel; the TPU kernel took jax.vjp of the step body
// (adjoint_common.cuh, shared with K7).
// Only y, k1 and ev_y0 carry cotangents: dt_try is detached, so the
// controller, dt and err_old take none; the masks route cotangents; the
// detection only decides masks, so object fields get none inside the loop.
// The (M, a) cotangents are written per ray, [B, 2], and summed by the
// wrapper: deterministic, and comparable bitwise with the plain version.
//
// No launch reads anything back to the host, and every shape is static: the
// final state of every ray goes to the fixed slot ck[n_seg] and K4 takes the
// end segments on the card, so a CUDA graph can hold a whole training step
// (raytracegr_jl_tpu_torch/step_graph.py, the counterpart of jax.jit).
//
// The plain PyTorch versions are in ops/adjoint.py (forward_segment,
// backward_plain, step_vjp, rhs_vjp); this file follows them operation by
// operation (build with --fmad=false). Ties follow JAX's rule: where a max,
// min or clip meets its bound exactly, the derivative is split half and half.
//
// Design: one thread per ray, as K1. Both kernels are bound by arithmetic and
// latency, not memory: K3 writes 34 values of state per ray per segment it
// runs; K4 reads one checkpoint per live segment and recomputes the
// stages twice (replay, then the adjoint's own forward sweep), so it costs
// about three forward steps per step. The per-step records of a segment
// live in local memory, sized for MAX_SEG steps (2.2 KB per thread in f32).
// A training batch of 200x200 rays makes ~9.5 warps per SM, too few to hide
// a local-memory round trip, so nothing on the step's own chain goes
// through local memory: the Tsit5 adjoint's stages are unrolled at compile
// time (stage_input<ROW>, back_stage<M>), its tableau entries are
// immediates (ts_a folds), and its stage arrays ks and kb live in registers
// (f32 Kerr-Schild: 222 registers, no spills; before, ks, kb and the tableau
// were ~3,900 local loads and stores). Only the per-step records stay in
// local memory. As in K1 and K2 the parameters are constant-bank operands
// (launch_with_params) and the training path's scene compile-time
// (SC_SPS4, example2 with 4 detection samples; SC_S4, the inversion's
// lensing scene). Blocks of MAX_THREADS.
//
// Grouped launches (GROUPED, a table in device memory): one K3 and one K4
// launch carry all starts of a vectorized multistart fit, each ray reading
// M, a and the object rows of its start (GroupParams in
// geodesic_common.cuh); the starts' rays are a batch as one start's are, so
// a step costs one launch of each at any number of starts. The ungrouped
// instantiations compile as they did before the flag.

#include "adjoint_common.cuh"

namespace {

// The fixed scenes of this library's main paths: the training path
// (example2, 4 detection samples) and the inversion's lensing scene (one
// sphere, 4 samples).
constexpr int FIXED_SCENES = (1 << SC_SPS4) | (1 << SC_S4);

constexpr int MAX_SEG = 32;

// --------------------------------------------------------------------------
// The kernels
// --------------------------------------------------------------------------
// K3: the whole forward pass in one launch. Ray i walks its segments from
// checkpoint 0: while it is active at the start of segment s (s < n_seg), it
// runs at most seg_len steps and writes checkpoint s + 1 itself; the first s
// at whose start it is inactive (n_seg if none) is its end segment e_i,
// written to ends[i]. The launches of the per-segment chain wrote the same
// states: a ray's segments depend only on its own state, so nothing needs a
// grid-wide barrier between them. n_used, the number of segments the chain
// runs (the first s at which no ray is active), is the largest e_i: one
// atomicMax per warp into used. k3_close then puts every ray's final state
// into the fixed slot ck[n_seg].
// GROUPED: each ray's M, a and object rows from its group's row of groups
// (GroupParams); rays_per_group and group_stride are read only then.
template <typename T, bool KERR, bool TSIT5, int SC, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS)
k3_kernel(T* __restrict__ ck, int* __restrict__ used, int* __restrict__ ends,
          int n, int r_mode, int n_obj, int npts, int seg_len, int n_seg,
          const T* __restrict__ groups, int rays_per_group,
          int group_stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  decltype(auto) p = ray_params<T, GROUPED>(groups, rays_per_group,
                                            group_stride, i);
  int end = 0;
  if (i < n) {
    const size_t stride = static_cast<size_t>(N_PLANES) * n;
    RayState<T> r;
    load_state(ck, n, i, r);
    while (end < n_seg && r.active > T(0)) {
      for (int it = 0; it < seg_len && r.active > T(0); ++it) {
        T dt_try;
        bool hit_now;
        body_step<T, KERR, TSIT5, SC>(p, r_mode, n_obj, npts, r, dt_try,
                                      hit_now);
      }
      ++end;
      store_state(ck + end * stride, n, i, r);
    }
    ends[i] = end;
  }
  // Every lane of the warp reaches here (no early return above).
  end = __reduce_max_sync(0xffffffffu, end);
  if ((threadIdx.x & 31) == 0 && end > 0) atomicMax(used, end);
}

// After k3_kernel, for a ray that ended before n_seg: its final state
// (checkpoint e_i) copied into the fixed slot ck[n_seg], where the forward's
// result is read. Nothing else past a ray's end is read: K4 walks ray i's
// segments from e_i - 1 down.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
k3_close(T* __restrict__ ck, const int* __restrict__ ends, int n,
         int n_seg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int e = ends[i];
  if (e >= n_seg) return;
  const size_t stride = static_cast<size_t>(N_PLANES) * n;
  const T* src = ck + e * stride;
  T* dst = ck + n_seg * stride;
#pragma unroll
  for (int q = 0; q < N_PLANES; ++q) dst[q * n + i] = src[q * n + i];
}

template <typename T, bool KERR, bool TSIT5, int SC, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS)
k4_kernel(const T* __restrict__ ck, const int* __restrict__ ends,
          const T* __restrict__ ct,
          T* __restrict__ ct0, T* __restrict__ pbar, int n, int r_mode,
          int n_obj, int npts, int seg_len, const T* __restrict__ groups,
          int rays_per_group, int group_stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  decltype(auto) p = ray_params<T, GROUPED>(groups, rays_per_group,
                                            group_stride, i);
  T cy[8], ck1[8], cev[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cy[c] = ct[(PL_Y + c) * n + i];
    ck1[c] = ct[(PL_K1 + c) * n + i];
    cev[c] = ct[(PL_EV_Y0 + c) * n + i];
  }
  T pM = T(0), pa = T(0);
  T ry[MAX_SEG][8], rk[MAX_SEG][8], rdt[MAX_SEG];
  bool rhit[MAX_SEG];
  // The ray is active at the start of each of its segments s < e_i. The
  // warp walks from its largest end segment in step, each lane skipping
  // the segments at or past its own end.
  const int e = ends[i];
  const int top = __reduce_max_sync(__activemask(), e);
  for (int s = top - 1; s >= 0; --s) {
    if (s >= e) continue;
    const T* P = ck + static_cast<size_t>(s) * N_PLANES * n;
    RayState<T> r;
    load_state(P, n, i, r);
    int nrec = 0;
    for (int it = 0; it < seg_len && r.active > T(0); ++it) {
      T y_before[8], k_before[8], dt_try;
      bool hit_now;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        y_before[c] = r.y[c];
        k_before[c] = r.k1[c];
      }
      if (body_step<T, KERR, TSIT5, SC>(p, r_mode, n_obj, npts, r, dt_try,
                                        hit_now)) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          ry[nrec][c] = y_before[c];
          rk[nrec][c] = k_before[c];
        }
        rdt[nrec] = dt_try;
        rhit[nrec] = hit_now;
        ++nrec;
      }
    }
    for (int j = nrec - 1; j >= 0; --j) {
      T yb[8], kb[8], gM, ga;
      step_vjp<T, KERR, TSIT5>(p, r_mode, ry[j], rk[j], rdt[j], cy, ck1, yb,
                               kb, gM, ga);
      if (rhit[j]) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          yb[c] = yb[c] + cev[c];
          cev[c] = T(0);
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        cy[c] = yb[c];
        ck1[c] = kb[c];
      }
      pM = pM + gM;
      pa = pa + ga;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    ct0[(PL_Y + c) * n + i] = cy[c];
    ct0[(PL_K1 + c) * n + i] = ck1[c];
    ct0[(PL_EV_Y0 + c) * n + i] = cev[c];
  }
  pbar[2 * i] = pM;
  pbar[2 * i + 1] = pa;
}

// K3's pass: used (1 int) zeroed, k3_kernel, then k3_close, all on st.
// used[0] is n_used (the count of segments the per-segment chain runs),
// kept on the card: nothing on the path reads it.
template <typename T>
int launch_k3(void* ck, void* used, void* ends, const void* prm, int n,
              int kerr, int tsit5, int r_mode, int scene, int n_obj, int npts,
              int seg_len, int n_seg, const void* groups, int rays_per_group,
              int group_stride, void* stream) {
  if (!launch_ok(FIXED_SCENES, scene, n, n_obj, npts, MAX_THREADS) ||
      !groups_ok(groups, n, n_obj, rays_per_group, group_stride) ||
      seg_len < 1 || n_seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  T* c = static_cast<T*>(ck);
  int* u = static_cast<int*>(used);
  int* e = static_cast<int*>(ends);
  const T* gr = static_cast<const T*>(groups);
  cudaError_t err = cudaMemsetAsync(u, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_with_params<T>(prm, st, [&] {
    bool ok;
    RTGR_BOOL(gr != nullptr, GROUPED_,
              RTGR_DISPATCH(ok, T, kerr, tsit5, scene,
                            k3_kernel<T, KERR_, TSIT5_, SC_, GROUPED_>
                            <<<blocks, MAX_THREADS, 0, st>>>(
                                c, u, e, n, r_mode, n_obj, npts, seg_len,
                                n_seg, gr, rays_per_group, group_stride)))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_close<T><<<blocks, MAX_THREADS, 0, st>>>(c, e, n, n_seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k4(const void* ck, const void* ends, const void* ct, void* ct0,
              void* pbar, const void* prm, int n, int kerr, int tsit5,
              int r_mode, int scene, int n_obj, int npts, int seg_len,
              const void* groups, int rays_per_group, int group_stride,
              void* stream) {
  if (!launch_ok(FIXED_SCENES, scene, n, n_obj, npts, MAX_THREADS) ||
      !groups_ok(groups, n, n_obj, rays_per_group, group_stride) ||
      seg_len < 1 || seg_len > MAX_SEG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* c = static_cast<const T*>(ck);
  const int* e = static_cast<const int*>(ends);
  const T* g = static_cast<const T*>(ct);
  T* g0 = static_cast<T*>(ct0);
  T* pb = static_cast<T*>(pbar);
  const T* gr = static_cast<const T*>(groups);
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    bool ok;
    RTGR_BOOL(gr != nullptr, GROUPED_,
              RTGR_DISPATCH(ok, T, kerr, tsit5, scene,
                            k4_kernel<T, KERR_, TSIT5_, SC_, GROUPED_>
                            <<<blocks, MAX_THREADS, 0, st>>>(
                                c, e, g, g0, pb, n, r_mode, n_obj, npts,
                                seg_len, gr, rays_per_group, group_stride)))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  }));
}

}  // namespace

#if RTGR_F32
extern "C" int rtgr_k3_f32(void* ck, void* used, void* ends, const void* prm,
                           int n, int kerr, int tsit5, int r_mode, int scene,
                           int n_obj, int npts, int seg_len, int n_seg,
                           const void* groups, int rays_per_group,
                           int group_stride, void* stream) {
  return launch_k3<float>(ck, used, ends, prm, n, kerr, tsit5, r_mode, scene,
                          n_obj, npts, seg_len, n_seg, groups, rays_per_group,
                          group_stride, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k3_f64(void* ck, void* used, void* ends, const void* prm,
                           int n, int kerr, int tsit5, int r_mode, int scene,
                           int n_obj, int npts, int seg_len, int n_seg,
                           const void* groups, int rays_per_group,
                           int group_stride, void* stream) {
  return launch_k3<double>(ck, used, ends, prm, n, kerr, tsit5, r_mode, scene,
                           n_obj, npts, seg_len, n_seg, groups,
                           rays_per_group, group_stride, stream);
}
#endif

#if RTGR_F32
extern "C" int rtgr_k4_f32(const void* ck, const void* ends, const void* ct,
                           void* ct0, void* pbar, const void* prm, int n,
                           int kerr, int tsit5, int r_mode, int scene,
                           int n_obj, int npts, int seg_len,
                           const void* groups, int rays_per_group,
                           int group_stride, void* stream) {
  return launch_k4<float>(ck, ends, ct, ct0, pbar, prm, n, kerr, tsit5,
                          r_mode, scene, n_obj, npts, seg_len, groups,
                          rays_per_group, group_stride, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k4_f64(const void* ck, const void* ends, const void* ct,
                           void* ct0, void* pbar, const void* prm, int n,
                           int kerr, int tsit5, int r_mode, int scene,
                           int n_obj, int npts, int seg_len,
                           const void* groups, int rays_per_group,
                           int group_stride, void* stream) {
  return launch_k4<double>(ck, ends, ct, ct0, pbar, prm, n, kerr, tsit5,
                           r_mode, scene, n_obj, npts, seg_len, groups,
                           rays_per_group, group_stride, stream);
}
#endif


// The fence around a graph replay that holds K3 and K4 launches
// (params_fence in geodesic_common.cuh): called on the replay stream just
// before and just after the replay.
#if RTGR_F32
extern "C" int rtgr_fence_f32(void* stream) {
  return static_cast<int>(
      params_fence<float>(static_cast<cudaStream_t>(stream)));
}
#endif

#if RTGR_F64
extern "C" int rtgr_fence_f64(void* stream) {
  return static_cast<int>(
      params_fence<double>(static_cast<cudaStream_t>(stream)));
}
#endif
