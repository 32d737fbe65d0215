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
// is replayed from its checkpoint, each accepted step's record (y, k1,
// dt_try, hit; RK4 also its stages) kept in local memory, and then walked
// back with the hand-written adjoint of the step (step_vjp; RK4's rk4_vjp
// on the kept stages) and of the right-hand side (rhs_vjp). CUDA has no
// autodiff inside a kernel; the TPU kernel took jax.vjp of the step body
// (adjoint_common.cuh, shared with K7).
// The start of the pass is here too: K3's prologue builds each ray's
// initial state from its launch state y0 (init_state, and initial_step
// where the caller gives no first step), and K10, launched right after K4,
// is its VJP back to y0, M and a (the JAX package's init and its AD, which
// XLA fuses around the two pallas_calls of its jitted step; ops/adjoint.py
// init_plain and init_vjp).
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
// runs; K4 reads one checkpoint per live segment, replays its steps and
// walks them back. What bounds K4's RK4 path on the H100 (PERF.md): at a
// training batch of 200x200 rays (1,250 warps on the card's 528
// schedulers) the schedulers' issue (half and twice the batch took 0.66
// and 1.73 of its time); at config 5 (1,024 to 16,384 rays, a warp or
// fewer per scheduler) each warp's chain (1.40-1.53 ms at 1 to 16 starts,
// ~11.7 us a step). Before, a step's reverse sweep recomputed the three
// forward right-hand sides its replay had just computed: 7 rhs and 4 rhs
// VJPs a step where 4 and 4 do. The walk:
// * RK4 keeps the replay's stages k2, k3 and k4 in the step's record (41
//   values, not 17), and the reverse sweep (rk4_vjp) runs no forward rhs:
//   the same numbers, bitwise. K4 took 21-27% less time at rk4/200 and at
//   config 5 (with the rest: rk4/200 1.73 to 1.14 ms, config 5 at 1, 4
//   and 16 starts 1.37-1.41/1.51-1.53/1.54-1.56 to 1.11/1.22-1.27/
//   1.25-1.32).
// * Thread t walks ray order[t]: the rays by end segment, largest first
//   (ops/adjoint.py work_order_cuda: a stable counting sort in three small
//   kernels, k4_order_*, 7 us against a general sort's 35 us), so that a
//   warp's lanes share their walk and the longest walks start first:
//   4-10% less time at rk4/200, 23-25% at tsit5/48, as fast at config 5's
//   1 and 4 starts and up to 6% slower at 16 (512 warps), where the
//   rays' own order would need a second path for ~0.06 ms of a 6.9 ms
//   step.
// * The records stay in local memory, sized for MAX_SEG steps (5.2 KB a
//   thread for RK4 at f32, 2.2 KB for Tsit5), where the compiler keeps
//   them in L1; CUDA keeps that stack for every thread the card can
//   hold (780 MiB more device memory than 2.2 KB did). Measured and
//   dropped: a scratch buffer in device memory sized to the segment (2-5%
//   slower: its stores go through to L2), and a ring in shared memory
//   (slower where it cut the warps an SM holds: 1.96 against 1.38 ms at
//   rk4/200).
// * Blocks of MAX_THREADS, a warp on each of an SM's four schedulers.
//   Measured and dropped: blocks of 32 and 64 (rk4/200 1.36 and 1.25
//   against 1.17 ms; tsit5/48 3.11 and 2.62 against 2.08).
// The Tsit5 adjoint's stages are unrolled at compile time
// (stage_input<ROW>, back_stage<M>), its tableau entries are immediates
// (ts_a folds), and its stage arrays ks and kb live in registers (f32
// Kerr-Schild: 222 registers, no spills; before, ks, kb and the tableau
// were ~3,900 local loads and stores). As in K1 and K2 the parameters are
// constant-bank operands (launch_with_params) and the training path's
// scene compile-time (SC_SPS4, example2 with 4 detection samples; SC_S4,
// the inversion's lensing scene).
//
// Grouped launches (GROUPED, a table in device memory): one K3 and one K4
// launch carry all starts of a vectorized multistart fit, each ray reading
// M, a and the object rows of its start (GroupParams in
// geodesic_common.cuh); the starts' rays are a batch as one start's are, so
// a step costs one launch of each at any number of starts. The ungrouped
// instantiations compile as they did before the flag.

#include <climits>

#include <cooperative_groups.h>

#include "adjoint_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The fixed scenes of this library's main paths: the training path
// (example2, 4 detection samples) and the inversion's lensing scene (one
// sphere, 4 samples).
constexpr int FIXED_SCENES = (1 << SC_SPS4) | (1 << SC_S4);

// The longest segment K4 replays: a segment's hit flags are the bits of
// one 32-bit word.
constexpr int MAX_SEG = 32;

// --------------------------------------------------------------------------
// The kernels
// --------------------------------------------------------------------------
// K3: the whole forward pass in one launch. Its prologue builds ray i's
// initial state from its launch state y0 [8, n] (init_state: k1 = rhs(y0),
// the event record at y0) at the step dt0[i], or with dt0 null at its own
// initial step (initial_step: rk4_dt, or Hairer's for Tsit5, one more rhs),
// the plain init_plain's bitwise, and writes it to checkpoint 0; the JAX
// package's jitted step builds it from the traced parameters and XLA fuses
// it around _fwd_seg_launch. Then ray i walks its segments from
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
k3_kernel(const T* __restrict__ y0, const T* __restrict__ dt0,
          T* __restrict__ ck, int* __restrict__ used, int* __restrict__ ends,
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
    init_state<T, KERR>(p, r_mode, y0, dt0, n, i, r);
    if (dt0 == nullptr)
      r.dt = initial_step<T, KERR, TSIT5>(p, r_mode, r.y, r.k1);
    store_state(ck, n, i, r);
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

// K4: thread t walks ray i = order[t] (the wrapper's work order) back from
// its end segment e_i. Each of its segments is replayed from its checkpoint
// and each accepted step's record kept in local memory: y and k1 before it
// and dt_try (REC values), for RK4 also the step's stages k2, k3 and k4
// (REC_KEEP values: the reverse sweep then runs no forward rhs), and
// whether it hit (a bit of `hits`). Then the steps are walked back. It
// writes the cotangents of ck[0]'s y, k1 and ev_y0 planes to ct0, which K10
// takes on to the launch states.
constexpr int REC = 17;
constexpr int REC_KEEP = REC + 24;

template <typename T, bool KERR, bool TSIT5, int SC, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS)
k4_kernel(const T* __restrict__ ck, const int* __restrict__ ends,
          const long long* __restrict__ order, const T* __restrict__ ct,
          T* __restrict__ ct0, T* __restrict__ pbar, int n, int r_mode,
          int n_obj, int npts, int seg_len, const T* __restrict__ groups,
          int rays_per_group, int group_stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int i = static_cast<int>(order[t]);
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
  constexpr int RN = TSIT5 ? REC : REC_KEEP;  // a step's record
  T rec[MAX_SEG * RN];
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
    unsigned hits = 0u;
    for (int it = 0; it < seg_len && r.active > T(0); ++it) {
      T y_before[8], k_before[8], stages[24], dt_try;
      bool hit_now;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        y_before[c] = r.y[c];
        k_before[c] = r.k1[c];
      }
      if (body_step<T, KERR, TSIT5, SC>(p, r_mode, n_obj, npts, r, dt_try,
                                        hit_now,
                                        TSIT5 ? nullptr : stages)) {
        T* q = rec + nrec * RN;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          q[c] = y_before[c];
          q[8 + c] = k_before[c];
        }
        q[16] = dt_try;
        if constexpr (!TSIT5) {
#pragma unroll
          for (int c = 0; c < 24; ++c) q[REC + c] = stages[c];
        }
        if (hit_now) hits |= 1u << nrec;
        ++nrec;
      }
    }
    for (int j = nrec - 1; j >= 0; --j) {
      const T* q = rec + j * RN;
      T y[8], k1[8], yb[8], kb[8], gM, ga;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        y[c] = q[c];
        k1[c] = q[8 + c];
      }
      const T dt = q[16];
      if constexpr (TSIT5) {
        step_vjp<T, KERR, TSIT5>(p, r_mode, y, k1, dt, cy, ck1, yb, kb, gM,
                                 ga);
      } else {
        T st[24];
#pragma unroll
        for (int c = 0; c < 24; ++c) st[c] = q[REC + c];
        rk4_vjp<T, KERR>(p, r_mode, y, k1, st, st + 8, st + 16, dt, cy, ck1,
                         yb, kb, gM, ga);
      }
      if ((hits >> j) & 1u) {
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

// K10: the VJP of K3's prologue, one thread per ray, launched right after
// K4 (ops/adjoint.py init_vjp). The launch state y0 (the y planes of ck[0])
// is the initial state's y and ev_y0 as it is and reaches its k1 = rhs(y0)
// through rhs_vjp, so ct_y0 = ct_y + ct_ev_y0 + rhs_vjp's y part, from K4's
// cotangents of ck[0] (ct0), written to ct_y0 [8, n], and rhs_vjp's (M, a)
// part is added to the ray's row of pbar. Bound by its loads and stores at
// a training batch (34 values in, 10 out a ray, ~870 operations). A kernel
// of its own, not K4's epilogue: folded into K4 it cost K4 0.05-0.13 ms at
// rk4/200, far beyond its own work (PERF.md).
template <typename T, bool KERR, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS)
k10_kernel(const T* __restrict__ ck, const T* __restrict__ ct0,
           T* __restrict__ ct_y0, T* __restrict__ pbar, int n, int r_mode,
           const T* __restrict__ groups, int rays_per_group,
           int group_stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  decltype(auto) p = ray_params<T, GROUPED>(groups, rays_per_group,
                                            group_stride, i);
  T y0[8], ck1[8], g[8], gM, ga;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    y0[c] = ck[(PL_Y + c) * n + i];
    ck1[c] = ct0[(PL_K1 + c) * n + i];
  }
  rhs_vjp<T, KERR>(p, r_mode, y0, ck1, g, gM, ga);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    ct_y0[c * n + i] =
        ct0[(PL_Y + c) * n + i] + ct0[(PL_EV_Y0 + c) * n + i] + g[c];
  pbar[2 * i] = pbar[2 * i] + gM;
  pbar[2 * i + 1] = pbar[2 * i + 1] + ga;
}

// K3's pass: used (1 int) zeroed, k3_kernel, then k3_close, all on st.
// used[0] is n_used (the count of segments the per-segment chain runs),
// kept on the card: nothing on the path reads it.
template <typename T>
int launch_k3(const void* y0, const void* dt0, void* ck, void* used,
              void* ends, const void* prm, int n, int kerr, int tsit5,
              int r_mode, int scene, int n_obj, int npts, int seg_len,
              int n_seg, const void* groups, int rays_per_group,
              int group_stride, void* stream) {
  if (!launch_ok(FIXED_SCENES, scene, n, n_obj, npts, MAX_THREADS) ||
      !groups_ok(groups, n, n_obj, rays_per_group, group_stride) ||
      seg_len < 1 || n_seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* y = static_cast<const T*>(y0);
  const T* d = static_cast<const T*>(dt0);
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
                                y, d, c, u, e, n, r_mode, n_obj, npts,
                                seg_len, n_seg, gr, rays_per_group,
                                group_stride)))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_close<T><<<blocks, MAX_THREADS, 0, st>>>(c, e, n, n_seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k4(const void* ck, const void* ends, const void* order,
              const void* ct, void* ct0, void* pbar, const void* prm, int n,
              int kerr, int tsit5, int r_mode, int scene, int n_obj,
              int npts, int seg_len, const void* groups, int rays_per_group,
              int group_stride, void* stream) {
  if (!launch_ok(FIXED_SCENES, scene, n, n_obj, npts, MAX_THREADS) ||
      !groups_ok(groups, n, n_obj, rays_per_group, group_stride) ||
      order == nullptr || seg_len < 1 || seg_len > MAX_SEG)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* c = static_cast<const T*>(ck);
  const int* e = static_cast<const int*>(ends);
  const long long* o = static_cast<const long long*>(order);
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
                                c, e, o, g, g0, pb, n, r_mode, n_obj, npts,
                                seg_len, gr, rays_per_group, group_stride)))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  }));
}

template <typename T>
int launch_k10(const void* ck, const void* ct0, void* ct_y0, void* pbar,
               const void* prm, int n, int kerr, int r_mode,
               const void* groups, int n_obj, int rays_per_group,
               int group_stride, void* stream) {
  if (n < 1 || !groups_ok(groups, n, n_obj, rays_per_group, group_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* c = static_cast<const T*>(ck);
  const T* g0 = static_cast<const T*>(ct0);
  T* gy = static_cast<T*>(ct_y0);
  T* pb = static_cast<T*>(pbar);
  const T* gr = static_cast<const T*>(groups);
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    RTGR_BOOL(gr != nullptr, GROUPED_,
              RTGR_BOOL(kerr, KERR_,
                        k10_kernel<T, KERR_, GROUPED_>
                        <<<blocks, MAX_THREADS, 0, st>>>(
                            c, g0, gy, pb, n, r_mode, gr, rays_per_group,
                            group_stride)))
    return cudaGetLastError();
  }));
}

// K4's work order (ops/adjoint.py work_order_cuda): the rays by end
// segment, largest first, and in index order within one end segment: a
// stable counting sort over the n_seg + 1 end segments (bin n_seg - e, so
// the largest end is bin 0), in one launch of one thread block cluster of
// ORDER_CTAS blocks on as many SMs. Replaces no TPU kernel (the TPU kernel
// walks its rays in pixel order). Bound: 4 bytes read and 8 written a ray,
// ~0.15 us at 40,000 rays, so what sets its time is latency: the launch,
// the loads, the barriers and each warp's chain of rounds. Hence one
// launch, in which each warp owns a contiguous segment of the rays
// (segment s = block rank x warps + warp), 32 rays a round
// (__match_any_sync groups a round's lanes of one bin: a pixel-order
// batch's neighbours mostly share their end):
//   1. each warp counts its segment's bins into its own row of shared
//      memory (a group's first lane adds its size), keeping up to
//      ORDER_BATCH rounds of ends in registers for step 3, and adds its row
//      into the block's totals (shared atomics: sums, which no order
//      changes); cluster barrier;
//   2. a warp per bin reads the bin's count in every block through
//      distributed shared memory (a lane per block): the count in the
//      lower-ranked blocks, and in the cluster; each row becomes its warp's
//      first place within the bin (a lane per row, a warp-wide scan); then
//      one warp scans the cluster's counts over the bins: each bin's first
//      place;
//   3. each warp walks its segment again and writes each ray's index at its
//      place, a round's lanes of one bin by lane (their rank in the group),
//      the rounds in order.
// Deterministic: no atomic decides a place. Only the f32 half of the
// library compiles it (it takes no working type).
#if RTGR_F32
constexpr int ORDER_CTAS = 8;  // the blocks of the cluster (portable size)
constexpr int ORDER_BATCH = 8;

__device__ __forceinline__ int order_bin(int e, int bins) {
  return bins - 1 - min(max(e, 0), bins - 1);
}

// The inclusive sum of v over the lanes up to this one.
__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// Shared memory: rows [warps][bins] (a warp's counts, then its places
// within the bins), totals [bins] (the block's counts, read by the
// cluster), first [bins] (the cluster's counts, then each bin's first
// place).
__global__ void __cluster_dims__(ORDER_CTAS, 1, 1) __launch_bounds__(1024)
k4_order_kernel(const int* __restrict__ ends, long long* __restrict__ order,
                int n, int bins) {
  extern __shared__ int smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = smem + warp * bins;
  int* totals = smem + warps * bins;
  int* first = totals + bins;
  for (int b = lane; b < bins; b += 32) row[b] = 0;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) totals[b] = 0;
  // This warp's segment [lo, hi), whole rounds of 32.
  const int segs = ORDER_CTAS * warps;
  const int len = ((n + segs - 1) / segs + 31) / 32 * 32;
  const int lo = min(n, (rank * warps + warp) * len);
  const int hi = min(n, lo + len);
  const bool one_batch = hi - lo <= 32 * ORDER_BATCH;
  const unsigned below = (1u << lane) - 1u;
  __syncthreads();

  // 1. Count.
  int bin[ORDER_BATCH];
  for (int b0 = lo; b0 < hi; b0 += 32 * ORDER_BATCH) {
#pragma unroll
    for (int r = 0; r < ORDER_BATCH; ++r) {
      const int k = b0 + 32 * r + lane;
      bin[r] = k < hi ? order_bin(__ldg(ends + k), bins) : -1;
    }
#pragma unroll
    for (int r = 0; r < ORDER_BATCH; ++r) {
      if (b0 + 32 * r >= hi) break;
      const unsigned same = __match_any_sync(0xffffffffu, bin[r]);
      if (bin[r] >= 0 && (same & below) == 0) row[bin[r]] += __popc(same);
      __syncwarp();
    }
  }
  for (int b = lane; b < bins; b += 32)
    if (row[b]) atomicAdd(&totals[b], row[b]);
  cluster.sync();

  // 2. A warp per bin: its count in each block (a lane per block), this
  //    block's start within the bin, the cluster's count; each row's first
  //    place within the bin (a lane per row).
  for (int b = warp; b < bins; b += warps) {
    const int c = lane < ORDER_CTAS ? cluster.map_shared_rank(totals, lane)[b]
                                    : 0;
    const int upto = warp_inclusive(c);
    const int before = __shfl_sync(0xffffffffu, upto - c, rank);
    if (lane == 31) first[b] = upto;
    const int v = lane < warps ? smem[lane * bins + b] : 0;
    if (lane < warps) smem[lane * bins + b] = before + warp_inclusive(v) - v;
  }
  // The other blocks' reads of totals are done once all have arrived here;
  // the wait is at the end, before any block's shared memory goes away.
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  __syncthreads();
  if (warp == 0) {  // the exclusive scan of first over the bins
    int carry = 0;
    for (int b0 = 0; b0 < bins; b0 += 32) {
      const int k = b0 + lane;
      const int v = k < bins ? first[k] : 0;
      const int x = warp_inclusive(v);
      if (k < bins) first[k] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();

  // 3. Scatter.
  for (int b0 = lo; b0 < hi; b0 += 32 * ORDER_BATCH) {
    if (!one_batch) {
#pragma unroll
      for (int r = 0; r < ORDER_BATCH; ++r) {
        const int k = b0 + 32 * r + lane;
        bin[r] = k < hi ? order_bin(__ldg(ends + k), bins) : -1;
      }
    }
#pragma unroll
    for (int r = 0; r < ORDER_BATCH; ++r) {
      if (b0 + 32 * r >= hi) break;
      const int b = bin[r];
      const unsigned same = __match_any_sync(0xffffffffu, b);
      if (b >= 0)
        order[first[b] + row[b] + __popc(same & below)] = b0 + 32 * r + lane;
      __syncwarp();
      if (b >= 0 && (same & below) == 0) row[b] += __popc(same);
      __syncwarp();
    }
  }
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// The launch on st: one cluster of ORDER_CTAS blocks of 32 warps where the
// bins leave room for their rows in shared memory, fewer where they do not.
int launch_k4_order(const int* ends, long long* order, int n, int bins,
                    cudaStream_t st) {
  // Dynamic shared memory up to the opt-in limit less 1 KB.
  static int limit[MAX_DEVICES];
  int dev;
  cudaError_t err = current_device(dev);
  if (err == cudaSuccess && limit[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k4_order_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - 1024);
    if (err == cudaSuccess) limit[dev] = optin - 1024;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || bins < 1 || n > INT_MAX - 32 * 1024 * ORDER_CTAS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long room = limit[dev] / 4 / bins - 2;
  const int warps = static_cast<int>(min(32LL, room));
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(int) * static_cast<size_t>(bins) * (warps + 2);
  k4_order_kernel<<<ORDER_CTAS, 32 * warps, bytes, st>>>(ends, order, n,
                                                         bins);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

#if RTGR_F32
extern "C" int rtgr_k3_f32(const void* y0, const void* dt0, void* ck,
                           void* used, void* ends, const void* prm, int n,
                           int kerr, int tsit5, int r_mode, int scene,
                           int n_obj, int npts, int seg_len, int n_seg,
                           const void* groups, int rays_per_group,
                           int group_stride, void* stream) {
  return launch_k3<float>(y0, dt0, ck, used, ends, prm, n, kerr, tsit5,
                          r_mode, scene, n_obj, npts, seg_len, n_seg, groups,
                          rays_per_group, group_stride, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k3_f64(const void* y0, const void* dt0, void* ck,
                           void* used, void* ends, const void* prm, int n,
                           int kerr, int tsit5, int r_mode, int scene,
                           int n_obj, int npts, int seg_len, int n_seg,
                           const void* groups, int rays_per_group,
                           int group_stride, void* stream) {
  return launch_k3<double>(y0, dt0, ck, used, ends, prm, n, kerr, tsit5,
                           r_mode, scene, n_obj, npts, seg_len, n_seg, groups,
                           rays_per_group, group_stride, stream);
}
#endif

#if RTGR_F32
extern "C" int rtgr_k4_f32(const void* ck, const void* ends,
                           const void* order, const void* ct, void* ct0,
                           void* pbar, const void* prm, int n, int kerr,
                           int tsit5, int r_mode, int scene, int n_obj,
                           int npts, int seg_len, const void* groups,
                           int rays_per_group, int group_stride,
                           void* stream) {
  return launch_k4<float>(ck, ends, order, ct, ct0, pbar, prm, n, kerr,
                          tsit5, r_mode, scene, n_obj, npts, seg_len, groups,
                          rays_per_group, group_stride, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k4_f64(const void* ck, const void* ends,
                           const void* order, const void* ct, void* ct0,
                           void* pbar, const void* prm, int n, int kerr,
                           int tsit5, int r_mode, int scene, int n_obj,
                           int npts, int seg_len, const void* groups,
                           int rays_per_group, int group_stride,
                           void* stream) {
  return launch_k4<double>(ck, ends, order, ct, ct0, pbar, prm, n, kerr,
                           tsit5, r_mode, scene, n_obj, npts, seg_len, groups,
                           rays_per_group, group_stride, stream);
}
#endif


#if RTGR_F32
extern "C" int rtgr_k10_f32(const void* ck, const void* ct0, void* ct_y0,
                            void* pbar, const void* prm, int n, int kerr,
                            int r_mode, const void* groups, int n_obj,
                            int rays_per_group, int group_stride,
                            void* stream) {
  return launch_k10<float>(ck, ct0, ct_y0, pbar, prm, n, kerr, r_mode, groups,
                           n_obj, rays_per_group, group_stride, stream);
}
#endif

#if RTGR_F64
extern "C" int rtgr_k10_f64(const void* ck, const void* ct0, void* ct_y0,
                            void* pbar, const void* prm, int n, int kerr,
                            int r_mode, const void* groups, int n_obj,
                            int rays_per_group, int group_stride,
                            void* stream) {
  return launch_k10<double>(ck, ct0, ct_y0, pbar, prm, n, kerr, r_mode,
                            groups, n_obj, rays_per_group, group_stride,
                            stream);
}
#endif


#if RTGR_F32
extern "C" int rtgr_k4_order(const void* ends, void* order, int n,
                             int bins, void* stream) {
  return launch_k4_order(static_cast<const int*>(ends),
                         static_cast<long long*>(order), n, bins,
                         static_cast<cudaStream_t>(stream));
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
