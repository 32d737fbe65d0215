// K6 and K7: the training path's localization epilogue and its reverse mode
// on NVIDIA Hopper (sm_90a), a library of their own beside adjoint.cu (K3
// and K4), whose step VJP K7 shares (adjoint_common.cuh), so that the two
// libraries compile in parallel.
//
// K6 and K7 replace no TPU kernel. The JAX package runs the localization
// epilogue (localize_events_cm after the segments, pallas_adjoint.py:380)
// and its plain AD inside its one jitted step, where XLA fuses both into a
// few fusions; the port ran them as ~5,900 small PyTorch kernels per step.
// K6 is K1's ray_result over each ray's final state (one thread per ray): a
// hit ray's crossing step rebuilt from its record, the bisection, the
// Newton polish and the interpolation; any other ray's y and lam as they
// stand. It also writes a record for K7 (planes [R, n], REC_* below): each
// hit ray's bisection end theta0 and the crossing step's stages. K7 is its
// reverse mode, one thread per ray (ops/adjoint.py localize_vjp, operation
// by operation): from the record, y* and lam* back through the polish's
// clamps and ok selection, the VJP of the event's JVP (value and tangent:
// the dense output's derivative and the objects' fields take cotangents
// too), the dense output's data, and the crossing step (the step's reverse
// sweep on the kept stages, with each Tsit5 stage's own cotangent injected,
// then rhs_vjp of k1 = rhs(ev_y0)). It writes the cotangents of the y and
// ev_y0 planes, which K4 takes, and per ray those of M, a and every object
// field (summed by the wrapper), and zeros for a ray that did not hit or
// whose cotangents are zero. The localization has no trisection, so
// SC_REFINE launches their SC_ANY kernels.
//
// What bounds them on the H100: latency. At a training batch (40,000
// rays, ~2.4 blocks of 128 per SM) each is one chain per ray, run once per
// step. The design (PERF.md, section 6):
// * K7 replays nothing: K6 keeps what K7 read back before (12 right-hand
//   sides of Tsit5 and 8 of RK4 before the reverse sweep started, and the
//   40 dependent bisection steps), ~9 MB at 40,000 f32 Tsit5 rays, which
//   K7 reads while it is in L2 (a hit ray's rows only). The Tsit5 stages
//   are read where the sweep uses them, not held across it: K7 runs the
//   shared dense output and reverse sweep (tsit5_interp, tsit5_vjp) on
//   Kept, a view of the record.
// * K7 is a kernel of its own, so that K4's registers stay as they are,
//   and it fits one wave at a training batch (k7_min_blocks: at most 168
//   registers at f32, with some spilled, against 190-231 and two waves).
// * K6 bisects one level a step, as K1 does: a two-level round (the
//   midpoint and both quarter points as three independent chains) was
//   slower at every batch measured (PERF.md).

#include "adjoint_common.cuh"

namespace {

// The fixed scenes of the training path and the inversion, as adjoint.cu's.
constexpr int FIXED_SCENES = (1 << SC_SPS4) | (1 << SC_S4);

// The localization record (ops/adjoint.py REC_*, rec_planes), planes [R, n]:
// theta0, then the crossing step's stages from REC_K, 8 planes each:
// Tsit5's k1..k7; RK4's k1..k4, then f(y1) (REC_F1) and y1 (REC_Y1).
// Written for a hit ray only.
constexpr int REC_TH0 = 0, REC_K = 1, REC_F1 = REC_K + 32,
              REC_Y1 = REC_K + 40;
template <bool TSIT5>
__host__ __device__ constexpr int rec_planes() {
  return REC_K + 8 * (TSIT5 ? 7 : 6);
}

// The blocks of K7 (MAX_THREADS each) that must fit on an SM at once, by
// working type: at 40,000 rays (1,250 warps over 132 SMs) one wave needs 10
// warps an SM, 3 of them on each of its 4 register partitions, so at most
// 168 registers a thread. The f64 kernels (tests, the oracle's checks) keep
// the compiler's own count, which spills less.
template <typename T>
__host__ __device__ constexpr int k7_min_blocks() {
  return std::is_same<T, float>::value ? 3 : 1;
}

// --------------------------------------------------------------------------
// K6 and K7: the localization epilogue and its reverse mode
// (ops/adjoint.py localize_plain, localize_vjp).
// --------------------------------------------------------------------------
// The balanced min or max's weights (wa, wb), as balanced() takes them: 1 to
// the side taken, half to each on a tie.
template <typename T, bool MAX>
__device__ __forceinline__ void bal_w(T a, T b, T& wa, T& wb) {
  const T m = MAX ? nmax(a, b) : nmin(a, b);
  wa = a == m ? (b == m ? T(0.5) : T(1)) : T(0);
  wb = b == m ? (a == m ? T(0.5) : T(1)) : T(0);
}

// Reverse mode of object i's value and tangent (object_jvp) at x, dx: the
// cotangents (cv, cdv) added into cx and cdx, and the object's 8 field
// cotangents in f (OBJ_STRIDE order; zero for a field it does not read).
template <typename T, typename PP>
__device__ __forceinline__ void object_jvp_vjp(const PP& p, int i, int kind,
                                               const T* x, const T* dx, T cv,
                                               T cdv, T* cx, T* cdx, T* f) {
  const T* o = &p.obj[i * OBJ_STRIDE];
#pragma unroll
  for (int k = 0; k < OBJ_STRIDE; ++k) f[k] = T(0);
  if (kind == KIND_PLANE) {  // v = t - time, dv = dt
    cx[0] = cx[0] + cv;
    cdx[0] = cdx[0] + cdv;
    f[4] = -cv;
    return;
  }
  const T d[3] = {x[1] - o[0], x[2] - o[1], x[3] - o[2]};
  if (kind == KIND_SPHERE) {  // v = s (|d|^2 - r^2), dv = s 2 (d . dx)
    const T r = o[3], s = sgn(r);
    const T gv = s * cv;
    const T t = T(2) * (s * cdv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T cd = T(2) * d[c] * gv + t * dx[c + 1];
      cx[c + 1] = cx[c + 1] + cd;
      cdx[c + 1] = cdx[c + 1] + t * d[c];
      f[c] = -cd;
    }
    f[3] = -(T(2) * r * gv);
    return;
  }
  // disk: max(|dz| - half, max(rho2 - r_out^2, r_in^2 - rho2))
  const T r_in = o[5], r_out = o[6], half = o[7];
  const T rho2 = d[0] * d[0] + d[1] * d[1];
  const T slab = fabs(d[2]) - half;
  const T ra = rho2 - r_out * r_out, rb = r_in * r_in - rho2;
  T wra, wrb, wa, wb;
  bal_w<T, true>(ra, rb, wra, wrb);
  bal_w<T, true>(slab, nmax(ra, rb), wa, wb);
  const T c_slab = cv * wa, c_ring = cv * wb;
  const T c_dslab = cdv * wa, c_dring = cdv * wb;
  const T c_a = c_ring * wra, c_b = c_ring * wrb;
  const T c_rho2 = c_a - c_b;
  const T t = T(2) * (c_dring * wra - c_dring * wrb);
  const T c_dz = sgn(d[2]) * c_slab;
  cdx[3] = cdx[3] + (d[2] >= T(0) ? c_dslab : -c_dslab);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T cd = T(2) * d[c] * c_rho2 + t * dx[c + 1];
    cx[c + 1] = cx[c + 1] + cd;
    cdx[c + 1] = cdx[c + 1] + t * d[c];
    f[c] = -cd;
  }
  cx[3] = cx[3] + c_dz;
  f[2] = -c_dz;
  f[5] = T(2) * r_in * c_b;
  f[6] = -(T(2) * r_out * c_a);
  f[7] = -c_slab;
}

// Reverse mode of event_jvp (ops/adjoint.py _event_vjp): the fold's
// weights recomputed forward, then the objects last to first; each
// object's field cotangents are final once it is visited, and go straight
// to its rows of pbar (column i of [n_par, n], from row 2).
template <typename T, int SC, typename PP>
__device__ __forceinline__ void event_vjp(const PP& p, int n_obj,
                                          const T* x, const T* dx, T cv,
                                          T cdv, T* cx, T* cdx, T* pbar,
                                          int n, int ray) {
  const int no = scene_nobj<SC>(n_obj);
  T wa[MAX_OBJ], wb[MAX_OBJ];
  T v, dv_unused;
  object_jvp(p, 0, scene_kind<T, SC>(p, 0), x, dx, v, dv_unused);
#pragma unroll
  for (int i = 1; i < no; ++i) {
    T vi, dvi;
    object_jvp(p, i, scene_kind<T, SC>(p, i), x, dx, vi, dvi);
    bal_w<T, false>(v, vi, wa[i], wb[i]);
    v = nmin(v, vi);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cx[c] = T(0);
    cdx[c] = T(0);
  }
#pragma unroll
  for (int i = no - 1; i >= 0; --i) {
    T ci, cdi;
    if (i > 0) {
      ci = cv * wb[i];
      cdi = cdv * wb[i];
      cv = cv * wa[i];
      cdv = cdv * wa[i];
    } else {
      ci = cv;
      cdi = cdv;
    }
    T f[OBJ_STRIDE];
    object_jvp_vjp(p, i, scene_kind<T, SC>(p, i), x, dx, ci, cdi, cx, cdx,
                   f);
#pragma unroll
    for (int k = 0; k < OBJ_STRIDE; ++k)
      pbar[static_cast<size_t>(2 + OBJ_STRIDE * i + k) * n + ray] = f[k];
  }
}

// Reverse mode of the cubic Hermite dense output at th over ROWS rows (and,
// with DCT, of its derivative): the cotangents of (y0, y1, f0, f1) added
// into a, b, f0b, f1b (ops/adjoint.py _hermite_vjp).
template <typename T, int ROWS, bool DCT>
__device__ __forceinline__ void hermite_vjp(T th, T dt, const T* ct,
                                            const T* dct, T* a, T* b, T* f0b,
                                            T* f1b) {
  const T h = th * (th - T(1));
#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    const T ct_g = DCT ? h * ct[c] + (T(2) * th - T(1)) * dct[c] : h * ct[c];
    const T ct_y0 = (T(1) - th) * ct[c];
    const T ct_y1 = th * ct[c];
    T ct_d = (T(1) - T(2) * th) * ct_g;
    T ct_f0 = ((th - T(1)) * dt) * ct_g;
    T ct_f1 = (th * dt) * ct_g;
    if (DCT) {
      const T ct_dg = h * dct[c];
      ct_d = ct_d - T(2) * ct_dg + dct[c];
      ct_f0 = ct_f0 + dt * ct_dg;
      ct_f1 = ct_f1 + dt * ct_dg;
    }
    a[c] = ct_y0 - ct_d;
    b[c] = ct_y1 + ct_d;
    f0b[c] = ct_f0;
    f1b[c] = ct_f1;
  }
}

// K6's ray_result (geodesic_common.cuh): y* and lam* of a hit ray by
// localize_record's steps, and its record written to rec; any other ray's y
// and lam as they stand, its record left unwritten (K7 reads none).
template <typename T, bool KERR, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ void ray_result_kept(const PP& p, int r_mode,
                                                int n_obj, int bisect_iters,
                                                const RayState<T>& r,
                                                T* y_out, T& lam_out, T* rec,
                                                int n, int i) {
  if (!(r.hit > T(0))) {
#pragma unroll
    for (int c = 0; c < 8; ++c) y_out[c] = r.y[c];
    lam_out = r.lam;
    return;
  }
  StepData<T, TSIT5> s;
#pragma unroll
  for (int c = 0; c < 8; ++c) s.y0[c] = r.ev_y0[c];
  rhs<T, KERR>(p, r_mode, s.y0, s.k[0]);
  s.dt = r.ev_dt;
  if constexpr (TSIT5) {
    T err[8];
    tsit5_step<T, KERR>(p, r_mode, s, err);
  } else {
    rk4_step<T, KERR>(p, r_mode, s, &s.k[1][0]);  // k2..k4 into k[1..3]
  }
  constexpr int NK = TSIT5 ? 7 : 4;
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      rec[static_cast<size_t>(REC_K + 8 * j + c) * n + i] = s.k[j][c];
  if constexpr (!TSIT5) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      rec[static_cast<size_t>(REC_F1 + c) * n + i] = s.k[6][c];
      rec[static_cast<size_t>(REC_Y1 + c) * n + i] = s.y1[c];
    }
  }
  const T th0 = bisect<T, TSIT5, SC>(p, n_obj, bisect_iters, s, r.ev_lo,
                                     r.ev_hi);
  rec[static_cast<size_t>(REC_TH0) * n + i] = th0;
  // localize with no bisection is the Newton polish from th0.
  const T th = localize<T, TSIT5, SC>(p, n_obj, 0, s, th0, th0);
  interp<T, TSIT5, 8>(s, th, y_out);
  lam_out = r.ev_lam + th * r.ev_dt;
}

// K6: ray i's result from its packed final state (ray_result, as K1 ends),
// and its record for K7.
template <typename T, bool KERR, bool TSIT5, int SC, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS)
k6_kernel(const T* __restrict__ P, T* __restrict__ y_out,
          T* __restrict__ lam_out, T* __restrict__ rec, int n, int r_mode,
          int n_obj, int bisect_iters, const T* __restrict__ groups,
          int rays_per_group, int group_stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  decltype(auto) p = ray_params<T, GROUPED>(groups, rays_per_group,
                                            group_stride, i);
  RayState<T> r;
  load_state(P, n, i, r);
  T y[8], lam;
  ray_result_kept<T, KERR, TSIT5, SC>(p, r_mode, n_obj, bisect_iters, r, y,
                                      lam, rec, n, i);
#pragma unroll
  for (int c = 0; c < 8; ++c) y_out[c * n + i] = y[c];
  lam_out[i] = lam;
}

// A hit ray's Tsit5 stages k1..k7 in K6's record as the shared dense output
// and reverse sweep index them (ks[j][c]), each read where it is used.
template <typename T>
struct Kept {
  struct Row {
    const T* r;
    int n;
    __device__ __forceinline__ T operator[](int c) const {
      return __ldg(r + static_cast<size_t>(c) * n);
    }
  };
  const T* r;  // rec + REC_K n + i
  int n;
  __device__ __forceinline__ Row operator[](int j) const {
    return Row{r + static_cast<size_t>(8 * j) * n, n};
  }
};

// K7: the reverse mode of K6 after the dead-ray cutoff, per ray (the plain
// localize_vjp with K6's record, operation by operation). A ray that did
// not hit, or whose cotangents are all zero, writes zeros for ev_y0 and
// the parameters. A hit ray reads theta0 and the crossing step's stages
// from the record, redoes the polish from theta0 (one event JVP), then
// walks them back: y* at theta*, lam*, the clamps and the ok selection,
// the event's JVP (value and tangent), the dense output at the bracket's
// end, the stages (the step's reverse sweep, with the Tsit5 stages' own
// cotangents injected) and k1 = rhs(ev_y0). Writes every plane of ct_P
// [34, n] and every row of pbar [n_par, n].
template <typename T, bool KERR, bool TSIT5, int SC, bool GROUPED>
__global__ void __launch_bounds__(MAX_THREADS, k7_min_blocks<T>())
k7_kernel(const T* __restrict__ P, const T* __restrict__ rec,
          const T* __restrict__ ct_y, const T* __restrict__ ct_lam,
          T* __restrict__ ct_P, T* __restrict__ pbar, int n, int r_mode,
          int n_obj, const T* __restrict__ groups, int rays_per_group,
          int group_stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  decltype(auto) p = ray_params<T, GROUPED>(groups, rays_per_group,
                                            group_stride, i);
  const int n_par = 2 + OBJ_STRIDE * scene_nobj<SC>(n_obj);
  T cy[8];
  bool nonzero = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    cy[c] = ct_y[c * n + i];
    nonzero = nonzero || cy[c] != T(0);
  }
  const T cl = ct_lam[i];
  nonzero = nonzero || cl != T(0);
  const bool hit = P[PL_HIT * n + i] > T(0);
  const bool dead = !hit && !(P[PL_ACTIVE * n + i] > T(0)) &&
                    P[PL_LAM * n + i] < p.cfg[P_LAM_END];
  const bool keep = !hit && !dead;
  const bool live = hit && nonzero;
  for (int q = 0; q < N_PLANES; ++q) {
    if (q >= PL_Y && q < PL_Y + 8) continue;
    if (q >= PL_EV_Y0 && q < PL_EV_Y0 + 8 && live) continue;
    ct_P[q * n + i] = T(0);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) ct_P[(PL_Y + c) * n + i] = keep ? cy[c] : T(0);
  if (!live) {
    for (int q = 0; q < n_par; ++q)
      pbar[static_cast<size_t>(q) * n + i] = T(0);
    return;
  }

  // -- forward: the polish from the record's theta0 --
  T y0[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) y0[c] = P[(PL_EV_Y0 + c) * n + i];
  const T dt = P[PL_EV_DT * n + i];
  const T th0 = rec[static_cast<size_t>(REC_TH0) * n + i];
  const Kept<T> k{rec + static_cast<size_t>(REC_K) * n + i, n};
  StepData<T, false> h;  // RK4: the Hermite's data
  T x[4], dx[4], val, dval;
  if constexpr (TSIT5) {
    tsit5_interp<4>(y0, k, dt, th0, x);
    tsit5_dinterp<4>(k, dt, th0, dx);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      h.y0[c] = y0[c];
      h.k[0][c] = rec[static_cast<size_t>(REC_K + c) * n + i];
      h.k[6][c] = rec[static_cast<size_t>(REC_F1 + c) * n + i];
      h.y1[c] = rec[static_cast<size_t>(REC_Y1 + c) * n + i];
    }
    h.dt = dt;
    interp<T, false, 4>(h, th0, x);
    dinterp<T, false>(h, th0, dx);
  }
  event_jvp<T, SC>(p, n_obj, x, dx, val, dval);
  const bool ok = fabs(dval) > T(1e-3) * (T(1) + fabs(val));
  const T den = ok ? dval : T(1);
  const T delta = (ok ? val : T(0)) / den;
  const T u = th0 - clip(delta, T(-1), T(1));
  const T th = clip(u, T(0), T(1));

  // -- reverse --
  T d8[8];
  if constexpr (TSIT5) tsit5_dinterp<8>(k, dt, th, d8);
  else dinterp<T, false, 8>(h, th, d8);
  T ct_th = cl * dt;
#pragma unroll
  for (int c = 0; c < 8; ++c) ct_th = ct_th + cy[c] * d8[c];
  const T ct_u = (u >= T(0) && u <= T(1)) ? ct_th : T(0);
  const T ct_delta = -((delta >= T(-1) && delta <= T(1)) ? ct_u : T(0));
  const T q = ct_delta / den;
  const T ct_val = ok ? q : T(0);
  const T ct_dval = ok ? -(q * delta) : T(0);
  T cx[4], cdx[4];
  event_vjp<T, SC>(p, n_obj, x, dx, ct_val, ct_dval, cx, cdx, pbar, n, i);
  T ct_y0[8], yb[8], ct_k1[8], gM, ga;
  if constexpr (TSIT5) {
    T bw[7], b0[7], db0[7];
    tsit5_bi(th, bw);
    tsit5_bi(th0, b0);
    tsit5_dbi(th0, db0);
    // Stage j's own cotangent, formed where the sweep adds it: bw[j] dt cy
    // on every row, plus b0[j] dt cx + db0[j] dt cdx on the position rows
    // (the dense output at theta*, and its value and derivative at theta0).
    auto ctk = [&](int j, int c) {
      T v = bw[j] * (dt * cy[c]);
      if (c < 4) v = v + b0[j] * (dt * cx[c]) + db0[j] * (dt * cdx[c]);
      return v;
    };
    T ct7[8], zero[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ct_y0[c] = c < 4 ? cy[c] + cx[c] : cy[c];
      ct7[c] = ctk(6, c);
      zero[c] = T(0);
    }
    tsit5_vjp<T, KERR>(p, r_mode, y0, k, dt, zero, ct7, yb, ct_k1, gM, ga,
                       ctk);
  } else {
    T a8[8], b8[8], f08[8], f18[8], a4[4], b4[4], f04[4], f14[4];
    hermite_vjp<T, 8, false>(th, dt, cy, nullptr, a8, b8, f08, f18);
    hermite_vjp<T, 4, true>(th0, dt, cx, cdx, a4, b4, f04, f14);
    T ct_y1[8], ct_f0[8], ct_f1[8], k1b[8], ks[3][8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ct_y0[c] = c < 4 ? a8[c] + a4[c] : a8[c];
      ct_y1[c] = c < 4 ? b8[c] + b4[c] : b8[c];
      ct_f0[c] = c < 4 ? f08[c] + f04[c] : f08[c];
      ct_f1[c] = c < 4 ? f18[c] + f14[c] : f18[c];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        ks[j][c] = rec[static_cast<size_t>(REC_K + 8 * (j + 1) + c) * n + i];
    }
    rk4_vjp<T, KERR>(p, r_mode, y0, h.k[0], ks[0], ks[1], ks[2], dt, ct_y1,
                     ct_f1, yb, k1b, gM, ga);
#pragma unroll
    for (int c = 0; c < 8; ++c) ct_k1[c] = ct_f0[c] + k1b[c];
  }
  T g[8], dM, da;
  rhs_vjp<T, KERR>(p, r_mode, y0, ct_k1, g, dM, da);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    ct_P[(PL_EV_Y0 + c) * n + i] = ct_y0[c] + yb[c] + g[c];
  pbar[i] = gM + dM;
  pbar[static_cast<size_t>(n) + i] = ga + da;
}

// K6's and K7's launches: the flags of K3 and K4 (npts only checked), and
// SC_ANY in place of SC_REFINE (no trisection here, so no SC_REFINE kernel
// is built for them); K6 also takes the bisection count.
inline bool localize_ok(int scene, int n, int n_obj, int npts,
                        const void* groups, int rays_per_group,
                        int group_stride) {
  return scene != SC_REFINE &&
         launch_ok(FIXED_SCENES, scene, n, n_obj, npts, MAX_THREADS) &&
         groups_ok(groups, n, n_obj, rays_per_group, group_stride);
}

template <typename T>
int launch_k6(const void* P, void* y, void* lam, void* rec, const void* prm,
              int n, int kerr, int tsit5, int r_mode, int scene, int n_obj,
              int npts, int bisect_iters, const void* groups,
              int rays_per_group, int group_stride, void* stream) {
  if (!localize_ok(scene, n, n_obj, npts, groups, rays_per_group,
                   group_stride) ||
      bisect_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* pp = static_cast<const T*>(P);
  T* yo = static_cast<T*>(y);
  T* lo = static_cast<T*>(lam);
  T* rc = static_cast<T*>(rec);
  const T* gr = static_cast<const T*>(groups);
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    bool ok;
    RTGR_BOOL(gr != nullptr, GROUPED_,
              RTGR_DISPATCH_SC(ok, T, kerr, tsit5, scene, false,
                               k6_kernel<T, KERR_, TSIT5_, SC_, GROUPED_>
                               <<<blocks, MAX_THREADS, 0, st>>>(
                                   pp, yo, lo, rc, n, r_mode, n_obj,
                                   bisect_iters, gr, rays_per_group,
                                   group_stride)))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  }));
}

template <typename T>
int launch_k7(const void* P, const void* rec, const void* ct_y,
              const void* ct_lam, void* ct_P, void* pbar, const void* prm,
              int n, int kerr, int tsit5, int r_mode, int scene, int n_obj,
              int npts, const void* groups, int rays_per_group,
              int group_stride, void* stream) {
  if (!localize_ok(scene, n, n_obj, npts, groups, rays_per_group,
                   group_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
  const T* pp = static_cast<const T*>(P);
  const T* rc = static_cast<const T*>(rec);
  const T* cy = static_cast<const T*>(ct_y);
  const T* cl = static_cast<const T*>(ct_lam);
  T* cp = static_cast<T*>(ct_P);
  T* pb = static_cast<T*>(pbar);
  const T* gr = static_cast<const T*>(groups);
  return static_cast<int>(launch_with_params<T>(prm, st, [&] {
    bool ok;
    RTGR_BOOL(gr != nullptr, GROUPED_,
              RTGR_DISPATCH_SC(ok, T, kerr, tsit5, scene, false,
                               k7_kernel<T, KERR_, TSIT5_, SC_, GROUPED_>
                               <<<blocks, MAX_THREADS, 0, st>>>(
                                   pp, rc, cy, cl, cp, pb, n, r_mode, n_obj,
                                   gr, rays_per_group, group_stride)))
    return ok ? cudaGetLastError() : cudaErrorInvalidValue;
  }));
}

}  // namespace

#define RTGR_K6(NAME, T)                                                     \
  extern "C" int NAME(const void* P, void* y, void* lam, void* rec,          \
                      const void* prm, int n, int kerr, int tsit5,           \
                      int r_mode, int scene, int n_obj, int npts,            \
                      int bisect_iters, const void* groups,                  \
                      int rays_per_group, int group_stride, void* stream) {  \
    return launch_k6<T>(P, y, lam, rec, prm, n, kerr, tsit5, r_mode, scene, \
                        n_obj, npts, bisect_iters, groups, rays_per_group,  \
                        group_stride, stream);                              \
  }
#define RTGR_K7(NAME, T)                                                     \
  extern "C" int NAME(const void* P, const void* rec, const void* ct_y,      \
                      const void* ct_lam, void* ct_P, void* pbar,            \
                      const void* prm, int n, int kerr, int tsit5,           \
                      int r_mode, int scene, int n_obj, int npts,            \
                      const void* groups, int rays_per_group,                \
                      int group_stride, void* stream) {                      \
    return launch_k7<T>(P, rec, ct_y, ct_lam, ct_P, pbar, prm, n, kerr,     \
                        tsit5, r_mode, scene, n_obj, npts, groups,          \
                        rays_per_group, group_stride, stream);              \
  }
#if RTGR_F32
RTGR_K6(rtgr_k6_f32, float)
RTGR_K7(rtgr_k7_f32, float)
#endif
#if RTGR_F64
RTGR_K6(rtgr_k6_f64, double)
RTGR_K7(rtgr_k7_f64, double)
#endif

// The fence around a graph replay that holds K6 and K7 launches
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
