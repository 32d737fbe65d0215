// Device code shared by the kernels of this directory: the parameter block,
// the Kerr-Schild and Minkowski right-hand side, the scene event and its
// derivative, dense output, the detection sweep and its gate, localization,
// and the Tsit5 and RK4 stage sweeps, the packed loop state and one step of
// the loop body. K1 (geodesic.cu), K2 (compaction.cu), K3 and K4 (adjoint.cu)
// step alike because they include the same functions, and K6 (adjoint.cu)
// localizes as K1 does. Each follows the
// plain PyTorch version in ops/geodesic_cm.py operation by operation (build
// with --fmad=false).
//
// What bounds a step on the H100: one ray per thread runs a long serial
// chain (six right-hand sides of 3 IEEE square roots and ~5 IEEE divisions
// each, three pows in the controller, a 9-sample detection sweep) on few
// warps: the disk's packed tail holds ~11 per SM. Measured there (PERF.md),
// half the rays take 0.71x the time of all of them and twice the rays
// 1.79x: past ~5 warps per SM the schedulers' issue, not only latency,
// sets the pace, so only fewer instructions per step pay. The design:
// * The parameter block lives in constant memory, one copy per library and
//   working type (c_params_f32, c_params_f64), filled before each launch by
//   a device-to-device cudaMemcpyToSymbolAsync on the launch's stream, with
//   no host sync. Every thread reads the same address, so the step's
//   constants are constant-bank operands of its instructions, not
//   shared-memory loads on its critical path. The stream orders the copy
//   before its kernel; the launches of a library and type on different
//   streams are serialized by launch_with_params, so that no copy overwrites
//   the constants of a kernel still running.
// * The scenes of the main paths are compile-time (scene codes SC_SPS9,
//   SC_SD9, SC_SPS4: their object kinds and detection samples): the sweep
//   and the event are unrolled, each weight and object field is an operand
//   at a known offset, and no branch on an object kind is left. SC_ANY
//   takes any scene at run time, as a kernel of its own.
// * The sweep evaluates all samples without an early exit, so that their
//   independent chains interleave; the first crossing is picked after.
// * Clamps and limits are one NaN-propagating FMNMX each in f32 (fmaxn,
//   fminn, clipn) where that gives the select's value, and the controller
//   runs only the pows of the branch it takes.
// * Optionally (P_GATE, cfg.event_gate) the sweep is skipped for a ray
//   whose dense output provably stays clear of every object this step.
// * Optionally (cfg.refine_minima) the sweep's argmin bracket is trisected
//   to rescue grazing hits that fall between two samples. Only the kernels
//   of scene code SC_REFINE (SC_ANY with the trisection) compile it in, so
//   the other kernels stay as they were; the gate is off there.
// * Blocks of MAX_THREADS (128) threads. Blocks of 32 and 64 were measured
//   no faster on the disk's packed tail (PERF.md); K2 alone takes the block
//   size as an argument, for that measurement.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <type_traits>

// Each library is two translation units (utils/cuda_build.py): one defines
// the f32 entry points (RTGR_F32), as whole-program device code, the other
// the f64 ones (RTGR_F64), as relocatable device code linked to
// csrc/pow64.cu, the double pow as PyTorch's kernels compute it (see tpow).
// Relocatable code turns the f32 kernels' division and square-root slow
// paths into ABI calls (K1: 127 to 153 registers, 13% slower), so the f32
// kernels stay whole-program. Built as one unit, both are defined.
#if !defined(RTGR_F32) && !defined(RTGR_F64)
#define RTGR_F32 1
#define RTGR_F64 1
#endif
extern "C" __device__ double rtgr_pow64(double x, double y);

namespace {
enum Prm {
  P_M, P_A, P_EPS2, P_EPS2_HALF, P_STATE_CLAMP, P_RHS_CLAMP, P_DET_MIN,
  P_RTOL, P_ATOL, P_LAM_MAX, P_LAM_END, P_DT_MIN, P_DT_DEAD, P_RK4_DT,
  P_SAFETY, P_QMIN, P_QMAX, P_NEG_BETA1, P_BETA2, P_QOLD_INIT, P_STOP_RHO2,
  P_GATE, P_BMAX0, P_BMAX1, P_BMAX2, P_BMAX3, P_BMAX4, P_BMAX5, P_BMAX6,
  P_HERM1, P_HERM2, P_HERM3, N_CFG = 32
};
constexpr int OBJ_STRIDE = 8;   // pos1, pos2, pos3, radius, time, r_in, r_out, half
constexpr int SMP_STRIDE = 8;   // 7 dense-output weights, then theta
constexpr int MAX_OBJ = 16;
constexpr int MAX_SMP = 32;
constexpr int MAX_THREADS = 128;
enum { KIND_SPHERE = 0, KIND_PLANE = 1, KIND_DISK = 2 };
enum { R_AS_WRITTEN = 0, R_TEXTBOOK = 1, R_TEXTBOOK_NOFLOOR = 2 };
// Scenes known at compile time (their kinds and detection samples), and
// SC_ANY, which takes kinds and counts at run time. SC_SPS9: sphere, plane,
// sphere, 9 samples (example2's render); SC_SD9: sphere, disk, 9 samples
// (the accretion disk); SC_SPS4: example2 with the training path's 4;
// SC_S4: one sphere, 4 samples (the lensing scene of the inversion).
// SC_REFINE: SC_ANY with refine_minima's trisection, for every library,
// type and metric.
enum { SC_ANY = 0, SC_SPS9 = 1, SC_SD9 = 2, SC_SPS4 = 3, SC_S4 = 4,
       SC_REFINE = 5 };
// Whether a scene code takes kinds and counts at run time.
__host__ __device__ constexpr bool sc_runtime(int sc) {
  return sc == SC_ANY || sc == SC_REFINE;
}
__host__ __device__ constexpr int sc_nobj(int sc) {
  return sc == SC_S4 ? 1 : (sc == SC_SD9 ? 2 : 3);
}
__host__ __device__ constexpr int sc_npts(int sc) {
  return (sc == SC_SPS4 || sc == SC_S4) ? 4 : 9;
}

// Host: the kernel of (kerr, tsit5, scene), with KERR_, TSIT5_ (bools) and SC_
// (a scene code) as compile-time constants in the launch statement given as
// the last argument; sets ok to false where none is instantiated. A library
// instantiates the fixed scenes of its main paths (its FIXED_SCENES, a mask
// of scene codes), for its f32 Kerr-Schild kernels only.
#define RTGR_BOOL(cond, NAME, ...)                                           \
  if (cond) {                                                                \
    constexpr bool NAME = true;                                              \
    __VA_ARGS__;                                                             \
  } else {                                                                   \
    constexpr bool NAME = false;                                             \
    __VA_ARGS__;                                                             \
  }
#define RTGR_FIXED(CODE, tsit5, ...)                                         \
  if constexpr ((FIXED_SCENES >> (CODE)) & 1) {                              \
    constexpr int SC_ = CODE;                                                \
    RTGR_BOOL(tsit5, TSIT5_, __VA_ARGS__)                                    \
  } else {                                                                   \
    ok = false;                                                              \
  }
// RTGR_DISPATCH_SC with REFINE false instantiates no SC_REFINE kernel (the
// localization, which has no trisection, launches SC_ANY for it) and sets
// ok to false for that code.
#define RTGR_DISPATCH(ok, T, kerr, tsit5, scene, ...)                        \
  RTGR_DISPATCH_SC(ok, T, kerr, tsit5, scene, true, __VA_ARGS__)
#define RTGR_DISPATCH_SC(ok, T, kerr, tsit5, scene, REFINE, ...)             \
  ok = true;                                                                 \
  if ((scene) == SC_ANY) {                                                   \
    constexpr int SC_ = SC_ANY;                                              \
    RTGR_BOOL(kerr, KERR_, RTGR_BOOL(tsit5, TSIT5_, __VA_ARGS__))            \
  } else if ((scene) == SC_REFINE) {                                         \
    if constexpr (REFINE) {                                                  \
      constexpr int SC_ = SC_REFINE;                                         \
      RTGR_BOOL(kerr, KERR_, RTGR_BOOL(tsit5, TSIT5_, __VA_ARGS__))          \
    } else {                                                                 \
      ok = false;                                                            \
    }                                                                        \
  } else if constexpr (std::is_same<T, float>::value) {                      \
    constexpr bool KERR_ = true;                                             \
    if (!(kerr)) {                                                           \
      ok = false;                                                            \
    } else if ((scene) == SC_SPS9) {                                         \
      RTGR_FIXED(SC_SPS9, tsit5, __VA_ARGS__)                                \
    } else if ((scene) == SC_SD9) {                                          \
      RTGR_FIXED(SC_SD9, tsit5, __VA_ARGS__)                                 \
    } else if ((scene) == SC_SPS4) {                                         \
      RTGR_FIXED(SC_SPS4, tsit5, __VA_ARGS__)                                \
    } else if ((scene) == SC_S4) {                                           \
      RTGR_FIXED(SC_S4, tsit5, __VA_ARGS__)                                  \
    } else {                                                                 \
      ok = false;                                                            \
    }                                                                        \
  } else {                                                                   \
    ok = false;                                                              \
  }

// Host: whether a launch's counts and block size are ones the kernels take
// (a fixed scene's own counts; blocks of whole warps up to MAX_THREADS).
inline bool launch_ok(int fixed_scenes, int scene, int n, int n_obj, int npts,
                      int threads) {
  if (n < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0)
    return false;
  if (sc_runtime(scene))
    return n_obj >= 1 && n_obj <= MAX_OBJ && npts >= 1 && npts <= MAX_SMP;
  return scene > 0 && scene < 31 && ((fixed_scenes >> scene) & 1) &&
         npts == sc_npts(scene) && n_obj == sc_nobj(scene);
}

template <typename T>
struct Params {
  T cfg[N_CFG];
  T obj[MAX_OBJ * OBJ_STRIDE];
  T smp[MAX_SMP * SMP_STRIDE];
  int kind[MAX_OBJ];
  int refine_iters;  // refine_minima's trisection steps (SC_REFINE)
  int pad;           // the size a multiple of 8 bytes in both types
};

__constant__ Params<float> c_params_f32;
__constant__ Params<double> c_params_f64;

template <typename T>
__device__ __forceinline__ const Params<T>& cparams() {
  if constexpr (std::is_same<T, float>::value) return c_params_f32;
  else return c_params_f64;
}

// The parameters of a ray of a grouped launch (K3 and K4 over several
// parameter sets at once: G groups of rays_per_group consecutive rays, one
// start of a multistart fit each). They read as Params<T> do, and are the
// constant block but for M, a and the objects' rows, which come from the
// ray's group row in device memory: M, a, then OBJ_STRIDE values per object
// (ops/adjoint.py flatten_params, one row per group). Every device function
// takes either (its parameter type PP is a template argument), so the
// ungrouped kernels, instantiated with Params<T>, compile as before. Where
// rays_per_group is a multiple of 32 every warp lies in one group and reads
// one row, a broadcast load; where it is not, a warp that straddles two
// groups reads two rows, one load each: correct, but serialized.
template <typename T>
struct GroupCfg {
  const T* g;
  __device__ __forceinline__ T operator[](int k) const {
    return k == P_M ? __ldg(g)
                    : (k == P_A ? __ldg(g + 1) : cparams<T>().cfg[k]);
  }
};
template <typename T>
struct GroupObj {
  const T* g;
  __device__ __forceinline__ const T& operator[](int k) const {
    return g[2 + k];
  }
};
template <typename T>
struct ConstSmp {
  __device__ __forceinline__ const T& operator[](int k) const {
    return cparams<T>().smp[k];
  }
};
template <typename T>
struct ConstKind {
  __device__ __forceinline__ int operator[](int k) const {
    return cparams<T>().kind[k];
  }
};
template <typename T>
struct GroupParams {
  GroupCfg<T> cfg;
  GroupObj<T> obj;
  ConstSmp<T> smp;
  ConstKind<T> kind;
};
template <typename T>
__device__ __forceinline__ GroupParams<T> group_params(const T* groups,
                                                       int rays_per_group,
                                                       int stride, int i) {
  const T* g = groups + static_cast<size_t>(i / rays_per_group) * stride;
  return GroupParams<T>{{g}, {g}, {}, {}};
}

// Ray i's parameters in a kernel: the constant block itself (ungrouped), or
// its group's view (GROUPED).
template <typename T, bool GROUPED>
__device__ __forceinline__
    std::conditional_t<GROUPED, GroupParams<T>, const Params<T>&>
    ray_params(const T* groups, int rays_per_group, int stride, int i) {
  if constexpr (GROUPED) return group_params(groups, rays_per_group, stride, i);
  else return cparams<T>();
}

// Host: one launch of this library's kernels of type T on stream st. The
// parameter block (the bytes of Params<T> in device memory, packed by
// ops/geodesic_cm.py pack_params) is copied into the library's constant copy
// on st, then launch() puts the kernel on st, so the stream orders the two.
// The constant copy is shared by every launch of the library and type on
// the device: a copy on another stream could overwrite it while an earlier
// kernel still reads it. So the launches are serialized (params_serial, one
// state per library and type, whichever kernel launches): a mutex keeps each
// copy and its launch together on the host, an event is recorded on st
// after every launch, and a launch on another stream than the previous one
// first waits for that event. On one stream, as on every main path, the
// cost is the event record.
//
// Under stream capture (a CUDA graph of a training step, step_graph.py) the
// copy and the launch become a copy node and a kernel node in capture order,
// so a replay orders them itself; the event is neither waited on nor
// recorded, since an event recorded outside a capture cannot be waited on
// inside it, and one recorded inside refers to the graph. The rule between a
// replay and eager launches is the rule between two streams: whoever replays
// a graph that holds this library's launches calls params_fence on the
// replay stream just before and just after the replay (the C entry points
// rtgr_fence_f32 and rtgr_fence_f64), so that the replay waits for the last
// eager launch on another stream and the next eager launch on another stream
// waits for the replay.
constexpr int MAX_DEVICES = 64;

struct ParamsSerial {
  std::mutex mu;
  cudaStream_t stream[MAX_DEVICES];
  cudaEvent_t done[MAX_DEVICES];
};

template <typename T>
ParamsSerial& params_serial() {
  static ParamsSerial s;
  return s;
}

// With the lock held: st waits for the previous launch if it was on another
// stream.
inline cudaError_t serial_wait(ParamsSerial& s, int dev, cudaStream_t st) {
  if (s.done[dev] == nullptr)
    return cudaEventCreateWithFlags(&s.done[dev], cudaEventDisableTiming);
  if (st != s.stream[dev]) return cudaStreamWaitEvent(st, s.done[dev], 0);
  return cudaSuccess;
}

// With the lock held: the next launch on another stream waits for st.
inline cudaError_t serial_record(ParamsSerial& s, int dev, cudaStream_t st) {
  s.stream[dev] = st;
  return cudaEventRecord(s.done[dev], st);
}

inline cudaError_t current_device(int& dev) {
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return dev < 0 || dev >= MAX_DEVICES ? cudaErrorInvalidDevice : cudaSuccess;
}

template <typename T>
cudaError_t copy_params(const void* prm, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return cudaMemcpyToSymbolAsync(c_params_f32, prm, sizeof(Params<T>), 0,
                                   cudaMemcpyDeviceToDevice, st);
  else
    return cudaMemcpyToSymbolAsync(c_params_f64, prm, sizeof(Params<T>), 0,
                                   cudaMemcpyDeviceToDevice, st);
}

template <typename T, typename Launch>
cudaError_t launch_with_params(const void* prm, cudaStream_t st,
                               Launch&& launch) {
  int dev;
  cudaError_t err = current_device(dev);
  if (err != cudaSuccess) return err;
  cudaStreamCaptureStatus capture;
  err = cudaStreamIsCapturing(st, &capture);
  if (err != cudaSuccess) return err;
  ParamsSerial& s = params_serial<T>();
  std::lock_guard<std::mutex> lock(s.mu);
  if (capture != cudaStreamCaptureStatusNone) {
    err = copy_params<T>(prm, st);
    return err == cudaSuccess ? launch() : err;
  }
  err = serial_wait(s, dev, st);
  if (err != cudaSuccess) return err;
  err = copy_params<T>(prm, st);
  if (err == cudaSuccess) err = launch();
  // Recorded whether or not the launch went out: the copy did.
  const cudaError_t rec = serial_record(s, dev, st);
  return err != cudaSuccess ? err : rec;
}

// The fence around a replay on st of a graph that holds launches of this
// library's kernels of type T (see launch_with_params). Refused while st is
// capturing.
template <typename T>
cudaError_t params_fence(cudaStream_t st) {
  int dev;
  cudaError_t err = current_device(dev);
  if (err != cudaSuccess) return err;
  cudaStreamCaptureStatus capture;
  err = cudaStreamIsCapturing(st, &capture);
  if (err != cudaSuccess) return err;
  if (capture != cudaStreamCaptureStatusNone)
    return cudaErrorStreamCaptureUnsupported;
  ParamsSerial& s = params_serial<T>();
  std::lock_guard<std::mutex> lock(s.mu);
  err = serial_wait(s, dev, st);
  return err != cudaSuccess ? err : serial_record(s, dev, st);
}

// Objects, samples and kinds of a scene: compile-time constants for the
// fixed scenes, the run-time values for SC_ANY.
template <int SC>
__device__ __forceinline__ int scene_nobj(int n_obj) {
  return sc_runtime(SC) ? n_obj : sc_nobj(SC);
}
template <int SC>
__device__ __forceinline__ int scene_npts(int npts) {
  return sc_runtime(SC) ? npts : sc_npts(SC);
}
template <typename T, int SC, typename PP>
__device__ __forceinline__ int scene_kind(const PP& p, int i) {
  if constexpr (sc_runtime(SC)) return p.kind[i];
  else if constexpr (SC == SC_SD9) return i == 0 ? KIND_SPHERE : KIND_DISK;
  else if constexpr (SC == SC_S4) return KIND_SPHERE;
  else return i == 1 ? KIND_PLANE : KIND_SPHERE;
}

// NaN-propagating min / max / clip, as torch.minimum, torch.maximum,
// torch.clamp (and jnp.minimum, jnp.maximum, jnp.clip).
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
template <typename T> __device__ __forceinline__ T clip(T x, T lo, T hi) {
  return nmin(nmax(x, lo), hi);
}
// nmax, nmin and clip as one NaN-propagating FMNMX each in f32 (PTX max.NaN
// and min.NaN, sm_80+), instead of a compare-and-select chain. They equal
// nmax and nmin except where +0 meets -0 (either zero may come back) and in
// a NaN's payload (canonical). So they serve where no such tie can arise
// (a bound that is never zero: the state, RHS and determinant clamps, the
// controller's limits; operands that are +0 when zero) or where the result
// is only compared with zero (the scene event and its gate bound); a NaN
// result fails the same tests either way. f64 has no such instruction and
// keeps the select.
template <typename T> __device__ __forceinline__ T fmaxn(T a, T b) {
  return nmax(a, b);
}
template <typename T> __device__ __forceinline__ T fminn(T a, T b) {
  return nmin(a, b);
}
#ifdef __CUDA_ARCH__
template <> __device__ __forceinline__ float fmaxn<float>(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
template <> __device__ __forceinline__ float fminn<float>(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
#endif
template <typename T> __device__ __forceinline__ T clipn(T x, T lo, T hi) {
  return fminn(fmaxn(x, lo), hi);
}
// pow with the bits of torch.pow on the card: powf inline for f32; for f64
// the pow of csrc/pow64.cu, built with contraction on as PyTorch is (under
// this file's --fmad=false libdevice's double pow rounds apart on about one
// input in a million).
template <typename T> __device__ __forceinline__ T tpow(T x, T y) {
  if constexpr (std::is_same<T, float>::value) return pow(x, y);
  else return rtgr_pow64(x, y);
}
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// --------------------------------------------------------------------------
// Right-hand side: y (8) -> ydot (8), clamped in and out.
// --------------------------------------------------------------------------
template <typename T, bool KERR, typename PP>
__device__ __forceinline__ void rhs(const PP& p, int r_mode,
                                    const T* yin, T* out) {
  const T sc = p.cfg[P_STATE_CLAMP], rc = p.cfg[P_RHS_CLAMP];
  T y[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) y[c] = clipn(yin[c], -sc, sc);
  if constexpr (!KERR) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[c] = clipn(y[4 + c], -rc, rc);
      out[4 + c] = T(0);
    }
    return;
  }
  const T M = p.cfg[P_M], a = p.cfg[P_A], eps2 = p.cfg[P_EPS2];
  const T xs = y[1], ys = y[2], zs = y[3];
  const T aa = a * a;
  // ks_parts
  const T rho2_raw = xs * xs + ys * ys + zs * zs;
  const T rho2 = r_mode == R_AS_WRITTEN ? fmaxn(rho2_raw, aa + eps2)
                                        : fmaxn(rho2_raw, eps2);
  const bool live = rho2_raw >= rho2;
  const T half = (rho2 - aa) / T(2);
  T inner = sqrt(aa * zs * zs + half * half);
  T r, dr_du, dr_dw;
  if (r_mode == R_AS_WRITTEN) {
    const T inv_inner = T(1) / inner;
    const T s = sqrt(rho2 - aa);
    r = s / T(2) + inner;
    dr_du = T(0.25) / s + T(0.5) * half * inv_inner;
    dr_dw = aa * zs * inv_inner;
  } else {
    if (r_mode == R_TEXTBOOK) {
      inner = fmaxn(inner, p.cfg[P_EPS2_HALF]);
      r = sqrt(fmaxn(half + inner, eps2));
    } else {
      r = sqrt(half + inner);
    }
    const T inv_inner = T(1) / inner;
    const T inv_2r = T(0.5) / r;
    dr_du = (T(0.5) + T(0.5) * half * inv_inner) * inv_2r;
    dr_dw = (aa * zs * inv_inner) * inv_2r;
  }
  const T r2 = r * r;
  const T q = r2 * r2 + aa * zs * zs;
  const T inv_q = T(1) / q;
  const T r3 = r * r2;
  const T two_m = T(2) * M;
  const T f = two_m * r3 * inv_q;
  const T df_dr = two_m * r2 * (T(3) * a * a * zs * zs - r2 * r2) * inv_q * inv_q;
  const T df_dw = T(-4) * M * r3 * a * a * zs * inv_q * inv_q;
  const T denom = r2 + aa;
  const T inv_denom = T(1) / denom;
  const T inv_r = T(1) / r;
  const T k1 = (r * xs + a * ys) * inv_denom;
  const T k2 = (r * ys - a * xs) * inv_denom;
  const T k3 = zs * inv_r;
  const T du[3] = {live ? T(2) * xs : T(0), live ? T(2) * ys : T(0),
                   live ? T(2) * zs : T(0)};
  T df[3], dk[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T r_c = dr_du * du[c];
    if (c == 2) {
      r_c = r_c + dr_dw;
      df[c] = df_dr * r_c + df_dw;
    } else {
      df[c] = df_dr * r_c;
    }
    const T two_r_rc = T(2) * r * r_c;
    if (c == 0) {
      dk[c][0] = (xs * r_c + r - k1 * two_r_rc) * inv_denom;
      dk[c][1] = (ys * r_c - a - k2 * two_r_rc) * inv_denom;
    } else if (c == 1) {
      dk[c][0] = (xs * r_c + a - k1 * two_r_rc) * inv_denom;
      dk[c][1] = (ys * r_c + r - k2 * two_r_rc) * inv_denom;
    } else {
      dk[c][0] = (xs * r_c - k1 * two_r_rc) * inv_denom;
      dk[c][1] = (ys * r_c - k2 * two_r_rc) * inv_denom;
    }
    dk[c][2] = (c == 2 ? (T(1) - k3 * r_c) : -(k3 * r_c)) * inv_r;
  }
  const T kappa = T(-1) + k1 * k1 + k2 * k2 + k3 * k3;
  T d = T(1) + f * kappa;
  const T dmin = p.cfg[P_DET_MIN];
  d = d < T(0) ? fminn(d, -dmin) : fmaxn(d, dmin);
  const T coef = f / d;
  // closed-form contraction (geodesic_cm)
  const T u0 = y[4], u1 = y[5], u2 = y[6], u3 = y[7];
  const T k[4] = {T(1), k1, k2, k3};
  const T ku = u0 + k1 * u1 + k2 * u2 + k3 * u3;
  const T fdot = df[0] * u1 + df[1] * u2 + df[2] * u3;
  T Dv[3], Ev[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    Dv[b] = u1 * dk[0][b] + u2 * dk[1][b] + u3 * dk[2][b];
    Ev[b] = u1 * dk[b][0] + u2 * dk[b][1] + u3 * dk[b][2];
  }
  const T uD = u1 * Dv[0] + u2 * Dv[1] + u3 * Dv[2];
  const T half_fdot = T(0.5) * fdot;
  const T s1 = half_fdot * ku + f * uD;
  T A[4];
  A[0] = ku * half_fdot + s1;
#pragma unroll
  for (int d_ = 1; d_ < 4; ++d_) {
    const T C_d = half_fdot * k[d_] + f * Dv[d_ - 1];
    const T Bu_d = T(0.5) * df[d_ - 1] * ku + f * Ev[d_ - 1];
    A[d_] = ku * C_d + k[d_] * s1 - ku * Bu_d;
  }
  const T kuA = -A[0] + k1 * A[1] + k2 * A[2] + k3 * A[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = clipn(y[4 + c], -rc, rc);
  out[4] = clipn(A[0] + (-coef) * kuA, -rc, rc);
#pragma unroll
  for (int c = 1; c < 4; ++c)
    out[4 + c] = clipn(-A[c] + coef * k[c] * kuA, -rc, rc);
}

// --------------------------------------------------------------------------
// Scene event: min over objects of the signed distance, and its derivative.
// The kind is an argument: a constant for the fixed scenes, whose branches
// then fold away.
// --------------------------------------------------------------------------
template <typename T, typename PP>
__device__ __forceinline__ T object_distance(const PP& p, int i,
                                             int kind, const T* x) {
  const T* o = &p.obj[i * OBJ_STRIDE];
  if (kind == KIND_PLANE) return x[0] - o[4];
  const T dx = x[1] - o[0], dy = x[2] - o[1], dz = x[3] - o[2];
  if (kind == KIND_SPHERE) {
    const T r = o[3];
    return sgn(r) * (dx * dx + dy * dy + dz * dz - r * r);
  }
  const T rho2 = dx * dx + dy * dy;
  return fmaxn(fabs(dz) - o[7],
               fmaxn(rho2 - o[6] * o[6], o[5] * o[5] - rho2));
}

template <typename T, int SC, typename PP>
__device__ __forceinline__ T event(const PP& p, int n_obj, const T* x) {
  const int n = scene_nobj<SC>(n_obj);
  T d = object_distance(p, 0, scene_kind<T, SC>(p, 0), x);
#pragma unroll
  for (int i = 1; i < n; ++i)
    d = fminn(d, object_distance(p, i, scene_kind<T, SC>(p, i), x));
  return d;
}

// (min or max of a and b, its tangent): half to each side on a tie.
template <typename T, bool MAX>
__device__ __forceinline__ void balanced(T a, T da, T b, T db, T& m, T& dm) {
  m = MAX ? nmax(a, b) : nmin(a, b);
  const T wa = a == m ? (b == m ? T(0.5) : T(1)) : T(0);
  const T wb = b == m ? (a == m ? T(0.5) : T(1)) : T(0);
  dm = da * wa + db * wb;
}

template <typename T, typename PP>
__device__ __forceinline__ void object_jvp(const PP& p, int i, int kind,
                                           const T* x, const T* dx_, T& v,
                                           T& dv) {
  const T* o = &p.obj[i * OBJ_STRIDE];
  if (kind == KIND_PLANE) {
    v = x[0] - o[4];
    dv = dx_[0];
    return;
  }
  const T dx = x[1] - o[0], dy = x[2] - o[1], dz = x[3] - o[2];
  if (kind == KIND_SPHERE) {
    const T r = o[3], s = sgn(r);
    v = s * (dx * dx + dy * dy + dz * dz - r * r);
    dv = s * (T(2) * (dx * dx_[1] + dy * dx_[2] + dz * dx_[3]));
    return;
  }
  const T rho2 = dx * dx + dy * dy;
  const T drho2 = T(2) * (dx * dx_[1] + dy * dx_[2]);
  const T slab = fabs(dz) - o[7];
  const T dslab = dz >= T(0) ? dx_[3] : -dx_[3];
  T ring, dring;
  balanced<T, true>(rho2 - o[6] * o[6], drho2, o[5] * o[5] - rho2, -drho2,
                    ring, dring);
  balanced<T, true>(slab, dslab, ring, dring, v, dv);
}

template <typename T, int SC, typename PP>
__device__ __forceinline__ void event_jvp(const PP& p, int n_obj,
                                          const T* x, const T* dx, T& v,
                                          T& dv) {
  const int n = scene_nobj<SC>(n_obj);
  object_jvp(p, 0, scene_kind<T, SC>(p, 0), x, dx, v, dv);
#pragma unroll
  for (int i = 1; i < n; ++i) {
    T vi, dvi;
    object_jvp(p, i, scene_kind<T, SC>(p, i), x, dx, vi, dvi);
    balanced<T, false>(v, dv, vi, dvi, v, dv);
  }
}

// The detection gate's scene bound (ops/geodesic_cm.py scene_crossing_bound,
// the JAX package's _scene_bound_from_get): a lower bound of the event over
// the position box [lo, hi], by interval arithmetic per kind.
template <typename T>
__device__ __forceinline__ T sq_min(T lo, T hi, T c) {
  const T m = fmaxn(fmaxn(lo - c, T(0)), fmaxn(c - hi, T(0)));
  return m * m;
}
template <typename T>
__device__ __forceinline__ T sq_max(T lo, T hi, T c) {
  const T m = fmaxn(fabs(lo - c), fabs(hi - c));
  return m * m;
}

template <typename T, typename PP>
__device__ __forceinline__ T object_bound(const PP& p, int i, int kind,
                                          const T* lo, const T* hi) {
  const T* o = &p.obj[i * OBJ_STRIDE];
  if (kind == KIND_PLANE) return lo[0] - o[4];
  if (kind == KIND_SPHERE) {
    const T r = o[3];
    if (r < T(0)) {
      const T sq = sq_max(lo[1], hi[1], o[0]) + sq_max(lo[2], hi[2], o[1])
                   + sq_max(lo[3], hi[3], o[2]);
      return r * r - sq;
    }
    const T sq = sq_min(lo[1], hi[1], o[0]) + sq_min(lo[2], hi[2], o[1])
                 + sq_min(lo[3], hi[3], o[2]);
    return sq - r * r;
  }
  const T sz = sq_min(lo[3], hi[3], o[2]);
  const T rho_lo = sq_min(lo[1], hi[1], o[0]) + sq_min(lo[2], hi[2], o[1]);
  const T rho_hi = sq_max(lo[1], hi[1], o[0]) + sq_max(lo[2], hi[2], o[1]);
  return fmaxn(sqrt(sz) - o[7],
               fmaxn(rho_lo - o[6] * o[6], o[5] * o[5] - rho_hi));
}

template <typename T, int SC, typename PP>
__device__ __forceinline__ T scene_bound(const PP& p, int n_obj,
                                         const T* lo, const T* hi) {
  const int n = scene_nobj<SC>(n_obj);
  T d = object_bound(p, 0, scene_kind<T, SC>(p, 0), lo, hi);
#pragma unroll
  for (int i = 1; i < n; ++i)
    d = fminn(d, object_bound(p, i, scene_kind<T, SC>(p, i), lo, hi));
  return d;
}

// --------------------------------------------------------------------------
// Dense output at a per-ray theta (same expressions as ops/integrate.py).
// --------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void tsit5_bi(T th, T* b) {
  const T th2 = th * th;
  b[0] = T(-1.0530884977290216) * th * (th - T(1.3299890189751412))
         * (th2 - T(1.4364028541716351) * th + T(0.7139816917074209));
  b[1] = T(0.1017) * th2 * (th2 - T(2.1966568338249754) * th + T(1.2949852507374631));
  b[2] = T(2.490627285651252793) * th2
         * (th2 - T(2.38535645472061657) * th + T(1.57803468208092486));
  b[3] = T(-16.54810288924490272) * (th - T(1.21712927295533244))
         * (th - T(0.61620406037800089)) * th2;
  b[4] = T(47.37952196281928122) * (th - T(1.203071208372362603))
         * (th - T(0.658047292653547382)) * th2;
  b[5] = T(-34.87065786149660974) * (th - T(1.2))
         * (th - T(0.666666666666666667)) * th2;
  b[6] = T(2.5) * (th - T(1.0)) * (th - T(0.6)) * th2;
}

template <typename T>
__device__ __forceinline__ T dcubic(T th, T th2, T dth2, T c, T r1, T r2) {
  const T pp = th - r1, qq = th - r2;
  return c * ((qq + pp) * th2 + pp * qq * dth2);
}

template <typename T>
__device__ __forceinline__ void tsit5_dbi(T th, T* db) {
  const T th2 = th * th;
  const T dth2 = T(2) * th;
  const T u1 = T(-1.0530884977290216) * th;
  const T v1 = th - T(1.3299890189751412);
  const T w1 = th2 - T(1.4364028541716351) * th + T(0.7139816917074209);
  db[0] = (T(-1.0530884977290216) * v1 + u1) * w1
          + u1 * v1 * (dth2 - T(1.4364028541716351));
  const T w2 = th2 - T(2.1966568338249754) * th + T(1.2949852507374631);
  db[1] = T(0.1017) * (dth2 * w2 + th2 * (dth2 - T(2.1966568338249754)));
  const T w3 = th2 - T(2.38535645472061657) * th + T(1.57803468208092486);
  db[2] = T(2.490627285651252793) * (dth2 * w3 + th2 * (dth2 - T(2.38535645472061657)));
  db[3] = dcubic(th, th2, dth2, T(-16.54810288924490272), T(1.21712927295533244),
                 T(0.61620406037800089));
  db[4] = dcubic(th, th2, dth2, T(47.37952196281928122), T(1.203071208372362603),
                 T(0.658047292653547382));
  db[5] = dcubic(th, th2, dth2, T(-34.87065786149660974), T(1.2),
                 T(0.666666666666666667));
  db[6] = dcubic(th, th2, dth2, T(2.5), T(1.0), T(0.6));
}

// The step's data that dense output needs.
template <typename T, bool TSIT5>
struct StepData {
  T y0[8];
  T y1[8];
  T k[7][8];   // Tsit5 stages k1..k7; RK4 keeps k1 in k[0] and f(y1) in k[6]
  T dt;
};

// Tsit5's dense output at theta on the first ROWS components, from the
// stages ks[j][c] (k1..k7): a step's own, or any array-like view of them
// (K7 reads them from K6's record).
template <int ROWS, typename T, typename KS>
__device__ __forceinline__ void tsit5_interp(const T* y0, const KS& ks, T dt,
                                             T th, T* out) {
  T b[7];
  tsit5_bi(th, b);
#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    T acc = b[0] * ks[0][c];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + b[j] * ks[j][c];
    out[c] = y0[c] + dt * acc;
  }
}

// Its derivative in theta, likewise.
template <int ROWS, typename T, typename KS>
__device__ __forceinline__ void tsit5_dinterp(const KS& ks, T dt, T th,
                                              T* out) {
  T db[7];
  tsit5_dbi(th, db);
#pragma unroll
  for (int c = 0; c < ROWS; ++c) {
    T acc = db[0] * ks[0][c];
#pragma unroll
    for (int j = 1; j < 7; ++j) acc = acc + db[j] * ks[j][c];
    out[c] = dt * acc;
  }
}

// Dense output at theta on the first ROWS components.
template <typename T, bool TSIT5, int ROWS>
__device__ __forceinline__ void interp(const StepData<T, TSIT5>& s, T th,
                                       T* out) {
  if constexpr (TSIT5) {
    tsit5_interp<ROWS>(s.y0, s.k, s.dt, th, out);
  } else {
    const T dt = s.dt;
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      const T y0 = s.y0[c], y1 = s.y1[c], f0 = s.k[0][c], f1 = s.k[6][c];
      out[c] = (T(1) - th) * y0 + th * y1
               + th * (th - T(1)) * ((T(1) - T(2) * th) * (y1 - y0)
                                     + (th - T(1)) * dt * f0 + th * dt * f1);
    }
  }
}

// Its derivative in theta on the first ROWS components.
template <typename T, bool TSIT5, int ROWS = 4>
__device__ __forceinline__ void dinterp(const StepData<T, TSIT5>& s, T th,
                                        T* out) {
  if constexpr (TSIT5) {
    tsit5_dinterp<ROWS>(s.k, s.dt, th, out);
  } else {
    const T dt = s.dt;
#pragma unroll
    for (int c = 0; c < ROWS; ++c) {
      const T y0 = s.y0[c], y1 = s.y1[c], f0 = s.k[0][c], f1 = s.k[6][c];
      const T g = (T(1) - T(2) * th) * (y1 - y0) + (th - T(1)) * dt * f0
                  + th * dt * f1;
      const T dg = T(-2) * (y1 - y0) + dt * f0 + dt * f1;
      out[c] = (y1 - y0) + (T(2) * th - T(1)) * g + th * (th - T(1)) * dg;
    }
  }
}

// Detection sweep at the host-precomputed sample thetas: first crossing
// bracket [th_lo, th_hi]; returns whether the event crossed this step. Every
// sample is evaluated (no early exit, so the samples' chains interleave) and
// the first one at or below zero gives the bracket, as the plain version's
// masked scan does.
// SC_REFINE (refine_minima, the plain _detect_scan's rescue): the samples'
// argmin, with d_prev at theta 0 as the first candidate, and its bracket
// [a0, b0] of the neighbouring sample thetas (b0 clipped at 1) are kept
// during the sweep; then refine_iters trisection steps on the dense output
// at run-time thetas (interp, as localize evaluates it; (b - a) / 3 a true
// division), and the event at the final bracket's midpoint decides: at or
// below zero, the ray crosses there unless a sample crossing at or before
// a0 stands.
template <typename T, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ bool detect(const PP& p, int n_obj, int npts,
                                       const StepData<T, TSIT5>& s, T& th_lo,
                                       T& th_hi) {
  constexpr bool REFINE = SC == SC_REFINE;
  const T d_prev = event<T, SC>(p, n_obj, s.y0);
  const int np = scene_npts<SC>(npts);
  T prev = T(0);
  bool found = false;
  th_lo = T(0);
  th_hi = T(0);
  T d_best = d_prev, a0 = T(0), b0 = REFINE ? p.smp[7] : T(0);
#pragma unroll
  for (int j = 0; j < np; ++j) {
    const T* w = &p.smp[j * SMP_STRIDE];
    const T th = w[7];
    T x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (TSIT5) {
        T acc = w[0] * s.k[0][c];
#pragma unroll
        for (int i = 1; i < 7; ++i) acc = acc + w[i] * s.k[i][c];
        x[c] = s.y0[c] + s.dt * acc;
      } else {  // w = (1 - th, th (th - 1), 1 - 2 th, th - 1)
        const T y0 = s.y0[c], y1 = s.y1[c];
        x[c] = w[0] * y0 + th * y1
               + w[1] * (w[2] * (y1 - y0) + w[3] * s.dt * s.k[0][c]
                         + th * s.dt * s.k[6][c]);
      }
    }
    bool now;
    if constexpr (REFINE) {
      const T d = event<T, SC>(p, n_obj, x);
      now = !found && d <= T(0);
      const bool better = d < d_best;
      d_best = better ? d : d_best;
      a0 = better ? prev : a0;
      b0 = better ? (j + 1 < np ? p.smp[(j + 1) * SMP_STRIDE + 7] : T(1))
                  : b0;
    } else {
      now = !found && event<T, SC>(p, n_obj, x) <= T(0);
    }
    th_lo = now ? prev : th_lo;
    th_hi = now ? th : th_hi;
    found = found || now;
    prev = th;
  }
  if constexpr (REFINE) {
    const int iters = cparams<T>().refine_iters;
    T a = a0, b = b0;
    for (int t = 0; t < iters; ++t) {
      const T third = (b - a) / T(3);
      const T m1 = a + third, m2 = b - third;
      T x1[4], x2[4];
      interp<T, TSIT5, 4>(s, m1, x1);
      interp<T, TSIT5, 4>(s, m2, x2);
      const bool take = event<T, SC>(p, n_obj, x1) < event<T, SC>(p, n_obj, x2);
      a = take ? a : m1;
      b = take ? m2 : b;
    }
    const T th_min = T(0.5) * (a + b);
    T xm[4];
    interp<T, TSIT5, 4>(s, th_min, xm);
    const bool min_neg = event<T, SC>(p, n_obj, xm) <= T(0);
    const bool use_min = min_neg && (!found || a0 < th_lo);
    th_lo = use_min ? a0 : th_lo;
    th_hi = use_min ? th_min : th_hi;
    found = found || min_neg;
  }
  return found && d_prev > T(0);
}

// The detection gate (cfg.event_gate; the JAX package's _detect_event_cm):
// whether the step's dense output may reach an object. The dense output
// stays within C of y0 (sup-norm envelopes of its basis over theta in [0, 1],
// P_BMAX* for Tsit5, P_HERM* for the cubic Hermite of RK4), and the scene
// bound over that box is a lower bound of the event; where it is positive
// no sample can cross and the sweep is skipped, bitwise neutrally.
template <typename T, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ bool may_cross(const PP& p, int n_obj,
                                          const StepData<T, TSIT5>& s) {
  T lo[4], hi[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    T C;
    if constexpr (TSIT5) {
      T acc = p.cfg[P_BMAX0] * fabs(s.k[0][c]);
#pragma unroll
      for (int j = 1; j < 7; ++j)
        acc = acc + p.cfg[P_BMAX0 + j] * fabs(s.k[j][c]);
      C = s.dt * acc;
    } else {
      C = p.cfg[P_HERM1] * fabs(s.y1[c] - s.y0[c])
          + s.dt * (p.cfg[P_HERM2] * fabs(s.k[0][c])
                    + p.cfg[P_HERM3] * fabs(s.k[6][c]));
    }
    lo[c] = s.y0[c] - C;
    hi[c] = s.y0[c] + C;
  }
  return scene_bound<T, SC>(p, n_obj, lo, hi) <= T(0);
}

// Bisection of the bracket [lo, hi]: its upper end.
template <typename T, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ T bisect(const PP& p, int n_obj, int bisect_iters,
                                    const StepData<T, TSIT5>& s, T lo,
                                    T hi) {
  for (int b = 0; b < bisect_iters; ++b) {
    const T mid = T(0.5) * (lo + hi);
    T x[4];
    interp<T, TSIT5, 4>(s, mid, x);
    if (event<T, SC>(p, n_obj, x) > T(0)) lo = mid; else hi = mid;
  }
  return hi;
}

// Bisection of the bracket, then one clipped Newton step: theta*.
template <typename T, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ T localize(const PP& p, int n_obj,
                                      int bisect_iters,
                                      const StepData<T, TSIT5>& s, T lo, T hi) {
  const T th0 = bisect<T, TSIT5, SC>(p, n_obj, bisect_iters, s, lo, hi);
  T x[4], dx[4], val, dval;
  interp<T, TSIT5, 4>(s, th0, x);
  dinterp<T, TSIT5>(s, th0, dx);
  event_jvp<T, SC>(p, n_obj, x, dx, val, dval);
  const bool ok = fabs(dval) > T(1e-3) * (T(1) + fabs(val));
  const T delta = (ok ? val : T(0)) / (ok ? dval : T(1));
  return clip(th0 - clip(delta, T(-1), T(1)), T(0), T(1));
}

// Tsitouras 5(4) tableau (ops/integrate.py TS_A, TS_BTILDE).
#define A_(i, j) T(TS_A_##i##j)
constexpr double TS_A_00 = 0.161;
constexpr double TS_A_10 = -0.008480655492356989, TS_A_11 = 0.335480655492357;
constexpr double TS_A_20 = 2.8971530571054935, TS_A_21 = -6.359448489975075,
                 TS_A_22 = 4.3622954328695815;
constexpr double TS_A_30 = 5.325864828439257, TS_A_31 = -11.748883564062828,
                 TS_A_32 = 7.4955393428898365, TS_A_33 = -0.09249506636175525;
constexpr double TS_A_40 = 5.86145544294642, TS_A_41 = -12.92096931784711,
                 TS_A_42 = 8.159367898576159, TS_A_43 = -0.071584973281401,
                 TS_A_44 = -0.028269050394068383;
constexpr double TS_A_50 = 0.09646076681806523, TS_A_51 = 0.01,
                 TS_A_52 = 0.4798896504144996, TS_A_53 = 1.379008574103742,
                 TS_A_54 = -3.290069515436081, TS_A_55 = 2.324710524099774;
// TS_A[row][j] as a constant expression: with row and j known at compile
// time (unrolled loops, template arguments) it folds to an immediate.
__host__ __device__ constexpr double ts_a(int row, int j) {
  return row == 0 ? TS_A_00
       : row == 1 ? (j == 0 ? TS_A_10 : TS_A_11)
       : row == 2 ? (j == 0 ? TS_A_20 : j == 1 ? TS_A_21 : TS_A_22)
       : row == 3 ? (j == 0 ? TS_A_30 : j == 1 ? TS_A_31 : j == 2 ? TS_A_32
                                                                : TS_A_33)
       : row == 4 ? (j == 0 ? TS_A_40 : j == 1 ? TS_A_41 : j == 2 ? TS_A_42
                     : j == 3 ? TS_A_43 : TS_A_44)
       : (j == 0 ? TS_A_50 : j == 1 ? TS_A_51 : j == 2 ? TS_A_52
          : j == 3 ? TS_A_53 : j == 4 ? TS_A_54 : TS_A_55);
}
constexpr double TS_BT0 = -0.00178001105222577714,
                 TS_BT1 = -0.0008164344596567469, TS_BT2 = 0.007880878010261995,
                 TS_BT3 = -0.1447110071732629, TS_BT4 = 0.5823571654525552,
                 TS_BT5 = -0.45808210592918697, TS_BT6 = 0.015151515151515152;

template <typename T, bool KERR, typename PP>
__device__ __forceinline__ void tsit5_step(const PP& p, int r_mode,
                                           StepData<T, true>& s, T* err) {
  const T dt = s.dt;
  T yt[8];
  auto (&k)[7][8] = s.k;
#pragma unroll
  for (int c = 0; c < 8; ++c) yt[c] = s.y0[c] + dt * (A_(0, 0) * k[0][c]);
  rhs<T, KERR>(p, r_mode, yt, k[1]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    yt[c] = s.y0[c] + dt * (A_(1, 0) * k[0][c] + A_(1, 1) * k[1][c]);
  rhs<T, KERR>(p, r_mode, yt, k[2]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    yt[c] = s.y0[c] + dt * (A_(2, 0) * k[0][c] + A_(2, 1) * k[1][c]
                            + A_(2, 2) * k[2][c]);
  rhs<T, KERR>(p, r_mode, yt, k[3]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    yt[c] = s.y0[c] + dt * (A_(3, 0) * k[0][c] + A_(3, 1) * k[1][c]
                            + A_(3, 2) * k[2][c] + A_(3, 3) * k[3][c]);
  rhs<T, KERR>(p, r_mode, yt, k[4]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    yt[c] = s.y0[c] + dt * (A_(4, 0) * k[0][c] + A_(4, 1) * k[1][c]
                            + A_(4, 2) * k[2][c] + A_(4, 3) * k[3][c]
                            + A_(4, 4) * k[4][c]);
  rhs<T, KERR>(p, r_mode, yt, k[5]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    s.y1[c] = s.y0[c] + dt * (A_(5, 0) * k[0][c] + A_(5, 1) * k[1][c]
                              + A_(5, 2) * k[2][c] + A_(5, 3) * k[3][c]
                              + A_(5, 4) * k[4][c] + A_(5, 5) * k[5][c]);
  rhs<T, KERR>(p, r_mode, s.y1, k[6]);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    err[c] = dt * (T(TS_BT0) * k[0][c] + T(TS_BT1) * k[1][c]
                   + T(TS_BT2) * k[2][c] + T(TS_BT3) * k[3][c]
                   + T(TS_BT4) * k[4][c] + T(TS_BT5) * k[5][c]
                   + T(TS_BT6) * k[6][c]);
}

// With `stages`, its k2, k3 and k4 are also written there (24 values:
// K4 keeps them for the step's reverse sweep, adjoint_common.cuh rk4_vjp).
template <typename T, bool KERR, typename PP>
__device__ __forceinline__ void rk4_step(const PP& p, int r_mode,
                                         StepData<T, false>& s,
                                         T* stages = nullptr) {
  const T dt = s.dt;
  T yt[8], k2[8], k3[8], k4[8];
  const T* k1 = s.k[0];
#pragma unroll
  for (int c = 0; c < 8; ++c) yt[c] = s.y0[c] + T(0.5) * dt * k1[c];
  rhs<T, KERR>(p, r_mode, yt, k2);
#pragma unroll
  for (int c = 0; c < 8; ++c) yt[c] = s.y0[c] + T(0.5) * dt * k2[c];
  rhs<T, KERR>(p, r_mode, yt, k3);
#pragma unroll
  for (int c = 0; c < 8; ++c) yt[c] = s.y0[c] + dt * k3[c];
  rhs<T, KERR>(p, r_mode, yt, k4);
  if (stages != nullptr) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      stages[c] = k2[c];
      stages[8 + c] = k3[c];
      stages[16 + c] = k4[c];
    }
  }
  const T dt6 = dt / T(6);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    s.y1[c] = s.y0[c] + dt6 * (k1[c] + T(2) * k2[c] + T(2) * k3[c] + k4[c]);
  rhs<T, KERR>(p, r_mode, s.y1, s.k[6]);
}

// --------------------------------------------------------------------------
// The resumable loop state of K2, K3 and K4: the make_step_cm state packed
// into 34 planes of the working type, ray-minor ([34, n]); masks are 0/1 and
// the step count is a float (exact to 2^24 in f32, far above any step
// budget). ops/adjoint.py pack_state / unpack_state hold the same layout.
// --------------------------------------------------------------------------
enum Plane {
  PL_Y = 0, PL_LAM = 8, PL_DT = 9, PL_K1 = 10, PL_ACTIVE = 18, PL_HIT = 19,
  PL_STEPS = 20, PL_ERR_OLD = 21, PL_EV_Y0 = 22, PL_EV_DT = 30, PL_EV_LAM = 31,
  PL_EV_LO = 32, PL_EV_HI = 33, N_PLANES = 34
};

template <typename T>
struct RayState {
  T y[8], k1[8], ev_y0[8];
  T lam, dt, active, hit, steps, err_old, ev_dt, ev_lam, ev_lo, ev_hi;
};

template <typename T>
__device__ __forceinline__ void load_state(const T* P, int n, int i,
                                           RayState<T>& r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    r.y[c] = P[(PL_Y + c) * n + i];
    r.k1[c] = P[(PL_K1 + c) * n + i];
    r.ev_y0[c] = P[(PL_EV_Y0 + c) * n + i];
  }
  r.lam = P[PL_LAM * n + i];
  r.dt = P[PL_DT * n + i];
  r.active = P[PL_ACTIVE * n + i];
  r.hit = P[PL_HIT * n + i];
  r.steps = P[PL_STEPS * n + i];
  r.err_old = P[PL_ERR_OLD * n + i];
  r.ev_dt = P[PL_EV_DT * n + i];
  r.ev_lam = P[PL_EV_LAM * n + i];
  r.ev_lo = P[PL_EV_LO * n + i];
  r.ev_hi = P[PL_EV_HI * n + i];
}

template <typename T>
__device__ __forceinline__ void store_state(T* P, int n, int i,
                                            const RayState<T>& r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    P[(PL_Y + c) * n + i] = r.y[c];
    P[(PL_K1 + c) * n + i] = r.k1[c];
    P[(PL_EV_Y0 + c) * n + i] = r.ev_y0[c];
  }
  P[PL_LAM * n + i] = r.lam;
  P[PL_DT * n + i] = r.dt;
  P[PL_ACTIVE * n + i] = r.active;
  P[PL_HIT * n + i] = r.hit;
  P[PL_STEPS * n + i] = r.steps;
  P[PL_ERR_OLD * n + i] = r.err_old;
  P[PL_EV_DT * n + i] = r.ev_dt;
  P[PL_EV_LAM * n + i] = r.ev_lam;
  P[PL_EV_LO * n + i] = r.ev_lo;
  P[PL_EV_HI * n + i] = r.ev_hi;
}

// The make_step_cm init of ray i from y0 [8, n] and dt0 [n]: k1 = rhs(y0),
// and an event record that starts finite (dt = 1), as the plain init's.
// With dt0 null the step is left at 0 for the caller to set
// (initial_step).
template <typename T, bool KERR, typename PP>
__device__ __forceinline__ void init_state(const PP& p, int r_mode,
                                           const T* y0, const T* dt0, int n,
                                           int i, RayState<T>& r) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    r.y[c] = y0[c * n + i];
    r.ev_y0[c] = r.y[c];
  }
  rhs<T, KERR>(p, r_mode, r.y, r.k1);
  r.lam = T(0);
  r.dt = dt0 != nullptr ? dt0[i] : T(0);
  r.active = T(1);
  r.hit = T(0);
  r.steps = T(0);
  r.err_old = p.cfg[P_QOLD_INIT];
  r.ev_dt = T(1);
  r.ev_lam = T(0);
  r.ev_lo = T(0);
  r.ev_hi = T(0);
}

// Hairer's initial step (ops/integrate.py hairer_init_dt, order 5) of the
// ray at y0, whose right-hand side f0 = rhs(y0) the caller has (init_state's
// k1): one more rhs, at y0 + dt0 f0, and the norms, selections and clamps of
// the plain version operation by operation. Its three means are sums over
// the 8 components left to right, then a division by 8 (mean8); 0.01 / dmax
// is a reciprocal times 0.01, as PyTorch evaluates a python scalar over a
// tensor; the exponent 1/6 is the double 1/6 rounded to T, as PyTorch rounds
// a python float exponent; torch.where, maximum, minimum and clamp are
// selects and NaN-propagating nmax/nmin.
template <typename T, bool KERR, typename PP>
__device__ __forceinline__ T hairer_init_dt(const PP& p, int r_mode,
                                            const T* y0, const T* f0) {
  const T rtol = p.cfg[P_RTOL], atol = p.cfg[P_ATOL];
  T sc[8], s0 = T(0), s1 = T(0);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    sc[c] = atol + fabs(y0[c]) * rtol;
    const T u = y0[c] / sc[c], v = f0[c] / sc[c];
    s0 = c == 0 ? u * u : s0 + u * u;
    s1 = c == 0 ? v * v : s1 + v * v;
  }
  const T d0 = sqrt(s0 / T(8)), d1 = sqrt(s1 / T(8));
  const bool small = d0 < T(1e-5) || d1 < T(1e-5);
  const T dt0 = small ? T(1e-6) : d0 * T(0.01) / d1;
  T y1[8], f1[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) y1[c] = y0[c] + dt0 * f0[c];
  rhs<T, KERR>(p, r_mode, y1, f1);
  T s2 = T(0);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T w = (f1[c] - f0[c]) / sc[c];
    s2 = c == 0 ? w * w : s2 + w * w;
  }
  const T d2 = sqrt(s2 / T(8)) / dt0;
  const T dmax = nmax(d1, d2);
  const T dt1 = dmax <= T(1e-15)
                    ? nmax(dt0 * T(1e-3), T(1e-6))
                    : tpow((T(1) / dmax) * T(0.01), T(1.0 / 6.0));
  return nmin(dt0 * T(100), nmin(dt1, p.cfg[P_LAM_MAX]));
}

// A ray's first step where the caller gives none: Hairer's for Tsit5 (the
// render.initial_dt), the constant rk4_dt for RK4.
template <typename T, bool KERR, bool TSIT5, typename PP>
__device__ __forceinline__ T initial_step(const PP& p, int r_mode,
                                          const T* y0, const T* f0) {
  if constexpr (TSIT5) return hairer_init_dt<T, KERR>(p, r_mode, y0, f0);
  else return p.cfg[P_RK4_DT];
}

// One iteration of the make_step_cm body for an ACTIVE ray. Returns whether
// the ray stepped (do); sets the step tried and whether it hit in this step.
// RK4 with `stages`: the step's k2, k3 and k4 there too (rk4_step).
template <typename T, bool KERR, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ bool body_step(const PP& p, int r_mode,
                                          int n_obj, int npts, RayState<T>& r,
                                          T& dt_try_out, bool& hit_now,
                                          T* stages = nullptr) {
  StepData<T, TSIT5> s;
  const T dt_min = p.cfg[P_DT_MIN], lam_max = p.cfg[P_LAM_MAX];
  T dt_try = nmax(nmin(r.dt, lam_max - r.lam), dt_min);
  if (!isfinite(dt_try)) dt_try = dt_min;
  s.dt = dt_try;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    s.y0[c] = r.y[c];
    s.k[0][c] = r.k1[c];
  }
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
      const T ratio = clipn(err[c] / sc, T(-1e15), T(1e15));
      acc = c == 0 ? ratio * ratio : acc + ratio * ratio;
    }
    en = sqrt(fmaxn(acc / T(8), T(1e-30)));
    const bool bad = !isfinite(en) || !fin;
    if (bad) en = T(1e30);  // ERR_BIG
    accept = en <= T(1);
    const T en_c = fmaxn(en, T(1e-10));
    const T safety = p.cfg[P_SAFETY];
    // Only the taken branch's pows run (q_pi for an accepted step, q_rej
    // for a rejected one): the values are those of computing both.
    T q;
    if (accept)
      q = safety * tpow(en_c, p.cfg[P_NEG_BETA1])
          * tpow(fmaxn(r.err_old, p.cfg[P_QOLD_INIT]), p.cfg[P_BETA2]);
    else
      q = fminn(safety * tpow(en_c, T(-0.2)), T(1));
    q = clipn(q, p.cfg[P_QMIN], p.cfg[P_QMAX]);
    dt_next = clip(dt_try * q, dt_min, lam_max);
    dead = (bad || !accept) && dt_try <= p.cfg[P_DT_DEAD];
  } else {
    rk4_step<T, KERR>(p, r_mode, s, stages);
#pragma unroll
    for (int c = 0; c < 8; ++c) fin = fin && isfinite(s.y1[c]);
    accept = fin;
    dt_next = p.cfg[P_RK4_DT];
    dead = !fin;
  }
  const T rho2 = s.y1[1] * s.y1[1] + s.y1[2] * s.y1[2] + s.y1[3] * s.y1[3];
  dead = dead || rho2 < p.cfg[P_STOP_RHO2];

  hit_now = false;
  bool active;
  if (accept) {  // accepted steps are finite
    T th_lo, th_hi;
    // The gate is one flag for the whole launch; where it is on, each ray
    // decides for itself (a warp runs the sweep if any of its rays may
    // cross).
    // SC_REFINE compiles the gate out: refine_minima turns it off.
    hit_now = (SC == SC_REFINE || p.cfg[P_GATE] == T(0)
               || may_cross<T, TSIT5, SC>(p, n_obj, s))
              && detect<T, TSIT5, SC>(p, n_obj, npts, s, th_lo, th_hi);
    if (hit_now) {
#pragma unroll
      for (int c = 0; c < 8; ++c) r.ev_y0[c] = s.y0[c];
      r.ev_dt = dt_try;
      r.ev_lam = r.lam;
      r.ev_lo = th_lo;
      r.ev_hi = th_hi;
      r.hit = T(1);
    }
    const T lam_acc = r.lam + dt_try;
    const bool done_span = lam_acc >= p.cfg[P_LAM_END];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      r.y[c] = s.y1[c];
      r.k1[c] = s.k[6][c];
    }
    if (!hit_now) r.lam = lam_acc;
    active = !hit_now && !done_span && !dead;
    r.steps = r.steps + T(1);
    r.err_old = fmaxn(en, p.cfg[P_QOLD_INIT]);
  } else {
    active = !dead;
  }
  if (active) r.dt = dt_next;
  else r.active = T(0);
  dt_try_out = dt_try;
  return accept;
}

// Localization from a ray's event record, the counterpart of the plain
// localize_events_cm: the crossing step is rebuilt from (ev_y0, ev_dt) with
// k1 = rhs(ev_y0), which equals bit for bit the FSAL stage the step carried
// (the same function of the same state), so the stages, the bisection of
// [ev_lo, ev_hi], the Newton polish and the interpolation are those of the
// step itself. Writes y* (8) and lam* = ev_lam + theta* ev_dt.
template <typename T, bool KERR, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ void localize_record(const PP& p, int r_mode,
                                                int n_obj, int bisect_iters,
                                                const RayState<T>& r, T* y_out,
                                                T& lam_out) {
  StepData<T, TSIT5> s;
#pragma unroll
  for (int c = 0; c < 8; ++c) s.y0[c] = r.ev_y0[c];
  rhs<T, KERR>(p, r_mode, s.y0, s.k[0]);
  s.dt = r.ev_dt;
  if constexpr (TSIT5) {
    T err[8];
    tsit5_step<T, KERR>(p, r_mode, s, err);
  } else {
    rk4_step<T, KERR>(p, r_mode, s);
  }
  const T th = localize<T, TSIT5, SC>(p, n_obj, bisect_iters, s, r.ev_lo,
                                      r.ev_hi);
  interp<T, TSIT5, 8>(s, th, y_out);
  lam_out = r.ev_lam + th * r.ev_dt;
}

// A ray's result (the plain localized): y* and lam* from the event record
// for a hit ray, its current y and lam for any other.
template <typename T, bool KERR, bool TSIT5, int SC, typename PP>
__device__ __forceinline__ void ray_result(const PP& p, int r_mode,
                                           int n_obj, int bisect_iters,
                                           const RayState<T>& r, T* y_out,
                                           T& lam_out) {
  if (r.hit > T(0)) {
    localize_record<T, KERR, TSIT5, SC>(p, r_mode, n_obj, bisect_iters, r,
                                        y_out, lam_out);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) y_out[c] = r.y[c];
  lam_out = r.lam;
}

}  // namespace
