// K11 and K12: the reference shading of the forward render and of the
// training path on NVIDIA Hopper (sm_90a), one thread per ray.
//
// Replace no TPU kernel: they are the port's counterpart of the XLA fusion
// that the JAX package makes of its shading around the pallas_calls
// (raytracegr_jl_tpu/models/objects.py shade_lanes, the hard shading of its
// render and training step, and shade_soft) and of the shading's AD inside
// its jitted step. The plain PyTorch versions are models/objects.py shade
// and shade_soft (K11), shade_vjp and shade_soft_vjp (K12): some 25 to 190
// elementwise launches over [B] and [B, N] tensors each. Each kernel reads
// a ray's end position (4 values) and the scene's fields (shared by all
// rays, a few hundred bytes from cache, or 8 values an object per ray), K12
// also the colour's cotangent (3), and writes the colour (3; K11) or the
// cotangents of x (4) and of the fields asked for, per ray (K12). The hard
// shading does ~60 operations a ray and a few hundred with its VJP, the soft
// one ~100 and ~300 an object: the kernels are bound by their bytes.
//
// K11, per ray: every object's signed distance (object_distance of
// geodesic_common.cuh, the kernels' scene event, on the object's row read
// from the fields); hard: the nearest object (torch.argmin's rule) and, if
// it lies within hit_dmin, its base colour (objects_common.cuh, shared with
// K5) dimmed by (index + 1) / N, else red; soft: the softmax of -d / temp
// written out over the objects (the shift, the exponentials, their sum left
// to right), the weights times each object's smooth colour, dimmed, summed
// left to right, the softmin distance -temp (log(sum) + shift), the sigmoid
// of (hit_dmin - softmin) / temp and the blend with red. Where the hard
// shading will be differentiated, K11 also writes each ray's record: the
// object hit, -1 for a miss (a byte). K12, per ray: hard, the object from
// K11's record (no distance), then the reverse for the colour's cotangent:
// its colour through theta (arccos of the clamped z / r), phi (atan2) and
// the disk's rho; soft, the forward again (config 5's one object has a
// softmax weight of exactly 1: a record of the weights would save little of
// it), then the reverse of the blend, the sigmoid, the logsumexp,
// the softmax and every object's colour and distance (the sphere's sign(r)
// form, the plane, the disk's two maximums split in half on ties as torch
// splits them). No cotangent where autograd would form 0 x inf: theta's at
// the poles, phi's on the axis, r's at the centre. A miss ray (hard) or one
// whose cotangent is zero gets exact zeros. K12's hard path was bound by
// its stores (with a zero cotangent it took its full time): a block stages
// its rays' pos cotangents in shared memory and writes their contiguous run
// in 16-byte words from consecutive threads, in blocks of 64 (an even load
// over the SMs at 40,000 rays).
//
// The fields are read by pointer, each with a ray stride of 0 (one value an
// object, shared) or 1 (one row per ray: the per-ray fields of the training
// path and a vectorized multistart's poses), not from a constant parameter
// block: a captured graph's replay reads the live fields, and the library
// has no launch state to serialize. x is read through its two strides, as
// the caller holds it (K1's [B, 8] rows or the training path's [8, B]
// planes).
//
// Rounding: each operation as the plain version evaluates it on the card,
// built with --fmad=false: a python-scalar divisor is a multiplication by its
// reciprocal rounded in the working type, sums run left to right from their
// first term, torch.sign is (0 < a) - (a < 0). K11 and K12 are bitwise equal
// to their plain versions.

#include <cstdint>

#include "objects_common.cuh"

namespace {

// K12's blocks (K11's are MAX_THREADS); its hard path's shared stage of
// K12_THREADS x MAX_OBJ rows of 4 fits the 48 KB of static shared memory at
// f64 for 64 threads, not for 128. The soft path runs in the same blocks:
// its registers, stack and times are those it had in blocks of 128.
constexpr int K12_THREADS = 64;

// The scene's float fields in models/objects.py SHADE_FIELDS order.
enum { F_POS, F_RADIUS, F_TIME, F_R_IN, F_R_OUT, F_HALF, N_FIELDS };

template <typename T>
struct ShadeScene {
  const T* f[N_FIELDS];
  int per_ray;               // bit k: field k holds one row per ray
  int n_obj;
  unsigned long long kinds;  // 4 bits an object

  __device__ __forceinline__ int kind(int j) const {
    return static_cast<int>((kinds >> (4 * j)) & 15ull);
  }
  // Object j's entry of field k for ray i, in rows of the field's width.
  __device__ __forceinline__ size_t at(int k, int i, int j) const {
    return ((per_ray >> k) & 1) ? static_cast<size_t>(i) * n_obj + j
                                : static_cast<size_t>(j);
  }
  // Object j's row for ray i as the parameter block lays one out
  // (OBJ_STRIDE: pos1, pos2, pos3, radius, time, r_in, r_out, half).
  __device__ __forceinline__ void row(int i, int j, T* o) const {
    const T* p = f[F_POS] + 4 * at(F_POS, i, j);
    o[0] = p[1];
    o[1] = p[2];
    o[2] = p[3];
#pragma unroll
    for (int k = 1; k < N_FIELDS; ++k) o[2 + k] = f[k][at(k, i, j)];
  }
};

// One object's row, which object_distance reads as a parameter block's
// object 0.
template <typename T>
struct ObjRow {
  T obj[OBJ_STRIDE];
};

// K12's per-ray outputs: [B, N, 4] for pos, [B, N] for the others; null
// for a field whose cotangent is not wanted.
template <typename T>
struct ShadeGrads {
  T* f[N_FIELDS];
};

// torch.sign on the card: (0 < a) - (a < 0).
template <typename T>
__device__ __forceinline__ T tsign(T a) {
  return T(static_cast<int>(T(0) < a) - static_cast<int>(a < T(0)));
}

template <typename T>
__device__ __forceinline__ void load_x(const T* xp, int i, int sx, int sc,
                                       T* x) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    x[c] = xp[static_cast<size_t>(i) * sx + static_cast<size_t>(c) * sc];
}

template <typename T>
__device__ __forceinline__ T distance(const ShadeScene<T>& sc, int i, int j,
                                      const T* x, ObjRow<T>& r) {
  sc.row(i, j, r.obj);
  return object_distance(r, 0, sc.kind(j), x);
}

template <typename T, bool SOFT>
__global__ void __launch_bounds__(MAX_THREADS)
k11_kernel(const T* __restrict__ xp, ShadeScene<T> sc, T* __restrict__ rgb,
           signed char* __restrict__ rec, int n, int sx, int sxc, T hit_dmin,
           T temp, T freq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x[4];
  load_x(xp, i, sx, sxc, x);
  const int n_obj = sc.n_obj;
  const T inv_n = T(1) / T(n_obj);
  ObjRow<T> r;
  T out[3];
  if constexpr (!SOFT) {
    T dmin;
    const int o = nearest_object(
        n_obj, [&](int j) { return distance(sc, i, j, x, r); }, dmin);
    if (rec != nullptr) rec[i] = dmin < hit_dmin ? o : -1;
    if (dmin < hit_dmin) {
      sc.row(i, o, r.obj);
      T base[3];
      base_colour<T, false>(sc.kind(o), x[1] - r.obj[0], x[2] - r.obj[1],
                            x[3] - r.obj[2], freq, base);
      const T dim = (T(o) + T(1)) * inv_n;
#pragma unroll
      for (int c = 0; c < 3; ++c) out[c] = base[c] * dim;
    } else {
      out[0] = T(1);
      out[1] = T(0);
      out[2] = T(0);
    }
  } else {
    const T inv_temp = T(1) / temp;
    T e[MAX_OBJ], m = T(0), s = T(0), obj[3] = {T(0), T(0), T(0)};
    for (int j = 0; j < n_obj; ++j) {
      e[j] = -distance(sc, i, j, x, r) * inv_temp;
      m = j == 0 ? e[j] : nmax(m, e[j]);
    }
    const T mm = fabs(m) == T(INFINITY) ? T(0) : m;
    for (int j = 0; j < n_obj; ++j) {
      e[j] = exp(e[j] - mm);
      s = j == 0 ? e[j] : s + e[j];
    }
    for (int j = 0; j < n_obj; ++j) {
      const T w = e[j] / s;
      sc.row(i, j, r.obj);
      T col[3];
      base_colour<T, true>(sc.kind(j), x[1] - r.obj[0], x[2] - r.obj[1],
                           x[3] - r.obj[2], freq, col);
      const T dim = (T(j) + T(1)) * inv_n;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T wc = w * (col[c] * dim);
        obj[c] = j == 0 ? wc : obj[c] + wc;
      }
    }
    const T sm = (log(s) + mm) * (-temp);
    const T p = T(1) / (T(1) + exp(-((hit_dmin - sm) * inv_temp)));
    const T q = T(1) - p;
    out[0] = p * obj[0] + q * T(1);
    out[1] = p * obj[1] + q * T(0);
    out[2] = p * obj[2] + q * T(0);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[3 * static_cast<size_t>(i) + c] = out[c];
}

// The cotangent of a colour channel's argument: torch.remainder passes it
// on; the smooth wave scales it by 0.5 sin(2 pi v) 2 pi.
template <typename T, bool SMOOTH>
__device__ __forceinline__ T wave_vjp(T g, T v) {
  if constexpr (SMOOTH) return g * (T(0.5) * sin(two_pi<T>() * v)) * two_pi<T>();
  else return g;
}

// base_colour's reverse (models/objects.py _colour_vjp): the cotangents b
// of the offsets (xx, yy, zz) for the colour's cotangent g.
template <typename T, bool SMOOTH>
__device__ __forceinline__ void colour_vjp(int kind, T xx, T yy, T zz,
                                           const T* g, T freq, T* b) {
  if (kind == KIND_PLANE) {
    b[0] = T(0);
    b[1] = T(0);
    b[2] = T(0);
    return;
  }
  const T phi = atan2(yy, xx);
  const T rho2 = xx * xx + yy * yy;
  if (kind == KIND_SPHERE) {
    const T r = sqrt(xx * xx + yy * yy + zz * zz);
    const bool nz = r != T(0);
    const T safe_r = nz ? r : T(1);
    const T u = zz / safe_r;
    const T uc = clip(u, T(-1), T(1));
    const T theta = acos(uc);
    const T vb0 = wave_vjp<T, SMOOTH>(g[0], freq * theta * inv_pi<T>());
    const T vb1 = wave_vjp<T, SMOOTH>(g[1], freq * phi * inv_pi<T>());
    const T thetab = vb0 * freq * inv_pi<T>();
    const T phib = vb1 * freq * inv_pi<T>();
    const T ub = (u > T(-1) && u < T(1))
                     ? -(thetab / sqrt(T(1) - uc * uc)) : T(0);
    const T zzb = ub / safe_r;
    const T srb = -(ub * u) / safe_r;
    const T qb = nz ? srb * T(0.5) / safe_r : T(0);
    const T tp = rho2 != T(0) ? phib / rho2 : T(0);
    b[0] = qb * xx * T(2) - tp * yy;
    b[1] = qb * yy * T(2) + tp * xx;
    b[2] = zzb + qb * zz * T(2);
    return;
  }
  const T rho = sqrt(rho2);
  const T vb0 = wave_vjp<T, SMOOTH>(g[0], rho);
  const T vb1 = wave_vjp<T, SMOOTH>(g[1], T(6) * phi * inv_pi<T>());
  const T phib = vb1 * T(6) * inv_pi<T>();
  const T r2b = rho != T(0) ? vb0 * T(0.5) / rho : T(0);
  const T tp = rho2 != T(0) ? phib / rho2 : T(0);
  b[0] = r2b * xx * T(2) - tp * yy;
  b[1] = r2b * yy * T(2) + tp * xx;
  b[2] = T(0);
}

// torch.maximum(a, b)'s cotangents for g: all to the larger, half to each
// on a tie.
template <typename T>
__device__ __forceinline__ void max_split(T a, T b, T g, T& ga, T& gb) {
  const T half = g * T(0.5);
  ga = a == b ? half : (a < b ? T(0) : g);
  gb = a == b ? half : (a > b ? T(0) : g);
}

// object_distance's reverse (models/objects.py _distance_vjp) for its
// cotangent db on row o: t's cotangent (the plane), the offsets' (rel, the
// sphere and the disk; has_rel) and the fields' (fb, in field order from
// radius on).
template <typename T>
__device__ __forceinline__ void distance_vjp(int kind, const T* x,
                                             const T* o, T db, T& tb,
                                             T* rel, bool& has_rel, T* fb) {
  tb = T(0);
  has_rel = kind != KIND_PLANE;
#pragma unroll
  for (int k = 0; k < N_FIELDS - 1; ++k) fb[k] = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) rel[c] = T(0);
  if (kind == KIND_PLANE) {
    tb = db;
    fb[F_TIME - 1] = -db;
    return;
  }
  const T dx = x[1] - o[0], dy = x[2] - o[1], dz = x[3] - o[2];
  if (kind == KIND_SPHERE) {
    const T r = o[3];
    const T qb = db * tsign(r);
    rel[0] = qb * dx * T(2);
    rel[1] = qb * dy * T(2);
    rel[2] = qb * dz * T(2);
    fb[F_RADIUS - 1] = -(qb * r * T(2));
    return;
  }
  const T ri = o[5], ro = o[6], hf = o[7];
  const T rho2 = dx * dx + dy * dy;
  const T a = rho2 - ro * ro;
  const T b = ri * ri - rho2;
  const T slab = fabs(dz) - hf;
  T slabb, ringb, ab, bb;
  max_split(slab, nmax(a, b), db, slabb, ringb);
  max_split(a, b, ringb, ab, bb);
  const T rho2b = ab - bb;
  rel[0] = rho2b * dx * T(2);
  rel[1] = rho2b * dy * T(2);
  rel[2] = slabb * tsign(dz);
  fb[F_HALF - 1] = -slabb;
  fb[F_R_OUT - 1] = -(ab * ro * T(2));
  fb[F_R_IN - 1] = bb * ri * T(2);
}

// Four values to p, 16-byte aligned, in 16-byte stores.
template <typename T>
__device__ __forceinline__ void store4(T* p, T a, T b, T c, T d) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
    reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
  }
}

// Object j's cotangents for ray i: -posb... as pos[1:3]'s (pos[0] takes
// none), fb as the other fields'.
template <typename T>
__device__ __forceinline__ void store_object(const ShadeGrads<T>& gr,
                                             int n_obj, int i, int j,
                                             const T* posb, const T* fb) {
  const size_t k = static_cast<size_t>(i) * n_obj + j;
  if (gr.f[F_POS] != nullptr)
    store4(gr.f[F_POS] + 4 * k, T(0), posb[0], posb[1], posb[2]);
#pragma unroll
  for (int f = 1; f < N_FIELDS; ++f)
    if (gr.f[f] != nullptr) gr.f[f][k] = fb[f - 1];
}

// K12's hard path. Its stores set its time (step 0: with a zero cotangent
// it ran as long as with hits), so a block's rays, which own one contiguous
// run of pos's cotangent [B, N, 4], stage it in shared memory and write it
// in 16-byte words from consecutive threads; ct_x goes out in one 16-byte
// word a ray. The object hit comes from K11's record: no distance here.
template <typename T>
__device__ __forceinline__ void k12_hard(const T* __restrict__ xp,
                                         const ShadeScene<T>& sc,
                                         const T* __restrict__ ct,
                                         const signed char* __restrict__ rec,
                                         T* __restrict__ ct_x,
                                         const ShadeGrads<T>& gr, int n,
                                         int sx, int sxc, T freq) {
  __shared__ __align__(16) T stage[K12_THREADS * MAX_OBJ * 4];
  const int t = threadIdx.x, base = blockIdx.x * K12_THREADS;
  const int i = base + t, n_obj = sc.n_obj;
  if (i < n) {
    T x[4], g[3], xb[4] = {T(0), T(0), T(0), T(0)}, nb[3];
    load_x(xp, i, sx, sxc, x);
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = ct[3 * static_cast<size_t>(i) + c];
    const int hit = rec[i];
    const bool nz = g[0] != T(0) || g[1] != T(0) || g[2] != T(0);
    const int o = nz ? hit : -1;
    if (o >= 0) {
      const T* p = sc.f[F_POS] + 4 * sc.at(F_POS, i, o);
      const T dim = (T(o) + T(1)) * (T(1) / T(n_obj));
      const T gd[3] = {g[0] * dim, g[1] * dim, g[2] * dim};
      T cb[3];
      colour_vjp<T, false>(sc.kind(o), x[1] - p[1], x[2] - p[2],
                           x[3] - p[3], gd, freq, cb);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xb[1 + c] = cb[c];
        nb[c] = -cb[c];
      }
    }
    for (int j = 0; j < n_obj; ++j) {
      const bool mine = j == o;
      store4(stage + 4 * (t * n_obj + j), T(0), mine ? nb[0] : T(0),
             mine ? nb[1] : T(0), mine ? nb[2] : T(0));
    }
    // The other fields take no cotangent in the hard shading.
    for (int f = 1; f < N_FIELDS; ++f)
      if (gr.f[f] != nullptr)
        for (int j = 0; j < n_obj; ++j)
          gr.f[f][static_cast<size_t>(i) * n_obj + j] = T(0);
    store4(ct_x + 4 * static_cast<size_t>(i), xb[0], xb[1], xb[2], xb[3]);
  }
  if (gr.f[F_POS] == nullptr) return;
  __syncthreads();
  const int rows = min(K12_THREADS, n - base) * n_obj;
  T* dst = gr.f[F_POS] + 4 * static_cast<size_t>(base) * n_obj;
  for (int k = t; k < rows; k += K12_THREADS)
    store4(dst + 4 * k, stage[4 * k], stage[4 * k + 1], stage[4 * k + 2],
           stage[4 * k + 3]);
}

template <typename T, bool SOFT>
__global__ void __launch_bounds__(K12_THREADS)
k12_kernel(const T* __restrict__ xp, ShadeScene<T> sc,
           const T* __restrict__ ct, const signed char* __restrict__ rec,
           T* __restrict__ ct_x, ShadeGrads<T> gr, int n, int sx, int sxc,
           T hit_dmin, T temp, T freq) {
  if constexpr (!SOFT) {
    k12_hard(xp, sc, ct, rec, ct_x, gr, n, sx, sxc, freq);
    return;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T x[4], g[3];
  load_x(xp, i, sx, sxc, x);
#pragma unroll
  for (int c = 0; c < 3; ++c) g[c] = ct[3 * static_cast<size_t>(i) + c];
  const int n_obj = sc.n_obj;
  const T inv_n = T(1) / T(n_obj);
  const bool nz = g[0] != T(0) || g[1] != T(0) || g[2] != T(0);
  const T zero3[3] = {T(0), T(0), T(0)};
  const T zerof[N_FIELDS - 1] = {T(0), T(0), T(0), T(0), T(0)};
  T xb[4] = {T(0), T(0), T(0), T(0)};
  ObjRow<T> r;
  if (!nz) {
    for (int j = 0; j < n_obj; ++j)
      store_object(gr, n_obj, i, j, zero3, zerof);
  } else {
    // The forward, as K11 computes it.
    const T inv_temp = T(1) / temp;
    T e[MAX_OBJ], w[MAX_OBJ], cw[MAX_OBJ][3], wb[MAX_OBJ];
    T m = T(0), s = T(0), obj[3] = {T(0), T(0), T(0)};
    for (int j = 0; j < n_obj; ++j) {
      e[j] = -distance(sc, i, j, x, r) * inv_temp;
      m = j == 0 ? e[j] : nmax(m, e[j]);
    }
    const T mm = fabs(m) == T(INFINITY) ? T(0) : m;
    for (int j = 0; j < n_obj; ++j) {
      e[j] = exp(e[j] - mm);
      s = j == 0 ? e[j] : s + e[j];
    }
    for (int j = 0; j < n_obj; ++j) {
      w[j] = e[j] / s;
      sc.row(i, j, r.obj);
      T col[3];
      base_colour<T, true>(sc.kind(j), x[1] - r.obj[0], x[2] - r.obj[1],
                           x[3] - r.obj[2], freq, col);
      const T dim = (T(j) + T(1)) * inv_n;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cw[j][c] = col[c] * dim;
        const T wc = w[j] * cw[j][c];
        obj[c] = j == 0 ? wc : obj[c] + wc;
      }
    }
    const T p = T(1) / (T(1) + exp(-((hit_dmin - (log(s) + mm) * (-temp))
                                     * inv_temp)));
    // Its reverse: the blend with red, the sigmoid, the softmin
    // distance, the weighted colour and the softmax.
    const T pb = g[0] * obj[0] + g[1] * obj[1] + g[2] * obj[2] - g[0];
    const T objb[3] = {g[0] * p, g[1] * p, g[2] * p};
    const T hb = pb * (p * (T(1) - p));
    const T lseb = -(hb * inv_temp) * (-temp);
    T acc = T(0);
    for (int j = 0; j < n_obj; ++j) {
      wb[j] = objb[0] * cw[j][0] + objb[1] * cw[j][1] + objb[2] * cw[j][2];
      const T t = w[j] * wb[j];
      acc = j == 0 ? t : acc + t;
    }
    const T gsum = lseb - acc;
    for (int j = 0; j < n_obj; ++j) {
      const T db = -(w[j] * (wb[j] + gsum) * inv_temp);
      const int kind = sc.kind(j);
      sc.row(i, j, r.obj);
      T tb, dist[3], fb[N_FIELDS - 1], cb[3], nb[3];
      bool has_rel;
      distance_vjp(kind, x, r.obj, db, tb, dist, has_rel, fb);
      const T dim = (T(j) + T(1)) * inv_n;
      const T colb[3] = {objb[0] * w[j] * dim, objb[1] * w[j] * dim,
                         objb[2] * w[j] * dim};
      colour_vjp<T, true>(kind, x[1] - r.obj[0], x[2] - r.obj[1],
                          x[3] - r.obj[2], colb, freq, cb);
      if (kind == KIND_PLANE) xb[0] = xb[0] + tb;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T rel = has_rel ? dist[c] + cb[c] : cb[c];
        xb[1 + c] = xb[1 + c] + rel;
        nb[c] = -rel;
      }
      store_object(gr, n_obj, i, j, nb, fb);
    }
  }
  store4(ct_x + 4 * static_cast<size_t>(i), xb[0], xb[1], xb[2], xb[3]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// rec: K11's record (hard only; null for none), K12's input (hard: it must
// be given; soft: null).
template <typename T>
int launch_shade(const void* x, const void* const* fields, const void* ct,
                 void* rec, void* out, void* const* grads, int n, int sx,
                 int sxc, int per_ray, int n_obj, int soft,
                 unsigned long long kinds, double hit_dmin, double temp,
                 double freq, void* stream) {
  if (n < 1 || n_obj < 1 || n_obj > MAX_OBJ || sx < 0 || sxc < 0 ||
      per_ray < 0 || per_ray >= (1 << N_FIELDS) ||
      (soft && rec != nullptr) || (ct != nullptr && !soft && rec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ct != nullptr && (!aligned16(out) || !aligned16(grads[F_POS])))
    return static_cast<int>(cudaErrorMisalignedAddress);
  for (int j = 0; j < n_obj; ++j)
    if (((kinds >> (4 * j)) & 15ull) > KIND_DISK)
      return static_cast<int>(cudaErrorInvalidValue);
  ShadeScene<T> sc;
  for (int k = 0; k < N_FIELDS; ++k) sc.f[k] = static_cast<const T*>(fields[k]);
  sc.per_ray = per_ray;
  sc.n_obj = n_obj;
  sc.kinds = kinds;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T h = static_cast<T>(hit_dmin), tp = static_cast<T>(temp);
  const T fq = static_cast<T>(freq);
  if (ct == nullptr) {
    const int blocks = (n + MAX_THREADS - 1) / MAX_THREADS;
    RTGR_BOOL(soft, SOFT_,
              k11_kernel<T, SOFT_><<<blocks, MAX_THREADS, 0, st>>>(
                  xp, sc, static_cast<T*>(out),
                  static_cast<signed char*>(rec), n, sx, sxc, h, tp, fq))
  } else {
    const int blocks = (n + K12_THREADS - 1) / K12_THREADS;
    ShadeGrads<T> gr;
    for (int k = 0; k < N_FIELDS; ++k) gr.f[k] = static_cast<T*>(grads[k]);
    RTGR_BOOL(soft, SOFT_,
              k12_kernel<T, SOFT_><<<blocks, K12_THREADS, 0, st>>>(
                  xp, sc, static_cast<const T*>(ct),
                  static_cast<const signed char*>(rec), static_cast<T*>(out),
                  gr, n, sx, sxc, h, tp, fq))
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K11: (x, pos, radius, time, r_in, r_out, half, rgb, rec; n, x's ray
// stride, x's component stride, the per-ray mask, n_obj, soft; the kinds,
// 4 bits an object; hit_dmin, temp, freq; stream), rec [n] int8 or null.
// K12: the same with the cotangent ct [n, 3] before rec (K11's, hard; null,
// soft), then ct_x [n, 4] and the six fields' cotangents (each [n, n_obj(,
// 4)] or null) in place of rgb.
#define RTGR_SHADE_ENTRIES(T, SUFFIX)                                        \
  extern "C" int rtgr_k11_##SUFFIX(                                          \
      const void* x, const void* pos, const void* radius, const void* time,  \
      const void* r_in, const void* r_out, const void* half, void* rgb,      \
      void* rec, int n, int sx, int sxc, int per_ray, int n_obj, int soft,   \
      unsigned long long kinds, double hit_dmin, double temp, double freq,   \
      void* stream) {                                                        \
    const void* fields[N_FIELDS] = {pos, radius, time, r_in, r_out, half};   \
    return launch_shade<T>(x, fields, nullptr, rec, rgb, nullptr, n, sx,     \
                           sxc, per_ray, n_obj, soft, kinds, hit_dmin, temp, \
                           freq, stream);                                    \
  }                                                                          \
  extern "C" int rtgr_k12_##SUFFIX(                                          \
      const void* x, const void* pos, const void* radius, const void* time,  \
      const void* r_in, const void* r_out, const void* half, const void* ct, \
      const void* rec, void* ct_x, void* pos_b, void* radius_b,              \
      void* time_b, void* r_in_b, void* r_out_b, void* half_b, int n,        \
      int sx, int sxc, int per_ray, int n_obj, int soft,                     \
      unsigned long long kinds, double hit_dmin, double temp, double freq,   \
      void* stream) {                                                        \
    const void* fields[N_FIELDS] = {pos, radius, time, r_in, r_out, half};   \
    void* grads[N_FIELDS] = {pos_b, radius_b, time_b, r_in_b, r_out_b,       \
                             half_b};                                        \
    return launch_shade<T>(x, fields, ct, const_cast<void*>(rec), ct_x,      \
                           grads, n, sx, sxc, per_ray, n_obj, soft, kinds,   \
                           hit_dmin, temp, freq, stream);                    \
  }

#if RTGR_F32
RTGR_SHADE_ENTRIES(float, f32)
#endif

#if RTGR_F64
RTGR_SHADE_ENTRIES(double, f64)
#endif
