// Device code of the reference's shading, shared by K5 (shading.cu: the
// redshift shading's nearest object and base colour) and K11/K12
// (objects.cu: the hard and soft shading and their VJP): torch.remainder's
// wave and its smooth counterpart, the nearest object by torch.argmin's
// rule, and an object's base colour at a point. Each follows
// models/objects.py (colors, shade) operation by operation (build with
// --fmad=false); a python-scalar divisor is PyTorch's multiplication by
// its reciprocal rounded in the working type.

#pragma once

#include "geodesic_common.cuh"

namespace {

// 1 / pi as PyTorch divides by math.pi: the reciprocal of pi rounded in T.
template <typename T>
__device__ __forceinline__ T inv_pi() {
  return T(1) / T(3.14159265358979323846);
}

// 2 pi as the python float 2 * math.pi, rounded in T.
template <typename T>
__device__ __forceinline__ T two_pi() {
  return T(6.283185307179586);
}

// torch.remainder(v, 1): fmod, moved into [0, 1).
template <typename T>
__device__ __forceinline__ T wave(T v) {
  T m = fmod(v, T(1));
  if (m != T(0) && m < T(0)) m = m + T(1);
  return m;
}

// The smooth colours' wave: 0.5 - 0.5 cos(2 pi v).
template <typename T>
__device__ __forceinline__ T smooth_wave(T v) {
  return T(0.5) - T(0.5) * cos(two_pi<T>() * v);
}

template <typename T, bool SMOOTH>
__device__ __forceinline__ T colour_wave(T v) {
  if constexpr (SMOOTH) return smooth_wave(v);
  else return wave(v);
}

// The nearest of n_obj objects, dist(j) each object's signed distance
// (torch.argmin: the earliest index, NaN first); its distance in dmin.
template <typename T, typename Dist>
__device__ __forceinline__ int nearest_object(int n_obj, Dist dist, T& dmin) {
  dmin = dist(0);
  int o = 0;
  for (int j = 1; j < n_obj; ++j) {
    const T d = dist(j);
    if (dmin == dmin && (d < dmin || d != d)) {
      dmin = d;
      o = j;
    }
  }
  return o;
}

// An object's base colour at (xx, yy, zz), the point's offset from its
// centre (models/objects.py colors): sphere: the freq x freq latitude/
// longitude checker, plane: green, disk: the radial and azimuthal checker;
// SMOOTH: each checker channel as the same-period smooth wave.
template <typename T, bool SMOOTH>
__device__ __forceinline__ void base_colour(int kind, T xx, T yy, T zz,
                                            T freq, T* base) {
  const T phi = atan2(yy, xx);
  if (kind == KIND_SPHERE) {
    const T r = sqrt(xx * xx + yy * yy + zz * zz);
    const T safe_r = r == T(0) ? T(1) : r;
    const T theta = acos(clip(zz / safe_r, T(-1), T(1)));
    base[0] = colour_wave<T, SMOOTH>(freq * theta * inv_pi<T>());
    base[1] = colour_wave<T, SMOOTH>(freq * phi * inv_pi<T>());
    base[2] = T(1);
  } else if (kind == KIND_PLANE) {
    base[0] = T(0);
    base[1] = T(0.5);
    base[2] = T(0);
  } else {
    base[0] = colour_wave<T, SMOOTH>(sqrt(xx * xx + yy * yy));
    base[1] = colour_wave<T, SMOOTH>(T(6) * phi * inv_pi<T>());
    base[2] = T(0.9);
  }
}

}  // namespace
