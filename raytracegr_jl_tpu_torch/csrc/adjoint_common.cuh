// The hand-written reverse mode shared by K4 (adjoint.cu) and K7
// (localize.cu): the right-hand side's (rhs_vjp) and one accepted step's
// (step_vjp, with the Tsit5 stages unrolled at compile time), each the
// plain version in ops/adjoint.py operation by operation (build with
// --fmad=false). Ties follow JAX's rule: where a max, min or clip meets its
// bound exactly, the derivative is split half and half. Also the check of a
// grouped launch's table arguments.

#pragma once

#include "geodesic_common.cuh"

namespace {

// --------------------------------------------------------------------------
// Reverse mode of the right-hand side (ops/adjoint.py rhs_vjp).
// --------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T w_clip(T x, T lo, T hi) {
  return (x > lo && x < hi) ? T(1) : ((x == lo || x == hi) ? T(0.5) : T(0));
}
template <typename T>
__device__ __forceinline__ T w_max(T x, T b) {
  return x > b ? T(1) : (x == b ? T(0.5) : T(0));
}

template <typename T, bool KERR, typename PP>
__device__ __forceinline__ void rhs_vjp(const PP& p, int r_mode,
                                        const T* yin, const T* ct, T* cty,
                                        T& Mb, T& ab) {
  const T sc = p.cfg[P_STATE_CLAMP], rc = p.cfg[P_RHS_CLAMP];
  T y[8], w_in[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    w_in[c] = w_clip(yin[c], -sc, sc);
    y[c] = clipn(yin[c], -sc, sc);
  }
  if constexpr (!KERR) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T g = ct[c] * w_clip(y[4 + c], -rc, rc);
      cty[c] = T(0) * w_in[c];
      cty[4 + c] = g * w_in[4 + c];
    }
    Mb = T(0);
    ab = T(0);
    return;
  }
  // -- forward (as rhs) --
  const T M = p.cfg[P_M], a = p.cfg[P_A], eps2 = p.cfg[P_EPS2];
  const T xs = y[1], ys = y[2], zs = y[3];
  const T u0 = y[4];
  const T uu[3] = {y[5], y[6], y[7]};
  const T xyz[3] = {xs, ys, zs};
  const T aa = a * a;
  const T rho2_raw = xs * xs + ys * ys + zs * zs;
  const T bound = r_mode == R_AS_WRITTEN ? aa + eps2 : eps2;
  const T rho2 = fmaxn(rho2_raw, bound);
  const T w_rho = w_max(rho2_raw, bound);
  const bool live = rho2_raw >= rho2;
  const T half = (rho2 - aa) / T(2);
  const T inner0 = sqrt(aa * zs * zs + half * half);
  T inner = inner0, inv_inner, s = T(0), r, dr_du, dr_dw, inv_2r = T(0);
  T w_inner = T(1), w_v = T(1);
  if (r_mode == R_AS_WRITTEN) {
    inv_inner = T(1) / inner0;
    s = sqrt(rho2 - aa);
    r = s / T(2) + inner0;
    dr_du = T(0.25) / s + T(0.5) * half * inv_inner;
    dr_dw = aa * zs * inv_inner;
  } else {
    if (r_mode == R_TEXTBOOK) {
      inner = fmaxn(inner0, p.cfg[P_EPS2_HALF]);
      w_inner = w_max(inner0, p.cfg[P_EPS2_HALF]);
      const T v = half + inner;
      w_v = w_max(v, eps2);
      r = sqrt(fmaxn(v, eps2));
    } else {
      r = sqrt(half + inner);
    }
    inv_inner = T(1) / inner;
    inv_2r = T(0.5) / r;
    dr_du = (T(0.5) + T(0.5) * half * inv_inner) * inv_2r;
    dr_dw = (aa * zs * inv_inner) * inv_2r;
  }
  const T r2 = r * r;
  const T q = r2 * r2 + aa * zs * zs;
  const T inv_q = T(1) / q;
  const T r3 = r * r2;
  const T two_m = T(2) * M;
  const T f = two_m * r3 * inv_q;
  const T t3 = T(3) * a * a * zs * zs - r2 * r2;
  const T df_dr = two_m * r2 * t3 * inv_q * inv_q;
  const T df_dw = T(-4) * M * r3 * a * a * zs * inv_q * inv_q;
  const T denom = r2 + aa;
  const T inv_denom = T(1) / denom;
  const T inv_r = T(1) / r;
  const T k1 = (r * xs + a * ys) * inv_denom;
  const T k2 = (r * ys - a * xs) * inv_denom;
  const T k3 = zs * inv_r;
  const T k[4] = {T(1), k1, k2, k3};
  T du[3], r_c[3], df[3], trc[3], n0[3], n1[3], n2[3], dk[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    du[c] = live ? T(2) * xyz[c] : T(0);
    T rc_ = dr_du * du[c];
    if (c == 2) {
      rc_ = rc_ + dr_dw;
      df[c] = df_dr * rc_ + df_dw;
    } else {
      df[c] = df_dr * rc_;
    }
    const T t = T(2) * r * rc_;
    if (c == 0) {
      n0[c] = xs * rc_ + r - k1 * t;
      n1[c] = ys * rc_ - a - k2 * t;
    } else if (c == 1) {
      n0[c] = xs * rc_ + a - k1 * t;
      n1[c] = ys * rc_ + r - k2 * t;
    } else {
      n0[c] = xs * rc_ - k1 * t;
      n1[c] = ys * rc_ - k2 * t;
    }
    n2[c] = c == 2 ? (T(1) - k3 * rc_) : -(k3 * rc_);
    r_c[c] = rc_;
    trc[c] = t;
    dk[c][0] = n0[c] * inv_denom;
    dk[c][1] = n1[c] * inv_denom;
    dk[c][2] = n2[c] * inv_r;
  }
  const T kappa = T(-1) + k1 * k1 + k2 * k2 + k3 * k3;
  const T d_raw = T(1) + f * kappa;
  const T dmin = p.cfg[P_DET_MIN];
  const bool neg = d_raw < T(0);
  const T d = neg ? fminn(d_raw, -dmin) : fmaxn(d_raw, dmin);
  const T w_d = neg ? w_max(-d_raw, dmin) : w_max(d_raw, dmin);
  const T coef = f / d;
  const T ku = u0 + k1 * uu[0] + k2 * uu[1] + k3 * uu[2];
  const T fdot = df[0] * uu[0] + df[1] * uu[1] + df[2] * uu[2];
  T Dv[3], Ev[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    Dv[b] = uu[0] * dk[0][b] + uu[1] * dk[1][b] + uu[2] * dk[2][b];
    Ev[b] = uu[0] * dk[b][0] + uu[1] * dk[b][1] + uu[2] * dk[b][2];
  }
  const T uD = uu[0] * Dv[0] + uu[1] * Dv[1] + uu[2] * Dv[2];
  const T half_fdot = T(0.5) * fdot;
  const T s1 = half_fdot * ku + f * uD;
  T A[4], C[4], Bu[4];
  A[0] = ku * half_fdot + s1;
#pragma unroll
  for (int d_ = 1; d_ < 4; ++d_) {
    C[d_] = half_fdot * k[d_] + f * Dv[d_ - 1];
    Bu[d_] = T(0.5) * df[d_ - 1] * ku + f * Ev[d_ - 1];
    A[d_] = ku * C[d_] + k[d_] * s1 - ku * Bu[d_];
  }
  const T kuA = -A[0] + k1 * A[1] + k2 * A[2] + k3 * A[3];
  const T out4 = A[0] + (-coef) * kuA;

  // -- reverse --
  T ub[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) ub[c] = ct[c] * w_clip(y[4 + c], -rc, rc);
  const T g4 = ct[4] * w_clip(out4, -rc, rc);
  T kuAb = (-coef) * g4;
  T coefb = -(kuA * g4);
  T Ab[4], kb[4];
  Ab[0] = g4;
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    const T outc = -A[c] + coef * k[c] * kuA;
    const T gg = ct[4 + c] * w_clip(outc, -rc, rc);
    Ab[c] = -gg;
    const T t = coef * k[c];
    const T tb = kuA * gg;
    kuAb = kuAb + t * gg;
    coefb = coefb + k[c] * tb;
    kb[c] = coef * tb;
  }
  Ab[0] = Ab[0] - kuAb;
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    Ab[c] = Ab[c] + k[c] * kuAb;
    kb[c] = kb[c] + A[c] * kuAb;
  }
  T kub = T(0), s1b = T(0), Cb[4], Bub[4];
#pragma unroll
  for (int d_ = 1; d_ < 4; ++d_) {
    kub = kub + C[d_] * Ab[d_] - Bu[d_] * Ab[d_];
    Cb[d_] = ku * Ab[d_];
    kb[d_] = kb[d_] + s1 * Ab[d_];
    s1b = s1b + k[d_] * Ab[d_];
    Bub[d_] = -(ku * Ab[d_]);
  }
  T dfb[3], Evb[3], Dvb[3];
  T fb = T(0);
#pragma unroll
  for (int d_ = 1; d_ < 4; ++d_) {
    dfb[d_ - 1] = T(0.5) * ku * Bub[d_];
    kub = kub + T(0.5) * df[d_ - 1] * Bub[d_];
    fb = fb + Ev[d_ - 1] * Bub[d_];
    Evb[d_ - 1] = f * Bub[d_];
  }
  T hfb = T(0);
#pragma unroll
  for (int d_ = 1; d_ < 4; ++d_) {
    hfb = hfb + k[d_] * Cb[d_];
    kb[d_] = kb[d_] + half_fdot * Cb[d_];
    fb = fb + Dv[d_ - 1] * Cb[d_];
    Dvb[d_ - 1] = f * Cb[d_];
  }
  kub = kub + half_fdot * Ab[0];
  hfb = hfb + ku * Ab[0];
  s1b = s1b + Ab[0];
  hfb = hfb + ku * s1b;
  kub = kub + half_fdot * s1b;
  fb = fb + uD * s1b;
  const T uDb = f * s1b;
  const T fdotb = T(0.5) * hfb;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    ub[b + 1] = ub[b + 1] + Dv[b] * uDb;
    Dvb[b] = Dvb[b] + uu[b] * uDb;
  }
  T dkb[3][3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ub[c + 1] = ub[c + 1] + dk[b][c] * Evb[b];
      dkb[b][c] = uu[c] * Evb[b];
    }
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ub[c + 1] = ub[c + 1] + dk[c][b] * Dvb[b];
      dkb[c][b] = dkb[c][b] + uu[c] * Dvb[b];
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dfb[c] = dfb[c] + uu[c] * fdotb;
    ub[c + 1] = ub[c + 1] + df[c] * fdotb;
  }
  ub[0] = ub[0] + kub;
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    ub[c] = ub[c] + k[c] * kub;
    kb[c] = kb[c] + y[4 + c] * kub;
  }
  fb = fb + coefb / d;
  const T db = -(coefb * coef) / d;
  const T drawb = w_d * db;
  fb = fb + kappa * drawb;
  const T kappab = f * drawb;
#pragma unroll
  for (int c = 1; c < 4; ++c) kb[c] = kb[c] + T(2) * k[c] * kappab;

  T xb[3] = {T(0), T(0), T(0)};
  T rb = T(0), aab = T(0), inv_denomb = T(0), inv_rb = T(0);
  T df_drb = T(0), df_dwb = T(0), dr_dub = T(0), dr_dwb = T(0);
  ab = T(0);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T n0b = inv_denom * dkb[c][0];
    inv_denomb = inv_denomb + n0[c] * dkb[c][0];
    const T n1b = inv_denom * dkb[c][1];
    inv_denomb = inv_denomb + n1[c] * dkb[c][1];
    const T n2b = inv_r * dkb[c][2];
    inv_rb = inv_rb + n2[c] * dkb[c][2];
    xb[0] = xb[0] + r_c[c] * n0b;
    xb[1] = xb[1] + r_c[c] * n1b;
    T rcb = xs * n0b + ys * n1b;
    if (c == 0) {
      rb = rb + n0b;
      ab = ab - n1b;
    } else if (c == 1) {
      ab = ab + n0b;
      rb = rb + n1b;
    }
    kb[1] = kb[1] - trc[c] * n0b;
    kb[2] = kb[2] - trc[c] * n1b;
    const T trb = -(k1 * n0b) - k2 * n1b;
    kb[3] = kb[3] - r_c[c] * n2b;
    rcb = rcb - k3 * n2b;
    rb = rb + T(2) * r_c[c] * trb;
    rcb = rcb + T(2) * r * trb;
    df_drb = df_drb + r_c[c] * dfb[c];
    rcb = rcb + df_dr * dfb[c];
    if (c == 2) {
      df_dwb = df_dwb + dfb[2];
      dr_dwb = dr_dwb + rcb;
    }
    dr_dub = dr_dub + du[c] * rcb;
    const T dub = dr_du * rcb;
    xb[c] = xb[c] + (live ? T(2) * dub : T(0));
  }
  xb[2] = xb[2] + inv_r * kb[3];
  inv_rb = inv_rb + zs * kb[3];
  T nb = inv_denom * kb[2];
  inv_denomb = inv_denomb + (r * ys - a * xs) * kb[2];
  rb = rb + ys * nb;
  xb[1] = xb[1] + r * nb;
  ab = ab - xs * nb;
  xb[0] = xb[0] - a * nb;
  nb = inv_denom * kb[1];
  inv_denomb = inv_denomb + (r * xs + a * ys) * kb[1];
  rb = rb + xs * nb;
  xb[0] = xb[0] + r * nb;
  ab = ab + ys * nb;
  xb[1] = xb[1] + a * nb;
  rb = rb - inv_r * inv_r * inv_rb;
  const T denomb = -(inv_denom * inv_denom * inv_denomb);
  T r2b = denomb;
  aab = aab + denomb;
  const T iq2 = inv_q * inv_q;
  const T e = T(-4) * df_dwb;
  Mb = r3 * aa * zs * iq2 * e;
  T r3b = M * aa * zs * iq2 * e;
  ab = ab + T(2) * M * r3 * a * zs * iq2 * e;
  xb[2] = xb[2] + M * r3 * aa * iq2 * e;
  T inv_qb = T(2) * M * r3 * aa * zs * inv_q * e;
  T two_mb = r2 * t3 * iq2 * df_drb;
  r2b = r2b + two_m * t3 * iq2 * df_drb;
  const T t3b = two_m * r2 * iq2 * df_drb;
  inv_qb = inv_qb + T(2) * two_m * r2 * t3 * inv_q * df_drb;
  ab = ab + T(6) * a * zs * zs * t3b;
  xb[2] = xb[2] + T(6) * aa * zs * t3b;
  r2b = r2b - T(2) * r2 * t3b;
  two_mb = two_mb + r3 * inv_q * fb;
  r3b = r3b + two_m * inv_q * fb;
  inv_qb = inv_qb + two_m * r3 * fb;
  Mb = Mb + T(2) * two_mb;
  rb = rb + r2 * r3b;
  r2b = r2b + r * r3b;
  const T qb = -(inv_q * inv_q * inv_qb);
  r2b = r2b + T(2) * r2 * qb;
  aab = aab + zs * zs * qb;
  xb[2] = xb[2] + T(2) * aa * zs * qb;
  rb = rb + T(2) * r * r2b;
  T rho2b = T(0), halfb, inner0b;
  if (r_mode == R_AS_WRITTEN) {
    const T sb = T(0.5) * rb - (T(0.25) * dr_dub) / (s * s);
    halfb = T(0.5) * inv_inner * dr_dub;
    const T inv_innerb = T(0.5) * half * dr_dub + aa * zs * dr_dwb;
    aab = aab + zs * inv_inner * dr_dwb;
    xb[2] = xb[2] + aa * inv_inner * dr_dwb;
    inner0b = rb - inv_inner * inv_inner * inv_innerb;
    const T sqb = (T(0.5) * sb) / s;
    rho2b = rho2b + sqb;
    aab = aab - sqb;
  } else {
    const T inv_2rb = (T(0.5) + T(0.5) * half * inv_inner) * dr_dub
                      + aa * zs * inv_inner * dr_dwb;
    halfb = T(0.5) * inv_inner * inv_2r * dr_dub;
    const T m = inv_2r * dr_dwb;
    aab = aab + zs * inv_inner * m;
    xb[2] = xb[2] + aa * inv_inner * m;
    const T inv_innerb = T(0.5) * half * inv_2r * dr_dub + aa * zs * m;
    rb = rb - T(2) * inv_2r * inv_2r * inv_2rb;
    T vb = inv_2r * rb;
    if (r_mode == R_TEXTBOOK) vb = w_v * vb;
    halfb = halfb + vb;
    const T innerb = vb - inv_inner * inv_inner * inv_innerb;
    inner0b = r_mode == R_TEXTBOOK ? w_inner * innerb : innerb;
  }
  // No cotangent where the inner radius is clamped (inner0 may be 0 there).
  const T wb = inner0b == T(0) ? T(0) : (T(0.5) * inner0b) / inner0;
  aab = aab + zs * zs * wb;
  xb[2] = xb[2] + T(2) * aa * zs * wb;
  halfb = halfb + T(2) * half * wb;
  rho2b = rho2b + T(0.5) * halfb;
  aab = aab - T(0.5) * halfb;
  const T rawb = w_rho * rho2b;
  if (r_mode == R_AS_WRITTEN) aab = aab + (T(1) - w_rho) * rho2b;
#pragma unroll
  for (int c = 0; c < 3; ++c) xb[c] = xb[c] + T(2) * xyz[c] * rawb;
  ab = ab + T(2) * a * aab;
  cty[0] = T(0) * w_in[0];
#pragma unroll
  for (int c = 0; c < 3; ++c) cty[1 + c] = xb[c] * w_in[1 + c];
#pragma unroll
  for (int c = 0; c < 4; ++c) cty[4 + c] = ub[c] * w_in[4 + c];
}

// y + dt * sum_{j <= ROW} TS_A[ROW][j] k_j, as tsit5_step adds; ks[j][c]
// the stages (an array, or K7's view of K6's record).
template <int ROW, typename T, typename KS>
__device__ __forceinline__ void stage_input(const T* y, T dt, const KS& ks,
                                            T* z) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    T acc = T(ts_a(ROW, 0)) * ks[0][c];
#pragma unroll
    for (int j = 1; j <= ROW; ++j) acc = acc + T(ts_a(ROW, j)) * ks[j][c];
    z[c] = y[c] + dt * acc;
  }
}

// One stage of the Tsit5 step's reverse sweep (step_vjp's loop over m, from
// 5 down to 1): the cotangent kb[M] of stage M pulled back through the RHS
// at that stage's input, into y's cotangent, (M, a) and the earlier stages.
template <int M, typename T, bool KERR, typename PP, typename KS>
__device__ __forceinline__ void back_stage(const PP& p, int r_mode,
                                           const T* y, T dt, const KS& ks,
                                           T (*kb)[8], T* yb, T& gM,
                                           T& ga) {
  T z[8], g[8], sb[8], dM, da;
  stage_input<M - 1>(y, dt, ks, z);
  rhs_vjp<T, KERR>(p, r_mode, z, kb[M], g, dM, da);
  gM = gM + dM;
  ga = ga + da;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    yb[c] = yb[c] + g[c];
    sb[c] = dt * g[c];
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      kb[j][c] = kb[j][c] + T(ts_a(M - 1, j)) * sb[c];
}

// The RK4 step's reverse sweep (step_vjp's RK4 branch) given its stages
// k2, k3 and k4 as rk4_step computed them from (y, k1, dt): K4 keeps them
// from its replay, so its reverse runs no forward rhs; step_vjp computes
// them first. The stage inputs z2, z3, z4 are rebuilt, the same
// expressions on the same numbers.
template <typename T, bool KERR, typename PP>
__device__ __forceinline__ void rk4_vjp(const PP& p, int r_mode, const T* y,
                                        const T* k1, const T* k2,
                                        const T* k3, const T* k4, T dt,
                                        const T* cty, const T* ctk, T* yb,
                                        T* k1b, T& gM, T& ga) {
  T z2[8], z3[8], z4[8], y1[8], g[8], dM, da;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    z2[c] = y[c] + T(0.5) * dt * k1[c];
    z3[c] = y[c] + T(0.5) * dt * k2[c];
    z4[c] = y[c] + dt * k3[c];
  }
  const T dt6 = dt / T(6);
#pragma unroll
  for (int c = 0; c < 8; ++c)
    y1[c] = y[c] + dt6 * (k1[c] + T(2) * k2[c] + T(2) * k3[c] + k4[c]);
  rhs_vjp<T, KERR>(p, r_mode, y1, ctk, g, gM, ga);
  T sb[8], k2b[8], k3b[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T b = cty[c] + g[c];
    yb[c] = b;
    sb[c] = dt6 * b;
    k1b[c] = sb[c];
    k2b[c] = T(2) * sb[c];
    k3b[c] = T(2) * sb[c];
  }
  rhs_vjp<T, KERR>(p, r_mode, z4, sb, g, dM, da);
  gM = gM + dM;
  ga = ga + da;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    yb[c] = yb[c] + g[c];
    k3b[c] = k3b[c] + dt * g[c];
  }
  rhs_vjp<T, KERR>(p, r_mode, z3, k3b, g, dM, da);
  gM = gM + dM;
  ga = ga + da;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    yb[c] = yb[c] + g[c];
    k2b[c] = k2b[c] + T(0.5) * dt * g[c];
  }
  rhs_vjp<T, KERR>(p, r_mode, z2, k2b, g, dM, da);
  gM = gM + dM;
  ga = ga + da;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    yb[c] = yb[c] + g[c];
    k1b[c] = k1b[c] + T(0.5) * dt * g[c];
  }
}

// The Tsit5 step's reverse sweep (step_vjp's Tsit5 branch) given its
// stages ks[j][c], k1..k6: step_vjp computes them first; K7 reads them from
// K6's record. CTKS: decltype(nullptr) for none (K4), or ctks(j, c), the cotangent
// of stage j itself, added where the sweep starts (K7: the dense output
// reads the stages; step_vjp's ct_ks).
template <typename T, bool KERR, typename PP, typename KS, typename CTKS>
__device__ __forceinline__ void tsit5_vjp(const PP& p, int r_mode,
                                          const T* y, const KS& ks, T dt,
                                          const T* cty, const T* ctk, T* yb,
                                          T* k1b, T& gM, T& ga,
                                          const CTKS& ctks) {
  T g[8], z[8];
  stage_input<5>(y, dt, ks, z);
  rhs_vjp<T, KERR>(p, r_mode, z, ctk, g, gM, ga);
  T kb[6][8], sb[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T b = cty[c] + g[c];
    yb[c] = b;
    sb[c] = dt * b;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      kb[j][c] = T(ts_a(5, j)) * sb[c];
      if constexpr (!std::is_same<CTKS, decltype(nullptr)>::value)
        kb[j][c] = kb[j][c] + ctks(j, c);
    }
  back_stage<5, T, KERR>(p, r_mode, y, dt, ks, kb, yb, gM, ga);
  back_stage<4, T, KERR>(p, r_mode, y, dt, ks, kb, yb, gM, ga);
  back_stage<3, T, KERR>(p, r_mode, y, dt, ks, kb, yb, gM, ga);
  back_stage<2, T, KERR>(p, r_mode, y, dt, ks, kb, yb, gM, ga);
  back_stage<1, T, KERR>(p, r_mode, y, dt, ks, kb, yb, gM, ga);
#pragma unroll
  for (int c = 0; c < 8; ++c) k1b[c] = kb[0][c];
}

// Reverse mode of one accepted step (ops/adjoint.py step_vjp):
// (ct of y_new, ct of k_last) -> (ct of y, ct of k1, ct of M, ct of a).
template <typename T, bool KERR, bool TSIT5, typename PP>
__device__ __forceinline__ void step_vjp(const PP& p, int r_mode,
                                         const T* y, const T* k1, T dt,
                                         const T* cty, const T* ctk, T* yb,
                                         T* k1b, T& gM, T& ga) {
  if constexpr (TSIT5) {
    T ks[6][8], z[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) ks[0][c] = k1[c];
    stage_input<0>(y, dt, ks, z);
    rhs<T, KERR>(p, r_mode, z, ks[1]);
    stage_input<1>(y, dt, ks, z);
    rhs<T, KERR>(p, r_mode, z, ks[2]);
    stage_input<2>(y, dt, ks, z);
    rhs<T, KERR>(p, r_mode, z, ks[3]);
    stage_input<3>(y, dt, ks, z);
    rhs<T, KERR>(p, r_mode, z, ks[4]);
    stage_input<4>(y, dt, ks, z);
    rhs<T, KERR>(p, r_mode, z, ks[5]);
    tsit5_vjp<T, KERR>(p, r_mode, y, ks, dt, cty, ctk, yb, k1b, gM, ga,
                       nullptr);
  } else {
    T z[8], k2[8], k3[8], k4[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) z[c] = y[c] + T(0.5) * dt * k1[c];
    rhs<T, KERR>(p, r_mode, z, k2);
#pragma unroll
    for (int c = 0; c < 8; ++c) z[c] = y[c] + T(0.5) * dt * k2[c];
    rhs<T, KERR>(p, r_mode, z, k3);
#pragma unroll
    for (int c = 0; c < 8; ++c) z[c] = y[c] + dt * k3[c];
    rhs<T, KERR>(p, r_mode, z, k4);
    rk4_vjp<T, KERR>(p, r_mode, y, k1, k2, k3, k4, dt, cty, ctk, yb, k1b, gM,
                     ga);
  }
}

// The group table's arguments: none (groups null: one parameter set), or
// G rows of group_stride values, at least M, a and each object's row, for
// rays_per_group consecutive rays each.
inline bool groups_ok(const void* groups, int n, int n_obj,
                      int rays_per_group, int group_stride) {
  return groups == nullptr ||
         (rays_per_group >= 1 && n % rays_per_group == 0 &&
          group_stride >= 2 + OBJ_STRIDE * n_obj);
}

}  // namespace
