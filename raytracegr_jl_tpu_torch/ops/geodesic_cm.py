"""K1, the geodesic integration of a ray batch: its plain PyTorch version and
the wrapper of its CUDA kernel (csrc/geodesic.cu).

Counterpart of raytracegr_jl_tpu/ops/pallas_geodesic.py: ``ks_parts``,
``geodesic_cm``, ``scene_event_cm``, the Tsit5/RK4 stages, the dense-output
detection sweep, the ``make_step_cm`` body, ``localize_events_cm`` and
``integrate_rays_cm`` (plain), ``impact_parameter_order``, and
``integrate_rays_cuda`` (the kernel, the counterpart of
``integrate_rays_pallas``), and what every kernel's launch shares: the
parameter block (``pack_params``), the scene code and the block size.

Layout: the plain version keeps the ray state component-major, ``[8, B]``,
so that each elementwise operation is one torch call over the batch; the
public functions take and return ``[B, 8]`` as in JAX.

The plain version is written so that the kernel can follow it operation by
operation: the same expression trees, explicit left-to-right sums instead of
reductions, true division where the divisor is not a power of two (PyTorch
on CUDA divides by a python scalar as a multiplication by its reciprocal).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from ..models.objects import (KIND_DISK, KIND_DISTANCE, KIND_DISTANCE_JVP,
                              KIND_PLANE, KIND_SPHERE, Scene, balanced_min,
                              object_kinds)
from .geometry import clamp_det, det_min, sanitize_bounds
from .integrate import (BMAX_TSIT5, ERR_BIG, HERMITE_ENV, TS_A, TS_BTILDE,
                        IntegratorConfig, TraceResult, hairer_init_dt,
                        hermite_dinterp, hermite_interp, tsit5_bi, tsit5_dbi)
from .metrics import (R_AS_WRITTEN, R_TEXTBOOK, Metric, _scalar,
                      clamped_rho2, kerr_schild_radius_partials)

EventFn = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# Right-hand side
# ---------------------------------------------------------------------------

def ks_parts(metric: Metric, xl):
    """Kerr-Schild structural parts for the closed-form geodesic
    contraction: ``(f, [d_x f, d_y f, d_z f], k[0..3], dk, coef)`` with
    ``dk[c][b] = d_c k_b`` (c, b spatial) and ``coef = f / (1 + f kappa)``,
    the Sherman-Morrison factor of g^-1. ``xl`` is the list of 4 position
    rows. Same operation order as the JAX ``kerr_schild_cm.ks_parts``."""
    xs, ys, zs = xl[1], xl[2], xl[3]
    M = _scalar(metric.params.M, xs)
    a = _scalar(metric.params.a, xs)
    rf, rho_min = metric.r_formula, metric.rho_min
    rho2_raw = xs * xs + ys * ys + zs * zs
    rho2 = clamped_rho2(rho2_raw, a, rho_min, rf)
    live = rho2_raw >= rho2
    r, dr_du, dr_dw = kerr_schild_radius_partials(rho2, zs, a, r_formula=rf,
                                                  rho_min=rho_min)
    r2 = r * r
    q = r2 * r2 + a * a * zs * zs
    inv_q = 1.0 / q
    r3 = r * r2
    f = 2 * M * r3 * inv_q
    df_dr = 2 * M * r2 * (3 * a * a * zs * zs - r2 * r2) * inv_q * inv_q
    df_dw = -4 * M * r3 * a * a * zs * inv_q * inv_q
    denom = r2 + a * a
    inv_denom = 1.0 / denom
    inv_r = 1.0 / r
    k1 = (r * xs + a * ys) * inv_denom
    k2 = (r * ys - a * xs) * inv_denom
    k3 = zs * inv_r
    zero = torch.zeros_like(r)
    du = [torch.where(live, 2 * xs, zero), torch.where(live, 2 * ys, zero),
          torch.where(live, 2 * zs, zero)]
    df, dk = [], []
    for c in (1, 2, 3):
        r_c = dr_du * du[c - 1]
        if c == 3:  # z also enters r explicitly
            r_c = r_c + dr_dw
            df.append(df_dr * r_c + df_dw)
        else:
            df.append(df_dr * r_c)
        two_r_rc = 2 * r * r_c
        if c == 1:
            dk1 = (xs * r_c + r - k1 * two_r_rc) * inv_denom
            dk2 = (ys * r_c - a - k2 * two_r_rc) * inv_denom
        elif c == 2:
            dk1 = (xs * r_c + a - k1 * two_r_rc) * inv_denom
            dk2 = (ys * r_c + r - k2 * two_r_rc) * inv_denom
        else:
            dk1 = (xs * r_c - k1 * two_r_rc) * inv_denom
            dk2 = (ys * r_c - k2 * two_r_rc) * inv_denom
        dk3 = ((1.0 - k3 * r_c) if c == 3 else -(k3 * r_c)) * inv_r
        dk.append([dk1, dk2, dk3])
    kappa = -1.0 + k1 * k1 + k2 * k2 + k3 * k3
    coef = f / clamp_det(1 + f * kappa)
    return f, df, [1.0, k1, k2, k3], dk, coef


def geodesic_cm(metric: Metric, y: torch.Tensor) -> torch.Tensor:
    """RHS on component-major state: ``y [8, B] -> ydot [8, B]``.

    Input clamped at the state bound, output at the RHS bound. Kerr-Schild
    uses the closed-form contraction ``udot^a = -eta^aa A_a + coef ku_r^a
    (ku_r . A)`` of the JAX package's ``geodesic_cm``; Minkowski is exactly
    ``udot = 0`` (JAX folds its all-zero parts at trace time)."""
    state_clamp, rhs_clamp = sanitize_bounds(y.dtype)
    y = torch.clamp(y, -state_clamp, state_clamp)
    if metric.name == "minkowski":
        out = torch.cat([y[4:], torch.zeros_like(y[4:])])
        return torch.clamp(out, -rhs_clamp, rhs_clamp)
    xl, ul = [y[i] for i in range(4)], [y[i] for i in range(4, 8)]
    f, df, k, dk, coef = ks_parts(metric, xl)
    us = ul[1:]
    ku = ul[0] + k[1] * ul[1] + k[2] * ul[2] + k[3] * ul[3]
    fdot = df[0] * us[0] + df[1] * us[1] + df[2] * us[2]
    Dv = [us[0] * dk[0][b] + us[1] * dk[1][b] + us[2] * dk[2][b]
          for b in range(3)]
    Ev = [us[0] * dk[d][0] + us[1] * dk[d][1] + us[2] * dk[d][2]
          for d in range(3)]
    uD = us[0] * Dv[0] + us[1] * Dv[1] + us[2] * Dv[2]
    half_fdot = 0.5 * fdot
    s1 = half_fdot * ku + f * uD
    A = [ku * half_fdot + s1]
    for d in (1, 2, 3):
        C_d = half_fdot * k[d] + f * Dv[d - 1]
        Bu_d = 0.5 * df[d - 1] * ku + f * Ev[d - 1]
        A.append(ku * C_d + k[d] * s1 - ku * Bu_d)
    kuA = -A[0] + k[1] * A[1] + k[2] * A[2] + k[3] * A[3]
    udot = [A[0] + (-coef) * kuA] + [-A[a] + coef * k[a] * kuA
                                     for a in (1, 2, 3)]
    return torch.clamp(torch.stack(ul + udot), -rhs_clamp, rhs_clamp)


def initial_dt(metric: Metric, y0: torch.Tensor,
               integ: IntegratorConfig) -> torch.Tensor:
    """Per-ray first step: ``rk4_dt`` for RK4, else Hairer's heuristic over
    the component-major right-hand side (``y0 [B, 8]``). K1, K2 and K3 take
    the same step in their prologues (csrc ``initial_step``)."""
    if integ.method == "rk4":
        return torch.full(y0.shape[:1], integ.rk4_dt, dtype=y0.dtype,
                          device=y0.device)
    return hairer_init_dt(lambda y: geodesic_cm(metric, y.t()).t(), y0,
                          integ.rtol, integ.atol, 5, integ.lam_max)


# ---------------------------------------------------------------------------
# Scene event
# ---------------------------------------------------------------------------

def _object_get(scene: Scene, i: int):
    """Object i's field (and component): a 0-d tensor, or ``[R]`` where
    the scene's fields carry a leading ray axis (a grouped batch's per-ray
    rows, ``pos [R, N, 4]``)."""
    def get(field, comp=None):
        arr = getattr(scene, field)
        return arr[..., i] if comp is None else arr[..., i, comp]
    return get


def scene_event_cm(scene: Scene) -> EventFn:
    """Min-distance event on component-major positions ``[4+, B] -> [B]``
    (only rows 0..3 are read)."""
    kinds = object_kinds(scene)
    gets = [_object_get(scene, i) for i in range(len(kinds))]

    def event(y):
        d = None
        for kind, get in zip(kinds, gets):
            di = KIND_DISTANCE[kind](y[0], y[1], y[2], y[3], get)
            d = di if d is None else torch.minimum(d, di)
        return d

    def jvp(y, dy):
        """(event(y), its derivative along dy); ties split the tangent."""
        d = dd = None
        for kind, get in zip(kinds, gets):
            di, ddi = KIND_DISTANCE_JVP[kind](y[0], y[1], y[2], y[3], dy[0],
                                              dy[1], dy[2], dy[3], get)
            if d is None:
                d, dd = di, ddi
            else:
                d, dd = balanced_min(d, dd, di, ddi)
        return d, dd

    event.jvp = jvp
    event.bound = scene_crossing_bound(scene)
    return event


def _sq_min(lo, hi, c):
    """min of (v - c)^2 over v in [lo, hi]."""
    m = torch.maximum(torch.clamp_min(lo - c, 0.0),
                      torch.clamp_min(c - hi, 0.0))
    return m * m


def _sq_max(lo, hi, c):
    """max of (v - c)^2 over v in [lo, hi]."""
    m = torch.maximum(torch.abs(lo - c), torch.abs(hi - c))
    return m * m


def scene_crossing_bound(scene: Scene):
    """A lower bound of the scene event over a position box (the JAX
    package's ``_scene_bound_from_get``): ``bound(lo, hi) -> [B]`` for the
    box's corners, two lists of 4 rows (t, x, y, z), is at most the event
    at every point of the box. Interval arithmetic per kind: a sphere's
    squared distance (the inside-out sky sphere's from its far corner), the
    plane's earliest time, the disk's slab and ring constraints. None where
    the scene holds another kind. The detection gate's certificate."""
    kinds = object_kinds(scene)
    if any(k not in (KIND_SPHERE, KIND_PLANE, KIND_DISK) for k in kinds):
        return None
    gets = [_object_get(scene, i) for i in range(len(kinds))]

    def bound(lo, hi):
        d = None
        for kind, get in zip(kinds, gets):
            if kind == KIND_PLANE:
                di = lo[0] - get("time")
            elif kind == KIND_SPHERE:
                r = get("radius")
                near = (_sq_min(lo[1], hi[1], get("pos", 1))
                        + _sq_min(lo[2], hi[2], get("pos", 2))
                        + _sq_min(lo[3], hi[3], get("pos", 3)))
                far = (_sq_max(lo[1], hi[1], get("pos", 1))
                       + _sq_max(lo[2], hi[2], get("pos", 2))
                       + _sq_max(lo[3], hi[3], get("pos", 3)))
                di = torch.where(r < 0, r * r - far, near - r * r)
            else:
                sz = _sq_min(lo[3], hi[3], get("pos", 3))
                rho_lo = (_sq_min(lo[1], hi[1], get("pos", 1))
                          + _sq_min(lo[2], hi[2], get("pos", 2)))
                rho_hi = (_sq_max(lo[1], hi[1], get("pos", 1))
                          + _sq_max(lo[2], hi[2], get("pos", 2)))
                r_in, r_out = get("r_in"), get("r_out")
                di = torch.maximum(torch.sqrt(sz) - get("half"),
                                   torch.maximum(rho_lo - r_out * r_out,
                                                 r_in * r_in - rho_hi))
            d = di if d is None else torch.minimum(d, di)
        return d

    return bound


# ---------------------------------------------------------------------------
# Stages and dense output
# ---------------------------------------------------------------------------

def _tsit5_step_cm(f, y, dt, k1):
    """Tsit5 stage sweep: y [8, B], dt [B] -> (y5, err, k7, (k1..k7))."""
    A, Bt = TS_A, TS_BTILDE
    k2 = f(y + dt * (A[0][0] * k1))
    k3 = f(y + dt * (A[1][0] * k1 + A[1][1] * k2))
    k4 = f(y + dt * (A[2][0] * k1 + A[2][1] * k2 + A[2][2] * k3))
    k5 = f(y + dt * (A[3][0] * k1 + A[3][1] * k2 + A[3][2] * k3
                     + A[3][3] * k4))
    k6 = f(y + dt * (A[4][0] * k1 + A[4][1] * k2 + A[4][2] * k3
                     + A[4][3] * k4 + A[4][4] * k5))
    y5 = y + dt * (A[5][0] * k1 + A[5][1] * k2 + A[5][2] * k3
                   + A[5][3] * k4 + A[5][4] * k5 + A[5][5] * k6)
    k7 = f(y5)
    err = dt * (Bt[0] * k1 + Bt[1] * k2 + Bt[2] * k3 + Bt[3] * k4
                + Bt[4] * k5 + Bt[5] * k6 + Bt[6] * k7)
    return y5, err, k7, (k1, k2, k3, k4, k5, k6, k7)


def _rk4_stages_cm(f, y, dt, k1):
    """RK4 stage sweep: y [8, B], dt [B] -> (y1, (k1, k2, k3, k4))."""
    k2 = f(y + 0.5 * dt * k1)
    k3 = f(y + 0.5 * dt * k2)
    k4 = f(y + dt * k3)
    # A tensor divisor keeps this a true division on CUDA as well; it is
    # filled on the device (no copy from the host).
    y1 = y + (dt / torch.full_like(dt, 6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y1, (k1, k2, k3, k4)


def _rk4_step_cm(f, y, dt, k1):
    y1, _ = _rk4_stages_cm(f, y, dt, k1)
    return y1, None, f(y1), None


def _tsit5_interp_cm(y0, ks, dt, th):
    """Tsit5 dense output ``y0 + dt * sum_i b_i(th) k_i`` (th a python float
    or a [B] tensor)."""
    bs = tsit5_bi(th)
    acc = bs[0] * ks[0]
    for b, k in zip(bs[1:], ks[1:]):
        acc = acc + b * k
    return y0 + dt * acc


def _tsit5_dinterp_cm(ks, dt, th):
    """d/dtheta of ``_tsit5_interp_cm``."""
    dbs = tsit5_dbi(th)
    acc = dbs[0] * ks[0]
    for b, k in zip(dbs[1:], ks[1:]):
        acc = acc + b * k
    return dt * acc


def _interpolants(y0, y1, f0, f1, dt, ks, rows):
    """``(interp(th), dinterp(th))`` on the first ``rows`` components: Tsit5
    dense output when ``ks`` is given, cubic Hermite otherwise."""
    if ks is not None:
        ksr = tuple(k[:rows] for k in ks)
        return (lambda th: _tsit5_interp_cm(y0[:rows], ksr, dt, th),
                lambda th: _tsit5_dinterp_cm(ksr, dt, th))
    a, b, c, d = y0[:rows], y1[:rows], f0[:rows], f1[:rows]
    return (lambda th: hermite_interp(a, b, c, d, dt, th),
            lambda th: hermite_dinterp(a, b, c, d, dt, th))


# ---------------------------------------------------------------------------
# Event detection and localization
# ---------------------------------------------------------------------------

def _detect_scan(event_fn, interp, y0, cfg: IntegratorConfig):
    """Sample the event on the step's dense output at theta = i/npts and
    bracket the first crossing: ``(crossed [B], th_lo, th_hi)``. The sample
    thetas are python floats, so the dense-output weights are computed in
    double and rounded to the working dtype, as in JAX.

    With ``cfg.refine_minima`` a grazing crossing that falls between two
    samples is rescued, as in the JAX package: the samples' argmin bracket
    is trisected ``min_refine_iters`` times on the dense output at
    run-time thetas, and where the event at the final bracket's midpoint
    is at or below zero the ray crosses there (unless an earlier sample
    crossing stands)."""
    d_prev = event_fn(y0)
    npts = cfg.interp_points
    th_lo = torch.zeros_like(d_prev)
    th_hi = torch.zeros_like(d_prev)
    found = torch.zeros_like(d_prev, dtype=torch.bool)
    refine = cfg.refine_minima
    if refine:  # the samples' argmin and its bracket of two sample spacings
        d_best = d_prev
        a0 = torch.zeros_like(d_prev)
        b0 = torch.full_like(d_prev, 1.0 / npts)
    prev_th = 0.0
    for i in range(1, npts + 1):
        th = i / npts
        d = event_fn(interp(th))
        new = (d <= 0.0) & ~found
        th_lo = torch.where(new, prev_th, th_lo)
        th_hi = torch.where(new, th, th_hi)
        found = found | new
        if refine:
            better = d < d_best
            d_best = torch.where(better, d, d_best)
            a0 = torch.where(better, prev_th, a0)
            b0 = torch.where(better, min((i + 1) / npts, 1.0), b0)
        prev_th = th
    if refine:
        three = d_prev.new_tensor(3.0)  # a true division on CUDA too
        a, b = a0, b0
        for _ in range(cfg.min_refine_iters):
            third = (b - a) / three
            m1, m2 = a + third, b - third
            take = event_fn(interp(m1)) < event_fn(interp(m2))
            a, b = torch.where(take, a, m1), torch.where(take, m2, b)
        th_min = 0.5 * (a + b)
        min_neg = event_fn(interp(th_min)) <= 0.0
        use_min = min_neg & (~found | (a0 < th_lo))
        th_lo = torch.where(use_min, a0, th_lo)
        th_hi = torch.where(use_min, th_min, th_hi)
        found = found | min_neg
    return found & (d_prev > 0.0), th_lo, th_hi


def may_cross(bound, y0, y1, f0, f1, dt, ks):
    """The detection gate: ``[B]`` bool, False where the step's dense output
    provably stays clear of every object (the box ``y0 +- C`` from the
    envelopes ``BMAX_TSIT5`` or ``HERMITE_ENV``, and the scene's lower
    bound over it is positive), so that no sample of the sweep can see a
    crossing. Position rows only; ``ks`` the Tsit5 stages or None (RK4's
    Hermite). The kernels' ``may_cross`` computes the same, in this
    order."""
    if ks is not None:
        acc = BMAX_TSIT5[0] * torch.abs(ks[0][:4])
        for bm, k in zip(BMAX_TSIT5[1:], ks[1:]):
            acc = acc + bm * torch.abs(k[:4])
        C = dt * acc
    else:
        c1, c2, c3 = HERMITE_ENV
        C = (c1 * torch.abs(y1[:4] - y0[:4])
             + dt * (c2 * torch.abs(f0[:4]) + c3 * torch.abs(f1[:4])))
    lo = [y0[c] - C[c] for c in range(4)]
    hi = [y0[c] + C[c] for c in range(4)]
    return bound(lo, hi) <= 0.0


def newton_polish(event_fn, interp, dinterp, th0):
    """One clipped Newton step on the event along theta from the bisection
    bracket's upper end: ``th_star``. The derivative is explicit (dense
    output by the product rule, event per kind), not autodiff."""
    val, dval = event_fn.jvp(interp(th0), dinterp(th0))
    ok = torch.abs(dval) > 1e-3 * (1.0 + torch.abs(val))
    delta = (torch.where(ok, val, torch.zeros_like(val))
             / torch.where(ok, dval, torch.ones_like(dval)))
    return torch.clamp(th0 - torch.clamp(delta, -1.0, 1.0), 0.0, 1.0)


def crossing_stages(metric: Metric, cfg: IntegratorConfig, ev_y0, ev_dt):
    """Each ray's recorded crossing step replayed from its event record
    (FSAL: k1 = rhs(ev_y0)): ``(y1, k1, k_last, ks, stages)``, ``ks`` the
    Tsit5 stages or None (RK4), ``stages`` the step's stages either way
    (Tsit5's k1..k7, RK4's k1..k4)."""
    rhs = lambda s: geodesic_cm(metric, s)  # noqa: E731
    k1 = rhs(ev_y0)
    if cfg.method == "tsit5":
        y1, _, k_last, ks = _tsit5_step_cm(rhs, ev_y0, ev_dt, k1)
        return y1, k1, k_last, ks, ks
    y1, stages = _rk4_stages_cm(rhs, ev_y0, ev_dt, k1)
    return y1, k1, rhs(y1), None, stages


def bisect_bracket(event_fn, interp, cfg: IntegratorConfig, lo, hi):
    """``cfg.bisect_iters`` bisections of the crossing bracket on the dense
    output: its upper end, which takes no gradient (JAX: sg)."""
    with torch.no_grad():
        for _ in range(cfg.bisect_iters):
            mid = 0.5 * (lo + hi)
            gt = event_fn(interp(mid)) > 0.0
            lo = torch.where(gt, mid, lo)
            hi = torch.where(gt, hi, mid)
    return hi


def localize_events_cm(metric: Metric, event_fn, cfg: IntegratorConfig,
                       ev_y0, ev_dt, ev_lo, ev_hi, keep: bool = False):
    """Replay each ray's recorded crossing step (FSAL: k1 = rhs(ev_y0)),
    bisect the bracket on the dense output, Newton-polish it and
    interpolate: ``(th_star [B], y_star [8, B])``. With ``keep``, also the
    bisection's end and the step, which the localization's VJP reads:
    ``(th_star, y_star, th0, crossing_stages(...))``."""
    crossing = crossing_stages(metric, cfg, ev_y0, ev_dt)
    y1, k1, k_last, ks, _ = crossing
    interp, dinterp = _interpolants(ev_y0, y1, k1, k_last, ev_dt, ks, 4)
    hi = bisect_bracket(event_fn, interp, cfg, ev_lo, ev_hi)
    th_star = newton_polish(event_fn, interp, dinterp, hi)
    interp8, _ = _interpolants(ev_y0, y1, k1, k_last, ev_dt, ks, 8)
    if keep:
        return th_star, interp8(th_star), hi, crossing
    return th_star, interp8(th_star)


# ---------------------------------------------------------------------------
# The plain integrator
# ---------------------------------------------------------------------------

def _check_options(cfg: IntegratorConfig) -> None:
    if cfg.method not in ("tsit5", "rk4"):
        raise ValueError(f"unknown method: {cfg.method!r}")
    if cfg.refine_minima and cfg.min_refine_iters < 0:
        raise ValueError("min_refine_iters must be >= 0, got "
                         f"{cfg.min_refine_iters}")


def _sum_sq_rows(r: torch.Tensor) -> torch.Tensor:
    """sum_c r[c]^2 over the 8 rows, left to right (a fixed order that the
    kernel repeats; a reduction kernel may add in another order)."""
    acc = r[0] * r[0]
    for c in range(1, r.shape[0]):
        acc = acc + r[c] * r[c]
    return acc


class StepState(NamedTuple):
    """The loop state of ``make_step_cm``: the JAX package's 14-tuple
    without its iteration counter, which the caller's loop keeps. ``y``,
    ``k1`` and ``ev_y0`` are ``[8, B]``, the rest ``[B]``; ``active`` and
    ``hit`` are bool, ``steps`` an integer count (int32, or the working
    float type in a packed checkpoint). The ``ev_*`` fields record each
    ray's crossing step for ``localize_events_cm``."""

    y: torch.Tensor
    lam: torch.Tensor
    dt: torch.Tensor
    k1: torch.Tensor
    active: torch.Tensor
    hit: torch.Tensor
    steps: torch.Tensor
    err_old: torch.Tensor
    ev_y0: torch.Tensor
    ev_dt: torch.Tensor
    ev_lam: torch.Tensor
    ev_lo: torch.Tensor
    ev_hi: torch.Tensor


class StepRecord(NamedTuple):
    """What one step decided, per ray: the step tried (no gradient), whether
    the ray stepped (``do``) and whether it hit in this step."""

    dt_try: torch.Tensor
    do: torch.Tensor
    hit_now: torch.Tensor


def make_step_cm(metric: Metric, event_fn: EventFn, cfg: IntegratorConfig):
    """``(init, body)`` of the masked batch loop, the counterpart of the JAX
    ``make_step_cm``: ``init(y [8, B], dt0 [B]) -> StepState`` and
    ``body(state) -> (state, StepRecord)``, one step of every ray.

    Finished rays are frozen by masks, so a step of an inactive ray is the
    identity. The body only detects crossings; ``localize_events_cm``
    localizes them from the ``ev_*`` record after the loop. ``dt_try`` is
    detached, as the JAX body's ``lax.stop_gradient``: step sizes are
    solver state, and gradients flow through the stage values only.

    With ``cfg.event_gate`` (and an event that carries a ``bound``, as
    ``scene_event_cm``'s does) the detection sweep is skipped for the rays
    that ``may_cross`` clears, and for the whole batch when it clears them
    all; results are bitwise those without the gate. ``cfg.refine_minima``
    adds the trisection of ``_detect_scan`` and turns the gate off."""
    _check_options(cfg)
    rhs = lambda s: geodesic_cm(metric, s)  # noqa: E731
    adaptive = cfg.method == "tsit5"
    step = _tsit5_step_cm if adaptive else _rk4_step_cm
    bound = getattr(event_fn, "bound", None)
    # refine_minima turns the gate off (its rescue must always run), as in
    # the JAX package.
    gate = cfg.event_gate and bound is not None and not cfg.refine_minima

    def init(y: torch.Tensor, dt0: torch.Tensor) -> StepState:
        B = y.shape[1]
        zero = torch.zeros_like(dt0)
        return StepState(
            y=y, lam=zero, dt=dt0.clone(), k1=rhs(y),
            active=torch.ones(B, dtype=torch.bool, device=y.device),
            hit=torch.zeros(B, dtype=torch.bool, device=y.device),
            steps=torch.zeros(B, dtype=torch.int32, device=y.device),
            err_old=torch.full_like(dt0, cfg.qold_init),
            # Event record: starts finite (dt = 1) so that localization of
            # rays that never hit stays NaN-free; their result is masked out.
            ev_y0=y.clone(), ev_dt=torch.ones_like(dt0), ev_lam=zero,
            ev_lo=zero, ev_hi=zero)

    def body(st: StepState):
        y, lam, dt, k1 = st.y, st.lam, st.dt, st.k1
        dt_try = torch.clamp_min(torch.minimum(dt, cfg.lam_max - lam),
                                 cfg.dt_min)
        dt_try = torch.where(torch.isfinite(dt_try), dt_try,
                             torch.full_like(dt_try, cfg.dt_min)).detach()
        y_new, err, k_last, ks = step(rhs, y, dt_try, k1)
        fin = torch.all(torch.isfinite(y_new), dim=0)
        if adaptive:
            sc = cfg.atol + cfg.rtol * torch.maximum(torch.abs(y),
                                                     torch.abs(y_new))
            ratio = torch.clamp(err / sc, -1e15, 1e15)
            en = torch.sqrt(torch.clamp_min(_sum_sq_rows(ratio) / 8, 1e-30))
            bad = ~torch.isfinite(en) | ~fin
            en = torch.where(bad, torch.full_like(en, ERR_BIG), en)
            accept = en <= 1.0
            en_c = torch.clamp_min(en, 1e-10)
            q_pi = (cfg.safety * en_c ** (-cfg.beta1)
                    * torch.clamp_min(st.err_old, cfg.qold_init) ** cfg.beta2)
            q_rej = cfg.safety * en_c ** (-0.2)
            q = torch.where(accept, q_pi, torch.clamp_max(q_rej, 1.0))
            q = torch.clamp(q, cfg.qmin, cfg.qmax)
            dt_next = torch.clamp(dt_try * q, cfg.dt_min, cfg.lam_max)
            dead = (bad | ~accept) & (dt_try <= 2 * cfg.dt_min)
        else:
            en = torch.ones_like(dt_try)
            bad = ~fin
            accept = ~bad
            dt_next = torch.full_like(dt_try, cfg.rk4_dt)
            dead = bad
        if cfg.stop_rho > 0.0:
            rho2 = y_new[1] ** 2 + y_new[2] ** 2 + y_new[3] ** 2
            dead = dead | (rho2 < cfg.stop_rho ** 2)

        do = st.active & accept
        y_evt = torch.where(fin, y_new, y)
        k_evt = torch.where(fin, k_last, k1)
        # Dying rays: zeroed stages make the interpolant the constant y0.
        ks_evt = (None if ks is None else
                  tuple(torch.where(fin, k, torch.zeros_like(k)) for k in ks))
        with torch.no_grad():  # detection only decides masks
            interp, _ = _interpolants(y, y_evt, k1, k_evt, dt_try, ks_evt, 4)
            may = (may_cross(bound, y, y_evt, k1, k_evt, dt_try, ks_evt)
                   if gate else None)
            if may is not None and not bool(may.any()):
                # No ray may cross: the sweep is skipped (JAX's cond).
                crossed = torch.zeros_like(do)
                th_lo = th_hi = torch.zeros_like(dt_try)
            else:
                crossed, th_lo, th_hi = _detect_scan(event_fn, interp, y,
                                                     cfg)
                if may is not None:  # decided per ray, as in the kernels
                    crossed = crossed & may
        hit_now = do & crossed

        # First hit only: the ray then deactivates.
        lam_acc = lam + dt_try
        done_span = lam_acc >= cfg.lam_max - 1e-6
        active = st.active & ~hit_now & ~(do & done_span) & ~dead
        new = StepState(
            y=torch.where(do, y_evt, y),
            lam=torch.where(do & ~hit_now, lam_acc, lam),
            dt=torch.where(active, dt_next, dt),
            k1=torch.where(do, k_evt, k1),
            active=active,
            hit=st.hit | hit_now,
            steps=st.steps + do.to(st.steps.dtype),
            err_old=torch.where(do, torch.clamp_min(en, cfg.qold_init),
                                st.err_old),
            ev_y0=torch.where(hit_now, y, st.ev_y0),
            ev_dt=torch.where(hit_now, dt_try, st.ev_dt),
            ev_lam=torch.where(hit_now, lam, st.ev_lam),
            ev_lo=torch.where(hit_now, th_lo, st.ev_lo),
            ev_hi=torch.where(hit_now, th_hi, st.ev_hi))
        return new, StepRecord(dt_try=dt_try, do=do, hit_now=hit_now)

    return init, body


def integrate_rays_cm(metric: Metric, scene: Scene, y0: torch.Tensor,
                      dt0: torch.Tensor, cfg: IntegratorConfig) -> TraceResult:
    """Plain version of K1: the masked batch loop of the JAX
    ``integrate_rays_cm`` (``make_step_cm`` body, then one
    ``localize_events_cm`` pass). ``y0 [B, 8]``, ``dt0 [B]``.

    Every ray steps until it hits, spans ``lam_max``, dies or the loop
    reaches ``max_steps``; finished rays are frozen by masks.
    ``cfg.sort_rays`` is ignored, as by the JAX ``xla_cm`` path: it only
    regroups rays for the kernel's warps."""
    event_fn = scene_event_cm(scene)
    init, body = make_step_cm(metric, event_fn, cfg)
    st, it = run_body(body, init(y0.t().contiguous(), dt0), cfg.max_steps)
    y, lam = localized(metric, event_fn, cfg, st)
    return TraceResult(y=y.t(), lam=lam, hit=st.hit, steps=st.steps,
                       n_iters=it)


def run_body(body, st: StepState, budget: int):
    """At most ``budget`` iterations of ``body``, stopping once no ray is
    active (an inactive ray's step is the identity): ``(state, iters)``."""
    it = 0
    while it < budget and bool(st.active.any()):
        st, _ = body(st)
        it += 1
    return st, it


def localized(metric: Metric, event_fn, cfg: IntegratorConfig,
              st: StepState):
    """The loop's result ``(y [8, B], lam [B])``: each hit ray localized
    from its event record, every other ray as it stands (the JAX
    ``localize_events_cm``'s return)."""
    y, lam = st.y, st.lam
    if bool(st.hit.any()):
        th_star, y_star = localize_events_cm(metric, event_fn, cfg, st.ev_y0,
                                             st.ev_dt, st.ev_lo, st.ev_hi)
        y = torch.where(st.hit, y_star, y)
        lam = torch.where(st.hit, st.ev_lam + th_star * st.ev_dt, lam)
    return y, lam


def impact_parameter(y0: torch.Tensor) -> torch.Tensor:
    """Each ray's impact parameter about the coordinate origin, ``[B, 8] ->
    [B]``: the distance of the origin from the line through x along the
    spatial direction of u: the JAX package's cheap proxy for a ray's
    integration cost."""
    x, u = y0[:, 1:4], y0[:, 5:8]
    un = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    perp = x - torch.sum(x * un, -1, keepdim=True) * un
    return torch.linalg.norm(perp, dim=-1)


def impact_parameter_order(y0: torch.Tensor):
    """``(order, inverse order)`` sorting a ``[B, 8]`` batch by
    ``impact_parameter``. The sort is stable, as ``jnp.argsort``; rays are
    integrated independently, so results do not depend on the order."""
    order = torch.argsort(impact_parameter(y0), stable=True)
    return order, torch.argsort(order)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

# Object fields in the kernel's per-object parameter rows (the order the
# JAX package's adjoint kernel packs them in, pallas_adjoint._OBJ_FIELDS).
OBJ_FIELDS = ("pos1", "pos2", "pos3", "radius", "time", "r_in", "r_out",
              "half")
_KERNEL_KINDS = (KIND_SPHERE, KIND_PLANE, KIND_DISK)
# The kernels' configuration block, in the order of csrc/geodesic_common.cuh's
# enum Prm (P_<NAME>), N_CFG slots.
CFG_SLOTS = ("M", "A", "EPS2", "EPS2_HALF", "STATE_CLAMP", "RHS_CLAMP",
             "DET_MIN", "RTOL", "ATOL", "LAM_MAX", "LAM_END", "DT_MIN",
             "DT_DEAD", "RK4_DT", "SAFETY", "QMIN", "QMAX", "NEG_BETA1",
             "BETA2", "QOLD_INIT", "STOP_RHO2", "GATE", "BMAX0", "BMAX1",
             "BMAX2", "BMAX3", "BMAX4", "BMAX5", "BMAX6", "HERM1", "HERM2",
             "HERM3")
N_CFG = 32
_MAX_OBJECTS = 16
_MAX_SAMPLES = 32
_R_MODE = {R_AS_WRITTEN: 0, R_TEXTBOOK: 1}
# sort_rays sorts only batches larger than this: the JAX package's rule,
# one TPU tile (TILE_S * LANES rays).
SORT_MIN_RAYS = 1024
# csrc Params<T>: N_CFG + 8 slots per object and per sample of the working
# type at their maximum counts, then MAX_OBJ int32 kinds, then two int32:
# refine_minima's trisection steps and a pad. Its bytes are what
# launch_with_params copies into the kernels' constant memory.
PARAM_VALUES = N_CFG + 8 * _MAX_OBJECTS + 8 * _MAX_SAMPLES
PARAM_INTS = _MAX_OBJECTS + 2
PARAMS_BYTES = {dt: PARAM_VALUES * dt.itemsize + 4 * PARAM_INTS
                for dt in (torch.float32, torch.float64)}
# Scene codes (csrc SC_*): scenes whose object kinds and detection samples
# the f32 Kerr-Schild kernels of a library know at compile time, by the
# main paths that run them (csrc FIXED_SCENES of each library); SC_ANY
# takes kinds and counts at run time, and SC_REFINE is SC_ANY with
# refine_minima's trisection (the only kernels that compile it in).
SC_ANY, SC_SPS9, SC_SD9, SC_SPS4, SC_S4, SC_REFINE = 0, 1, 2, 3, 4, 5
_SCENE_CODES = {((KIND_SPHERE, KIND_PLANE, KIND_SPHERE), 9): SC_SPS9,
                ((KIND_SPHERE, KIND_DISK), 9): SC_SD9,
                ((KIND_SPHERE, KIND_PLANE, KIND_SPHERE), 4): SC_SPS4,
                ((KIND_SPHERE,), 4): SC_S4}
FIXED_SCENES = {"geodesic": (SC_SPS9, SC_SD9), "compaction": (SC_SD9,),
                "adjoint": (SC_SPS4, SC_S4), "localize": (SC_SPS4, SC_S4)}
# Threads per block of every launch (csrc MAX_THREADS). Blocks of 32 and
# 64 threads were measured no faster on the disk's packed tail (PERF.md).
MAX_THREADS = 128


def _config_slots(metric: Metric, cfg: IntegratorConfig,
                  dtype: torch.dtype) -> list:
    """The configuration block, ``CFG_SLOTS`` in order, as python floats
    (M and a read from the metric: see ``pack_params`` for tensors)."""
    state_clamp, rhs_clamp = sanitize_bounds(dtype)
    eps2 = metric.rho_min * metric.rho_min
    M, a = (float(metric.params.M), float(metric.params.a))
    slots = dict(
        M=M, A=a, EPS2=eps2, EPS2_HALF=eps2 / 2, STATE_CLAMP=state_clamp,
        RHS_CLAMP=rhs_clamp, DET_MIN=det_min(dtype), RTOL=cfg.rtol,
        ATOL=cfg.atol, LAM_MAX=cfg.lam_max, LAM_END=cfg.lam_max - 1e-6,
        DT_MIN=cfg.dt_min, DT_DEAD=2 * cfg.dt_min, RK4_DT=cfg.rk4_dt,
        SAFETY=cfg.safety, QMIN=cfg.qmin, QMAX=cfg.qmax,
        NEG_BETA1=-cfg.beta1, BETA2=cfg.beta2, QOLD_INIT=cfg.qold_init,
        STOP_RHO2=cfg.stop_rho ** 2,
        GATE=float(bool(cfg.event_gate) and not cfg.refine_minima),
        **{f"BMAX{j}": b for j, b in enumerate(BMAX_TSIT5)},
        **{f"HERM{j + 1}": c for j, c in enumerate(HERMITE_ENV)})
    return [slots[k] for k in CFG_SLOTS]


def _sample_slots(cfg: IntegratorConfig) -> list:
    """8 slots per detection sample: its dense-output weights, then
    theta."""
    blk = []
    npts = cfg.interp_points
    for i in range(1, npts + 1):
        th = i / npts
        if cfg.method == "tsit5":
            w = list(tsit5_bi(th))
        else:  # the Hermite sample's factors, as python evaluates them
            w = [1 - th, th * (th - 1), 1 - 2 * th, th - 1, 0.0, 0.0, 0.0]
        blk += w + [th]
    return blk


def _object_rows(scene: Scene, dtype: torch.dtype) -> torch.Tensor:
    """``[N, 8]`` on the scene's device: each object's ``OBJ_FIELDS``,
    rounded to ``dtype``."""
    return torch.stack([scene.pos[:, 1], scene.pos[:, 2], scene.pos[:, 3]]
                       + [getattr(scene, f) for f in OBJ_FIELDS[3:]],
                       dim=1).detach().to(dtype)


def kernel_params(metric: Metric, scene: Scene, cfg: IntegratorConfig,
                  dtype: torch.dtype):
    """The kernel's parameter block as python floats, computed in double
    and rounded to ``dtype`` by the caller's tensor, like JAX's python
    scalars: configuration, then 8 fields per object, then 8 slots per
    detection sample (its dense-output weights, then theta). Reads the
    scene's values (from the card where they lie there); ``pack_params``
    builds the same block without a read."""
    rows = _object_rows(scene, torch.float64).reshape(-1).tolist()
    return _config_slots(metric, cfg, dtype) + rows + _sample_slots(cfg)


# The host part of each parameter block built so far, on its device, by
# its values but for M and a (which every pass writes itself): built once
# and kept, so that a captured CUDA graph's copy from it stays valid. Its
# size is bounded by the configurations, scenes' kinds and devices in use,
# not by the values of M and a that pass through it.
_HOST_BLOCKS: dict = {}


def pack_params(metric: Metric, scene: Scene, cfg: IntegratorConfig,
                dtype: torch.dtype, device) -> torch.Tensor:
    """The bytes of csrc ``Params<T>`` on ``device`` (uint8,
    ``PARAMS_BYTES[dtype]``): the configuration, then the objects' rows
    from slot ``N_CFG``, the samples' from ``N_CFG + 8 * 16``, zeros
    between (the values of ``kernel_params``), then the 16 int32 object
    kinds, the trisection steps of ``refine_minima`` (0 without it) and a
    zero pad. Every launch copies it into the kernels' constant memory on its
    stream (csrc launch_with_params).

    Nothing is read back from the card, and after the first pass of a
    configuration nothing is copied from the host: the configuration,
    samples and kinds are host values, put on the device once per set of
    values and device (from pinned memory, without a host sync) and kept
    (``_HOST_BLOCKS``, keyed without M and a); each pass clones that block
    on the device and writes the object rows, and M and a, into it: the
    rows from the scene's tensors, M and a from the metric's tensors (the
    training path) or as floats (a fill, which a CUDA graph keeps as a
    constant), so that their current values reach the kernels, also when a
    graph replays the pass. Raises for what the kernels do not take
    (``check_kernel_config``), and where a new block would be copied from
    the host while the stream is being captured."""
    kinds = check_kernel_config(metric, scene, cfg)
    params = metric.params
    ma = (params.M, params.a)
    metric = metric._replace(params=params._replace(M=0.0, a=0.0))
    n_obj = len(kinds)
    vals = [0.0] * PARAM_VALUES
    vals[:N_CFG] = _config_slots(metric, cfg, dtype)
    smp = N_CFG + 8 * _MAX_OBJECTS
    samples = _sample_slots(cfg)
    vals[smp:smp + len(samples)] = samples
    refine = int(cfg.min_refine_iters) if cfg.refine_minima else 0
    ints = list(kinds) + [0] * (_MAX_OBJECTS - n_obj) + [refine, 0]
    device = torch.device(device)
    key = (tuple(vals), tuple(ints), dtype, device)
    base = _HOST_BLOCKS.get(key)
    if base is None:
        host = torch.cat([torch.tensor(vals, dtype=dtype).view(torch.uint8),
                          torch.tensor(ints, dtype=torch.int32)
                          .view(torch.uint8)])
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a new parameter block cannot be copied "
                                   "to the card during stream capture: run "
                                   "the pass once before capturing it")
            base = host.pin_memory().to(device, non_blocking=True)
        else:
            base = host.to(device)
        _HOST_BLOCKS[key] = base
    out = base.clone()
    out_vals = out[:PARAM_VALUES * dtype.itemsize].view(dtype)
    out_vals[N_CFG:N_CFG + 8 * n_obj] = _object_rows(scene, dtype).reshape(-1)
    for i, v in enumerate(ma):
        if isinstance(v, torch.Tensor):
            out_vals[i] = v.detach()
        else:  # a fill: a float set by index would be copied from the host
            out_vals[i].fill_(float(v))
    return out


def scene_code(kinds, npts: int, dtype: torch.dtype, kerr: bool,
               library: str, refine: bool = False) -> int:
    """The kernel of ``library`` (csrc/<library>.cu) that a launch takes, as
    a scene code: ``SC_REFINE`` with ``refine`` (``refine_minima``), else a
    fixed scene for an f32 Kerr-Schild launch whose object kinds and sample
    count are one of the library's ``FIXED_SCENES``, ``SC_ANY`` otherwise.
    The dispatch is exact: each code is its own kernel."""
    if refine:
        return SC_REFINE
    code = _SCENE_CODES.get((tuple(int(k) for k in kinds), int(npts)))
    if (code not in FIXED_SCENES[library] or dtype != torch.float32
            or not kerr):
        return SC_ANY
    return code


def launch_config(metric: Metric, scene: Scene, cfg: IntegratorConfig,
                  like: torch.Tensor, library: str):
    """What every launch of ``library``'s kernels over ``like``'s device and
    dtype shares: ``(prm, flags)``, the packed parameter block on the
    device and the int flags ``(kerr, tsit5, r_mode, scene, n_obj, npts)``.
    Reads nothing from the card (``pack_params``). Built once per trace or
    pass, or once for a fixed scene and configuration (``render_fn``)."""
    _check_options(cfg)
    kinds = check_kernel_config(metric, scene, cfg)
    kerr = metric.name == "kerr_schild"
    prm = pack_params(metric, scene, cfg, like.dtype, like.device)
    return prm, (int(kerr), int(cfg.method == "tsit5"),
                 kernel_r_mode(metric),
                 scene_code(kinds, cfg.interp_points, like.dtype, kerr,
                            library, cfg.refine_minima),
                 len(kinds), int(cfg.interp_points))


def kernel_r_mode(metric: Metric) -> int:
    """The kernels' radius mode (csrc R_*): as written, textbook, or
    textbook without the ring floor when ``rho_min`` is 0."""
    r_mode = _R_MODE[metric.r_formula]
    if r_mode == 1 and metric.rho_min <= 0.0:
        r_mode = 2
    return r_mode


def check_kernel_config(metric: Metric, scene: Scene,
                        cfg: IntegratorConfig) -> tuple:
    """Raise for what the kernels do not take; the object kinds (host
    ints: no read from the card)."""
    kinds = object_kinds(scene)
    if any(k not in _KERNEL_KINDS for k in kinds):
        raise NotImplementedError(f"object kinds {list(kinds)}: the kernels "
                                  f"know {_KERNEL_KINDS}")
    if not 0 < len(kinds) <= _MAX_OBJECTS:
        raise ValueError(f"the kernels take 1..{_MAX_OBJECTS} objects")
    if not 0 < cfg.interp_points <= _MAX_SAMPLES:
        raise ValueError(f"interp_points must be in 1..{_MAX_SAMPLES}")
    if metric.name not in ("minkowski", "kerr_schild"):
        raise ValueError(f"unknown metric: {metric.name!r}")
    return kinds


def _find_lib():
    from ..utils import cuda_build
    return cuda_build.load("geodesic")


def integrate_rays_cuda(metric: Metric, scene: Scene, y0: torch.Tensor,
                        dt0: torch.Tensor | None, cfg: IntegratorConfig,
                        launch=None) -> TraceResult:
    """Run K1 (csrc/geodesic.cu) over a ray batch on the card: the
    counterpart of the JAX ``integrate_rays_pallas``. ``y0 [B, 8]`` and
    ``dt0 [B]`` CUDA tensors of one float dtype; with ``dt0=None`` the
    kernel takes each ray's initial step in its prologue, equal bit for bit
    to ``render.initial_dt`` (Hairer's heuristic for Tsit5, ``rk4_dt`` for
    RK4). ``launch``: the ``(prm, flags)`` of ``launch_config(metric,
    scene, cfg, y0, "geodesic")``, built once by a caller that traces one
    scene and configuration many times (``render_fn``); built here if not
    given.

    With ``cfg.sort_rays`` a batch of more than ``SORT_MIN_RAYS`` rays is
    launched in ``impact_parameter_order``, so that a warp's rays need
    similar step counts, and the results are put back in the caller's
    order. Raises for CPU tensors, a failed build, and what the kernel
    does not take (object kinds it does not know). Reads nothing from the
    card. Adds one to
    ``integrate_rays_cuda.launches`` per launch, and its rays to
    ``integrate_rays_cuda.rays``."""
    if launch is None:
        _check_options(cfg)
        check_kernel_config(metric, scene, cfg)
    if y0.device.type != "cuda" or (dt0 is not None
                                    and dt0.device != y0.device):
        raise ValueError("integrate_rays_cuda needs CUDA tensors on one "
                         f"device, got {y0.device} and "
                         f"{None if dt0 is None else dt0.device}")
    if y0.dtype not in (torch.float32, torch.float64) or (
            dt0 is not None and dt0.dtype != y0.dtype):
        raise TypeError(f"unsupported dtypes {y0.dtype}, "
                        f"{None if dt0 is None else dt0.dtype}")
    if y0.dim() != 2 or y0.shape[1] != 8 or (
            dt0 is not None and dt0.shape != y0.shape[:1]):
        raise ValueError(f"bad shapes y0 {tuple(y0.shape)}, dt0 "
                         f"{None if dt0 is None else tuple(dt0.shape)}")
    if launch is None:
        launch = launch_config(metric, scene, cfg, y0, "geodesic")
    prm, (kerr, tsit5, r_mode, code, n_obj, npts) = launch
    if prm.device != y0.device or prm.numel() != PARAMS_BYTES[y0.dtype]:
        raise ValueError("the launch setup is for another device or dtype")

    lib = _find_lib()
    dev, dtype = y0.device, y0.dtype
    B = y0.shape[0]
    inv_order = None
    if cfg.sort_rays and B > SORT_MIN_RAYS:
        order, inv_order = impact_parameter_order(y0)
        y0 = y0[order]
        dt0 = None if dt0 is None else dt0[order]
    y_in = y0.t().contiguous()  # [8, B]: coalesced per-component loads
    dt_in = None if dt0 is None else dt0.contiguous()
    y_out = torch.empty_like(y_in)
    lam = torch.empty(B, dtype=dtype, device=dev)
    hit = torch.empty(B, dtype=torch.int32, device=dev)
    steps = torch.empty(B, dtype=torch.int32, device=dev)
    if B > 0:
        fn = lib.rtgr_k1_f32 if dtype == torch.float32 else lib.rtgr_k1_f64
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = lambda t: ctypes.c_void_p(  # noqa: E731
            None if t is None else t.data_ptr())
        with torch.cuda.device(dev):
            rc = fn(ptr(y_in), ptr(dt_in), ptr(y_out), ptr(lam), ptr(hit),
                    ptr(steps), ptr(prm), B, kerr, tsit5, r_mode, code,
                    int(cfg.max_steps), n_obj, npts, int(cfg.bisect_iters),
                    ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"K1 launch failed: CUDA error {rc}")
        integrate_rays_cuda.launches += 1
        integrate_rays_cuda.rays += B
    y_out, hit = y_out.t(), hit > 0
    if inv_order is not None:
        y_out, lam = y_out[inv_order], lam[inv_order]
        hit, steps = hit[inv_order], steps[inv_order]
    return TraceResult(y=y_out, lam=lam, hit=hit, steps=steps, n_iters=0)


integrate_rays_cuda.launches = 0
integrate_rays_cuda.rays = 0
