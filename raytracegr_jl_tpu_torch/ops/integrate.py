"""Integrator configuration, Tsit5 tableau, dense output and the initial step
(counterpart of raytracegr_jl_tpu/ops/integrate.py), and the row-major
integrator over an arbitrary right-hand side.

The component-major step loop of the closed-form metrics lives in
ops/geodesic_cm.py (plain version) and csrc/geodesic.cu (the kernel). The
row-major route here (``integrate_rays``, ``integrate_rays_scan``) steps
a ray batch ``[B, 8]`` through any ``rhs`` and ``event_fn`` written in
torch ops: the generic-metric route of render.py's ``"rowmajor"``
backend (the JAX package's ``"xla"``), plain torch on every device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

# Tsitouras 5(4) tableau (FSAL), the published coefficients.
TS_C = (0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
TS_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    # Row 7 == 5th-order solution weights b_i (FSAL)
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
# Error weights: err = dt * sum(btilde_i * k_i)  (5th minus embedded 4th)
TS_BTILDE = (
    -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
    -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
    0.015151515151515152,
)

# Large-but-finite stand-in for "infinite error": guarantees rejection
# while keeping every downstream power and sqrt finite in f32.
ERR_BIG = 1e30

RHS = Callable[[torch.Tensor], torch.Tensor]  # [B, 8] -> [B, 8]
# [..., 8] -> [...], pointwise over the leading axes (the detection
# sweep evaluates it on [interp_points, B, 8] at once).
EventFn = Callable[[torch.Tensor], torch.Tensor]


class IntegratorConfig(NamedTuple):
    """Solver settings; the same fields and defaults as the JAX package's
    ``IntegratorConfig`` (its docstrings give each field's rationale).

    The port's integrators run ``method``, the tolerances, the span and
    step bounds, the controller gains, ``interp_points``, ``bisect_iters``,
    ``stop_rho``, ``event_gate`` (the detection sweep skipped per ray
    where it provably sees no crossing; bitwise-neutral, off by default)
    and ``refine_minima`` (the trisection of the samples' argmin bracket,
    ``min_refine_iters`` steps, that rescues grazing hits; it turns the
    gate off). ``sort_rays`` orders the kernels' batch by impact parameter
    (the plain integrator ignores it). The gradient fields belong to the
    differentiable path (render.py, ops/adjoint.py)."""

    method: str = "tsit5"  # "tsit5" | "rk4"
    rtol: float = 1e-12
    atol: float = 1e-12
    lam_max: float = 100.0
    max_steps: int = 10_000
    rk4_dt: float = 0.05
    interp_points: int = 9
    bisect_iters: int = 40
    refine_minima: bool = False
    min_refine_iters: int = 16
    safety: float = 0.9
    qmin: float = 0.2
    qmax: float = 10.0
    beta1: float = 7.0 / 50.0
    beta2: float = 2.0 / 25.0
    qold_init: float = 1e-4
    dt_min: float = 1e-14
    stop_rho: float = 0.0
    sort_rays: bool = False
    grad_mode: str = "auto"
    grad_seg_len: int = 8
    grad_groups: int = 1
    event_gate: bool = False
    state_cap: float = 0.0


class TraceResult(NamedTuple):
    y: torch.Tensor  # [B, 8] final state (at the surface crossing for hits)
    lam: torch.Tensor  # [B] final affine parameter
    hit: torch.Tensor  # [B] bool, event fired
    steps: torch.Tensor  # [B] int32 accepted steps per ray
    n_iters: int  # loop iterations used (0 where the kernel does not count)


def hermite_interp(y0, y1, f0, f1, dt, th):
    """Cubic Hermite dense output on a step (any layout whose leading axes
    broadcast against ``dt`` and ``th``; ``th`` may be a python float)."""
    return ((1 - th) * y0 + th * y1
            + th * (th - 1) * ((1 - 2 * th) * (y1 - y0)
                               + (th - 1) * dt * f0 + th * dt * f1))


def hermite_dinterp(y0, y1, f0, f1, dt, th):
    """d/dtheta of ``hermite_interp``, by the product rule."""
    g = ((1 - 2 * th) * (y1 - y0) + (th - 1) * dt * f0 + th * dt * f1)
    dg = -2 * (y1 - y0) + dt * f0 + dt * f1
    return (y1 - y0) + (2 * th - 1) * g + th * (th - 1) * dg


def tsit5_bi(th):
    """Tsit5's 4th-order dense-output weights ``b_i(theta)`` (python floats
    or tensors; same expression and operation order as the JAX package)."""
    th2 = th * th
    b1 = (-1.0530884977290216 * th * (th - 1.3299890189751412)
          * (th2 - 1.4364028541716351 * th + 0.7139816917074209))
    b2 = 0.1017 * th2 * (th2 - 2.1966568338249754 * th + 1.2949852507374631)
    b3 = (2.490627285651252793 * th2
          * (th2 - 2.38535645472061657 * th + 1.57803468208092486))
    b4 = (-16.54810288924490272 * (th - 1.21712927295533244)
          * (th - 0.61620406037800089) * th2)
    b5 = (47.37952196281928122 * (th - 1.203071208372362603)
          * (th - 0.658047292653547382) * th2)
    b6 = (-34.87065786149660974 * (th - 1.2)
          * (th - 0.666666666666666667) * th2)
    b7 = 2.5 * (th - 1.0) * (th - 0.6) * th2
    return b1, b2, b3, b4, b5, b6, b7


def tsit5_dbi(th):
    """d/dtheta of ``tsit5_bi``, by the product rule on the same factors
    (the Newton polish of event localization uses it; the CUDA kernel
    evaluates the same expressions)."""
    th2 = th * th
    dth2 = 2 * th
    u1 = -1.0530884977290216 * th
    v1 = th - 1.3299890189751412
    w1 = th2 - 1.4364028541716351 * th + 0.7139816917074209
    db1 = ((-1.0530884977290216 * v1 + u1) * w1
           + u1 * v1 * (dth2 - 1.4364028541716351))
    w2 = th2 - 2.1966568338249754 * th + 1.2949852507374631
    db2 = 0.1017 * (dth2 * w2 + th2 * (dth2 - 2.1966568338249754))
    w3 = th2 - 2.38535645472061657 * th + 1.57803468208092486
    db3 = 2.490627285651252793 * (dth2 * w3
                                  + th2 * (dth2 - 2.38535645472061657))

    def cubic(c, r1, r2):
        # d/dth [c (th - r1)(th - r2) th^2]
        p, q = th - r1, th - r2
        return c * ((q + p) * th2 + p * q * dth2)

    db4 = cubic(-16.54810288924490272, 1.21712927295533244,
                0.61620406037800089)
    db5 = cubic(47.37952196281928122, 1.203071208372362603,
                0.658047292653547382)
    db6 = cubic(-34.87065786149660974, 1.2, 0.666666666666666667)
    db7 = cubic(2.5, 1.0, 0.6)
    return db1, db2, db3, db4, db5, db6, db7


def dense_output_envelopes():
    """Static sup-norm envelopes of the dense-output basis over theta in
    [0, 1], with a 1% + 1e-6 margin (the JAX package's
    ``_dense_output_envelopes``; the detection gate needs an
    over-approximation): ``(BMAX_TSIT5 [7], (C1, C2, C3))`` with
    ``|H(theta) - y0| <= dt * sum_j BMAX_j |k_j|`` (Tsit5) and
    ``|H(theta) - y0| <= C1 |y1 - y0| + dt (C2 |f0| + C3 |f1|)`` (Hermite)."""
    th = np.linspace(0.0, 1.0, 65537)
    bmax = tuple(float(np.abs(np.asarray(b)).max() * 1.01 + 1e-6)
                 for b in tsit5_bi(th))
    a1 = th + th * (th - 1) * (1 - 2 * th)
    a2 = th * (th - 1) ** 2
    a3 = th * th * (th - 1)
    herm = tuple(float(np.abs(a).max() * 1.01 + 1e-6) for a in (a1, a2, a3))
    return bmax, herm


def mean8(q: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of 8: summed left to right, then divided by
    8. The order is fixed on every device, and K1 repeats it;
    ``torch.mean`` on the card adds in an order that depends on the
    operand's layout."""
    s = q[..., 0]
    for c in range(1, 8):
        s = s + q[..., c]
    return s / 8


def hairer_init_dt(f: RHS, y0: torch.Tensor, rtol, atol, order: int = 5,
                   lam_span: float = 100.0) -> torch.Tensor:
    """Per-ray automatic initial step size (Hairer, Norsett & Wanner II.4).
    ``y0`` is ``[B, 8]``; ``f`` maps ``[B, 8] -> [B, 8]``. K1 computes the
    same in its prologue (csrc geodesic_common.cuh ``hairer_init_dt``),
    operation by operation: the norms' sums left to right (``mean8``),
    ``0.01 / dmax`` as a reciprocal times 0.01 (as PyTorch evaluates a
    scalar over a tensor)."""
    f0 = f(y0)
    sc = atol + torch.abs(y0) * rtol
    d0 = torch.sqrt(mean8((y0 / sc) ** 2))
    d1 = torch.sqrt(mean8((f0 / sc) ** 2))
    small = (d0 < 1e-5) | (d1 < 1e-5)
    dt0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    y1 = y0 + dt0[..., None] * f0
    f1 = f(y1)
    d2 = torch.sqrt(mean8(((f1 - f0) / sc) ** 2)) / dt0
    dmax = torch.maximum(d1, d2)
    dt1 = torch.where(dmax <= 1e-15, torch.clamp_min(dt0 * 1e-3, 1e-6),
                      (torch.reciprocal(dmax) * 0.01) ** (1.0 / (order + 1)))
    return torch.minimum(100.0 * dt0, torch.clamp_max(dt1, lam_span))


BMAX_TSIT5, HERMITE_ENV = dense_output_envelopes()


# ---------------------------------------------------------------------------
# The row-major route: steppers, event localization and the two drivers,
# as the JAX package's (same names, same operation order).
# ---------------------------------------------------------------------------

def tsit5_step(f: RHS, y: torch.Tensor, dt: torch.Tensor, k1: torch.Tensor):
    """One Tsit5 stage sweep over ``y [B, 8]`` with per-ray ``dt [B]`` and
    ``k1 = f(y)`` (FSAL): ``(y5, err, k7, (k1..k7))``."""
    d = dt[..., None]
    A = TS_A
    k2 = f(y + d * (A[0][0] * k1))
    k3 = f(y + d * (A[1][0] * k1 + A[1][1] * k2))
    k4 = f(y + d * (A[2][0] * k1 + A[2][1] * k2 + A[2][2] * k3))
    k5 = f(y + d * (A[3][0] * k1 + A[3][1] * k2 + A[3][2] * k3
                    + A[3][3] * k4))
    k6 = f(y + d * (A[4][0] * k1 + A[4][1] * k2 + A[4][2] * k3
                    + A[4][3] * k4 + A[4][4] * k5))
    y5 = y + d * (A[5][0] * k1 + A[5][1] * k2 + A[5][2] * k3
                  + A[5][3] * k4 + A[5][4] * k5 + A[5][5] * k6)
    k7 = f(y5)
    Bt = TS_BTILDE
    err = d * (Bt[0] * k1 + Bt[1] * k2 + Bt[2] * k3 + Bt[3] * k4
               + Bt[4] * k5 + Bt[5] * k6 + Bt[6] * k7)
    return y5, err, k7, (k1, k2, k3, k4, k5, k6, k7)


def rk4_step(f: RHS, y: torch.Tensor, dt: torch.Tensor, k1: torch.Tensor):
    """Classic RK4: ``(y1, zero error, f(y1), None)`` (the event sweep uses
    cubic Hermite dense output)."""
    d = dt[..., None]
    k2 = f(y + 0.5 * d * k1)
    k3 = f(y + 0.5 * d * k2)
    k4 = f(y + d * k3)
    y1 = y + (d / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return y1, torch.zeros_like(y1), f(y1), None


def error_norm(err, y0, y1, rtol, atol):
    """Hairer's scaled RMS error norm over the 8 components, per ray; the
    ratio clamped before squaring and the mean floored inside the sqrt
    (both keep f32 and the sqrt's derivative finite; see the JAX
    package)."""
    sc = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    ratio = torch.clamp(err / sc, -1e15, 1e15)
    return torch.sqrt(torch.clamp_min(torch.mean(ratio ** 2, dim=-1), 1e-30))


def tsit5_interp(y0, ks, dt, theta):
    """Tsit5's 4th-order dense output, row-major: ``y0``, ``ks`` ``[B, 8]``,
    ``dt [B]``, ``theta`` broadcastable against ``[B]``."""
    bs = tsit5_bi(theta[..., None])
    acc = bs[0] * ks[0]
    for b, k in zip(bs[1:], ks[1:]):
        acc = acc + b * k
    return y0 + dt[..., None] * acc


def _locate_event(event_fn: EventFn, y0, y1, f0, f1, dt,
                  cfg: IntegratorConfig, ks=None):
    """The first zero crossing of the event function within a step:
    ``(crossed [B], theta* [B], y* [B, 8])``. The sweep samples the dense
    output (Tsit5's with ``ks``, cubic Hermite without) at
    ``interp_points`` interior thetas on detached copies; with
    ``refine_minima`` it trisects the samples' argmin bracket; bisection
    runs only where some ray crossed (a host read: JAX's ``lax.cond``);
    one Newton step through the event function from the detached root
    carries the root's gradient."""
    B = y0.shape[0]
    npts = cfg.interp_points
    dtype, dev = y0.dtype, y0.device
    thetas = torch.arange(1, npts + 1, dtype=dtype, device=dev) / npts
    y0s, y1s, f0s, f1s, dts = (t.detach() for t in (y0, y1, f0, f1, dt))
    if ks is not None:
        kss = tuple(k.detach() for k in ks)

        def interp_s(th):
            return tsit5_interp(y0s, kss, dts, th)

        def interp_g(th):
            return tsit5_interp(y0, ks, dt, th)
    else:
        def interp_s(th):
            return hermite_interp(y0s, y1s, f0s, f1s, dts[..., None],
                                  th[..., None])

        def interp_g(th):
            return hermite_interp(y0, y1, f0, f1, dt[..., None],
                                  th[..., None])
    d_prev = event_fn(y0s)

    def sample(theta):
        return event_fn(interp_s(theta))

    d_samples = sample(thetas[:, None].expand(npts, B))  # [npts, B]
    neg = d_samples <= 0.0
    any_neg = neg.any(dim=0)
    first = torch.argmax(neg.to(torch.uint8), dim=0)
    th_hi = thetas[first]
    th_lo = torch.where(first == 0, torch.zeros_like(th_hi),
                        thetas[first - 1])

    if cfg.refine_minima:
        th_all = torch.cat([torch.zeros((1,), dtype=dtype, device=dev),
                            thetas])
        d_all = torch.cat([d_prev[None], d_samples], dim=0)
        mi = torch.argmin(d_all, dim=0)
        lo_i = torch.clamp_min(mi - 1, 0)
        a, b = th_all[lo_i], th_all[torch.clamp_max(mi + 1, npts)]
        for _ in range(cfg.min_refine_iters):
            m1 = a + (b - a) / 3.0
            m2 = b - (b - a) / 3.0
            take = sample(m1) < sample(m2)
            a, b = torch.where(take, a, m1), torch.where(take, m2, b)
        th_min = 0.5 * (a + b)
        min_neg = sample(th_min) <= 0.0
        use_min = min_neg & (~any_neg | (th_all[lo_i] < th_lo))
        th_lo = torch.where(use_min, th_all[lo_i], th_lo)
        th_hi = torch.where(use_min, th_min, th_hi)
        any_neg = any_neg | min_neg

    crossed = any_neg & (d_prev > 0.0)
    lo, hi = th_lo, th_hi
    _locate_event.host_reads += 1
    if bool(crossed.any()):
        for _ in range(cfg.bisect_iters):
            mid = 0.5 * (lo + hi)
            above = sample(mid) > 0.0
            lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    # The residual's theta-derivative as a vjp with ones: each ray's
    # residual depends on its own theta alone (torch.func.jvp gives the
    # same numbers, slower; see geometry.dmetric).
    th0 = hi.detach()
    val, pull = torch.func.vjp(lambda th: event_fn(interp_g(th)), th0)
    (dval,) = pull(torch.ones_like(val))
    # A relative slope threshold keeps val/dval and its derivatives bounded
    # for garbage rays; near-tangential hits keep the bisection's root.
    ok = torch.abs(dval) > 1e-3 * (1.0 + torch.abs(val))
    delta = (torch.where(ok, val, torch.zeros_like(val))
             / torch.where(ok, dval, torch.ones_like(dval)))
    th_star = torch.clamp(th0 - torch.clamp(delta, -1.0, 1.0), 0.0, 1.0)
    return crossed, th_star, interp_g(th_star)


_locate_event.host_reads = 0


class _LoopState(NamedTuple):
    y: torch.Tensor
    lam: torch.Tensor
    dt: torch.Tensor
    k1: torch.Tensor
    active: torch.Tensor
    hit: torch.Tensor
    steps: torch.Tensor
    err_old: torch.Tensor
    it: int


def _make_step_body(rhs: RHS, event_fn: EventFn, cfg: IntegratorConfig):
    """The step body shared by ``integrate_rays`` and
    ``integrate_rays_scan``: one masked step of every ray."""
    if cfg.state_cap > 0.0:
        raw_rhs = rhs

        def rhs(y, _cap=cfg.state_cap):  # noqa: F811 (the capped rhs)
            return raw_rhs(torch.clamp(y, -_cap, _cap))

    stepper = tsit5_step if cfg.method == "tsit5" else rk4_step
    adaptive = cfg.method == "tsit5"

    def body(st: _LoopState) -> _LoopState:
        lam_left = cfg.lam_max - st.lam
        dt_try = torch.clamp_min(torch.minimum(st.dt, lam_left), cfg.dt_min)
        dt_try = torch.where(torch.isfinite(dt_try), dt_try,
                             torch.full_like(dt_try, cfg.dt_min))
        # Step sizes are solver state, not physics: no gradient through
        # them (physical gradients flow via the stages and the event).
        dt_try = dt_try.detach()

        y_new, err, k_last, ks = stepper(rhs, st.y, dt_try, st.k1)
        fin = torch.isfinite(y_new).all(dim=-1)

        if adaptive:
            en = error_norm(err, st.y, y_new, cfg.rtol, cfg.atol)
            bad = ~torch.isfinite(en) | ~fin
            en = torch.where(bad, torch.full_like(en, ERR_BIG), en)
            accept = en <= 1.0
            en_c = torch.clamp_min(en, 1e-10)
            q_pi = (cfg.safety * en_c ** (-cfg.beta1)
                    * torch.clamp_min(st.err_old, cfg.qold_init)
                    ** cfg.beta2)
            q_rej = cfg.safety * en_c ** (-0.2)
            q = torch.where(accept, q_pi, torch.clamp_max(q_rej, 1.0))
            q = torch.clamp(q, cfg.qmin, cfg.qmax)
            dt_next = torch.clamp(dt_try * q, cfg.dt_min, cfg.lam_max)
            dead = (bad | ~accept) & (dt_try <= 2 * cfg.dt_min)
        else:
            en = torch.ones_like(st.lam)
            bad = ~fin
            accept = ~bad
            dt_next = torch.full_like(st.dt, cfg.rk4_dt)
            dead = bad

        if cfg.stop_rho > 0.0:
            rho2 = torch.sum(y_new[..., 1:4] ** 2, dim=-1)
            dead = dead | (rho2 < cfg.stop_rho ** 2)

        do = st.active & accept
        # Localization never sees a non-finite trial state (NaN primals
        # poison reverse-mode cotangents of the whole batch).
        fin_c = fin[..., None]
        y_evt = torch.where(fin_c, y_new, st.y)
        k_evt = torch.where(fin_c, k_last, st.k1)
        ks_evt = (None if ks is None else
                  tuple(torch.where(fin_c, k, torch.zeros_like(k))
                        for k in ks))
        crossed, th_star, y_star = _locate_event(
            event_fn, st.y, y_evt, st.k1, k_evt, dt_try, cfg, ks=ks_evt)
        hit_now = do & crossed

        y_acc = torch.where(hit_now[..., None], y_star, y_new)
        lam_acc = st.lam + torch.where(hit_now, th_star * dt_try, dt_try)
        done_span = lam_acc >= cfg.lam_max - 1e-12

        return _LoopState(
            y=torch.where(do[..., None], y_acc, st.y),
            lam=torch.where(do, lam_acc, st.lam),
            dt=torch.where(st.active, dt_next, st.dt),
            k1=torch.where(do[..., None], k_last, st.k1),
            active=st.active & ~hit_now & ~(do & done_span) & ~dead,
            hit=st.hit | hit_now,
            steps=st.steps + do.to(st.steps.dtype),
            err_old=torch.where(do, torch.clamp_min(en, cfg.qold_init),
                                st.err_old),
            it=st.it + 1)

    return body


def _init_state(rhs: RHS, y0: torch.Tensor,
                cfg: IntegratorConfig) -> _LoopState:
    B, dtype, dev = y0.shape[0], y0.dtype, y0.device
    if cfg.method == "tsit5":
        dt0 = hairer_init_dt(rhs, y0, cfg.rtol, cfg.atol, 5, cfg.lam_max)
    else:
        dt0 = torch.full((B,), cfg.rk4_dt, dtype=dtype, device=dev)
    return _LoopState(
        y=y0, lam=torch.zeros((B,), dtype=dtype, device=dev), dt=dt0,
        k1=rhs(y0), active=torch.ones((B,), dtype=torch.bool, device=dev),
        hit=torch.zeros((B,), dtype=torch.bool, device=dev),
        steps=torch.zeros((B,), dtype=torch.int32, device=dev),
        err_old=torch.full((B,), cfg.qold_init, dtype=dtype, device=dev),
        it=0)


def _result(st: _LoopState) -> TraceResult:
    return TraceResult(y=st.y, lam=st.lam, hit=st.hit, steps=st.steps,
                       n_iters=st.it)


def integrate_rays(rhs: RHS, event_fn: EventFn, y0: torch.Tensor,
                   cfg: IntegratorConfig) -> TraceResult:
    """The forward route: masked batched steps of ``y0 [B, 8]`` until every
    ray has hit a surface, spent the span or died, or ``max_steps``
    iterations have run (JAX's ``lax.while_loop``), without gradients.
    Each iteration reads ``active.any()`` on the host, and the event
    sweep reads whether any ray crossed (``integrate_rays.host_reads`` and
    ``_locate_event.host_reads`` count them)."""
    with torch.no_grad():
        body = _make_step_body(rhs, event_fn, cfg)
        st = _init_state(rhs, y0, cfg)
        while st.it < cfg.max_steps:
            integrate_rays.host_reads += 1
            if not bool(st.active.any()):
                break
            st = body(st)
    return _result(st)


integrate_rays.host_reads = 0


def integrate_rays_scan(rhs: RHS, event_fn: EventFn, y0: torch.Tensor,
                        cfg: IntegratorConfig,
                        remat: bool = True) -> TraceResult:
    """The differentiable route: the same body for exactly ``max_steps``
    iterations (JAX's bounded ``lax.scan``), taped by autograd. With
    ``remat`` each step is checkpointed: the backward pass recomputes a
    step's stages from its input state, so the tape holds one state per
    step. The checkpoint is torch's reentrant one (``use_reentrant=True``;
    the non-reentrant one's saved-tensor hooks exclude the ``torch.func``
    derivatives of ops/geometry.py), whose backward accumulates into the
    leaves that ``rhs`` and ``event_fn`` close over: differentiate the
    result with ``.backward()``, not ``torch.autograd.grad``."""
    body = _make_step_body(rhs, event_fn, cfg)
    st = _init_state(rhs, y0, cfg)
    if not remat:
        for _ in range(cfg.max_steps):
            st = body(st)
        return _result(st)
    # The reentrant checkpoint tracks tensors passed directly, and its
    # outputs require grad only where an input does: a leaf that requires
    # grad stands in for the parameters the closures hold.
    anchor = torch.empty(0, dtype=y0.dtype, device=y0.device,
                         requires_grad=True)

    def flat_body(it, _anchor, *tensors):
        return tuple(body(_LoopState(*tensors, it=it))[:-1])

    for _ in range(cfg.max_steps):
        st = _LoopState(*checkpoint(flat_body, st.it, anchor, *st[:-1],
                                    use_reentrant=True), it=st.it + 1)
    return _result(st)
