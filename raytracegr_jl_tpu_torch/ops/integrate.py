"""Integrator configuration, Tsit5 tableau, dense output and the initial step
(counterpart of raytracegr_jl_tpu/ops/integrate.py).

The batched step loop itself lives in ops/geodesic_cm.py (plain version)
and csrc/geodesic.cu (the kernel); this module holds what both share.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

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

RHS = Callable[[torch.Tensor], torch.Tensor]


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
