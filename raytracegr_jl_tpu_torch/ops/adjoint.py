"""The checkpointed adjoint of the geodesic integration: the differentiable
path of the port, with K3 (forward segment) and K4 (fused backward replay)
as CUDA kernels (csrc/adjoint.cu), and K6 (localization) and K7 (its VJP)
(csrc/localize.cu), beside their plain PyTorch versions.

Counterpart of raytracegr_jl_tpu/ops/adjoint.py (``integrate_rays_cm_ckpt``)
and raytracegr_jl_tpu/ops/pallas_adjoint.py (``flatten_params``,
``integrate_rays_cm_ckpt_pallas``):

* forward: each ray's initial state from its launch state ``y0`` (the
  ``make_step_cm`` init: k1 = rhs(y0), the event record at y0, and its
  initial step; K3's prologue), then the body in segments of ``seg_len``
  steps, one checkpoint of the 13-field state per segment; each ray's end
  segment is the first at whose start it is inactive, and every ray's
  final state lies in the fixed slot ``ck[n_seg]`` (on the card one K3
  launch runs every ray through its segments; the plain version stops the
  batch early once no ray is active);
* backward: each ray's segments in reverse from its end segment, each
  replayed from its checkpoint, and the cotangents pushed back through each
  step by a hand-written adjoint (``step_vjp``, ``rhs_vjp``), the same in
  PyTorch and in K4, and at last through the initial state back to y0, M
  and a (``init_vjp``; K10, right after K4);
* after the loop, the epilogue as one function (``_Localized``): each hit
  ray localized from its event record (``localize_events_cm``), every other
  ray's state as it stands (K6); on backward its hand-written VJP (K7,
  ``localize_vjp``), with the dead-ray cutoff, which carries the event's
  and the objects' gradients and hands the ``y`` and ``ev_y0`` planes'
  cotangents to K4. The JAX package leaves this epilogue to XLA's fusion
  of plain AD inside its jitted step.

On the card nothing here reads a value back to the host and every shape is
static (the segment counts stay on the card), so a CUDA graph can hold a
whole training step (step_graph.py), as ``jax.jit`` holds the JAX
package's.

Which state carries a cotangent follows from the body. ``y``, ``k1`` and
``ev_y0`` do. ``dt_try`` is detached, so ``dt``, ``err_old`` and the
controller carry none; ``lam``, ``ev_lam`` and ``ev_dt`` are sums of
detached steps; the masks (``do``, ``fin``, ``hit_now``) route cotangents
and take none; detection only decides masks, so the object fields get no
cotangent inside the loop. The loop's parameter cotangents are therefore
those of M and a alone, summed per ray (``[B, 2]``) and then over rays with
one ``torch.sum``, so that the kernel and the plain version can be compared
bitwise and the sum is deterministic. The epilogue's cotangents reach every
entry of ``flatten_params``, per ray (``ray_params``, ``[2 + 8 N, B]``),
and autograd sums them into the caller's tensors with the shading's.

A grouped route runs several parameter sets in one batch (the starts of a
vectorized multistart fit): G groups of ``B / G`` consecutive rays, each
with its own M, a and object rows, one row per group of the table that
``flatten_params`` builds (``[G, P]``). K3 and K4 read each ray's row from
the table in one launch; the plain versions expand it per ray; the (M, a)
cotangents stay per ray and are summed per group.

A batch may also run as sorted parts (``SortedParts``: the render's
``sort_rays`` on the kernel route, ``grad_groups`` on the plain route):
the rays in impact-parameter order, cut into parts that each take their
own forward and backward pass, with the per-ray (M, a) cotangents summed
in the caller's order, so that values and gradients are bitwise those of
one pass. ``integrate_rays_autograd`` tapes every step instead (the
render's ``grad_mode="scan"``, optionally rematerialized).

The state is packed into ``[34, B]`` planes of the working type (layout
below); the checkpoint buffer is ``[n_seg + 1, 34, B]``: the state at the
start of each segment a ray runs, then every ray's final state in
``ck[n_seg]``. A forward pass also returns ``used [1 + B]`` (int32, on the
state's device): ``used[0]`` the count of segments the per-segment chain
runs (``n_used``, the largest end segment), ``used[1:]`` the rays' end
segments.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.objects import (FIELD_DIMS, KIND_DISTANCE_JVP, KIND_PLANE,
                              KIND_SPHERE, Scene, object_kinds)
from .geodesic_cm import (OBJ_FIELDS, SC_ANY, SC_REFINE, StepState,
                          _check_options, _interpolants, _object_get,
                          _tsit5_dinterp_cm, check_kernel_config, geodesic_cm,
                          impact_parameter_order, initial_dt, kernel_r_mode,
                          launch_config, localize_events_cm, make_step_cm,
                          scene_event_cm)
from .geometry import det_min, sanitize_bounds
from .integrate import (TS_A, IntegratorConfig, TraceResult, hermite_dinterp,
                        tsit5_bi, tsit5_dbi)
from .metrics import KerrSchildParams, Metric

# Plane layout of the packed state (csrc/adjoint.cu, enum Plane).
P_Y, P_LAM, P_DT, P_K1, P_ACTIVE, P_HIT, P_STEPS, P_ERR_OLD = (0, 8, 9, 10,
                                                               18, 19, 20, 21)
P_EV_Y0, P_EV_DT, P_EV_LAM, P_EV_LO, P_EV_HI = 22, 30, 31, 32, 33
N_PLANES = 34
# Longest segment K4 replays: it keeps a record of each step of a segment
# and their hit flags as the bits of one 32-bit word (csrc/adjoint.cu
# MAX_SEG).
MAX_SEG = 32


def pack_state(st: StepState) -> torch.Tensor:
    """``StepState -> [34, B]`` in the working type (masks as 0/1)."""
    dt = st.dt
    row = lambda v: v.to(dt.dtype)[None]  # noqa: E731
    return torch.cat([st.y, row(st.lam), row(dt), st.k1, row(st.active),
                      row(st.hit), row(st.steps), row(st.err_old), st.ev_y0,
                      row(st.ev_dt), row(st.ev_lam), row(st.ev_lo),
                      row(st.ev_hi)])


def unpack_state(P: torch.Tensor) -> StepState:
    """``[34, B] -> StepState`` (``steps`` stays in the working type)."""
    return StepState(
        y=P[P_Y:P_Y + 8], lam=P[P_LAM], dt=P[P_DT], k1=P[P_K1:P_K1 + 8],
        active=P[P_ACTIVE] > 0, hit=P[P_HIT] > 0, steps=P[P_STEPS],
        err_old=P[P_ERR_OLD], ev_y0=P[P_EV_Y0:P_EV_Y0 + 8], ev_dt=P[P_EV_DT],
        ev_lam=P[P_EV_LAM], ev_lo=P[P_EV_LO], ev_hi=P[P_EV_HI])


def flatten_params(metric: Metric, scene: Scene,
                   groups: int | None = None) -> torch.Tensor:
    """``pvec [P]``: M, a, then 8 fields per object in ``OBJ_FIELDS``
    order, stacked so that gradients flow back to each. With ``groups`` G
    the batch is grouped (M, a and the scene's fields per ray, ``[R]`` and
    ``pos [R, N, 4]``, or shared): ``[G, P]``, each group's row from its
    first ray, the table that K3 and K4 read (``Route.groups``)."""
    like = scene.pos
    as_t = lambda v: torch.as_tensor(v, dtype=like.dtype,  # noqa: E731
                                     device=like.device)
    if groups is None:
        parts = [as_t(metric.params.M), as_t(metric.params.a)]
        for i in range(scene.n_objects):
            parts += [scene.pos[i, 1], scene.pos[i, 2], scene.pos[i, 3]]
            parts += [getattr(scene, f)[i] for f in OBJ_FIELDS[3:]]
        return torch.stack(parts)

    def per_group(v):
        t = as_t(v)
        return t.expand(groups) if t.dim() == 0 else \
            t[::t.shape[0] // groups]

    cols = [per_group(metric.params.M), per_group(metric.params.a)]
    for i in range(scene.n_objects):
        cols += [per_group(scene.pos[..., i, c]) for c in (1, 2, 3)]
        cols += [per_group(getattr(scene, f)[..., i]) for f in OBJ_FIELDS[3:]]
    return torch.stack(cols, dim=1)


def group_sums(g: torch.Tensor, groups: int) -> torch.Tensor:
    """``g [G * rays, ...]``'s sum over each group of ``rays`` consecutive
    rows, in float64, rounded once to ``g``'s dtype: ``[G, ...]``."""
    rows = g.reshape(groups, -1, *g.shape[1:])
    return rows.sum(dim=1, dtype=torch.float64).to(g.dtype)


class _PerRay(torch.autograd.Function):
    """``per_ray``: ``repeat_interleave`` along the first axis, its
    backward each group's sum in float64 (``group_sums``)."""

    @staticmethod
    def forward(ctx, v, rays):
        ctx.groups = v.shape[0]
        return v.repeat_interleave(rays, dim=0)

    @staticmethod
    def backward(ctx, g):
        return group_sums(g, ctx.groups), None


def per_ray(v: torch.Tensor, rays: int) -> torch.Tensor:
    """A parameter per ray: ``v [G, ...]`` (one row per group of ``rays``
    consecutive rays) repeated to ``[G * rays, ...]``. On backward each
    group's per-ray cotangents are summed in float64 and rounded once, so
    that a parameter's gradient does not depend on how its rays are
    batched: a start of a vectorized multistart gets the gradient of its
    own serial fit (but in the last bit, rarely). That matters where the
    gradient is rounding alone, as at a start that a symmetry of the scene
    leaves with none: Adam divides it by its eps (1e-8), and a difference
    in the order of an f32 sum of ~1e-10 moves the fit."""
    return _PerRay.apply(v, rays)


def ray_params(metric: Metric, scene: Scene, B: int) -> torch.Tensor:
    """``flatten_params``' entries per ray, ``[2 + 8 N, B]``, as the
    caller's tensors hold them: a grouped batch's per-ray value as it is, a
    shared value through ``per_ray``, so that the gradients reach those
    tensors ray by ray, summed as ``per_ray`` sums."""
    like = scene.pos
    as_t = lambda v: torch.as_tensor(v, dtype=like.dtype,  # noqa: E731
                                     device=like.device)
    parts = [as_t(metric.params.M), as_t(metric.params.a)]
    for i in range(scene.n_objects):
        parts += [scene.pos[..., i, c] for c in (1, 2, 3)]
        parts += [getattr(scene, f)[..., i] for f in OBJ_FIELDS[3:]]
    shared = [i for i, v in enumerate(parts) if v.dim() == 0]
    if shared:
        vals = per_ray(torch.stack([parts[i] for i in shared])[None], B).t()
        if len(shared) == len(parts):
            return vals
        for k, i in enumerate(shared):
            parts[i] = vals[k]
    return torch.stack(parts)


def segment_length(cfg: IntegratorConfig, seg_len: int | None) -> int:
    """The JAX rule: at most ``max_steps``, shrunk until it divides
    ``max_steps`` (so the segments run exactly ``max_steps`` steps)."""
    seg_len = max(1, min(8 if seg_len is None else seg_len, cfg.max_steps))
    while cfg.max_steps % seg_len:
        seg_len -= 1
    return seg_len


# ---------------------------------------------------------------------------
# The hand-written adjoint of one step (plain version of K4's arithmetic)
#
# Ties follow JAX's rule: the derivative of max(x, b) or min(x, b) is split
# half and half where x == b, so a clip at exactly its bound passes half the
# cotangent. (torch.clamp would pass all of it.) Every expression below is
# written out as csrc/adjoint.cu writes it, in the same order.
# ---------------------------------------------------------------------------

class AdjParams(NamedTuple):
    """What the adjoint reads: the metric (whose RHS the stages use), M and
    a as 0-d tensors of the working type, the radius formula's mode (csrc
    R_*), the metric's kind and the bounds."""

    metric: Metric
    M: torch.Tensor
    a: torch.Tensor
    eps2: float
    eps2_half: float
    state_clamp: float
    rhs_clamp: float
    det_min: float
    r_mode: int
    kerr: bool


def adj_params(metric: Metric, dtype, device) -> AdjParams:
    sc, rc = sanitize_bounds(dtype)
    eps2 = metric.rho_min * metric.rho_min
    as_t = lambda v: torch.as_tensor(v, dtype=dtype,  # noqa: E731
                                     device=device).detach()
    return AdjParams(metric=metric, M=as_t(metric.params.M),
                     a=as_t(metric.params.a), eps2=eps2, eps2_half=eps2 / 2,
                     state_clamp=sc, rhs_clamp=rc, det_min=det_min(dtype),
                     r_mode=kernel_r_mode(metric),
                     kerr=metric.name == "kerr_schild")


def _w_clip(x, lo, hi):
    """d clip(x, lo, hi)/dx: 1 inside, 1/2 on a bound, 0 outside or NaN."""
    one = torch.ones_like(x)
    return torch.where((x > lo) & (x < hi), one,
                       torch.where((x == lo) | (x == hi), 0.5 * one,
                                   torch.zeros_like(x)))


def _w_max(x, b):
    """d max(x, b)/dx: 1 above, 1/2 on a tie, 0 below or NaN."""
    one = torch.ones_like(x)
    return torch.where(x > b, one, torch.where(x == b, 0.5 * one,
                                               torch.zeros_like(x)))


def rhs_vjp(p: AdjParams, yin: torch.Tensor, ct: torch.Tensor):
    """Reverse mode of ``geodesic_cm``: ``(yin [8, B], ct [8, B]) ->
    (ct_yin [8, B], ct_M [B], ct_a [B])``. Recomputes the forward
    intermediates, then runs their adjoint in reverse order through the
    output clip, the contraction, ``coef``'s det clamp, ``ks_parts`` and the
    radius formula, the rho2 clamp and the input clip."""
    sc, rc = p.state_clamp, p.rhs_clamp
    w_in = _w_clip(yin, -sc, sc)
    y = torch.clamp(yin, -sc, sc)
    zero = torch.zeros_like(y[0])
    if not p.kerr:
        g = ct[:4] * _w_clip(y[4:], -rc, rc)
        return (torch.cat([torch.zeros_like(g), g]) * w_in, zero, zero)

    # -- forward (csrc rhs) --
    M, a = p.M, p.a
    xs, ys, zs = y[1], y[2], y[3]
    u0, u1, u2, u3 = y[4], y[5], y[6], y[7]
    uu = (u1, u2, u3)
    xyz = (xs, ys, zs)
    aa = a * a
    rho2_raw = xs * xs + ys * ys + zs * zs
    bound = aa + p.eps2 if p.r_mode == 0 else torch.full_like(xs, p.eps2)
    rho2 = torch.maximum(rho2_raw, bound)
    w_rho = _w_max(rho2_raw, bound)
    live = rho2_raw >= rho2
    half = (rho2 - aa) / 2
    inner0 = torch.sqrt(aa * zs * zs + half * half)
    if p.r_mode == 0:
        inv_inner = 1.0 / inner0
        s = torch.sqrt(rho2 - aa)
        r = s / 2 + inner0
        dr_du = 0.25 / s + 0.5 * half * inv_inner
        dr_dw = aa * zs * inv_inner
    else:
        if p.r_mode == 1:
            inner = torch.clamp_min(inner0, p.eps2_half)
            w_inner = _w_max(inner0, p.eps2_half)
            v = half + inner
            w_v = _w_max(v, p.eps2)
            r = torch.sqrt(torch.clamp_min(v, p.eps2))
        else:
            inner = inner0
            r = torch.sqrt(half + inner)
        inv_inner = 1.0 / inner
        inv_2r = 0.5 / r
        dr_du = (0.5 + 0.5 * half * inv_inner) * inv_2r
        dr_dw = (aa * zs * inv_inner) * inv_2r
    r2 = r * r
    q = r2 * r2 + aa * zs * zs
    inv_q = 1.0 / q
    r3 = r * r2
    two_m = 2 * M
    f = two_m * r3 * inv_q
    t3 = 3 * a * a * zs * zs - r2 * r2
    df_dr = two_m * r2 * t3 * inv_q * inv_q
    df_dw = -4 * M * r3 * a * a * zs * inv_q * inv_q
    denom = r2 + aa
    inv_denom = 1.0 / denom
    inv_r = 1.0 / r
    k1 = (r * xs + a * ys) * inv_denom
    k2 = (r * ys - a * xs) * inv_denom
    k3 = zs * inv_r
    k = (None, k1, k2, k3)
    du = [torch.where(live, 2 * v_, zero) for v_ in xyz]
    r_c, df, two_r_rc, n0, n1, n2, dk = [], [], [], [], [], [], []
    for c in range(3):
        rc_ = dr_du * du[c]
        if c == 2:
            rc_ = rc_ + dr_dw
            df.append(df_dr * rc_ + df_dw)
        else:
            df.append(df_dr * rc_)
        trc = 2 * r * rc_
        if c == 0:
            a0 = xs * rc_ + r - k1 * trc
            a1 = ys * rc_ - a - k2 * trc
        elif c == 1:
            a0 = xs * rc_ + a - k1 * trc
            a1 = ys * rc_ + r - k2 * trc
        else:
            a0 = xs * rc_ - k1 * trc
            a1 = ys * rc_ - k2 * trc
        a2 = (1.0 - k3 * rc_) if c == 2 else -(k3 * rc_)
        r_c.append(rc_), two_r_rc.append(trc)
        n0.append(a0), n1.append(a1), n2.append(a2)
        dk.append([a0 * inv_denom, a1 * inv_denom, a2 * inv_r])
    kappa = -1.0 + k1 * k1 + k2 * k2 + k3 * k3
    d_raw = 1 + f * kappa
    neg = d_raw < 0
    d = torch.where(neg, torch.clamp_max(d_raw, -p.det_min),
                    torch.clamp_min(d_raw, p.det_min))
    w_d = torch.where(neg, _w_max(-d_raw, p.det_min),
                      _w_max(d_raw, p.det_min))
    coef = f / d
    ku = u0 + k1 * u1 + k2 * u2 + k3 * u3
    fdot = df[0] * u1 + df[1] * u2 + df[2] * u3
    Dv = [u1 * dk[0][b] + u2 * dk[1][b] + u3 * dk[2][b] for b in range(3)]
    Ev = [u1 * dk[b][0] + u2 * dk[b][1] + u3 * dk[b][2] for b in range(3)]
    uD = u1 * Dv[0] + u2 * Dv[1] + u3 * Dv[2]
    half_fdot = 0.5 * fdot
    s1 = half_fdot * ku + f * uD
    A = [ku * half_fdot + s1]
    C, Bu = [None], [None]
    for d_ in (1, 2, 3):
        C.append(half_fdot * k[d_] + f * Dv[d_ - 1])
        Bu.append(0.5 * df[d_ - 1] * ku + f * Ev[d_ - 1])
        A.append(ku * C[d_] + k[d_] * s1 - ku * Bu[d_])
    kuA = -A[0] + k1 * A[1] + k2 * A[2] + k3 * A[3]
    out4 = A[0] + (-coef) * kuA
    outs = [-A[c] + coef * k[c] * kuA for c in (1, 2, 3)]

    # -- reverse --
    gu = [ct[c] * _w_clip(y[4 + c], -rc, rc) for c in range(4)]
    g4 = ct[4] * _w_clip(out4, -rc, rc)
    ub = list(gu)  # cotangents of u0..u3
    kuAb = (-coef) * g4
    coefb = -(kuA * g4)
    Ab = [g4]
    kb = [None]
    for c in (1, 2, 3):
        gg = ct[4 + c] * _w_clip(outs[c - 1], -rc, rc)
        Ab.append(-gg)
        t = coef * k[c]
        tb = kuA * gg
        kuAb = kuAb + t * gg
        coefb = coefb + k[c] * tb
        kb.append(coef * tb)
    Ab[0] = Ab[0] - kuAb
    for c in (1, 2, 3):
        Ab[c] = Ab[c] + k[c] * kuAb
        kb[c] = kb[c] + A[c] * kuAb
    kub = zero
    s1b = zero
    Cb, Bub = [None], [None]
    for d_ in (1, 2, 3):
        kub = kub + C[d_] * Ab[d_] - Bu[d_] * Ab[d_]
        Cb.append(ku * Ab[d_])
        kb[d_] = kb[d_] + s1 * Ab[d_]
        s1b = s1b + k[d_] * Ab[d_]
        Bub.append(-(ku * Ab[d_]))
    dfb, Evb, Dvb = [], [], []
    fb = zero
    for d_ in (1, 2, 3):
        dfb.append(0.5 * ku * Bub[d_])
        kub = kub + 0.5 * df[d_ - 1] * Bub[d_]
        fb = fb + Ev[d_ - 1] * Bub[d_]
        Evb.append(f * Bub[d_])
    hfb = zero
    for d_ in (1, 2, 3):
        hfb = hfb + k[d_] * Cb[d_]
        kb[d_] = kb[d_] + half_fdot * Cb[d_]
        fb = fb + Dv[d_ - 1] * Cb[d_]
        Dvb.append(f * Cb[d_])
    kub = kub + half_fdot * Ab[0]
    hfb = hfb + ku * Ab[0]
    s1b = s1b + Ab[0]
    hfb = hfb + ku * s1b
    kub = kub + half_fdot * s1b
    fb = fb + uD * s1b
    uDb = f * s1b
    fdotb = 0.5 * hfb
    for b in range(3):
        ub[b + 1] = ub[b + 1] + Dv[b] * uDb
        Dvb[b] = Dvb[b] + uu[b] * uDb
    dkb = [[None] * 3 for _ in range(3)]
    for b in range(3):
        for c in range(3):
            ub[c + 1] = ub[c + 1] + dk[b][c] * Evb[b]
            dkb[b][c] = uu[c] * Evb[b]
    for b in range(3):
        for c in range(3):
            ub[c + 1] = ub[c + 1] + dk[c][b] * Dvb[b]
            dkb[c][b] = dkb[c][b] + uu[c] * Dvb[b]
    for c in range(3):
        dfb[c] = dfb[c] + uu[c] * fdotb
        ub[c + 1] = ub[c + 1] + df[c] * fdotb
    ub[0] = ub[0] + kub
    for c in (1, 2, 3):
        ub[c] = ub[c] + k[c] * kub
        kb[c] = kb[c] + y[4 + c] * kub
    fb = fb + coefb / d
    db = -(coefb * coef) / d
    drawb = w_d * db
    fb = fb + kappa * drawb
    kappab = f * drawb
    for c in (1, 2, 3):
        kb[c] = kb[c] + 2 * k[c] * kappab

    xb = [zero, zero, zero]
    rb = zero
    ab = zero
    aab = zero
    inv_denomb = zero
    inv_rb = zero
    df_drb = zero
    df_dwb = zero
    dr_dub = zero
    dr_dwb = zero
    for c in range(3):
        n0b = inv_denom * dkb[c][0]
        inv_denomb = inv_denomb + n0[c] * dkb[c][0]
        n1b = inv_denom * dkb[c][1]
        inv_denomb = inv_denomb + n1[c] * dkb[c][1]
        n2b = inv_r * dkb[c][2]
        inv_rb = inv_rb + n2[c] * dkb[c][2]
        xb[0] = xb[0] + r_c[c] * n0b
        xb[1] = xb[1] + r_c[c] * n1b
        rcb = xs * n0b + ys * n1b
        if c == 0:
            rb = rb + n0b
            ab = ab - n1b
        elif c == 1:
            ab = ab + n0b
            rb = rb + n1b
        kb[1] = kb[1] - two_r_rc[c] * n0b
        kb[2] = kb[2] - two_r_rc[c] * n1b
        trb = -(k1 * n0b) - k2 * n1b
        kb[3] = kb[3] - r_c[c] * n2b
        rcb = rcb - k3 * n2b
        rb = rb + 2 * r_c[c] * trb
        rcb = rcb + 2 * r * trb
        df_drb = df_drb + r_c[c] * dfb[c]
        rcb = rcb + df_dr * dfb[c]
        if c == 2:
            df_dwb = df_dwb + dfb[2]
            dr_dwb = dr_dwb + rcb
        dr_dub = dr_dub + du[c] * rcb
        dub = dr_du * rcb
        xb[c] = xb[c] + torch.where(live, 2 * dub, zero)
    # k3 = zs / r, k2 and k1 over denom
    xb[2] = xb[2] + inv_r * kb[3]
    inv_rb = inv_rb + zs * kb[3]
    nb = inv_denom * kb[2]
    inv_denomb = inv_denomb + (r * ys - a * xs) * kb[2]
    rb = rb + ys * nb
    xb[1] = xb[1] + r * nb
    ab = ab - xs * nb
    xb[0] = xb[0] - a * nb
    nb = inv_denom * kb[1]
    inv_denomb = inv_denomb + (r * xs + a * ys) * kb[1]
    rb = rb + xs * nb
    xb[0] = xb[0] + r * nb
    ab = ab + ys * nb
    xb[1] = xb[1] + a * nb
    rb = rb - inv_r * inv_r * inv_rb
    denomb = -(inv_denom * inv_denom * inv_denomb)
    r2b = denomb
    aab = aab + denomb
    # df_dw = -4 M r3 a a zs iq iq
    iq2 = inv_q * inv_q
    e = -4 * df_dwb
    Mb = r3 * aa * zs * iq2 * e
    r3b = M * aa * zs * iq2 * e
    ab = ab + 2 * M * r3 * a * zs * iq2 * e
    xb[2] = xb[2] + M * r3 * aa * iq2 * e
    inv_qb = 2 * M * r3 * aa * zs * inv_q * e
    # df_dr = two_m r2 t3 iq iq
    two_mb = r2 * t3 * iq2 * df_drb
    r2b = r2b + two_m * t3 * iq2 * df_drb
    t3b = two_m * r2 * iq2 * df_drb
    inv_qb = inv_qb + 2 * two_m * r2 * t3 * inv_q * df_drb
    ab = ab + 6 * a * zs * zs * t3b
    xb[2] = xb[2] + 6 * aa * zs * t3b
    r2b = r2b - 2 * r2 * t3b
    # f = two_m r3 iq
    two_mb = two_mb + r3 * inv_q * fb
    r3b = r3b + two_m * inv_q * fb
    inv_qb = inv_qb + two_m * r3 * fb
    Mb = Mb + 2 * two_mb
    rb = rb + r2 * r3b
    r2b = r2b + r * r3b
    qb = -(inv_q * inv_q * inv_qb)
    r2b = r2b + 2 * r2 * qb
    aab = aab + zs * zs * qb
    xb[2] = xb[2] + 2 * aa * zs * qb
    rb = rb + 2 * r * r2b
    # radius
    rho2b = zero
    if p.r_mode == 0:
        sb = 0.5 * rb - (0.25 * dr_dub) / (s * s)
        halfb = 0.5 * inv_inner * dr_dub
        inv_innerb = 0.5 * half * dr_dub + aa * zs * dr_dwb
        aab = aab + zs * inv_inner * dr_dwb
        xb[2] = xb[2] + aa * inv_inner * dr_dwb
        inner0b = rb - inv_inner * inv_inner * inv_innerb
        sqb = (0.5 * sb) / s
        rho2b = rho2b + sqb
        aab = aab - sqb
    else:
        inv_2rb = ((0.5 + 0.5 * half * inv_inner) * dr_dub
                   + aa * zs * inv_inner * dr_dwb)
        halfb = 0.5 * inv_inner * inv_2r * dr_dub
        m = inv_2r * dr_dwb
        aab = aab + zs * inv_inner * m
        xb[2] = xb[2] + aa * inv_inner * m
        inv_innerb = 0.5 * half * inv_2r * dr_dub + aa * zs * m
        rb = rb - 2 * inv_2r * inv_2r * inv_2rb
        vb = inv_2r * rb
        if p.r_mode == 1:
            vb = w_v * vb
        halfb = halfb + vb
        innerb = vb - inv_inner * inv_inner * inv_innerb
        inner0b = w_inner * innerb if p.r_mode == 1 else innerb
    # inner0 = sqrt(aa zs zs + half half); no cotangent where it is clamped
    wb = torch.where(inner0b == 0, zero, (0.5 * inner0b) / inner0)
    aab = aab + zs * zs * wb
    xb[2] = xb[2] + 2 * aa * zs * wb
    halfb = halfb + 2 * half * wb
    rho2b = rho2b + 0.5 * halfb
    aab = aab - 0.5 * halfb
    rawb = w_rho * rho2b
    if p.r_mode == 0:
        aab = aab + (1 - w_rho) * rho2b
    for c in range(3):
        xb[c] = xb[c] + 2 * xyz[c] * rawb
    ab = ab + 2 * a * aab
    ct_y = torch.stack([zero] + xb + ub) * w_in
    return ct_y, Mb, ab


def _stage_input(y, dt, ks, row):
    """``y + dt * sum_j TS_A[row][j] k_j``, as ``_tsit5_step_cm`` adds."""
    coeffs = TS_A[row]
    acc = coeffs[0] * ks[0]
    for c_, k_ in zip(coeffs[1:], ks[1:]):
        acc = acc + c_ * k_
    return y + dt * acc


def step_vjp(p: AdjParams, tsit5: bool, y, k1, dt, ct_y, ct_k, ct_ks=None,
             ks=None):
    """Reverse mode of one accepted step ``(y, k1) -> (y_new, k_last)`` at
    the (detached) step ``dt``: ``(ct_y_new, ct_k_last) -> (ct_y, ct_k1,
    ct_M [B], ct_a [B])``. The stages are recomputed from ``(y, k1, dt)``,
    unless ``ks`` holds them as the forward step computed them (Tsit5's
    k1..k7, RK4's k1..k4: the localization's record), bit for bit the ones
    recomputed. The error estimate feeds only the controller and the
    masks, so it takes no cotangent. ``ct_ks`` (Tsit5 only): cotangents of
    the stages k1..k6 themselves, which a reader of the dense output adds
    (the localization's VJP), injected where the reverse sweep starts."""
    rhs = lambda s: geodesic_cm(p.metric, s)  # noqa: E731
    if tsit5:
        if ks is None:
            ks = [k1]
            for row in range(5):
                ks.append(rhs(_stage_input(y, dt, ks, row)))
        y5 = _stage_input(y, dt, ks, 5)
        g, gM, ga = rhs_vjp(p, y5, ct_k)
        b = ct_y + g
        yb = b
        sb = dt * b
        kb = [TS_A[5][j] * sb for j in range(6)]
        if ct_ks is not None:
            kb = [kb[j] + ct_ks[j] for j in range(6)]
        for m in range(5, 0, -1):
            g, dM, da = rhs_vjp(p, _stage_input(y, dt, ks, m - 1), kb[m])
            gM = gM + dM
            ga = ga + da
            yb = yb + g
            sb = dt * g
            for j in range(m):
                kb[j] = kb[j] + TS_A[m - 1][j] * sb
        return yb, kb[0], gM, ga
    if ct_ks is not None:
        raise ValueError("stage cotangents are injected on Tsit5 only")
    if ks is None:
        k2 = rhs(y + 0.5 * dt * k1)
        k3 = rhs(y + 0.5 * dt * k2)
        k4 = rhs(y + dt * k3)
    else:
        k2, k3, k4 = ks[1:4]
    z2 = y + 0.5 * dt * k1
    z3 = y + 0.5 * dt * k2
    z4 = y + dt * k3
    dt6 = dt / dt.new_tensor(6.0)
    y1 = y + dt6 * (k1 + 2 * k2 + 2 * k3 + k4)
    g, gM, ga = rhs_vjp(p, y1, ct_k)
    b = ct_y + g
    yb = b
    sb = dt6 * b
    k1b = sb
    k2b = 2 * sb
    k3b = 2 * sb
    g, dM, da = rhs_vjp(p, z4, sb)
    gM, ga = gM + dM, ga + da
    yb = yb + g
    k3b = k3b + dt * g
    g, dM, da = rhs_vjp(p, z3, k3b)
    gM, ga = gM + dM, ga + da
    yb = yb + g
    k2b = k2b + 0.5 * dt * g
    g, dM, da = rhs_vjp(p, z2, k2b)
    gM, ga = gM + dM, ga + da
    yb = yb + g
    k1b = k1b + 0.5 * dt * g
    return yb, k1b, gM, ga


# ---------------------------------------------------------------------------
# K3 and K4: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

class Route(NamedTuple):
    """Everything a segment run and its adjoint need besides the state.
    A grouped route carries the group table ``groups`` (``[G, P]``, rows
    of ``flatten_params``, detached, in the working type on the state's
    device): the batch's B rays form G groups of ``B / G`` consecutive
    rays, each with its row's M, a and object fields; ``metric`` and
    ``scene`` are then group 0's, which set what all groups share (the
    metric's kind and bounds, the object kinds, the configuration)."""

    metric: Metric  # parameters detached
    scene: Scene  # detached
    cfg: IntegratorConfig
    seg_len: int
    n_seg: int
    cuda: bool
    groups: torch.Tensor | None = None


def rays_per_group(route: Route, B: int) -> int:
    """The rays of each group of a grouped route over ``B`` rays."""
    G = route.groups.shape[0]
    if G < 1 or B % G:
        raise ValueError(f"{B} rays do not split into {G} groups")
    return B // G


def route_rows(route: Route, B: int):
    """``(metric, scene)`` per ray over ``B`` rays: the route's own, or a
    grouped route's table expanded to one row per ray (M and a ``[B]``, the
    object fields ``[B, N]``, ``pos [B, N, 4]``), as the plain versions
    read them."""
    if route.groups is None:
        return route.metric, route.scene
    rpg = rays_per_group(route, B)
    n = route.scene.n_objects
    tab = route.groups.repeat_interleave(rpg, dim=0)  # [B, P]
    rows = tab[:, 2:2 + 8 * n].reshape(B, n, 8)
    metric = route.metric._replace(params=KerrSchildParams(M=tab[:, 0],
                                                           a=tab[:, 1]))
    pos = torch.cat([route.scene.pos[:, :1].expand(B, n, 1), rows[..., :3]],
                    dim=-1)
    fields = {f: rows[..., 3 + k] for k, f in enumerate(OBJ_FIELDS[3:])}
    return metric, route.scene._replace(pos=pos, **fields)


def forward_segment(route: Route, P: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: ``seg_len`` steps of the body on a packed state
    ``[34, B]`` (each ray with its group's parameters on a grouped
    route)."""
    metric, scene = route_rows(route, P.shape[1])
    _, body = make_step_cm(metric, scene_event_cm(scene), route.cfg)
    st = unpack_state(P)
    for _ in range(route.seg_len):
        st, _ = body(st)
    return pack_state(st)


def backward_plain(route: Route, ck: torch.Tensor, ends: torch.Tensor,
                   ct: torch.Tensor):
    """Plain version of K4: ``(checkpoints, the rays' end segments [B]
    int32, ct of the final state [34, B]) -> (ct of the initial state
    [34, B], per-ray (M, a) cotangents [B, 2])``. Ray i's segments in
    reverse from ``ends[i] - 1``; each is replayed from its checkpoint and
    its accepted steps are walked back with ``step_vjp``. A segment at or
    past a ray's end, and a ray's non-stepping iteration, are the identity;
    where-masks keep them so (what the checkpoints hold there is never
    taken)."""
    metric, scene = route_rows(route, ck.shape[2])
    p = adj_params(metric, ck.dtype, ck.device)
    tsit5 = route.cfg.method == "tsit5"
    _, body = make_step_cm(metric, scene_event_cm(scene), route.cfg)
    ct_y = ct[P_Y:P_Y + 8]
    ct_k = ct[P_K1:P_K1 + 8]
    ct_ev = ct[P_EV_Y0:P_EV_Y0 + 8]
    B = ck.shape[2]
    pM = torch.zeros(B, dtype=ck.dtype, device=ck.device)
    pa = torch.zeros_like(pM)
    # The plain version reads the longest walk to the host.
    n = int(ends.max()) if B else 0
    for s in range(n - 1, -1, -1):
        st = unpack_state(ck[s])
        st = st._replace(active=st.active & (s < ends))
        recs = []
        for _ in range(route.seg_len):
            nxt, rec = body(st)
            recs.append((st.y, st.k1, rec))
            st = nxt
        for y, k1, rec in reversed(recs):
            yb, kb, gM, ga = step_vjp(p, tsit5, y, k1, rec.dt_try, ct_y, ct_k)
            yb = torch.where(rec.hit_now, yb + ct_ev, yb)
            ct_ev = torch.where(rec.hit_now, torch.zeros_like(ct_ev), ct_ev)
            ct_y = torch.where(rec.do, yb, ct_y)
            ct_k = torch.where(rec.do, kb, ct_k)
            pM = torch.where(rec.do, pM + gM, pM)
            pa = torch.where(rec.do, pa + ga, pa)
    ct0 = torch.zeros_like(ct)
    ct0[P_Y:P_Y + 8] = ct_y
    ct0[P_K1:P_K1 + 8] = ct_k
    ct0[P_EV_Y0:P_EV_Y0 + 8] = ct_ev
    return ct0, torch.stack([pM, pa], dim=1)


def init_plain(route: Route, y0: torch.Tensor,
               dt0: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K3's prologue: the packed initial state ``[34, B]``
    of the rays at ``y0 [8, B]``, ``make_step_cm``'s init (k1 = rhs(y0),
    the event record at y0) at the step ``dt0 [B]``, or where it is None
    at each ray's own initial step (``initial_dt``: ``rk4_dt``, Hairer's
    for Tsit5); a grouped route's rays with their groups' parameters. Not
    differentiated: ``init_vjp`` is its reverse mode."""
    metric, scene = route_rows(route, y0.shape[1])
    with torch.no_grad():
        if dt0 is None:
            dt0 = initial_dt(metric, y0.t(), route.cfg)
        init, _ = make_step_cm(metric, scene_event_cm(scene), route.cfg)
        return pack_state(init(y0, dt0))


def init_vjp(route: Route, y0: torch.Tensor, ct: torch.Tensor,
             pbar: torch.Tensor):
    """Plain version of K10, the reverse mode of ``init_plain``
    at ``y0 [8, B]``: ``(ct [34, B], pbar [B, 2]) -> (ct_y0 [8, B], pbar
    [B, 2])``, from the initial state's cotangent and the per-ray (M, a)
    cotangents that ``backward_plain`` returns. y0 is the state's y and
    ev_y0 as it is and reaches k1 through ``rhs_vjp``, whose (M, a)
    cotangents are added to ``pbar``; the sums in K4's order."""
    metric, _ = route_rows(route, y0.shape[1])
    p = adj_params(metric, y0.dtype, y0.device)
    g, gM, ga = rhs_vjp(p, y0, ct[P_K1:P_K1 + 8])
    ct_y0 = ct[P_Y:P_Y + 8] + ct[P_EV_Y0:P_EV_Y0 + 8] + g
    return ct_y0, torch.stack([pbar[:, 0] + gM, pbar[:, 1] + ga], dim=1)


def k4_plain(route: Route, ck: torch.Tensor, ends: torch.Tensor,
             ct: torch.Tensor):
    """Plain version of ``backward_cuda`` (K4, then K10):
    ``backward_plain``, then ``init_vjp`` at the rays' launch states
    (``ck[0]``'s y planes): ``(ct_y0 [8, B], pbar [B, 2])``."""
    return init_vjp(route, ck[0, P_Y:P_Y + 8],
                    *backward_plain(route, ck, ends, ct))


def _check_kernel_inputs(route: Route, t: torch.Tensor) -> None:
    check_kernel_config(route.metric, route.scene, route.cfg)
    if not 0 < route.seg_len <= MAX_SEG:
        raise ValueError(f"K4 replays segments of at most {MAX_SEG} steps, "
                         f"got {route.seg_len}")
    if t.device.type != "cuda":
        raise ValueError(f"K3 and K4 need CUDA tensors, got {t.device}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {t.dtype}")
    tab = route.groups
    if tab is not None and (
            tab.device != t.device or tab.dtype != t.dtype or tab.dim() != 2
            or not tab.is_contiguous()
            or tab.shape[1] < 2 + 8 * route.scene.n_objects):
        raise ValueError("the group table must be a contiguous [G, P] "
                         "tensor of the state's dtype and device")


def launch_args(route: Route, like: torch.Tensor):
    """K3's and K4's parameter block on the card and their int flags
    (``launch_config``'s): built once per pass."""
    _check_kernel_inputs(route, like)
    return launch_config(route.metric, route.scene, route.cfg, like,
                         "adjoint")


def _lib():
    from ..utils import cuda_build
    return cuda_build.load("adjoint")


def _group_args(route: Route, B: int):
    """The C entry points' group arguments: (table, rays per group, row
    stride), or none."""
    if route.groups is None:
        return ctypes.c_void_p(None), 0, 0
    return (ctypes.c_void_p(route.groups.data_ptr()),
            rays_per_group(route, B), route.groups.shape[1])


def forward_segment_cuda(route: Route, ck: torch.Tensor, y0: torch.Tensor,
                         dt0: torch.Tensor | None = None,
                         args=None) -> torch.Tensor:
    """K3: the whole forward pass in one launch, on the card. ``ck`` is
    the checkpoint buffer ``[n_seg + 1, 34, B]``, ``y0 [8, B]`` the rays'
    launch states and ``dt0 [B]`` their first steps, or None for each
    ray's own (``initial_step``, bitwise ``initial_dt``'s). Each ray builds
    its initial state in the kernel's prologue (``init_plain``'s, bitwise)
    and writes it to ``ck[0]``, then runs its segments and writes their
    checkpoints.
    Returns ``used [1 + B]`` (int32, on the card, not read here):
    ``used[0]`` is ``n_used`` and ``used[1 + i]`` ray i's end segment (the
    first at whose start it is inactive, ``n_seg`` if none). The buffer
    then holds what the per-segment chain (``run_segments``' plain route)
    holds wherever a reader looks (``read_mask``): ray i's whole state at
    the start of each segment up to its end, and every ray's whole final
    state in ``ck[n_seg]``. ``args`` from ``launch_args`` (built here if
    not given). Adds one to ``forward_segment_cuda.launches`` per pass and
    its rays to ``forward_segment_cuda.rays`` (where the launch is issued:
    a CUDA graph's replays of a captured launch do not count). A grouped
    route launches the grouped kernel (each ray's parameters from its
    group's row of ``route.groups``) in the same one launch."""
    if ck.device.type != "cuda":
        raise ValueError(f"K3 needs CUDA tensors, got {ck.device}")
    if ck.dim() != 3 or ck.shape[0] != route.n_seg + 1 or (
            ck.shape[1] != N_PLANES) or not ck.is_contiguous():
        raise ValueError(f"bad checkpoint buffer {tuple(ck.shape)}")
    B = ck.shape[2]
    if (y0.device != ck.device or y0.dtype != ck.dtype
            or y0.shape != (8, B) or not y0.is_contiguous()):
        raise ValueError("K3 takes the launch states as a contiguous [8, B] "
                         "tensor of the checkpoints' dtype and device")
    if dt0 is not None and (dt0.device != ck.device or dt0.dtype != ck.dtype
                            or dt0.shape != (B,) or not dt0.is_contiguous()):
        raise ValueError("K3 takes the first steps as a contiguous [B] "
                         "tensor of the checkpoints' dtype and device")
    prm, flags = args if args is not None else launch_args(route, ck)
    used = torch.empty(1 + B, dtype=torch.int32, device=ck.device)
    fn = _lib().rtgr_k3_f32 if ck.dtype == torch.float32 else \
        _lib().rtgr_k3_f64
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(ck.device):
        rc = fn(ptr(y0), ctypes.c_void_p(None if dt0 is None
                                         else dt0.data_ptr()),
                ptr(ck), ptr(used), ptr(used[1:]), ptr(prm), B, *flags,
                route.seg_len, route.n_seg, *_group_args(route, B),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
    forward_segment_cuda.launches += 1
    forward_segment_cuda.rays += B
    return used


forward_segment_cuda.launches = 0
forward_segment_cuda.rays = 0


def work_order(ends: torch.Tensor) -> torch.Tensor:
    """K4's work order: the rays by end segment, largest first, and in
    index order within one end segment (a stable sort, so that a launch's
    warps and its times repeat). int64 ``[B]``, on ``ends``' device, made
    there with no host read (capture-safe). Thread t of K4 walks ray
    ``order[t]``, so a warp's lanes share their walk back and the longest
    walks start first; which thread runs a ray changes none of its
    values."""
    return torch.argsort(ends, descending=True, stable=True)


def work_order_cuda(ends: torch.Tensor, n_seg: int) -> torch.Tensor:
    """K4's work order on the card: ``work_order(ends)``'s permutation
    (int64 ``[B]``), from a stable counting sort over the ``n_seg + 1`` end
    segments in one launch of the adjoint library (csrc/adjoint.cu
    k4_order_kernel, one cluster of thread blocks) in place of a general
    sort. Reads nothing back, so a CUDA graph can hold it. Adds one to
    ``work_order_cuda.launches`` per launch."""
    if (ends.device.type != "cuda" or ends.dtype != torch.int32
            or ends.dim() != 1 or not ends.is_contiguous()):
        raise ValueError("the work order takes the end segments as a "
                         "contiguous int32 [B] tensor on the card")
    B = ends.shape[0]
    order = torch.empty(B, dtype=torch.int64, device=ends.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(ends.device):
        rc = _lib().rtgr_k4_order(
            ptr(ends), ptr(order), B, n_seg + 1,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K4's work order failed: CUDA error {rc}")
    work_order_cuda.launches += 1
    return order


work_order_cuda.launches = 0


def backward_cuda(route: Route, ck: torch.Tensor, ends: torch.Tensor,
                  ct: torch.Tensor, args=None):
    """K4: the whole walk back in one launch, one thread per ray, then K10
    (``init_vjp_cuda``) from the initial state to the launch states: the
    same contract as ``k4_plain`` (``(ct_y0 [8, B], pbar [B, 2])``; a
    grouped route's rays with their groups' parameters); ``ends`` K3's end
    segments on the card (``used[1:]`` of ``forward_segment_cuda``),
    ``args`` as for K3. Thread t walks ray ``order[t]``, the work order
    that ``work_order_cuda`` makes from ``ends`` first. Adds one to
    ``backward_cuda.launches`` per K4 launch and its rays to
    ``backward_cuda.rays`` (where issued, as K3's)."""
    if ck.device.type != "cuda":
        raise ValueError(f"K4 needs CUDA tensors, got {ck.device}")
    B = ck.shape[2]
    if (ends.device != ck.device or ends.dtype != torch.int32
            or ends.shape != (B,) or not ends.is_contiguous()):
        raise ValueError("K4 takes the end segments as a contiguous int32 "
                         "[B] tensor on the checkpoints' device")
    order = work_order_cuda(ends, route.n_seg)
    prm, flags = args if args is not None else launch_args(route, ck)
    ct = ct.contiguous()
    ct0 = torch.empty_like(ct)  # K4 writes the y, k1 and ev_y0 planes
    pbar = torch.empty((B, 2), dtype=ck.dtype, device=ck.device)
    fn = _lib().rtgr_k4_f32 if ck.dtype == torch.float32 else \
        _lib().rtgr_k4_f64
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(ck.device):
        rc = fn(ptr(ck), ptr(ends), ptr(order), ptr(ct), ptr(ct0),
                ptr(pbar), ptr(prm), B, *flags, route.seg_len,
                *_group_args(route, B),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {rc}")
    backward_cuda.launches += 1
    backward_cuda.rays += B
    return init_vjp_cuda(route, ck, ct0, pbar, (prm, flags))


backward_cuda.launches = 0
backward_cuda.rays = 0


def init_vjp_cuda(route: Route, ck: torch.Tensor, ct0: torch.Tensor,
                  pbar: torch.Tensor, args=None):
    """K10: ``init_vjp`` in one launch on the card, one thread per ray
    (csrc/adjoint.cu k10_kernel), right after K4: from the cotangent of
    the initial state ``ct0 [34, B]`` (its y, k1 and ev_y0 planes, as K4
    writes them) and the per-ray (M, a) cotangents ``pbar [B, 2]``, at the
    launch states in ``ck[0]``'s y planes: ``(ct_y0 [8, B], pbar)``,
    ``pbar`` updated in place. ``args`` as for K3. Adds one to
    ``init_vjp_cuda.launches`` per launch (where issued)."""
    B = ck.shape[2]
    if (ct0.shape != (N_PLANES, B) or pbar.shape != (B, 2)
            or not (ct0.is_contiguous() and pbar.is_contiguous())
            or {ct0.dtype, pbar.dtype} != {ck.dtype}
            or {ct0.device, pbar.device} != {ck.device}):
        raise ValueError("K10 takes contiguous [34, B] and [B, 2] "
                         "cotangents of the checkpoints' dtype and device")
    prm, flags = args if args is not None else launch_args(route, ck)
    kerr, _, r_mode, _, n_obj, _ = flags
    ct_y0 = torch.empty((8, B), dtype=ck.dtype, device=ck.device)
    fn = _lib().rtgr_k10_f32 if ck.dtype == torch.float32 else \
        _lib().rtgr_k10_f64
    table, rpg, stride = _group_args(route, B)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(ck.device):
        rc = fn(ptr(ck), ptr(ct0), ptr(ct_y0), ptr(pbar), ptr(prm), B, kerr,
                r_mode, table, n_obj, rpg, stride,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K10 launch failed: CUDA error {rc}")
    init_vjp_cuda.launches += 1
    return ct_y0, pbar


init_vjp_cuda.launches = 0


# ---------------------------------------------------------------------------
# K6 and K7: the localization epilogue and its hand-written VJP
#
# After the loop every ray's result is read from its final state: a hit
# ray's localized from its event record (``localize_events_cm``), any
# other's as it stands. K6 computes it in one launch and keeps a record of
# each hit ray's bisection end and crossing-step stages; K7 reads that
# record (it replays neither the step nor the bisection) and pushes the
# cotangents of ``(y, lam)`` back to the final state's ``y`` and ``ev_y0``
# planes and to every parameter the epilogue reads: M and a (the crossing
# step) and the objects' fields (the event). The plain versions below hold
# the arithmetic the kernels repeat, in their order.
#
# The VJP follows torch autograd of the plain epilogue: the interpolation
# of y* at theta*; theta* through the clamps (torch's gradient is inclusive
# at a clamp's bounds) and the ``ok`` selection of the Newton polish; val
# AND dval (the event's JVP at the bracket's end: the VJP of a JVP, which
# reaches the tangent's dense-output derivative and the event's second
# derivatives); the balanced min and max of the event, half to each side on
# a tie; and the replayed step back to ev_y0, M and a (``step_vjp`` with a
# cotangent injected per Tsit5 stage, whose dense output reads all seven).
# The bracket, ev_dt and the masks take none.
# ---------------------------------------------------------------------------

# The localization record that K6 keeps for K7 (csrc/localize.cu REC_*),
# ``[rec_planes, B]``: theta0, the bisection's end (plane REC_TH0), then the
# crossing step's stages from plane REC_K, 8 planes each: Tsit5's k1..k7;
# RK4's k1..k4, f(y1) and y1. Only a hit ray's column is read: the plain
# version writes zeros in any other, K6 leaves it unwritten.
REC_TH0, REC_K = 0, 1


def rec_planes(tsit5: bool) -> int:
    """The record's planes: 57 for Tsit5, 49 for RK4."""
    return REC_K + 8 * (7 if tsit5 else 6)


def localize_plain(route: Route, P: torch.Tensor):
    """Plain version of K6: ``(y [8, B], lam [B], rec [R, B])`` from the
    packed final state ``[34, B]``: every ray localized (the steps of
    ``localize_events_cm``, as the JAX package's epilogue: the crossing
    step, the bisection, the polish and the interpolation), then a hit
    ray's result selected, any other ray's y and lam as they stand; ``rec``
    the record of each hit ray's bisection end and stages (``REC_*``),
    which ``localize_vjp`` reads instead of replaying them. A grouped
    route's rays read their group's parameters."""
    metric, scene = route_rows(route, P.shape[1])
    st = unpack_state(P)
    th, ys, th0, (y1, _, k_last, ks, stages) = localize_events_cm(
        metric, scene_event_cm(scene), route.cfg, st.ev_y0, st.ev_dt,
        st.ev_lo, st.ev_hi, keep=True)
    rec = torch.cat([th0[None], *stages]
                    + ([] if ks is not None else [k_last, y1]))
    return (torch.where(st.hit, ys, st.y),
            torch.where(st.hit, st.ev_lam + th * st.ev_dt, st.lam),
            torch.where(st.hit, rec, torch.zeros_like(rec)))


def _incl(x, lo, hi):
    """Where torch's clamp(x, lo, hi) passes its gradient: lo <= x <= hi."""
    return (x >= lo) & (x <= hi)


def _balanced_w(a, b, is_max: bool):
    """The balanced min or max's weights ``(wa, wb)``: 1 to the side taken,
    half to each on a tie (``models.objects.balanced_min``)."""
    m = torch.maximum(a, b) if is_max else torch.minimum(a, b)
    one = torch.ones_like(m)
    wa = torch.where(a == m, torch.where(b == m, 0.5 * one, one), 0 * one)
    wb = torch.where(b == m, torch.where(a == m, 0.5 * one, one), 0 * one)
    return wa, wb


def _object_jvp_vjp(kind: int, get, x, dx, cv, cdv, ct_x, ct_dx):
    """Reverse mode of one object's ``KIND_DISTANCE_JVP`` at position rows
    ``x`` and tangent rows ``dx`` (4 each): the cotangents ``(cv, cdv)`` of
    its value and tangent added into ``ct_x`` and ``ct_dx`` (lists of rows,
    updated in place), and returned per field, ``{OBJ_FIELDS index:
    cotangent}``."""
    if kind == KIND_PLANE:  # v = t - time, dv = dt
        ct_x[0] = ct_x[0] + cv
        ct_dx[0] = ct_dx[0] + cdv
        return {4: -cv}
    d = [x[c] - get("pos", c) for c in (1, 2, 3)]
    if kind == KIND_SPHERE:  # v = s (|d|^2 - r^2), dv = s 2 (d . dx)
        r = get("radius")
        sgn = torch.sign(r)
        gv = sgn * cv
        t = 2 * (sgn * cdv)
        out = {}
        for c in range(3):
            cd = 2 * d[c] * gv + t * dx[c + 1]
            ct_x[c + 1] = ct_x[c + 1] + cd
            ct_dx[c + 1] = ct_dx[c + 1] + t * d[c]
            out[c] = -cd
        out[3] = -(2 * r * gv)
        return out
    # disk: max(|dz| - half, max(rho2 - r_out^2, r_in^2 - rho2))
    r_in, r_out, half = get("r_in"), get("r_out"), get("half")
    rho2 = d[0] * d[0] + d[1] * d[1]
    slab = torch.abs(d[2]) - half
    ra, rb = rho2 - r_out ** 2, r_in ** 2 - rho2
    wra, wrb = _balanced_w(ra, rb, True)
    wa, wb = _balanced_w(slab, torch.maximum(ra, rb), True)
    c_slab, c_ring = cv * wa, cv * wb
    c_dslab, c_dring = cdv * wa, cdv * wb
    c_a, c_b = c_ring * wra, c_ring * wrb
    c_rho2 = c_a - c_b
    t = 2 * (c_dring * wra - c_dring * wrb)
    c_dz = torch.sign(d[2]) * c_slab
    ct_dx[3] = ct_dx[3] + torch.where(d[2] >= 0, c_dslab, -c_dslab)
    out = {}
    for c in range(2):
        cd = 2 * d[c] * c_rho2 + t * dx[c + 1]
        ct_x[c + 1] = ct_x[c + 1] + cd
        ct_dx[c + 1] = ct_dx[c + 1] + t * d[c]
        out[c] = -cd
    ct_x[3] = ct_x[3] + c_dz
    out[2] = -c_dz
    out[5] = 2 * r_in * c_b
    out[6] = -(2 * r_out * c_a)
    out[7] = -c_slab
    return out


def _event_vjp(scene: Scene, x, dx, cv, cdv):
    """Reverse mode of ``scene_event_cm(scene).jvp`` (the fold of the
    objects' value and tangent by the balanced min): ``(ct_x, ct_dx,
    fields)``, ``ct_x`` and ``ct_dx`` lists of 4 rows, ``fields[i]`` object
    i's ``{OBJ_FIELDS index: cotangent}``. The fold's weights are
    recomputed forward; the objects are visited last to first."""
    kinds = object_kinds(scene)
    gets = [_object_get(scene, i) for i in range(len(kinds))]
    xs, dxs = [x[c] for c in range(4)], [dx[c] for c in range(4)]
    v, w = None, []
    for kind, get in zip(kinds, gets):
        vi, _ = KIND_DISTANCE_JVP[kind](*xs, *dxs, get)
        if v is None:
            v = vi
        else:
            w.append(_balanced_w(v, vi, False))
            v = torch.minimum(v, vi)
    zero = torch.zeros_like(cv)
    ct_x, ct_dx = [zero] * 4, [zero] * 4
    fields = [None] * len(kinds)
    for i in range(len(kinds) - 1, -1, -1):
        if i > 0:
            wa, wb = w[i - 1]
            ci, cdi = cv * wb, cdv * wb
            cv, cdv = cv * wa, cdv * wa
        else:
            ci, cdi = cv, cdv
        fields[i] = _object_jvp_vjp(kinds[i], gets[i], xs, dxs, ci, cdi,
                                    ct_x, ct_dx)
    return ct_x, ct_dx, fields


def _hermite_vjp(th, dt, ct, dct):
    """Reverse mode of ``hermite_interp`` (and, with ``dct``, of
    ``hermite_dinterp``) at ``th`` over rows: the cotangents of ``(y0, y1,
    f0, f1)``."""
    h = th * (th - 1)
    ct_g = h * ct if dct is None else h * ct + (2 * th - 1) * dct
    ct_y0 = (1 - th) * ct
    ct_y1 = th * ct
    ct_d = (1 - 2 * th) * ct_g
    ct_f0 = ((th - 1) * dt) * ct_g
    ct_f1 = (th * dt) * ct_g
    if dct is not None:
        ct_dg = h * dct
        ct_d = ct_d - 2 * ct_dg + dct
        ct_f0 = ct_f0 + dt * ct_dg
        ct_f1 = ct_f1 + dt * ct_dg
    return ct_y0 - ct_d, ct_y1 + ct_d, ct_f0, ct_f1


def localize_vjp(route: Route, P: torch.Tensor, ct_y: torch.Tensor,
                 ct_lam: torch.Tensor, rec: torch.Tensor | None = None):
    """Plain version of K7, the reverse mode of ``localize_plain`` after the
    dead-ray cutoff: ``(P [34, B], ct_y [8, B], ct_lam [B]) -> (ct_P [34,
    B], pbar [2 + 8 N, B])``. ``ct_P`` holds the cotangent of the ``y``
    plane (a ray that did not hit and is not dead: see ``_integrate``) and
    of the ``ev_y0`` plane (a hit ray), zeros elsewhere; ``pbar`` the
    per-ray cotangents of ``flatten_params``' entries (M, a, then 8 fields
    per object), which the caller sums over the batch or per group. A ray
    whose cotangents are all zero, or that did not hit, takes zeros here
    without its step being replayed, as in K7. With ``rec``, the record of
    ``localize_plain`` or K6, the bisection's end and the stages are read
    from it, as K7 reads them; without, they are replayed (the crossing
    step, the bisection, ``step_vjp``'s stages), bit for bit the same."""
    B = P.shape[1]
    metric, scene = route_rows(route, B)
    cfg = route.cfg
    tsit5 = cfg.method == "tsit5"
    st = unpack_state(P)
    zero = torch.zeros_like(st.lam)
    dead = ~st.hit & ~st.active & (st.lam < cfg.lam_max - 1e-6)
    keep = ~st.hit & ~dead
    live = st.hit & ((ct_y != 0).any(0) | (ct_lam != 0))
    n_obj = scene.n_objects

    # -- forward (localize_events_cm), keeping what the reverse reads --
    p = adj_params(metric, P.dtype, P.device)
    y0, dt = st.ev_y0, st.ev_dt
    event_fn = scene_event_cm(scene)
    kept = None
    if rec is None:
        _, _, th0, (y1, k1, k_last, ks, _) = localize_events_cm(
            metric, event_fn, cfg, y0, dt, st.ev_lo, st.ev_hi, keep=True)
    else:
        kept = [rec[REC_K + 8 * j:REC_K + 8 * j + 8]
                for j in range(7 if tsit5 else 4)]
        k1 = kept[0]
        if tsit5:
            y1, k_last, ks = None, kept[6], tuple(kept)
        else:
            y1, k_last, ks = (rec[REC_K + 40:REC_K + 48],
                              rec[REC_K + 32:REC_K + 40], None)
        th0 = rec[REC_TH0]
    interp, dinterp = _interpolants(y0, y1, k1, k_last, dt, ks, 4)
    x, dx = interp(th0), dinterp(th0)
    val, dval = event_fn.jvp(x, dx)
    ok = torch.abs(dval) > 1e-3 * (1.0 + torch.abs(val))
    den = torch.where(ok, dval, torch.ones_like(dval))
    delta = torch.where(ok, val, zero) / den
    u = th0 - torch.clamp(delta, -1.0, 1.0)
    th = torch.clamp(u, 0.0, 1.0)

    # -- reverse --
    # y* = dense output at th (8 rows); lam* = ev_lam + th ev_dt
    if tsit5:
        d8 = _tsit5_dinterp_cm(ks, dt, th)
    else:
        d8 = hermite_dinterp(y0, y1, k1, k_last, dt, th)
    ct_th = ct_lam * dt
    for c in range(8):
        ct_th = ct_th + ct_y[c] * d8[c]
    ct_u = torch.where(_incl(u, 0.0, 1.0), ct_th, zero)
    ct_delta = -torch.where(_incl(delta, -1.0, 1.0), ct_u, zero)
    q = ct_delta / den
    ct_val = torch.where(ok, q, zero)
    ct_dval = torch.where(ok, -(q * delta), zero)
    ct_x, ct_dx, fields = _event_vjp(scene, x, dx, ct_val, ct_dval)
    ct_x, ct_dx = torch.stack(ct_x), torch.stack(ct_dx)
    # the dense output's data: at th (8 rows, y*) and at th0 (4 rows, x, dx)
    if tsit5:
        bw, b0, db0 = tsit5_bi(th), tsit5_bi(th0), tsit5_dbi(th0)
        cy, cx, cdx = dt * ct_y, dt * ct_x, dt * ct_dx
        ct_k = []
        for j in range(7):
            kj = bw[j] * cy
            ct_k.append(torch.cat([kj[:4] + b0[j] * cx + db0[j] * cdx,
                                   kj[4:]]))
        ct_y0 = torch.cat([ct_y[:4] + ct_x, ct_y[4:]])
        yb, ct_k1, gM, ga = step_vjp(p, True, y0, k1, dt, torch.zeros_like(y0),
                                     ct_k[6], ct_ks=ct_k[:6], ks=kept)
    else:
        a8, b8, f08, f18 = _hermite_vjp(th, dt, ct_y, None)
        a4, b4, f04, f14 = _hermite_vjp(th0, dt, ct_x, ct_dx)
        top = lambda u8, u4: torch.cat([u8[:4] + u4, u8[4:]])  # noqa: E731
        ct_y0, ct_y1 = top(a8, a4), top(b8, b4)
        ct_f0, ct_f1 = top(f08, f04), top(f18, f14)
        yb, k1b, gM, ga = step_vjp(p, False, y0, k1, dt, ct_y1, ct_f1,
                                   ks=kept)
        ct_k1 = ct_f0 + k1b
    g, dM, da = rhs_vjp(p, y0, ct_k1)
    ct_ev = ct_y0 + yb + g
    rows = [gM + dM, ga + da]
    for i in range(n_obj):
        rows += [fields[i].get(f, zero) for f in range(8)]
    pbar = torch.where(live, torch.stack(rows), torch.zeros_like(rows[0]))
    ct_P = torch.zeros_like(P)
    ct_P[P_Y:P_Y + 8] = torch.where(keep, ct_y, torch.zeros_like(ct_y))
    ct_P[P_EV_Y0:P_EV_Y0 + 8] = torch.where(live, ct_ev,
                                            torch.zeros_like(ct_ev))
    return ct_P, pbar



def localize_args(route: Route, P: torch.Tensor):
    """K6's and K7's parameter block on the card and their int flags (those
    of ``launch_config`` for the localize library, SC_REFINE launched as
    SC_ANY: the localization has no trisection, so the two would compile to
    the same kernel; then the bisection count, which K7 does not take),
    built once per pass."""
    if P.device.type != "cuda":
        raise ValueError(f"K6 and K7 need CUDA tensors, got {P.device}")
    if P.dim() != 2 or P.shape[0] != N_PLANES or not P.is_contiguous():
        raise ValueError(f"bad packed state {tuple(P.shape)}")
    _check_kernel_inputs(route, P)
    prm, flags = launch_config(route.metric, route.scene, route.cfg, P,
                               "localize")
    kerr, tsit5, r_mode, code, n_obj, npts = flags
    return prm, (kerr, tsit5, r_mode, SC_ANY if code == SC_REFINE else code,
                 n_obj, npts, int(route.cfg.bisect_iters))


def _loc_lib():
    from ..utils import cuda_build
    return cuda_build.load("localize")


def localize_cuda(route: Route, P: torch.Tensor, args=None):
    """K6: ``localize_plain`` in one launch on the card, one thread per ray
    (csrc/localize.cu k6_kernel): ``(y [8, B], lam [B], rec [R, B])`` from
    the packed final state ``P [34, B]``, a grouped route's rays with their
    groups' parameters; ``rec`` the record K7 reads. ``args`` from
    ``localize_args`` (built here if not given). Reads nothing back. Adds
    one to ``localize_cuda.launches`` per launch (where it is issued, as
    K3's)."""
    prm, flags = args if args is not None else localize_args(route, P)
    B = P.shape[1]
    y = torch.empty((8, B), dtype=P.dtype, device=P.device)
    lam = torch.empty(B, dtype=P.dtype, device=P.device)
    rec = torch.empty((rec_planes(route.cfg.method == "tsit5"), B),
                      dtype=P.dtype, device=P.device)
    if B == 0:
        return y, lam, rec
    fn = _loc_lib().rtgr_k6_f32 if P.dtype == torch.float32 else \
        _loc_lib().rtgr_k6_f64
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(P.device):
        rc = fn(ptr(P), ptr(y), ptr(lam), ptr(rec), ptr(prm), B, *flags,
                *_group_args(route, B),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {rc}")
    localize_cuda.launches += 1
    return y, lam, rec


localize_cuda.launches = 0


def localize_vjp_cuda(route: Route, P: torch.Tensor, ct_y: torch.Tensor,
                      ct_lam: torch.Tensor, rec: torch.Tensor, args=None):
    """K7: ``localize_vjp`` with K6's record ``rec`` in one launch on the
    card, one thread per ray (csrc/localize.cu k7_kernel), the same
    contract; every plane of ``ct_P`` and every row of ``pbar`` written by
    the kernel. Adds one to ``localize_vjp_cuda.launches`` per launch
    (where issued)."""
    prm, flags = args if args is not None else localize_args(route, P)
    B = P.shape[1]
    if ct_y.shape != (8, B) or ct_lam.shape != (B,):
        raise ValueError(f"bad cotangents {tuple(ct_y.shape)}, "
                         f"{tuple(ct_lam.shape)} for {B} rays")
    if (rec.shape != (rec_planes(route.cfg.method == "tsit5"), B)
            or rec.dtype != P.dtype or rec.device != P.device
            or not rec.is_contiguous()):
        raise ValueError(f"bad record {tuple(rec.shape)} {rec.dtype} for "
                         f"{B} rays")
    ct_y = ct_y.to(P.dtype).contiguous()
    ct_lam = ct_lam.to(P.dtype).contiguous()
    n_par = 2 + 8 * route.scene.n_objects
    ct_P = torch.empty_like(P)
    pbar = torch.empty((n_par, B), dtype=P.dtype, device=P.device)
    if B == 0:
        return ct_P, pbar
    fn = _loc_lib().rtgr_k7_f32 if P.dtype == torch.float32 else \
        _loc_lib().rtgr_k7_f64
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(P.device):
        rc = fn(ptr(P), ptr(rec), ptr(ct_y), ptr(ct_lam), ptr(ct_P),
                ptr(pbar), ptr(prm), B, *flags[:-1], *_group_args(route, B),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {rc}")
    localize_vjp_cuda.launches += 1
    return ct_P, pbar


localize_vjp_cuda.launches = 0


def run_segments(route: Route, y0: torch.Tensor,
                 dt0: torch.Tensor | None = None):
    """The forward loop from the launch states ``y0 [8, B]`` and first
    steps ``dt0 [B]`` (None: each ray's own): ``(checkpoints [n_seg + 1,
    34, B], used [1 + B])`` with ``used`` as ``forward_segment_cuda``
    returns it. Checkpoint 0 holds every ray's initial state, checkpoint s
    the state at the start of segment s for the rays active there,
    checkpoint ``n_seg`` every ray's final state. The kernel route is one
    K3 launch (the initial state in its prologue) and reads nothing back;
    the plain route is ``chain_plain`` from ``init_plain``."""
    B = y0.shape[1]
    if not route.cuda:
        return chain_plain(route, init_plain(route, y0, dt0))
    ck = torch.empty((route.n_seg + 1, N_PLANES, B), dtype=y0.dtype,
                     device=y0.device)
    if B == 0:
        return ck, torch.zeros(1, dtype=torch.int32, device=y0.device)
    return ck, forward_segment_cuda(route, ck, y0, dt0,
                                    launch_args(route, y0))


def chain_plain(route: Route, P0: torch.Tensor):
    """The plain forward loop from a packed initial state ``P0 [34, B]``,
    returned as ``run_segments`` returns it: one segment at a time, with a
    check for an active ray before each, stopping after a segment that
    leaves none active (the early exit of the JAX ``_ckpt_fwd``); then the
    final state copied into ``ck[n_seg]`` and the end segments read from
    the checkpoints (``end_segments``). It also takes states that K3's
    prologue does not make (rays near their span's end, or inactive from
    the start), for K4's checks on such batches."""
    ck = torch.empty((route.n_seg + 1,) + tuple(P0.shape), dtype=P0.dtype,
                     device=P0.device)
    ck[0] = P0
    s = 0
    while s < route.n_seg and bool(ck[s, P_ACTIVE].any()):
        ck[s + 1] = forward_segment(route, ck[s])
        s += 1
    if s < route.n_seg:
        ck[route.n_seg] = ck[s]
    n_used = torch.full((1,), s, dtype=torch.int32, device=P0.device)
    return ck, torch.cat([n_used, end_segments(ck, s, route.n_seg)])


def end_segments(ck: torch.Tensor, n_used: int, n_seg: int) -> torch.Tensor:
    """Per ray, the first segment at whose start it is inactive (``n_seg``
    where it never is), from checkpoints ``ck[0 .. n_used]`` of the
    per-segment chain: K3's ``used[1:]``."""
    inactive = ck[:n_used + 1, P_ACTIVE] <= 0  # [n_used + 1, B]
    first = inactive.to(torch.int8).argmax(0).to(torch.int32)
    return torch.where(inactive.any(0), first, torch.full_like(first, n_seg))


def read_mask(ends: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``[n_seg + 1, 34, B]`` bool: the values of the checkpoints that their
    readers take, given the rays' end segments: every plane of ray i at
    each segment up to its end (K4's replays; the end's own is its final
    state) and at ``n_seg`` (the forward's result). The kernel route writes
    just these; the plain route writes more."""
    s = torch.arange(n_seg + 1, device=ends.device)[:, None]
    rows = (s <= ends[None, :]) | (s == n_seg)
    return rows[:, None, :].expand(n_seg + 1, N_PLANES, ends.shape[0])


def used_segments(ends: torch.Tensor, n_seg: int) -> int:
    """``n_used`` from the rays' end segments: the segments the chain runs
    stop at the first whose start finds no ray active, so it is the largest
    end segment (at most ``n_seg``; 0 for no rays). K3 computes it on the
    card with one atomicMax per warp."""
    return min(n_seg, int(ends.max())) if ends.numel() else 0


class SortedParts(NamedTuple):
    """A batch run as sorted parts: its rays in ``order`` (by impact
    parameter), cut at ``bounds`` into contiguous parts, each its own
    forward pass (its own checkpoints, stopping with its own slowest ray)
    and backward pass; ``inverse`` puts them back in the caller's order.
    Every ray steps as it would in one pass (rays are independent), and the
    per-ray (M, a) cotangents are summed in the caller's order, so values
    and gradients are bitwise those of one pass. One part is the kernel
    route's ``sort_rays``, several the plain route's ``grad_groups``."""

    order: torch.Tensor
    inverse: torch.Tensor
    bounds: tuple


def sorted_parts(y0: torch.Tensor, n_parts: int) -> SortedParts:
    """``n_parts`` parts of ``y0 [B, 8]`` in impact-parameter order, at the
    JAX package's bounds ``round(p * B / n_parts)``."""
    order, inverse = impact_parameter_order(y0.detach())
    B = y0.shape[0]
    return SortedParts(order, inverse, tuple(round(p * B / n_parts)
                                             for p in range(n_parts + 1)))


class _Checkpointed(torch.autograd.Function):
    """``(y0 [8, B], dt0 [B] or None, pvec [P], route, info, parts) ->
    final state [34, B]``, with the number of segments run in
    ``info["n_used"]`` (a 0-d int32 tensor on the state's device, the most
    of any part): the initial state built from the launch states y0 (K3's
    prologue, ``init_plain``) and the segments run from it. Gradients for
    y0 and for M, a (pvec[0:2]), through the loop and the initial state
    (K4 and K10, ``k4_plain``). The final state's other planes'
    cotangents are dropped (see the module docstring), the first steps
    take none, and the object fields get none. On a grouped route
    ``pvec`` is the ``[G, P]`` table and each group's (M, a) cotangent the
    sum over its rays. ``parts``: None (one pass over the batch as given)
    or the ``SortedParts`` to run it as."""

    @staticmethod
    def forward(ctx, y0, dt0, pvec, route, info, parts):
        y0 = y0.detach()
        dt0 = None if dt0 is None else dt0.detach()
        if parts is not None:
            y0 = y0[:, parts.order]
            dt0 = None if dt0 is None else dt0[parts.order]
        bounds = (0, y0.shape[1]) if parts is None else parts.bounds
        cut = lambda t, lo, hi: (  # noqa: E731
            None if t is None else t[..., lo:hi].contiguous())
        runs = [run_segments(route, cut(y0, lo, hi), cut(dt0, lo, hi))
                for lo, hi in zip(bounds, bounds[1:])]
        info["n_used"] = torch.cat([used[:1] for _, used in runs]).amax()
        ctx.route, ctx.parts, ctx.bounds = route, parts, bounds
        ctx.save_for_backward(*(ck for ck, _ in runs),
                              *(used for _, used in runs))
        ctx.p_shape = pvec.shape
        out = torch.cat([ck[route.n_seg] for ck, _ in runs], dim=1)
        return out if parts is None else out[:, parts.inverse]

    @staticmethod
    def backward(ctx, ct):
        back = backward_cuda if ctx.route.cuda else k4_plain
        parts, bounds = ctx.parts, ctx.bounds
        if parts is not None:
            ct = ct[:, parts.order]
        saved = ctx.saved_tensors
        cks, useds = saved[:len(saved) // 2], saved[len(saved) // 2:]
        res = [back(ctx.route, ck, used[1:], ct[:, lo:hi].contiguous())
               for ck, used, lo, hi in zip(cks, useds, bounds, bounds[1:])]
        ct_y0 = torch.cat([c for c, _ in res], dim=1)
        pbar = torch.cat([p for _, p in res], dim=0)
        if parts is not None:  # (M, a) summed in the caller's order
            ct_y0, pbar = ct_y0[:, parts.inverse], pbar[parts.inverse]
        g = torch.zeros(ctx.p_shape, dtype=ct.dtype, device=ct.device)
        if ctx.route.groups is None:
            g[:2] = torch.sum(pbar, dim=0)
        else:
            g[:, :2] = pbar.reshape(ctx.p_shape[0], -1, 2).sum(dim=1)
        return ct_y0, None, g, None, None, None


class _Localized(torch.autograd.Function):
    """``(P [34, B], rows, route) -> (y [8, B], lam [B])``: the loop's
    result from its packed final state (K6 on the kernel route,
    ``localize_plain`` on the plain one), with the hand-written VJP on
    backward (K7, ``localize_vjp``), which reads the forward's record
    (saved for backward, ``rec_planes`` x B values, ~9 MB at 40,000 f32
    Tsit5 rays) instead of replaying it: gradients for P's y and ev_y0 planes
    (which ``_Checkpointed`` hands to K4) and, per ray, for the parameters
    the epilogue reads, ``rows`` (``ray_params``: the values the route
    holds). Autograd sums the per-ray cotangents into the caller's tensors
    (over the batch for a shared value, over a group's rays for a grouped
    batch's), each together with the other per-ray cotangents that reach
    the same tensor (the shading's)."""

    @staticmethod
    def forward(ctx, P, rows, route):
        P = P.detach().contiguous()
        if route.cuda:
            ctx.args = localize_args(route, P)
            y, lam, rec = localize_cuda(route, P, ctx.args)
        else:
            y, lam, rec = localize_plain(route, P)
        ctx.route = route
        ctx.save_for_backward(P, rec)
        return y, lam

    @staticmethod
    def backward(ctx, ct_y, ct_lam):
        P, rec = ctx.saved_tensors
        route = ctx.route
        if route.cuda:
            ct_P, pbar = localize_vjp_cuda(route, P, ct_y, ct_lam, rec,
                                           ctx.args)
        else:
            ct_P, pbar = localize_vjp(route, P, ct_y, ct_lam, rec)
        return ct_P, pbar, None


def _detached(scene: Scene) -> Scene:
    """The scene's fields without their graph; the kind tensor (ints, with
    its host copy of the kinds) as it is."""
    return scene._replace(**{f: getattr(scene, f).detach()
                             for f in Scene._fields if f != "kind"})


def _first_group(scene: Scene) -> Scene:
    """Group 0's scene of a grouped batch: each field with a leading ray
    axis at its first ray."""
    return scene._replace(**{
        f: getattr(scene, f)[0] for f in Scene._fields
        if f != "kind" and getattr(scene, f).dim() > FIELD_DIMS.get(f, 1)})


def _integrate(metric: Metric, scene: Scene, y0: torch.Tensor,
               dt0: torch.Tensor | None, cfg: IntegratorConfig, seg_len,
               mode: str,
               groups: int | None = None, sort_parts: int | None = None,
               remat: bool = False,
               autograd_epilogue: bool = False) -> TraceResult:
    _check_options(cfg)
    if sort_parts is not None and (groups is not None or sort_parts < 1):
        raise ValueError("sort_parts takes an ungrouped batch and at least "
                         f"one part, got {sort_parts} with groups={groups}")
    seg = segment_length(cfg, seg_len)
    pvec = flatten_params(metric, scene, groups)
    table = None if groups is None else pvec.detach().contiguous()
    row = pvec.detach() if groups is None else table[0]
    detached = Metric(metric.name, KerrSchildParams(M=row[0], a=row[1]),
                      metric.r_formula, metric.rho_min)
    route = Route(metric=detached,
                  scene=_detached(scene if groups is None
                                  else _first_group(scene)),
                  cfg=cfg, seg_len=seg, n_seg=cfg.max_steps // seg,
                  cuda=mode == "cuda", groups=table)
    event_fn = scene_event_cm(scene)
    if mode == "autograd":
        # The initial state under autograd (the oracle of init_vjp).
        init, body = make_step_cm(metric, event_fn, cfg)
        if dt0 is None:
            with torch.no_grad():
                dt0 = initial_dt(metric, y0, cfg)

        def step(s):
            return body(s)[0]

        st, n = init(y0.t(), dt0.detach()), 0
        while n < route.n_seg and bool(st.active.any()):
            for _ in range(seg):
                st = (checkpoint(step, st, use_reentrant=False) if remat
                      else step(st))
            n += 1
        n_used = torch.full((), n, dtype=torch.int32, device=y0.device)
        P = pack_state(st)
    else:
        info = {}
        parts = (None if sort_parts is None
                 else sorted_parts(y0, sort_parts))
        P = _Checkpointed.apply(y0.t(), None if dt0 is None else dt0.detach(),
                                pvec, route, info, parts)
        n_used = info["n_used"]
        st = unpack_state(P)
    if autograd_epilogue:
        # Dead-ray cotangent cutoff: rays killed mid-flight (captured
        # inside stop_rho or failed at dt_min) froze after a capture spiral
        # whose step Jacobians are huge; their y is detached (values
        # unchanged), as in the JAX package. Rays still active at the step
        # budget keep theirs.
        dead = ~st.hit & ~st.active & (st.lam < cfg.lam_max - 1e-6)
        y = torch.where(dead, st.y.detach(), st.y)
        # Every ray is localized, as in the JAX package, and a hit ray's
        # result selected: no host read decides it. A ray that never hit
        # keeps the initial event record (its start, a span of 1), whose
        # localization is finite, so the zero cotangent that the selection
        # gives it stays zero.
        th_star, y_star = localize_events_cm(metric, event_fn, cfg,
                                             st.ev_y0, st.ev_dt, st.ev_lo,
                                             st.ev_hi)
        y = torch.where(st.hit, y_star, y)
        lam = torch.where(st.hit, st.ev_lam + th_star * st.ev_dt, st.lam)
    else:
        # The same epilogue as one function, the dead-ray cutoff in its
        # hand-written VJP (K6 and K7 on the kernel route).
        y, lam = _Localized.apply(P, ray_params(metric, scene, y0.shape[0]),
                                  route)
    return TraceResult(y=y.t(), lam=lam, hit=st.hit,
                       steps=st.steps.to(torch.int32), n_iters=n_used * seg)


def integrate_rays_autograd(metric: Metric, scene: Scene, y0: torch.Tensor,
                            dt0: torch.Tensor | None, cfg: IntegratorConfig,
                            seg_len: int | None = None,
                            groups: int | None = None,
                            remat: bool = False,
                            autograd_epilogue: bool = False) -> TraceResult:
    """The same forward, with ``torch.autograd`` taping every step of the
    plain body: the differentiable path's ``grad_mode="scan"`` (the JAX
    ``integrate_rays_cm_scan``), and the oracle the hand adjoint of the
    loop (``step_vjp``, K4) and of the initial state (``init_vjp``, K10)
    is held against. With ``remat`` each step is
    rematerialized on backward (``torch.utils.checkpoint``, JAX's
    ``remat=True``), so the tape holds one state per step instead of every
    intermediate; the values and gradients are the same. Step sizes stay
    detached either way.

    The epilogue (the dead-ray cutoff and the localization) takes the hand
    VJP of the checkpointed routes (``localize_vjp``), so that this route
    and those differentiate it with the same arithmetic: the localization's
    Jacobian cancels almost exactly in the event's own direction (a hit
    point lies on its surface whatever the parameters), and two correct
    VJPs agree there only to about 1e-9. With ``autograd_epilogue`` torch
    autograd differentiates the epilogue as well (``localize_events_cm``):
    every gradient by autograd, the oracle of the hand VJP."""
    return _integrate(metric, scene, y0, dt0, cfg, seg_len, "autograd",
                      groups, remat=remat,
                      autograd_epilogue=autograd_epilogue)


def integrate_rays_ckpt(metric: Metric, scene: Scene, y0: torch.Tensor,
                        dt0: torch.Tensor | None, cfg: IntegratorConfig,
                        seg_len: int | None = None,
                        groups: int | None = None,
                        sort_parts: int | None = None) -> TraceResult:
    """Differentiable integration, plain version (the JAX
    ``integrate_rays_cm_ckpt``): checkpointed segments of the step body,
    the hand adjoint on backward. ``y0 [B, 8]``, ``dt0 [B]`` or None (each
    ray's own first step, ``initial_dt``); gradients reach y0, M, a and
    (through the localization) the scene, y0 and M, a also through the
    initial state (``init_vjp``). With
    ``groups`` G the batch holds G parameter sets, one per group of
    ``B / G`` consecutive rays: M and a per ray (``[B]``) and the scene's
    fields with a leading ray axis where they differ (``pos [B, N, 4]``),
    each constant within a group; gradients reach every group's. With
    ``sort_parts`` P (an ungrouped batch) the rays are sorted by impact
    parameter and run as P parts, each with its own forward and backward
    pass (``SortedParts``; JAX's ``grad_groups``): the values and gradients
    are bitwise those of one pass."""
    return _integrate(metric, scene, y0, dt0, cfg, seg_len, "plain", groups,
                      sort_parts)


def integrate_rays_ckpt_cuda(metric: Metric, scene: Scene, y0: torch.Tensor,
                             dt0: torch.Tensor | None,
                             cfg: IntegratorConfig,
                             seg_len: int | None = None,
                             groups: int | None = None,
                             sort_parts: int | None = None) -> TraceResult:
    """The same with one K3 launch on forward (the initial state in its
    prologue; with ``dt0=None`` each ray's first step too) and one K4
    launch on backward, then K10 (the initial state's VJP): the JAX
    ``integrate_rays_cm_ckpt_pallas``, a grouped batch in one launch of
    each. ``sort_parts=1`` launches the batch in
    impact-parameter order (the JAX route's ``sort_rays``), with results
    and gradients bitwise those unsorted. Raises for CPU tensors and for
    what the kernels do not take."""
    return _integrate(metric, scene, y0, dt0, cfg, seg_len, "cuda", groups,
                      sort_parts)
