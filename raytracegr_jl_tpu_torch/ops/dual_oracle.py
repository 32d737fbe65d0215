"""An end-to-end pixel-gradient oracle in Dual arithmetic (counterpart of
raytracegr_jl_tpu/ops/dual_oracle.py).

A complete forward-sensitivity render, written entirely in the hand-rolled
forward mode of ops/dual.py with a width-1 tangent: the camera's null
rays, fixed-step RK4 geodesic integration, in-step event localization with
the Newton polish of the differentiable path, and the reference's hard
shading. The tangent carries d/dM or d/d(a sphere's centre component).
No ``torch.autograd``, no ``torch.func`` and no derivative module of the
port (ops/geometry.py's ``dmetric``, ops/geodesic_cm.py's Kerr-Schild
parts, ops/adjoint.py) appears below: agreement with the gradients of the
training path (the plain checkpointed adjoint, K3 and K4 on the card, the
row-major route) is a check between independent differentiations.

Scope: the rk4 differentiable configuration (``default_inverse_cfg(...,
method="rk4")``) on Kerr-Schild scenes of spheres and planes. The metric's
coordinate partials are closed-form algebra in (x, M) that the Dual rules
push the tangent through, so no nested differentiation is needed.

Layout: the ray state is a list of 8 scalar Duals of batch shape [B],
each with a width-1 eps. The scene's fields are read to the host once per
render (``host_scene``); every other tensor stays on the device of the
pixel batch, and no loop of the oracle reads a tensor back.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

from . import dual as du
from .dual import Dual, clamp_min, clip_dual, mod1, sqrt, where_dual
from .metrics import R_AS_WRITTEN, R_TEXTBOOK

KIND_SPHERE = 0
KIND_PLANE = 1
ETA = (-1.0, 1.0, 1.0, 1.0)


class HostScene(NamedTuple):
    """A scene's object rows as host values (sphere and plane fields)."""

    kind: List[int]
    pos: List[List[float]]
    radius: List[float]
    time: List[float]


def host_scene(scene) -> HostScene:
    """The scene's fields as Python lists: one device-to-host copy per
    field, made once per render so that the loops below issue none."""
    if isinstance(scene, HostScene):
        return scene
    return HostScene([int(k) for k in scene.kind.tolist()],
                     scene.pos.tolist(), scene.radius.tolist(),
                     scene.time.tolist())


# ---------------------------------------------------------------------------
# Kerr-Schild metric and its analytic coordinate partials on Duals: the
# algebra of metrics.kerr_schild and kerr_schild_radius_partials, written
# again here so that the oracle shares no derivative code with the port.
# ---------------------------------------------------------------------------

def _radius_partials_dual(rho2: Dual, z: Dual, a: float, r_formula: str,
                          rho_min: float):
    """(r, dr/du, dr/dw) with u = rho2 and w the explicit z-dependence."""
    half = (rho2 - a * a) / 2.0
    inner = sqrt(half * half + (a * a) * (z * z))
    if r_formula == R_AS_WRITTEN:
        inv_inner = 1.0 / inner
        s = sqrt(rho2 - a * a)
        r = s / 2.0 + inner
        dr_du = 0.25 / s + (0.5 * half) * inv_inner
        dr_dw = (a * a) * z * inv_inner
    elif r_formula == R_TEXTBOOK:
        if rho_min > 0.0:
            eps2 = rho_min * rho_min
            inner = clamp_min(inner, eps2 / 2.0)
            r = sqrt(clamp_min(half + inner, eps2))
        else:
            r = sqrt(half + inner)
        inv_inner = 1.0 / inner
        inv_2r = 0.5 / r
        dr_du = (0.5 + 0.5 * half * inv_inner) * inv_2r
        dr_dw = ((a * a) * z * inv_inner) * inv_2r
    else:
        raise ValueError(f"unknown r_formula: {r_formula!r}")
    return r, dr_du, dr_dw


def _clamped_rho2_dual(rho2_raw: Dual, a: float, rho_min: float,
                       r_formula: str) -> Dual:
    eps2 = rho_min * rho_min
    floor = a * a + eps2 if r_formula == R_AS_WRITTEN else eps2
    return clamp_min(rho2_raw, floor)


def ks_g_dual(xl, M: Dual, a: float, r_formula: str, rho_min: float):
    """g_ab as a 4x4 nested list of Duals; ``xl``: 4 coordinate Duals
    [B]."""
    xs, ys, zs = xl[1], xl[2], xl[3]
    rho2 = _clamped_rho2_dual(xs * xs + ys * ys + zs * zs, a, rho_min,
                              r_formula)
    r, _, _ = _radius_partials_dual(rho2, zs, a, r_formula, rho_min)
    r2 = r * r
    f = (2.0 * M) * (r * r2) / (r2 * r2 + (a * a) * (zs * zs))
    denom = r2 + a * a
    one = du.lift(1.0, r)
    k = [one, (r * xs + a * ys) / denom, (r * ys - a * xs) / denom, zs / r]
    fk = [f * ki for ki in k]
    return [[fk[i] * k[j] + (ETA[i] if i == j else 0.0) for j in range(4)]
            for i in range(4)]


def ks_g_dg_dual(xl, M: Dual, a: float, r_formula: str, rho_min: float):
    """(g, dg) with dg[c][i][j] = d_c g_ij, all Duals; dg[0] holds literal
    zeros (a stationary metric)."""
    xs, ys, zs = xl[1], xl[2], xl[3]
    rho2_raw = xs * xs + ys * ys + zs * zs
    rho2 = _clamped_rho2_dual(rho2_raw, a, rho_min, r_formula)
    live = rho2_raw.val >= rho2.val  # clamped points: d(rho2)/dx = 0
    r, dr_du, dr_dw = _radius_partials_dual(rho2, zs, a, r_formula, rho_min)
    r2 = r * r
    q = r2 * r2 + (a * a) * (zs * zs)
    inv_q = 1.0 / q
    f = (2.0 * M) * (r * r2) * inv_q
    df_dr = (2.0 * M) * r2 * ((3.0 * a * a) * (zs * zs) - r2 * r2) \
        * inv_q * inv_q
    df_dw = (-4.0 * M) * (r * r2) * (a * a) * zs * inv_q * inv_q
    denom = r2 + a * a
    inv_denom = 1.0 / denom
    inv_r = 1.0 / r
    one = du.lift(1.0, r)
    zero = du.lift(0.0, r)
    k1 = (r * xs + a * ys) * inv_denom
    k2 = (r * ys - a * xs) * inv_denom
    k3 = zs * inv_r
    k = [one, k1, k2, k3]
    fk = [f * ki for ki in k]
    g = [[fk[i] * k[j] + (ETA[i] if i == j else 0.0) for j in range(4)]
         for i in range(4)]

    duu = [where_dual(live, 2.0 * xs, zero),
           where_dual(live, 2.0 * ys, zero),
           where_dual(live, 2.0 * zs, zero)]
    dg = [[[0.0] * 4 for _ in range(4)]]
    for ci, c in enumerate((1, 2, 3)):
        r_c = dr_du * duu[ci] + (dr_dw if c == 3 else zero)
        f_c = df_dr * r_c + (df_dw if c == 3 else zero)
        two_r_rc = (2.0 * r) * r_c
        dk1 = (xs * r_c + (r if c == 1 else (du.lift(a, r) if c == 2
                                             else zero))
               - k1 * two_r_rc) * inv_denom
        dk2 = (ys * r_c + (r if c == 2 else (du.lift(-a, r) if c == 1
                                             else zero))
               - k2 * two_r_rc) * inv_denom
        dk3 = ((one if c == 3 else zero) - k3 * r_c) * inv_r
        dk = [zero, dk1, dk2, dk3]
        B = [(0.5 * f_c) * k[i] + f * dk[i] for i in range(4)]
        dgc = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for j in range(i, 4):
                v = B[i] * k[j] + k[i] * B[j]
                dgc[i][j] = dgc[j][i] = v
        dg.append(dgc)
    return g, dg


def ks_gu_dual(g_list, xl, M: Dual, a: float, r_formula: str,
               rho_min: float):
    """The Sherman-Morrison inverse of g = eta + f k k^T on Duals (no
    determinant clamp: the oracle runs on live states, where 1 + f kappa
    ~ 1)."""
    xs, ys, zs = xl[1], xl[2], xl[3]
    rho2 = _clamped_rho2_dual(xs * xs + ys * ys + zs * zs, a, rho_min,
                              r_formula)
    r, _, _ = _radius_partials_dual(rho2, zs, a, r_formula, rho_min)
    r2 = r * r
    f = (2.0 * M) * (r * r2) / (r2 * r2 + (a * a) * (zs * zs))
    denom = r2 + a * a
    one = du.lift(1.0, r)
    k = [one, (r * xs + a * ys) / denom, (r * ys - a * xs) / denom, zs / r]
    kappa = -(k[0] * k[0]) + k[1] * k[1] + k[2] * k[2] + k[3] * k[3]
    coef = f / (1.0 + f * kappa)
    ku = [-k[0], k[1], k[2], k[3]]
    gu = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            v = -(coef * ku[i] * ku[j]) + (ETA[i] if i == j else 0.0)
            gu[i][j] = gu[j][i] = v
    return gu


def geodesic_rhs_dual(y, M: Dual, a: float, r_formula: str, rho_min: float):
    """The geodesic right-hand side, 8 Duals -> 8 Duals:

        udot^a = -sum_d gu[a][d] * A_d,
        A_d = u^b u^c d_c g_db - (1/2) u^b u^c d_d g_bc

    (the contraction of the component-major right-hand side, algebraically
    the row-major path's -Gamma u u)."""
    xl, ul = y[:4], y[4:]
    g, dg = ks_g_dg_dual(xl, M, a, r_formula, rho_min)
    gu = ks_gu_dual(g, xl, M, a, r_formula, rho_min)
    zero = du.lift(0.0, xl[0])

    def dsum(terms):
        acc = None
        for t in terms:
            acc = t if acc is None else acc + t
        return acc if acc is not None else zero

    # S[c][d] = sum_b d_c g_db u^b (the c = 0 row is identically zero)
    S = [[zero] * 4] + [
        [dsum([dg[c][d][b] * ul[b] for b in range(4)]) for d in range(4)]
        for c in (1, 2, 3)]
    A = []
    for d in range(4):
        t1 = dsum([ul[c] * S[c][d] for c in (1, 2, 3)])
        t2 = dsum([ul[b] * S[d][b] for b in range(4)]) if d > 0 else zero
        A.append(t1 - 0.5 * t2)
    udot = [-dsum([gu[a_][d] * A[d] for d in range(4)]) for a_ in range(4)]
    return list(ul) + udot


# ---------------------------------------------------------------------------
# Scene: signed distances and hard shading on Duals (models/objects.py's
# KIND_* semantics).
# ---------------------------------------------------------------------------

def _default_cget(scene, like: Dual):
    """Centre accessor ``cget(i, comp) -> Dual``: object i's position
    component with zero tangent. ``render_dual_sensitivity(wrt=("pos", i,
    comp))`` gives one entry a unit tangent to carry a pose
    sensitivity."""
    pos = host_scene(scene).pos

    def cget(i, comp):
        return du.lift(pos[i][comp], like)

    return cget


def _object_distance_dual(scene, i: int, xl, cget):
    """Signed distance of object i at the position Duals ``xl`` (spheres and
    planes, the shapes of the reference's scenes)."""
    hs = host_scene(scene)
    kind = hs.kind[i]
    if kind == KIND_SPHERE:  # quadratic, sign flipped by a negative radius
        radius = hs.radius[i]
        dx = xl[1] - cget(i, 1)
        dy = xl[2] - cget(i, 2)
        dz = xl[3] - cget(i, 3)
        sgn = 1.0 if radius >= 0 else -1.0
        return sgn * (dx * dx + dy * dy + dz * dz - radius * radius)
    if kind == KIND_PLANE:  # d = t - time
        return xl[0] - hs.time[i]
    raise NotImplementedError(f"oracle: unsupported kind {kind}")


def _min_distance_dual(scene, xl, cget):
    """(min distance Dual, argmin [B], all distances): the first index wins
    ties, as in objects.min_distance and shade."""
    n = len(host_scene(scene).kind)
    ds = [_object_distance_dual(scene, i, xl, cget) for i in range(n)]
    best = ds[0]
    arg = torch.zeros_like(best.val, dtype=torch.int32)
    for i in range(1, n):
        better = ds[i].val < best.val  # strict: the earlier index wins ties
        best = where_dual(better, ds[i], best)
        arg = torch.where(better, i, arg).to(torch.int32)
    return best, arg, ds


def _event_grad_dual(scene, arg, xl, cget):
    """d(min distance)/d(x^a) of the argmin object, as 4 Duals (the
    directional-derivative factor of the Newton polish)."""
    hs = host_scene(scene)
    zero = du.lift(0.0, xl[0])
    grads = [zero, zero, zero, zero]
    for i, kind in enumerate(hs.kind):
        sel = arg == i
        if kind == KIND_SPHERE:
            sgn = 1.0 if hs.radius[i] >= 0 else -1.0
            for a_ in (1, 2, 3):
                grads[a_] = where_dual(
                    sel, (2.0 * sgn) * (xl[a_] - cget(i, a_)), grads[a_])
        elif kind == KIND_PLANE:
            grads[0] = where_dual(sel, du.lift(1.0, xl[0]), grads[0])
    return grads


def shade_dual(scene, xl, hit_dmin: float = 0.01, freq: float = 12.0,
               cget=None):
    """The reference's hard shading (objects.shade) on Duals: a list of 3
    rgb Duals."""
    hs = host_scene(scene)
    n = len(hs.kind)
    if cget is None:
        cget = _default_cget(hs, xl[0])
    dmin, arg, ds = _min_distance_dual(hs, xl, cget)
    hit_any = dmin.val < hit_dmin
    zero = du.lift(0.0, xl[0])
    one = du.lift(1.0, xl[0])

    rgb = [zero, zero, zero]
    for i, kind in enumerate(hs.kind):
        sel = hit_any & (arg == i)
        if kind == KIND_SPHERE:
            xx = xl[1] - cget(i, 1)
            yy = xl[2] - cget(i, 2)
            zz = xl[3] - cget(i, 3)
            r = sqrt(xx * xx + yy * yy + zz * zz)
            rsafe = where_dual(r.val == 0.0, one, r)
            theta = du.acos(clip_dual(zz / rsafe, -1.0, 1.0))
            # The correct atan2 rule (the render path never meets the
            # reference's wrong one).
            phi = du.atan2(yy, xx)
            col = [mod1((freq / math.pi) * theta),
                   mod1((freq / math.pi) * phi), one]
        elif kind == KIND_PLANE:
            col = [zero, du.lift(0.5, xl[0]), zero]
        else:
            raise NotImplementedError(f"oracle: unsupported kind {kind}")
        dim = (i + 1) / n
        for ch in range(3):
            rgb[ch] = where_dual(sel, dim * col[ch], rgb[ch])
    # a miss is red (1, 0, 0), with zero tangent
    rgb[0] = where_dual(hit_any, rgb[0], one)
    return rgb


# ---------------------------------------------------------------------------
# Integration: fixed-step RK4 with the differentiable path's in-step event
# localization.
# ---------------------------------------------------------------------------

def _ladd(a, b):
    return [x + y for x, y in zip(a, b)]


def _lscale(c, a):
    return [c * x for x in a]


def _lwhere(mask, a, b):
    return [where_dual(mask, x, y) for x, y in zip(a, b)]


def _hermite_dual(y0, y1, f0, f1, dt: float, th):
    """Cubic Hermite dense output on Duals; ``th`` a Dual or a float."""
    if not isinstance(th, Dual):
        th = du.lift(th, y0[0])
    out = []
    for i in range(8):
        p = (1.0 - 2.0 * th) * (y1[i] - y0[i]) \
            + (th - 1.0) * (dt * f0[i]) + th * (dt * f1[i])
        out.append((1.0 - th) * y0[i] + th * y1[i] + (th * (th - 1.0)) * p)
    return out


def _hermite_dth_dual(y0, y1, f0, f1, dt: float, th):
    """d/d(theta) of the Hermite interpolant on Duals (the polynomial's
    derivative written out)."""
    if not isinstance(th, Dual):
        th = du.lift(th, y0[0])
    out = []
    for i in range(8):
        delta = y1[i] - y0[i]
        p = (1.0 - 2.0 * th) * delta + (th - 1.0) * (dt * f0[i]) \
            + th * (dt * f1[i])
        dp = -2.0 * delta + dt * f0[i] + dt * f1[i]
        out.append(delta + (2.0 * th - 1.0) * p + (th * (th - 1.0)) * dp)
    return out


def _locate_event_dual(scene, y0, y1, f0, f1, dt: float, interp_points: int,
                       bisect_iters: int, cget=None):
    """The differentiable path's event localization (RK4, Hermite) on
    Duals: the bracketing and bisection on primals (the path stops their
    gradient too), then the Newton polish in Dual arithmetic. Returns
    (crossed [B], y_star: 8 Duals)."""
    hs = host_scene(scene)
    B = y0[0].val.shape[0]
    dtype, device = y0[0].val.dtype, y0[0].val.device
    npts = interp_points
    thetas = torch.arange(1, npts + 1, dtype=dtype, device=device) / npts
    if cget is None:
        cget = _default_cget(hs, y0[0])

    y0v = [c.val for c in y0]
    y1v = [c.val for c in y1]
    f0v = [c.val for c in f0]
    f1v = [c.val for c in f1]

    def interp_v(th):
        out = []
        for i in range(8):
            p = (1 - 2 * th) * (y1v[i] - y0v[i]) \
                + (th - 1) * (dt * f0v[i]) + th * (dt * f1v[i])
            out.append((1 - th) * y0v[i] + th * y1v[i] + th * (th - 1) * p)
        return out

    def event_v(xs):
        dmin = None
        for i, kind in enumerate(hs.kind):
            if kind == KIND_SPHERE:
                c = hs.pos[i]
                radius = hs.radius[i]
                sgn = 1.0 if radius >= 0 else -1.0
                d = sgn * ((xs[1] - c[1]) ** 2 + (xs[2] - c[2]) ** 2
                           + (xs[3] - c[3]) ** 2 - radius * radius)
            else:
                d = xs[0] - hs.time[i]
            dmin = d if dmin is None else torch.minimum(dmin, d)
        return dmin

    d_prev = event_v(y0v)
    d_samples = torch.stack([event_v(interp_v(thetas[j].expand(B)))
                             for j in range(npts)])  # [npts, B]
    neg = d_samples <= 0.0
    any_neg = neg.any(0)
    first = torch.argmax(neg.to(torch.uint8), 0)  # the first sample that is
    th_hi = thetas[first]
    th_lo = torch.where(first == 0, torch.zeros_like(th_hi),
                        thetas[(first - 1).clamp_min(0)])
    crossed = any_neg & (d_prev > 0.0)

    lo, hi = th_lo, th_hi
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        d_mid = event_v(interp_v(mid))
        lo = torch.where(d_mid > 0.0, mid, lo)
        hi = torch.where(d_mid > 0.0, hi, mid)

    # The Newton polish: th0 is a primal constant; the correction
    # -val/dval carries the sensitivity of the crossing (d/dM and, through
    # cget, d/d(object pose)).
    th0 = du.constant(hi, y0[0].eps.shape[-1])
    H0 = _hermite_dual(y0, y1, f0, f1, dt, th0)
    val, argmin, _ = _min_distance_dual(hs, H0[:4], cget)
    egrad = _event_grad_dual(hs, argmin, H0[:4], cget)
    Hp = _hermite_dth_dual(y0, y1, f0, f1, dt, th0)
    dval = egrad[0] * Hp[0]
    for a_ in range(1, 4):
        dval = dval + egrad[a_] * Hp[a_]
    ok = torch.abs(dval.val) > 1e-3 * (1.0 + torch.abs(val.val))
    delta = where_dual(ok, val, 0.0) / where_dual(ok, dval, 1.0)
    th_star = clip_dual(th0 - clip_dual(delta, -1.0, 1.0), 0.0, 1.0)
    y_star = _hermite_dual(y0, y1, f0, f1, dt, th_star)
    return crossed, y_star


def render_dual_dM(scene, xg, ng, M0, a=0.0, **kw):
    """End-to-end render and d/dM (see ``render_dual_sensitivity``)."""
    return render_dual_sensitivity(scene, xg, ng, M0, a, wrt="M", **kw)


def render_dual_sensitivity(scene, xg: torch.Tensor, ng: torch.Tensor,
                            M0: float, a: float = 0.0, *, wrt="M",
                            r_formula: str = R_AS_WRITTEN,
                            rho_min: float = 1e-3, rk4_dt: float = 0.25,
                            n_steps: int = 32, interp_points: int = 4,
                            bisect_iters: int = 20, hit_dmin: float = 0.01):
    """End-to-end render and d/d(param), entirely in Dual arithmetic.

    Follows ``grad.make_ray_render_for_params`` on the rk4 configuration:
    ``pixel_rays`` (the metric-dependent null normalization), RK4 with
    in-step event localization, the reference's hard shading. ``xg``,
    ``ng``: the pixel batch ``[B, 4]`` (``flat_pixel_grid``) on any
    device; ``scene``: a ``Scene`` on any device.

    ``wrt``: ``"M"`` (the black-hole mass) or ``("pos", i, comp)``,
    component ``comp`` (1..3) of object ``i``'s centre, which flows
    through the termination (the Newton polish), the which-object
    boundaries and the checker angles: the pose path of
    ``InverseParams.sphere_pos``.

    Returns ``(rgb [B, 3], drgb_dparam [B, 3])`` on the pixel batch's
    device.
    """
    hs = host_scene(scene)
    B = xg.shape[0]
    dtype, device = xg.dtype, xg.device
    m_tan = 1.0 if wrt == "M" else 0.0
    M = Dual(torch.full((B,), float(M0), dtype=dtype, device=device),
             torch.full((B, 1), m_tan, dtype=dtype, device=device))

    def const(v):
        return du.constant(v.to(dtype).expand(B), 1)

    if wrt == "M":
        cget = _default_cget(hs, M)
    else:
        tag, obj_i, obj_c = wrt
        if tag != "pos" or obj_c not in (1, 2, 3):
            raise ValueError(f"wrt must be 'M' or ('pos', i, 1..3): {wrt!r}")
        base = _default_cget(hs, M)

        def cget(i, comp):
            c = base(i, comp)
            if i == obj_i and comp == obj_c:
                return Dual(c.val, torch.ones_like(c.eps))
            return c

    # The camera: pixel_rays on Duals.
    xpix = [const(xg[:, i]) for i in range(4)]
    nvec = [const(ng[:, i]) for i in range(4)]
    g = ks_g_dual(xpix, M, a, r_formula, rho_min)
    gu = ks_gu_dual(g, xpix, M, a, r_formula, rho_min)
    t = [gu[i][0] for i in range(4)]

    def quad(v, w):
        acc = None
        for i in range(4):
            for j in range(4):
                term = v[i] * g[i][j] * w[j]
                acc = term if acc is None else acc + term
        return acc

    t2 = quad(t, t)
    n2 = quad(nvec, nvec)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    that = [ti / sqrt(-t2) for ti in t]
    nhat = [ni / sqrt(n2) for ni in nvec]
    u = [inv_sqrt2 * (a_ + b_) for a_, b_ in zip(that, nhat)]

    y = xpix + u

    def rhs(yy):
        return geodesic_rhs_dual(yy, M, a, r_formula, rho_min)

    k1 = rhs(y)
    active = torch.ones((B,), dtype=torch.bool, device=device)

    for _ in range(n_steps):
        # The RK4 step (integrate.rk4_step).
        k2 = rhs(_ladd(y, _lscale(0.5 * rk4_dt, k1)))
        k3 = rhs(_ladd(y, _lscale(0.5 * rk4_dt, k2)))
        k4 = rhs(_ladd(y, _lscale(rk4_dt, k3)))
        incr = _ladd(_ladd(k1, _lscale(2.0, k2)),
                     _ladd(_lscale(2.0, k3), k4))
        y_new = _ladd(y, _lscale(rk4_dt / 6.0, incr))
        k_last = rhs(y_new)

        crossed, y_star = _locate_event_dual(
            hs, y, y_new, k1, k_last, rk4_dt, interp_points, bisect_iters,
            cget=cget)
        hit_now = active & crossed
        y_acc = _lwhere(hit_now, y_star, y_new)
        y = _lwhere(active, y_acc, y)
        k1 = _lwhere(active, k_last, k1)
        active = active & ~hit_now

    rgb = shade_dual(hs, y[:4], hit_dmin, cget=cget)
    rgb_val = torch.stack([c.val for c in rgb], -1)
    rgb_dp = torch.stack([c.eps[..., 0] for c in rgb], -1)
    return rgb_val, rgb_dp
