"""Geometry in PyTorch (counterpart of raytracegr_jl_tpu/ops/geometry.py):
the dtype-aware sanitization bounds of every right-hand-side evaluation,
the closed-form 4x4 inverse, and the generic-metric route of the
row-major integrator: the metric's coordinate derivative (``dmetric``,
by automatic differentiation in one evaluation of the metric), the
Christoffel symbols and the geodesic right-hand side for any metric
written as a function of torch ops.

The JAX functions take one event ``x [4]`` and are batched with
``jax.vmap``; these take ``[..., 4]`` (or ``[..., 8]``) directly. A metric
must then be pointwise over the leading axes (each ``g[i]`` a function of
``x[i]`` alone), as every metric of the package is."""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .metrics import D

MetricFn = Callable[[torch.Tensor], torch.Tensor]

# State and RHS magnitude bounds (derivation in the JAX package's
# ops/geometry.py): they only bite for garbage states of dying rays and keep
# every intermediate finite, in f32 as in f64.
STATE_CLAMP = 1e4
RHS_CLAMP = 1e15
STATE_CLAMP_F32 = 128.0
RHS_CLAMP_F32 = 1e9


def is_narrow(dtype: torch.dtype) -> bool:
    """True for 32-bit (and narrower) floats, which take the tight bounds."""
    return torch.finfo(dtype).bits <= 32


def sanitize_bounds(dtype: torch.dtype) -> Tuple[float, float]:
    """(state_clamp, rhs_clamp) for the compute dtype."""
    if is_narrow(dtype):
        return STATE_CLAMP_F32, RHS_CLAMP_F32
    return STATE_CLAMP, RHS_CLAMP


def det_min(dtype: torch.dtype) -> float:
    """|det| floor of the metric inverses: 1e-4 in f32, 1e-12 in f64."""
    return 1e-4 if is_narrow(dtype) else 1e-12


def clamp_det(d: torch.Tensor) -> torch.Tensor:
    """Push ``d`` away from 0 by ``det_min``, keeping its sign."""
    m = det_min(d.dtype)
    return torch.where(d < 0, torch.clamp_max(d, -m), torch.clamp_min(d, m))


def det3(m, r: int, c: int):
    """The determinant of the 3x3 minor of the entries ``m[a][b]`` without
    row r and column c (csrc/camera_common.cuh det3 alike)."""
    rs = [i for i in range(4) if i != r]
    cs = [j for j in range(4) if j != c]
    a, b, c0 = m[rs[0]][cs[0]], m[rs[0]][cs[1]], m[rs[0]][cs[2]]
    d, e, f = m[rs[1]][cs[0]], m[rs[1]][cs[1]], m[rs[1]][cs[2]]
    g_, h, i = m[rs[2]][cs[0]], m[rs[2]][cs[1]], m[rs[2]][cs[2]]
    return (a * (e * i - f * h) - b * (d * i - f * g_)
            + c0 * (d * h - e * g_))


def inv4(g: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of 4x4 matrices, batched: ``[..., 4, 4]``
    (adjugate over a clamped determinant)."""
    m = [[g[..., a, b] for b in range(4)] for a in range(4)]
    cof = [[((-1) ** (a + b)) * det3(m, a, b) for b in range(4)]
           for a in range(4)]
    det = sum(m[0][c] * cof[0][c] for c in range(4))
    inv_det = 1.0 / clamp_det(det)
    rows = [torch.stack([cof[b][a] * inv_det for b in range(4)], dim=-1)
            for a in range(4)]
    return torch.stack(rows, dim=-2)


def inv4_column0(m):
    """Column 0 of ``inv4`` from the entries ``m[a][b]`` (tensors of one
    shape), as a list of four: row 0's cofactors over the clamped
    determinant, the same expressions as ``inv4``'s, so the same bits,
    without the other twelve cofactors."""
    cof = [((-1) ** c) * det3(m, 0, c) for c in range(4)]
    det = sum(m[0][c] * cof[c] for c in range(4))
    inv_det = 1.0 / clamp_det(det)
    return [cof[c] * inv_det for c in range(4)]


def dmetric(metric: MetricFn, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Metric and its coordinate derivative: ``g [..., 4, 4]`` and
    ``dg [..., 4, 4, 4]`` with ``dg[..., a, b, c] = d_c g_ab``, from one
    evaluation of the metric on four stacked copies of ``x``, copy c
    differentiated along e_c (the JAX package's ``_value_and_jacfwd``, a
    jvp per basis vector sharing one pass). The jvps come from two
    vector-Jacobian products (``torch.func.vjp``): ``u(w) = J^T w`` is
    linear in ``w``, so its vjp with e_c is ``J e_c``. Forward mode
    (``torch.func.jvp``) gives the same numbers, but PyTorch gives the
    tangent of every constant operand as a ZeroTensor, whose operations
    run through Python meta functions: twice as slow for Kerr-Schild.
    ``torch.func`` works on its own level of the graph, so the cost does
    not grow with the history of ``x``, and reverse mode runs through the
    result where gradients are enabled."""
    stacked = (x.shape[-1],) + x.shape
    g, pull = torch.func.vjp(metric, x.expand(stacked))
    _, pull_w = torch.func.vjp(lambda w: pull(w)[0], torch.zeros_like(g))
    basis = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    (dg,) = pull_w(basis.reshape(stacked[:1] + (1,) * (x.dim() - 1)
                                 + stacked[-1:]).expand(stacked))
    return g[0], dg.movedim(0, -1)


def christoffel(metric: MetricFn, x: torch.Tensor) -> torch.Tensor:
    """Christoffel symbols of the second kind, ``Gamma^a_bc`` ``[..., 4, 4,
    4]``: ``(dg[a,b,c] + dg[a,c,b] - dg[b,c,a]) / 2`` raised with ``inv4``."""
    g, dg = dmetric(metric, x)
    gu = inv4(g)
    gamma_l = (dg + dg.transpose(-1, -2) - dg.movedim(-1, -3)) / 2
    return torch.einsum("...ad,...dbc->...abc", gu, gamma_l)


class Ray(NamedTuple):
    """Ray state: position x^a and 4-velocity u^a."""

    x: torch.Tensor  # [..., 4]
    u: torch.Tensor  # [..., 4]


def r2s(r: Ray) -> torch.Tensor:
    """Pack a Ray into a flat state ``[..., 8]``."""
    return torch.cat([r.x, r.u], dim=-1)


def s2r(s: torch.Tensor) -> Ray:
    """Unpack a flat state ``[..., 8]`` into a Ray."""
    return Ray(x=s[..., :D], u=s[..., D:])


def geodesic(s: torch.Tensor, metric: MetricFn) -> torch.Tensor:
    """Geodesic right-hand side on flat states ``[..., 8]``: dx/dl = u,
    du/dl = -Gamma u u."""
    x, u = s[..., :D], s[..., D:]
    gamma = christoffel(metric, x)
    udot = -torch.einsum("...abc,...b,...c->...a", gamma, u, u)
    return torch.cat([u, udot], dim=-1)


def geodesic_batched(metric: MetricFn) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """The right-hand side over a ray batch, ``[B, 8] -> [B, 8]``
    (``geodesic`` is batched already; the JAX package vmaps its own)."""
    return lambda s: geodesic(s, metric)
