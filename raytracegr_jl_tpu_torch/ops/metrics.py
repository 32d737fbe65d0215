"""Spacetime metrics in PyTorch (counterpart of raytracegr_jl_tpu/ops/metrics.py).

Row-major point functions ``[..., 4] -> [..., 4, 4]`` for the camera, plus
the shared Kerr-Schild radius helpers that the component-major right-hand
side (ops/geodesic_cm.py) and the CUDA kernel (csrc/geodesic.cu) follow
operation by operation.

A metric is a ``Metric`` value (name, parameters, radius formula, clamp)
that is also callable as ``x -> g``: the kernel wrapper reads its fields,
the camera calls it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

D = 4  # spacetime dimension

R_AS_WRITTEN = "as_written"
R_TEXTBOOK = "textbook"

_ETA_DIAG = (-1.0, 1.0, 1.0, 1.0)


class KerrSchildParams(NamedTuple):
    """Physics parameters of the Kerr-Schild metric."""

    M: float = 1.0  # black-hole mass
    a: float = 0.0  # spin parameter (J/M)


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A parameter as a 0-d tensor of ``like``'s dtype, so that products of
    parameters round in the working dtype (as JAX's typed scalars do)."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def eta(dtype=torch.float64, device=None) -> torch.Tensor:
    """Minkowski eta_ab = diag(-1, 1, 1, 1), made on the device (no copy
    from the host, so a CUDA graph can hold it)."""
    time_axis = (torch.arange(D, device=device) == 0).to(dtype)
    return torch.diag(1.0 - 2.0 * time_axis)


def minkowski(x: torch.Tensor) -> torch.Tensor:
    """Minkowski metric, ``[..., 4] -> [..., 4, 4]``."""
    return eta(x.dtype, x.device).expand(x.shape[:-1] + (D, D))


def clamped_rho2(rho2_raw: torch.Tensor, a, rho_min: float,
                 r_formula: str = R_AS_WRITTEN) -> torch.Tensor:
    """Singularity-clamped coordinate radius squared.

    ``as_written`` floors at ``a^2 + rho_min^2`` (its radius takes
    ``sqrt(rho2 - a^2)``); ``textbook`` at ``rho_min^2``."""
    eps2 = rho_min * rho_min
    if r_formula == R_AS_WRITTEN:
        return torch.maximum(rho2_raw, a * a + eps2)
    return torch.clamp_min(rho2_raw, eps2)


def kerr_schild_radius(rho2: torch.Tensor, z: torch.Tensor, a, *,
                       r_formula: str = R_AS_WRITTEN,
                       rho_min: float = 0.0) -> torch.Tensor:
    """Boyer-Lindquist-like radius r(x). ``as_written`` is the reference's
    formula with the outer sqrt misplaced; ``textbook`` the standard one,
    floored at ``rho_min`` away from the ring singularity. ``rho2`` must come
    from ``clamped_rho2``."""
    half = (rho2 - a * a) / 2
    inner = torch.sqrt(a * a * z * z + half * half)
    if r_formula == R_AS_WRITTEN:
        return torch.sqrt(rho2 - a * a) / 2 + inner
    if r_formula == R_TEXTBOOK:
        if rho_min > 0.0:
            eps2 = rho_min * rho_min
            inner = torch.clamp_min(inner, eps2 / 2)
            return torch.sqrt(torch.clamp_min(half + inner, eps2))
        return torch.sqrt(half + inner)
    raise ValueError(f"unknown r_formula: {r_formula!r}")


def kerr_schild_radius_partials(rho2: torch.Tensor, z: torch.Tensor, a, *,
                                r_formula: str = R_AS_WRITTEN,
                                rho_min: float = 0.0):
    """``(r, dr/du, dr/dw)`` with u = rho2 and w the explicit z-dependence,
    for the hand-derived metric tangents of the right-hand side."""
    half = (rho2 - a * a) / 2
    inner = torch.sqrt(a * a * z * z + half * half)
    if r_formula == R_AS_WRITTEN:
        inv_inner = 1.0 / inner
        s = torch.sqrt(rho2 - a * a)
        r = s / 2 + inner
        dr_du = 0.25 / s + 0.5 * half * inv_inner
        dr_dw = a * a * z * inv_inner
    elif r_formula == R_TEXTBOOK:
        if rho_min > 0.0:
            eps2 = rho_min * rho_min
            inner = torch.clamp_min(inner, eps2 / 2)
            r = torch.sqrt(torch.clamp_min(half + inner, eps2))
        else:
            r = torch.sqrt(half + inner)
        inv_inner = 1.0 / inner
        inv_2r = 0.5 / r
        dr_du = (0.5 + 0.5 * half * inv_inner) * inv_2r
        dr_dw = (a * a * z * inv_inner) * inv_2r
    else:
        raise ValueError(f"unknown r_formula: {r_formula!r}")
    return r, dr_du, dr_dw


def kerr_schild(x: torch.Tensor,
                params: KerrSchildParams = KerrSchildParams(), *,
                r_formula: str = R_AS_WRITTEN,
                rho_min: float = 1e-3) -> torch.Tensor:
    """Kerr-Schild metric g_ab = eta_ab + f k_a k_b, ``[..., 4] -> [..., 4, 4]``."""
    M = _scalar(params.M, x)
    a = _scalar(params.a, x)
    xs, ys, zs = x[..., 1], x[..., 2], x[..., 3]
    rho2 = clamped_rho2(xs * xs + ys * ys + zs * zs, a, rho_min, r_formula)
    r = kerr_schild_radius(rho2, zs, a, r_formula=r_formula, rho_min=rho_min)
    r2 = r * r
    f = 2 * M * (r * r2) / (r2 * r2 + a * a * zs * zs)
    denom = r2 + a * a
    k = torch.stack([torch.ones_like(r), (r * xs + a * ys) / denom,
                     (r * ys - a * xs) / denom, zs / r], dim=-1)
    return (eta(x.dtype, x.device)
            + f[..., None, None] * k[..., :, None] * k[..., None, :])


class Metric(NamedTuple):
    """A metric by name and parameters; ``metric(x)`` evaluates g_ab."""

    name: str  # "minkowski" | "kerr_schild"
    params: KerrSchildParams = KerrSchildParams()
    r_formula: str = R_AS_WRITTEN
    rho_min: float = 1e-3

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "minkowski":
            return minkowski(x)
        return kerr_schild(x, self.params, r_formula=self.r_formula,
                           rho_min=self.rho_min)


def make_metric(name: str, params: KerrSchildParams | None = None, *,
                r_formula: str = R_AS_WRITTEN,
                rho_min: float = 1e-3) -> Metric:
    """Metric from a config name (``"minkowski"`` or ``"kerr_schild"``).
    Minkowski carries M = a = 0, as in the JAX package."""
    if name == "minkowski":
        return Metric(name, KerrSchildParams(M=0.0, a=0.0), r_formula,
                      rho_min)
    if name == "kerr_schild":
        if r_formula not in (R_AS_WRITTEN, R_TEXTBOOK):
            raise ValueError(f"unknown r_formula: {r_formula!r}")
        return Metric(name, params if params is not None
                      else KerrSchildParams(), r_formula, rho_min)
    raise ValueError(f"unknown metric: {name!r}")
