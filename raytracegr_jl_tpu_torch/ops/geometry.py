"""Geometry helpers in PyTorch (counterpart of raytracegr_jl_tpu/ops/geometry.py):
the dtype-aware sanitization bounds of every right-hand-side evaluation and
the closed-form 4x4 inverse the camera uses."""

from __future__ import annotations

from typing import Tuple

import torch

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


def inv4(g: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of 4x4 matrices, batched: ``[..., 4, 4]``
    (adjugate over a clamped determinant)."""
    m = [[g[..., a, b] for b in range(4)] for a in range(4)]

    def det3(r, c):
        rs = [i for i in range(4) if i != r]
        cs = [j for j in range(4) if j != c]
        a, b, c0 = m[rs[0]][cs[0]], m[rs[0]][cs[1]], m[rs[0]][cs[2]]
        d, e, f = m[rs[1]][cs[0]], m[rs[1]][cs[1]], m[rs[1]][cs[2]]
        g_, h, i = m[rs[2]][cs[0]], m[rs[2]][cs[1]], m[rs[2]][cs[2]]
        return (a * (e * i - f * h) - b * (d * i - f * g_)
                + c0 * (d * h - e * g_))

    cof = [[((-1) ** (a + b)) * det3(a, b) for b in range(4)]
           for a in range(4)]
    det = sum(m[0][c] * cof[0][c] for c in range(4))
    inv_det = 1.0 / clamp_det(det)
    rows = [torch.stack([cof[b][a] * inv_det for b in range(4)], dim=-1)
            for a in range(4)]
    return torch.stack(rows, dim=-2)
