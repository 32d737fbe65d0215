"""Camera / canvas construction (counterpart of raytracegr_jl_tpu/models/camera.py).

Pixel offsets ``(i + 1/2)/ni - 1/2`` tilt both position and normal (curved
screen); each ray's 4-velocity is the metric-normalised null vector
``(t_hat + n_hat) / sqrt(2)`` with ``t = g^-1 (1, 0, 0, 0)`` (past-pointing).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.geometry import inv4
from ..utils.device import resolve_device


class Canvas(NamedTuple):
    """Pixel grid: ``pos``/``normal`` are [ni, nj, 4], ``rgb`` [ni, nj, 3]."""

    pos: torch.Tensor
    normal: torch.Tensor
    rgb: torch.Tensor

    @property
    def shape(self):
        return self.pos.shape[:-1]


def pixel_rays(metric, pos: torch.Tensor, normal: torch.Tensor):
    """Null 4-velocity for pixel(s): ``[..., 4]`` positions and tilted
    normals -> (pos, u)."""
    g = metric(pos)
    gu = inv4(g)
    t = gu[..., :, 0]
    t2 = torch.einsum("...a,...ab,...b->...", t, g, t)
    n2 = torch.einsum("...a,...ab,...b->...", normal, g, normal)
    that = t / torch.sqrt(-t2)[..., None]
    nhat = normal / torch.sqrt(n2)[..., None]
    u = (that + nhat) / math.sqrt(2.0)
    return pos, u


def pixel_grid(pos, widthx, widthy, normal, ni: int, nj: int,
               dtype=torch.float64, device=None):
    """Pixel positions and tilted (pre-normalisation) normals, [ni, nj, 4],
    on ``device`` (the CUDA card unless another is named)."""
    device = resolve_device(device)
    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    pos, widthx, widthy, normal = t(pos), t(widthx), t(widthy), t(normal)
    dx = (torch.arange(ni, dtype=dtype, device=device) + 0.5) / ni - 0.5
    dy = (torch.arange(nj, dtype=dtype, device=device) + 0.5) / nj - 0.5
    offset = dx[:, None, None] * widthx + dy[None, :, None] * widthy
    return pos + offset, normal + offset


def make_canvas(metric, pos, widthx, widthy, normal, ni: int, nj: int,
                dtype=torch.float64, device=None) -> Canvas:
    """The ni x nj canvas of ray initial conditions, on ``device`` (the
    CUDA card unless another is named)."""
    device = resolve_device(device)
    x, n = pixel_grid(pos, widthx, widthy, normal, ni, nj, dtype, device)
    x, u = pixel_rays(metric, x, n)
    return Canvas(pos=x, normal=u,
                  rgb=torch.zeros((ni, nj, 3), dtype=dtype, device=device))
