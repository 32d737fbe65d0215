"""Gravitational-redshift shading (counterpart of
raytracegr_jl_tpu/models/shading.py).

Every hit is shaded by its g-factor ``g = omega_obs / omega_emit``: the
frequency the camera's observer measures (the normalised raised
time-covector of the camera frame, the frame ``make_canvas`` builds its null
normals in) over the frequency in the emitter's frame. Disk matter moves on
circular Keplerian orbits about the z-axis; spheres and planes use their
stored ``vel``. Both are normalised with the local metric. A hit's base
colour is scaled by ``g ** beaming`` (I_obs = g^4 I_emit for bolometric
intensity), a miss is black.

Plain PyTorch batched over rays and differentiable by autograd
(``shade_redshift``), its contractions ``u^a g_ab v^b`` written out as
left-to-right sums (``models.camera.quad``: on the card ``torch.einsum``
is a batched GEMM that adds in an order of its own), and K5
(csrc/shading.cu), the same shading as one CUDA kernel, bitwise equal to
the plain version (``shade_redshift_cuda``). The forward renders shade
through K5 on the card (``render._shade``); a differentiable render, the
plain backends and CPU tensors take the plain version under autograd.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.geodesic_cm import (PARAMS_BYTES, check_kernel_config,
                               kernel_r_mode, pack_params)
from ..ops.geometry import inv4
from ..ops.integrate import IntegratorConfig
from ..ops.metrics import Metric, _scalar
from .camera import quad
from .objects import KIND_DISK, Scene, colors, distances

# Floor for squared norms before sqrt and division. Inside the photon sphere
# the Keplerian u becomes spacelike (-g(u,u) <= 0); rays cannot hit a
# physical disk there (r_in >= ISCO), so the floor only keeps dead-ray
# garbage finite, and reverse-mode gradients NaN-free.
_NORM2_FLOOR = 1e-6


def _entries(g: torch.Tensor):
    """The entries ``g[a][b]`` of ``[..., 4, 4]`` matrices, for ``quad``."""
    return [[g[..., a, b] for b in range(4)] for a in range(4)]


def _contract(u: torch.Tensor, g: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``u^a g_ab v^b`` of ``[..., 4]``, ``[..., 4, 4]``, ``[..., 4]``
    (broadcast), summed left to right as ``quad`` (csrc/camera_common.cuh
    quad)."""
    return quad([u[..., c] for c in range(4)], _entries(g),
                [v[..., c] for c in range(4)])


def normalize_timelike(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u = v / sqrt(max(-g_ab v^a v^b, floor)): unit timelike 4-velocity."""
    n2 = -_contract(v, g, v)
    return v / torch.sqrt(torch.clamp_min(n2, _NORM2_FLOOR))[..., None]


def keplerian_velocity(g: torch.Tensor, x: torch.Tensor, center: torch.Tensor,
                       M, a, prograde: bool = True) -> torch.Tensor:
    """4-velocity of circular-orbit disk matter at point(s) ``x``:
    Omega = +-sqrt(M) / (rho^{3/2} +- a sqrt(M)) with the cylindrical radius
    standing in for the Boyer-Lindquist r, normalised with the local
    metric ``g``."""
    rel = x[..., 1:] - center[..., 1:]
    rho = torch.sqrt(torch.clamp_min(rel[..., 0] ** 2 + rel[..., 1] ** 2,
                                     _NORM2_FLOOR))
    sqrtM = torch.sqrt(torch.clamp_min(_scalar(M, rho), 0.0))
    sgn = 1.0 if prograde else -1.0
    omega = sgn * sqrtM / (rho * torch.sqrt(rho) + sgn * _scalar(a, rho)
                           * sqrtM)
    v = torch.stack([torch.ones_like(omega), -omega * rel[..., 1],
                     omega * rel[..., 0], torch.zeros_like(omega)], dim=-1)
    return normalize_timelike(g, v)


def emitter_velocities(metric: Metric, scene: Scene, x: torch.Tensor,
                       M, a) -> torch.Tensor:
    """Unit 4-velocity of every object's matter at point(s) x:
    ``[..., 4] -> [..., N, 4]``. Disks get the Keplerian flow; spheres and
    planes their stored ``vel`` normalised with the local metric."""
    g = metric(x)[..., None, :, :]  # [..., 1, 4, 4], shared by the objects
    kepler = keplerian_velocity(g, x[..., None, :], scene.pos, M, a)
    stored = normalize_timelike(g, torch.broadcast_to(scene.vel,
                                                      kepler.shape))
    return torch.where((scene.kind == KIND_DISK)[..., None], kepler, stored)


def camera_frequency(metric: Metric, y0: torch.Tensor) -> torch.Tensor:
    """omega_obs = -g_ab u_obs^a k^b at the launch point, per ray, with
    u_obs the camera frame's normalised raised time-covector."""
    x0, k0 = y0[..., :4], y0[..., 4:]
    g = metric(x0)
    that = normalize_timelike(g, inv4(g)[..., :, 0])
    return -_contract(that, g, k0)


def g_factors(metric: Metric, scene: Scene, y0: torch.Tensor, y: torch.Tensor,
              M, a) -> torch.Tensor:
    """Per-(ray, object) redshift factor g = omega_obs / omega_emit:
    ``[..., 8], [..., 8] -> [..., N]``."""
    x, k = y[..., :4], y[..., 4:]
    g_hit = metric(x)[..., None, :, :]
    u_emit = emitter_velocities(metric, scene, x, M, a)  # [..., N, 4]
    # The traced k is past-pointing (backward ray tracing) and the emitter
    # u future-pointing, so the emitted frequency -g(u, -k) is +g(u, k).
    w_emit = _contract(u_emit, g_hit, k[..., None, :])
    w_obs = camera_frequency(metric, y0)
    # Positive for every physical hit; the floor guards dead-ray garbage.
    w_emit = torch.clamp_min(w_emit, 1e-3)
    return w_obs[..., None] / w_emit


def shade_redshift(metric: Metric, scene: Scene, y0: torch.Tensor,
                   y: torch.Tensor, M, a, hit_dmin: float = 0.01,
                   beaming: float = 4.0, exposure: float = 1.0
                   ) -> torch.Tensor:
    """Physical shading: the nearest object's base colour (distance below
    ``hit_dmin``, earliest index on ties) scaled by
    ``clip(exposure * g ** beaming, 0, 1)``; black on a miss."""
    x = y[..., :4]
    d = distances(scene, x)  # [..., N]
    hit_any = torch.min(d, dim=-1).values < hit_dmin
    omin = torch.argmin(d, dim=-1)
    base = colors(scene, x)  # [..., N, 3]
    gf = g_factors(metric, scene, y0, y, M, a)  # [..., N]
    lit = base * torch.clamp(exposure * gf ** beaming, 0.0, 1.0)[..., None]
    col = torch.gather(lit, -2, omin[..., None, None].expand(
        omin.shape + (1, 3))).squeeze(-2)
    return torch.where(hit_any[..., None], col, torch.zeros_like(col))


def shade_redshift_cuda(metric: Metric, scene: Scene, y0: torch.Tensor,
                        y: torch.Tensor, hit_dmin: float = 0.01,
                        beaming: float = 4.0, exposure: float = 1.0,
                        prm: torch.Tensor | None = None) -> torch.Tensor:
    """K5: ``shade_redshift`` of ``[B, 8]`` launch and end states on the
    card, one launch, with the metric's M and a (tensors or floats),
    bitwise equal to the plain version. Not differentiable: the states are
    read as data (``render._shade`` routes a differentiable render to the
    plain version). ``y`` is read as the caller holds it where it is
    ``[B, 8]`` rows (K1's) or ``[8, B]`` planes transposed (the compacted
    render's), with no copy. ``prm``: the packed parameter block
    (``ops.geodesic_cm.pack_params`` of ``metric`` and ``scene`` on the
    states' device and dtype), built here if not given. Raises for CPU
    tensors, a failed build or launch, and scenes the kernels do not take.
    Reads nothing from the card. Adds one to
    ``shade_redshift_cuda.launches`` per launch."""
    from ..utils import cuda_build
    if y.device.type != "cuda" or y0.device != y.device:
        raise ValueError("shade_redshift_cuda needs CUDA tensors on one "
                         f"device, got {y0.device} and {y.device}")
    if y.dtype not in (torch.float32, torch.float64) or y0.dtype != y.dtype:
        raise TypeError(f"unsupported dtypes {y0.dtype}, {y.dtype}")
    if y.dim() != 2 or y.shape[1] != 8 or y0.shape != y.shape:
        raise ValueError(f"bad shapes y0 {tuple(y0.shape)}, y "
                         f"{tuple(y.shape)}")
    cfg = IntegratorConfig()
    kinds = check_kernel_config(metric, scene, cfg)
    if prm is None:
        prm = pack_params(metric, scene, cfg, y.dtype, y.device)
    if prm.device != y.device or prm.numel() != PARAMS_BYTES[y.dtype]:
        raise ValueError("the parameter block is for another device or dtype")
    B = y.shape[0]
    rgb = torch.empty((B, 3), dtype=y.dtype, device=y.device)
    if B == 0:
        return rgb
    # y as the caller holds it where it is rows or the transposed planes
    # of the compacted render (plane stride ps), else copied into rows.
    y0, y = y0.detach().contiguous(), y.detach()
    ps = y.stride(1) if y.stride(0) == 1 and y.stride(1) >= B else 0
    if not ps:
        y = y.contiguous()
    vel = scene.vel.detach().to(y.dtype).contiguous()
    lib = cuda_build.load("shading")
    fn = lib.rtgr_k5_f32 if y.dtype == torch.float32 else lib.rtgr_k5_f64
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(y.device):
        rc = fn(ptr(y0), ptr(y), ps, ptr(vel), ptr(rgb), ptr(prm), B,
                int(metric.name == "kerr_schild"), kernel_r_mode(metric),
                len(kinds), float(hit_dmin), float(beaming), float(exposure),
                ctypes.c_void_p(torch.cuda.current_stream(y.device)
                                .cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {rc}")
    shade_redshift_cuda.launches += 1
    return rgb


shade_redshift_cuda.launches = 0
