"""Differentiable rendering: pixel-loss gradients with respect to the physics
parameters (counterpart of raytracegr_jl_tpu/grad.py).

Reverse mode runs through the whole pipeline: the camera's metric-dependent
null rays (``pixel_rays``), the checkpointed geodesic integration
(ops/adjoint.py: K3 and K4 on the card) and the shading, down to the
Kerr-Schild mass M, the spin a and the pose of one sphere.
"""

from __future__ import annotations

import torch
from torch import nn

from .models.camera import pixel_grid, pixel_rays
from .models.objects import Scene, make_scene
from .models.scenes import SceneSpec
from .ops.adjoint import per_ray
from .ops.integrate import IntegratorConfig
from .ops.metrics import KerrSchildParams, make_metric
from .render import RenderConfig, render_fn
from .utils.device import resolve_device


class InverseParams(nn.Module):
    """The learnable physics parameters: black-hole mass ``M``, spin ``a``
    and the 4-position ``sphere_pos`` of the visible sphere (the JAX
    package's ``InverseParams`` as three ``nn.Parameter``s), on ``device``
    (the CUDA card unless another is named)."""

    def __init__(self, M, a, sphere_pos, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        as_p = lambda v: nn.Parameter(torch.as_tensor(  # noqa: E731
            v, dtype=dtype, device=device).detach().clone())
        self.M = as_p(M)
        self.a = as_p(a)
        self.sphere_pos = as_p(sphere_pos)

    def copy(self) -> "InverseParams":
        """A detached copy, as new leaves."""
        return InverseParams(self.M, self.a, self.sphere_pos,
                             self.M.dtype, self.M.device)


def _with_sphere(scene: Scene, index: int, pos: torch.Tensor) -> Scene:
    """``scene`` with object ``index`` moved to ``pos``, built anew so that
    the graph reaches ``pos`` (no in-place write into the scene)."""
    rows = [pos[None] if i == index else scene.pos[i:i + 1]
            for i in range(scene.n_objects)]
    return scene._replace(pos=torch.cat(rows))


def _metric(spec: SceneSpec, params: InverseParams, cfg: RenderConfig,
            rays: int | None = None):
    """The metric of ``params``; with ``rays``, of stacked params (``M
    [N]``, ``a [N]``), per ray: each start's value for its ``rays``
    consecutive rays (``[N * rays]``)."""
    M, a = params.M, params.a
    if rays is not None:
        M, a = per_ray(M, rays), per_ray(a, rays)
    return make_metric(spec.metric_name, KerrSchildParams(M=M, a=a),
                       r_formula=spec.r_formula, rho_min=_grad_rho_min(cfg))


def _with_spheres(scene: Scene, index: int, pos: torch.Tensor,
                  rays: int) -> Scene:
    """``scene`` per ray for stacked sphere poses ``pos [N, 4]``: object
    ``index`` at each start's pose for its ``rays`` consecutive rays
    (``scene.pos`` becomes ``[N * rays, n_objects, 4]``)."""
    base = scene.pos.expand(pos.shape[0], -1, -1)
    rows = [pos[:, None] if i == index else base[:, i:i + 1]
            for i in range(scene.n_objects)]
    return scene._replace(pos=per_ray(torch.cat(rows, dim=1), rays))


def make_render_for_params(spec: SceneSpec, cfg: RenderConfig,
                           sphere_index: int = 2, dtype=torch.float32,
                           device=None):
    """``params -> rgb [ni, nj, 3]``; the canvas's null normals are
    rebuilt per call (``make_canvas``'s) because they depend on the metric
    (so on M and a); its pixel grid is built once, so that a call copies
    nothing from the host."""
    device = resolve_device(device)
    scene0 = make_scene(spec.objects, dtype, device)
    xg, ng = pixel_grid(spec.cam_pos, spec.cam_widthx, spec.cam_widthy,
                        spec.cam_normal, spec.ni, spec.nj, dtype, device)

    def render(params: InverseParams) -> torch.Tensor:
        metric = _metric(spec, params, cfg)
        scene = _with_sphere(scene0, sphere_index, params.sphere_pos)
        pos, normal = pixel_rays(metric, xg, ng)
        return render_fn(metric, scene, cfg)(pos, normal)

    return render


def flat_pixel_grid(spec: SceneSpec, dtype=torch.float32, device=None):
    """The parameter-free pixel batch of a spec, ``(xg [B, 4], ng [B, 4])``
    with B = ni * nj: the data arguments of ``make_ray_loss_fn``."""
    xg, ng = pixel_grid(spec.cam_pos, spec.cam_widthx, spec.cam_widthy,
                        spec.cam_normal, spec.ni, spec.nj, dtype, device)
    return xg.reshape(-1, 4), ng.reshape(-1, 4)


def make_ray_render_for_params(spec: SceneSpec, cfg: RenderConfig,
                               sphere_index: int = 2, dtype=torch.float32,
                               device=None):
    """``(params, xg, ng) -> rgb [B, 3]``: the render with the pixel batch
    as data. Gradients reach M and a through ``pixel_rays``."""
    scene0 = make_scene(spec.objects, dtype, device)

    def render(params: InverseParams, xg: torch.Tensor, ng: torch.Tensor):
        metric = _metric(spec, params, cfg)
        scene = _with_sphere(scene0, sphere_index, params.sphere_pos)
        x, u = pixel_rays(metric, xg, ng)
        return render_fn(metric, scene, cfg)(x, u)

    return render


def _grad_rho_min(cfg: RenderConfig) -> float:
    """Singularity clamp for differentiable configs: ``stop_rho / 2`` when a
    capture-stop radius is set (every evaluation below it belongs to a ray
    already dying inside the horizon), at least 1e-3. It bounds the
    metric's position partials, which keeps f32 (M, a) cotangent sums
    finite. Render a target through the same factories so that both share
    the clamp."""
    return max(1e-3, 0.5 * cfg.integrator.stop_rho)


def make_ray_loss_fn(spec: SceneSpec, cfg: RenderConfig,
                     sphere_index: int = 2, dtype=torch.float32,
                     device=None):
    """Pixel-MSE loss with the ray batch as data:
    ``(params, xg, ng, target [B, 3]) -> scalar``."""
    render = make_ray_render_for_params(spec, cfg, sphere_index, dtype,
                                        device)

    def loss(params: InverseParams, xg, ng, target) -> torch.Tensor:
        return torch.mean((render(params, xg, ng) - target) ** 2)

    return loss


def make_loss_fn(spec: SceneSpec, target_rgb: torch.Tensor, cfg: RenderConfig,
                 sphere_index: int = 2, dtype=torch.float32, device=None):
    """Pixel-MSE loss ``params -> scalar`` against a target image;
    ``cfg`` must be differentiable (``default_inverse_cfg``)."""
    render = make_render_for_params(spec, cfg, sphere_index, dtype, device)

    def loss(params: InverseParams) -> torch.Tensor:
        return torch.mean((render(params) - target_rgb) ** 2)

    return loss


def make_multistart_loss_fn(spec: SceneSpec, target_rgb: torch.Tensor,
                            cfg: RenderConfig, sphere_index: int = 2,
                            dtype=torch.float32, device=None):
    """The pixel-MSE losses of several starts at once: ``params -> losses
    [N]`` for ``params`` stacked along a leading start axis (``M [N]``,
    ``a [N]``, ``sphere_pos [N, 4]``). The pixel batch is repeated N
    times, start-major, and rendered in one call: one grouped K3 and K4
    launch on the card, whatever N (the JAX package vmaps ``make_loss_fn``
    over the starts). Start i's loss equals ``make_loss_fn``'s at its
    parameters."""
    scene0 = make_scene(spec.objects, dtype, device)
    xg, ng = flat_pixel_grid(spec, dtype, scene0.pos.device)
    B = xg.shape[0]
    target = target_rgb.reshape(B, 3)

    def loss(params: InverseParams) -> torch.Tensor:
        N = params.M.shape[0]
        metric = _metric(spec, params, cfg, B)
        scene = _with_spheres(scene0, sphere_index, params.sphere_pos, B)
        x, u = pixel_rays(metric, xg.repeat(N, 1), ng.repeat(N, 1))
        rgb = render_fn(metric, scene, cfg, groups=N)(x, u)
        return torch.mean(((rgb - target.repeat(N, 1)) ** 2).reshape(N, -1),
                          dim=1)

    return loss


def default_inverse_cfg(dtype=torch.float32, max_steps: int = 64,
                        method: str = "rk4", rk4_dt: float = 0.25,
                        soft_temp: float | None = None,
                        stop_rho: float = 0.0) -> RenderConfig:
    """The differentiable configuration of the JAX package: tolerance
    eps^(3/4), 4 detection samples, 20 bisections, segments of 16 steps.
    ``soft_temp`` turns on ``shade_soft``, which optimization needs: hard
    shading is piecewise constant in the parameters."""
    tol = float(torch.finfo(dtype).eps) ** 0.75
    return RenderConfig(
        integrator=IntegratorConfig(method=method, rk4_dt=rk4_dt, rtol=tol,
                                    atol=tol, max_steps=max_steps,
                                    interp_points=4, bisect_iters=20,
                                    stop_rho=stop_rho, state_cap=1e6,
                                    grad_seg_len=16),
        differentiable=True,
        soft_temp=soft_temp,
    )
