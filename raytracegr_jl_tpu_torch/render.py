"""Render driver (counterpart of raytracegr_jl_tpu/render.py): flatten the
pixel grid to a ray batch ``[B, 8]``, pick each ray's initial step,
integrate it and shade the end points.

The forward render integrates with K1 (the CUDA kernel, or its plain
PyTorch version). The differentiable render (``differentiable=True``)
integrates with the checkpointed adjoint of ops/adjoint.py: K3 and K4 on
CUDA tensors, their plain versions on CPU tensors, or autograd through
every step with ``grad_mode="scan"``. The ``"rowmajor"`` backend (the
JAX package's ``"xla"``) takes any metric function: the geodesic
right-hand side by automatic differentiation of the metric
(ops/geometry.py) and
the row-major integrator of ops/integrate.py, plain torch on every
device. Shading is the
reference's hard shading, ``shade_soft`` when ``soft_temp`` is set (on the
component-major backends one function with a hand-written reverse,
``shade_reference``: K11 and K12 on CUDA tensors; the row-major backend
takes autograd of the plain forward), or the gravitational-redshift
shading of models/shading.py with ``shading="redshift"`` (K5 in a forward
render on the CUDA backend, the plain version under autograd elsewhere).
The compacted forward render is in compaction.py."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .models.camera import Canvas
from .models.objects import Scene, shade, shade_reference, shade_soft
from .models.shading import shade_redshift, shade_redshift_cuda
from .ops.adjoint import (integrate_rays_autograd, integrate_rays_ckpt,
                          integrate_rays_ckpt_cuda, per_ray)
from .ops.geodesic_cm import (initial_dt, integrate_rays_cm,
                              integrate_rays_cuda, launch_config, pack_params)
from .models.objects import FIELD_DIMS, min_distance
from .ops.geometry import MetricFn, geodesic, sanitize_bounds
from .ops.integrate import (IntegratorConfig, TraceResult, integrate_rays,
                            integrate_rays_scan)
from .ops.metrics import KerrSchildParams, Metric

# The component-major backends, which take a ``Metric`` (and the
# compacted render); "rowmajor" takes any metric function.
BACKENDS = ("torch", "cuda")
ROWMAJOR = "rowmajor"
SHADINGS = ("reference", "redshift")


class RenderConfig(NamedTuple):
    """Render settings; the fields of the JAX package's ``RenderConfig``
    without ``pallas_interpret`` (a CUDA kernel has no interpreter).

    ``backend``: ``"cuda"`` (the kernels), ``"torch"`` (their plain
    versions), None, which picks ``"cuda"`` for CUDA tensors and
    ``"torch"`` for CPU tensors, or ``"rowmajor"`` (any metric function;
    the differentiable path tapes every step, the grad_mode fields do not
    apply). ``shading``: ``"reference"`` (hard, or
    soft with ``soft_temp``) or ``"redshift"`` (g-factor beaming)."""

    integrator: IntegratorConfig = IntegratorConfig()
    hit_dmin: float = 0.01
    differentiable: bool = False
    backend: str | None = None
    soft_temp: float | None = None
    soft_freq: float = 12.0
    shading: str = "reference"
    beaming: float = 4.0
    exposure: float = 1.0


def default_tol(dtype: torch.dtype) -> float:
    """eps(T)^(3/4), the reference's reltol = abstol."""
    return float(torch.finfo(dtype).eps) ** 0.75


# The differentiable path's modes, with JAX's names: "ckpt" is the
# checkpointed adjoint's plain version, "ckpt_cuda" the same with K3, K4,
# K6 and K7 (JAX's "ckpt_pallas"), "scan" autograd through every step of
# the plain body, each rematerialized (JAX's integrate_rays_cm_scan; the
# localization after the loop takes the hand VJP of the other modes), and
# "auto" picks "ckpt_cuda" where ``backend`` resolves to "cuda" and "ckpt"
# elsewhere.
GRAD_MODES = ("auto", "ckpt", "ckpt_cuda", "scan")
# grad_groups splits only batches of at least this many rays per part
# (JAX: B < 2 G 128 runs ungrouped).
MIN_RAYS_PER_GRAD_GROUP = 2 * 128


def _check(cfg: RenderConfig, metric=None) -> None:
    if cfg.shading not in SHADINGS:
        raise ValueError(f"unknown shading: {cfg.shading!r}")
    if cfg.backend not in BACKENDS + (ROWMAJOR, None):
        raise ValueError(f"unknown backend: {cfg.backend!r}")
    if (metric is not None and not isinstance(metric, Metric)
            and cfg.backend != ROWMAJOR):
        raise ValueError(f"a metric function ({metric!r}) renders only with "
                         f"backend={ROWMAJOR!r}; the backend "
                         f"{cfg.backend!r} takes a Metric")
    if not cfg.differentiable:
        return
    if cfg.integrator.grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode: {cfg.integrator.grad_mode!r}")


def resolve_backend(cfg: RenderConfig, x: torch.Tensor) -> str:
    """The backend a render of ``x`` runs on: the configured one, or by
    the tensor's device."""
    if cfg.backend is not None:
        return cfg.backend
    return "cuda" if x.device.type == "cuda" else "torch"


def _sanitized_rhs(metric: MetricFn):
    """The row-major right-hand side ``[B, 8] -> [B, 8]`` of any metric
    function, its input and output clamped by the dtype's bounds
    (``sanitize_bounds``)."""
    def rhs(y):
        state_clamp, rhs_clamp = sanitize_bounds(y.dtype)
        k = geodesic(torch.clamp(y, -state_clamp, state_clamp), metric)
        return torch.clamp(k, -rhs_clamp, rhs_clamp)
    return rhs


def trace_batch(metric: Metric | MetricFn, scene: Scene, y0: torch.Tensor,
                cfg: RenderConfig, launch=None,
                groups: int | None = None) -> TraceResult:
    """Integrate a flat ray batch ``[B, 8]`` to termination. With
    ``differentiable`` the result carries gradients to y0, the metric's M
    and a, and the scene; the initial step does not (the body detaches
    every step size). ``launch``: K1's launch setup (``launch_config``) for
    the CUDA backend, where the caller keeps one. ``groups``: a grouped
    batch of the differentiable path (``integrate_rays_ckpt``). The
    ``"rowmajor"`` backend takes any metric function: the row-major
    ``integrate_rays``, or ``integrate_rays_scan`` when differentiable."""
    _check(cfg, metric)
    if groups is not None and (not cfg.differentiable
                               or cfg.backend == ROWMAJOR):
        raise NotImplementedError("a grouped batch needs the differentiable "
                                  "path of a component-major backend")
    if cfg.backend == ROWMAJOR:
        run = integrate_rays_scan if cfg.differentiable else integrate_rays
        return run(_sanitized_rhs(metric), lambda y: min_distance(scene, y),
                   y0, cfg.integrator)
    if cfg.differentiable:
        return _trace_differentiable(metric, scene, y0, cfg, groups)
    if resolve_backend(cfg, y0) == "cuda":
        # K1 takes each ray's initial step (initial_dt's, bit for bit) in
        # its prologue.
        return integrate_rays_cuda(metric, scene, y0, None, cfg.integrator,
                                   launch)
    dt0 = initial_dt(metric, y0, cfg.integrator)
    return integrate_rays_cm(metric, scene, y0, dt0, cfg.integrator)


def _trace_differentiable(metric: Metric, scene: Scene, y0: torch.Tensor,
                          cfg: RenderConfig,
                          groups: int | None) -> TraceResult:
    """The differentiable path, routed as the JAX package's
    ``_trace_differentiable_cm``: ``"scan"`` tapes every step
    (rematerialized) and ignores ``sort_rays`` and ``grad_groups``; the
    kernel route (``"ckpt_cuda"``) launches the batch in impact-parameter
    order with ``sort_rays`` and ignores ``grad_groups``; the plain route
    (``"ckpt"``) runs ``grad_groups`` sorted parts, each its own forward
    and backward pass, where the batch holds at least
    ``MIN_RAYS_PER_GRAD_GROUP`` rays per part, and ignores ``sort_rays``.
    Both leave values and gradients bitwise as they are without them
    (``ops.adjoint.SortedParts``). A multistart batch (``groups``) runs
    as given. Each ray takes its own initial step (``dt0=None``): K3's
    prologue on the kernel route, ``initial_dt`` inside the plain ones."""
    integ = cfg.integrator
    mode = integ.grad_mode
    if mode == "auto":
        mode = "ckpt_cuda" if resolve_backend(cfg, y0) == "cuda" else "ckpt"
    seg = integ.grad_seg_len
    if mode == "scan":
        return integrate_rays_autograd(metric, scene, y0, None, integ, seg,
                                       groups, remat=True)
    parts = None
    if mode == "ckpt_cuda":
        if integ.sort_rays and groups is None:
            parts = 1
        return integrate_rays_ckpt_cuda(metric, scene, y0, None, integ, seg,
                                        groups, parts)
    n = integ.grad_groups
    if (n > 1 and groups is None
            and y0.shape[0] >= n * MIN_RAYS_PER_GRAD_GROUP):
        parts = n
    return integrate_rays_ckpt(metric, scene, y0, None, integ, seg, groups,
                               parts)


def trace_rays(metric: Metric | MetricFn, scene: Scene, canvas: Canvas,
               cfg: RenderConfig | None = None) -> Canvas:
    """Render: returns the canvas with ``rgb`` filled."""
    if cfg is None:
        tol = default_tol(canvas.pos.dtype)
        cfg = RenderConfig(integrator=IntegratorConfig(rtol=tol, atol=tol))
    rgb = render_fn(metric, scene, cfg)(canvas.pos, canvas.normal)
    return canvas._replace(rgb=rgb)


def render_fn(metric: Metric | MetricFn, scene: Scene, cfg: RenderConfig,
              groups: int | None = None):
    """``(pos, normal) -> rgb`` closure over a fixed scene and config. On
    the CUDA backend K1's launch setup and K5's parameter block are built
    at the first call for each device and dtype and kept (no read from the
    card); where M or a is a tensor, whose value the caller may change
    between calls, they are built anew for each call. ``groups``: the rays
    form that many groups, each with its own parameters
    (``trace_batch``)."""
    _check(cfg, metric)
    keep = cfg.backend != ROWMAJOR and not cfg.differentiable and not any(
        isinstance(v, torch.Tensor) for v in metric.params)
    launches = {}
    blocks = {} if keep else None

    def fn(pos: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
        flat = torch.cat([pos, normal], dim=-1).reshape(-1, 8)
        launch = None
        if keep and resolve_backend(cfg, flat) == "cuda":
            key = (flat.device, flat.dtype)
            if key not in launches:
                launches[key] = launch_config(metric, scene, cfg.integrator,
                                              flat, "geodesic")
            launch = launches[key]
        res = trace_batch(metric, scene, flat, cfg, launch, groups)
        return _shade(metric, scene, flat, res.y, cfg, blocks).reshape(
            pos.shape[:-1] + (3,))

    return fn


def _redshift_on_card(metric: Metric | MetricFn, scene: Scene,
                      y0: torch.Tensor, y: torch.Tensor,
                      cfg: RenderConfig) -> bool:
    """Whether the redshift shading runs as K5: a forward render on the
    CUDA backend of a component-major metric, no input of the shading
    requiring a gradient (K5 is not differentiable; every other render
    takes the plain version under autograd)."""
    if (cfg.differentiable or cfg.backend == ROWMAJOR
            or resolve_backend(cfg, y) != "cuda"):
        return False
    inputs = (y0, y, *getattr(metric, "params", ()), *scene)
    return not any(isinstance(t, torch.Tensor) and t.requires_grad
                   for t in inputs)


def _shade(metric: Metric | MetricFn, scene: Scene, y0: torch.Tensor,
           y: torch.Tensor, cfg: RenderConfig,
           blocks: dict | None = None) -> torch.Tensor:
    """The end states' colours ``[B, 3]``; ``y0`` the launch states (the
    redshift shading's camera frequency; M = a = 0 for a metric function
    without ``params``). The redshift shading of a forward render on the
    CUDA backend is one K5 launch (``shade_redshift_cuda``, bitwise the
    plain version), with its parameter block kept in ``blocks`` per device
    and dtype where the caller keeps one (None: built for this call). The
    reference shading of a component-major backend goes through
    ``shade_reference`` (K11 and K12 on CUDA tensors)."""
    if cfg.shading == "redshift":
        if _redshift_on_card(metric, scene, y0, y, cfg):
            key = (y.device, y.dtype)
            if blocks is not None and key not in blocks:
                blocks[key] = pack_params(metric, scene, IntegratorConfig(),
                                          y.dtype, y.device)
            return shade_redshift_cuda(
                metric, scene, y0, y, cfg.hit_dmin, cfg.beaming,
                cfg.exposure, None if blocks is None else blocks[key])
        p = getattr(metric, "params", KerrSchildParams(M=0.0, a=0.0))
        return shade_redshift(metric, scene, y0, y, p.M, p.a, cfg.hit_dmin,
                              cfg.beaming, cfg.exposure)
    # The fields that take gradients, per ray: their per-ray cotangents
    # then meet the localization's ray by ray, and each parameter's are
    # summed once (ops.adjoint.per_ray).
    B = y.shape[0]
    scene = scene._replace(**{
        f: per_ray(v[None], B) for f, v in scene._asdict().items()
        if f != "kind" and v.requires_grad
        and v.dim() == FIELD_DIMS.get(f, 1)})
    if cfg.backend == ROWMAJOR:
        if cfg.soft_temp is not None:
            return shade_soft(scene, y[..., :4], cfg.hit_dmin, cfg.soft_temp,
                              color_freq=cfg.soft_freq)
        return shade(scene, y[..., :4], cfg.hit_dmin)
    return shade_reference(scene, y[..., :4], cfg.hit_dmin, cfg.soft_temp,
                           cfg.soft_freq)
