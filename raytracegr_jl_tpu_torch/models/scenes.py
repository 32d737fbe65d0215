"""The reference's example scenes (counterpart of raytracegr_jl_tpu/models/scenes.py):
example1 (flat space), example2 (Kerr-Schild black hole), the accretion
disk around a spinning hole and the inversion's lensing scene, as data."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.camera import Canvas, make_canvas
from ..models.objects import Disk, Plane, Sphere, make_scene
from ..ops.metrics import KerrSchildParams, make_metric
from ..render import IntegratorConfig, RenderConfig, default_tol, trace_rays
from ..utils.device import resolve_device


class SceneSpec(NamedTuple):
    metric_name: str
    metric_params: KerrSchildParams
    r_formula: str
    objects: tuple
    cam_pos: tuple
    cam_widthx: tuple
    cam_widthy: tuple
    cam_normal: tuple
    ni: int
    nj: int


def example1_spec(ni: int = 200, nj: int = 200) -> SceneSpec:
    """Flat space: caelum sky sphere (r=-10), time-plane (t=-20), sphere of
    radius 1/2 at the origin."""
    return SceneSpec(
        metric_name="minkowski",
        metric_params=KerrSchildParams(),
        r_formula="as_written",
        objects=(
            Sphere(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0), radius=-10.0),
            Plane(time=-20.0),
            Sphere(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0), radius=0.5),
        ),
        cam_pos=(0, 0, -2, 0),
        cam_widthx=(0, 1, 0, 0),
        cam_widthy=(0, 0, 0, 1),
        cam_normal=(0, 0, 1, 0),
        ni=ni,
        nj=nj,
    )


def example2_spec(ni: int = 200, nj: int = 200, M: float = 1.0,
                  a: float = 0.0, r_formula: str = "as_written") -> SceneSpec:
    """Black hole: Kerr-Schild hole at the origin, sphere at x=+4, camera at
    x=+4."""
    return SceneSpec(
        metric_name="kerr_schild",
        metric_params=KerrSchildParams(M=M, a=a),
        r_formula=r_formula,
        objects=(
            Sphere(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0), radius=-10.0),
            Plane(time=-20.0),
            Sphere(pos=(0, 4, 0, 0), vel=(1, 0, 0, 0), radius=0.5),
        ),
        cam_pos=(0, 4, -2, 0),
        cam_widthx=(0, 1, 0, 0),
        cam_widthy=(0, 0, 0, 1),
        cam_normal=(0, 0, 1, 0),
        ni=ni,
        nj=nj,
    )


def accretion_disk_spec(ni: int = 1024, nj: int = 1024, M: float = 1.0,
                        a: float = 0.8) -> SceneSpec:
    """Accretion disk (annulus rho in [3, 12] M, half-thickness 0.1) in the
    equatorial plane of a spinning Kerr hole, textbook radius, sky sphere
    at r = 30, camera at (0, -20, 4) looking at the hole. Trace it with
    ``stop_rho=1.0``. The port shades it hard; redshift shading is not
    ported yet."""
    return SceneSpec(
        metric_name="kerr_schild",
        metric_params=KerrSchildParams(M=M, a=a),
        r_formula="textbook",
        objects=(
            Sphere(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0), radius=-30.0),
            Disk(pos=(0, 0, 0, 0), r_in=3.0, r_out=12.0, half=0.1),
        ),
        cam_pos=(0, 0, -20, 4),
        cam_widthx=(0, 1.3, 0, 0),
        cam_widthy=(0, 0, 0.2549, 1.2748),
        cam_normal=(0, 0, 0.9806, -0.1961),
        ni=ni,
        nj=nj,
    )


def lensing_inverse_spec(ni: int = 32, nj: int = 32, M: float = 0.5,
                         sphere_x: float = 5.0) -> SceneSpec:
    """The inversion's scene (BASELINE config 5): one textured sphere seen
    past a black hole at a moderate impact parameter, from which gradient
    descent recovers M and the sphere's z to 1%. Rays to the sphere pass
    the hole at b ~ 3-7 against b_crit ~ 2.6 M, a smooth deflection with
    no photon-ring winding (whose sensitivities are useless for fitting);
    the sphere is the only object (no silhouette flips of a sky in the
    loss); the radius is the textbook one. Fit it with soft shading
    (``soft_temp`` ~ 0.05, ``soft_freq`` ~ 2): the coarse smooth texture
    widens M's basin."""
    return SceneSpec(
        metric_name="kerr_schild",
        metric_params=KerrSchildParams(M=M, a=0.0),
        r_formula="textbook",
        objects=(
            Sphere(pos=(0, sphere_x, 12.0, 0), vel=(1, 0, 0, 0), radius=2.0),
        ),
        cam_pos=(0, 0, -20, 0),
        cam_widthx=(0, 0.9, 0, 0),
        cam_widthy=(0, 0, 0, 0.9),
        cam_normal=(0, 0, 1, 0),
        ni=ni,
        nj=nj,
    )


def build(spec: SceneSpec, dtype=torch.float64, device=None):
    """Materialize (metric, scene, canvas) from a spec on ``device`` (the
    CUDA card unless another is named; without a card that raises)."""
    device = resolve_device(device)
    metric = make_metric(spec.metric_name, spec.metric_params,
                         r_formula=spec.r_formula)
    scene = make_scene(spec.objects, dtype=dtype, device=device)
    canvas = make_canvas(metric, spec.cam_pos, spec.cam_widthx,
                         spec.cam_widthy, spec.cam_normal, spec.ni, spec.nj,
                         dtype=dtype, device=device)
    return metric, scene, canvas


def render_spec(spec: SceneSpec, dtype=torch.float64, cfg: RenderConfig | None
                = None, device=None) -> Canvas:
    """Render a spec; by default RK4 in flat space, Tsit5 otherwise, at the
    reference tolerance eps^(3/4)."""
    metric, scene, canvas = build(spec, dtype, device)
    if cfg is None:
        tol = default_tol(dtype)
        method = "rk4" if spec.metric_name == "minkowski" else "tsit5"
        cfg = RenderConfig(integrator=IntegratorConfig(
            method=method, rtol=tol, atol=tol))
    return trace_rays(metric, scene, canvas, cfg)


def example1(ni: int = 200, nj: int = 200, dtype=torch.float64,
             outfile: str | None = "scenes/sphere.png",
             device=None) -> Canvas:
    """Render (and optionally save) the flat-space example."""
    canvas = render_spec(example1_spec(ni, nj), dtype, device=device)
    if outfile:
        from ..utils.image import save_png
        print(f'Output file is "{save_png(outfile, canvas.rgb)}"')
    return canvas


def example2(ni: int = 200, nj: int = 200, dtype=torch.float64,
             outfile: str | None = "scenes/sphere2.png",
             device=None) -> Canvas:
    """Render (and optionally save) the black-hole example."""
    canvas = render_spec(example2_spec(ni, nj), dtype, device=device)
    if outfile:
        from ..utils.image import save_png
        print(f'Output file is "{save_png(outfile, canvas.rgb)}"')
    return canvas
