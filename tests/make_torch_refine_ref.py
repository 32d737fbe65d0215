"""Writes tests/torch_refine_ref.npz: the JAX package's values that
tests/test_torch_refine.py holds the port's ``refine_minima`` to, so that
the tier-1 suite runs no JAX program for them.

    python tests/make_torch_refine_ref.py

On tests/test_event_detection.py's grazing rays (64 rays from the example1
camera aimed just inside the radius-0.5 sphere's silhouette, every one a
true hit by the closed-form oracle) in example1's scene, f64, Tsit5 at the
reference tolerance, 4000 steps:

* ``y0``, ``dt0``: the rays and their initial steps (Hairer's heuristic);
* ``tsit5_refine_*``: ``integrate_rays_cm`` (the ``xla_cm`` backend) with
  ``refine_minima=True``: ``y``, ``lam``, ``hit``, ``steps``;
* ``tsit5_plain_*``: the same without refinement, whose hits on the small
  sphere (``|x| < 1`` at the end; the others end on the sky sphere) miss
  some of the rays;
* ``rk4_refine_*``, ``rk4_plain_*``: the same with RK4 at a fixed step of
  2.0 (the cubic Hermite dense output over steps as long as the way to
  the sphere).

Runs on the CPU in well under a minute. Not collected by pytest.
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracegr_jl_tpu import IntegratorConfig, make_metric  # noqa: E402
from raytracegr_jl_tpu.ops import integrate as jint  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
from raytracegr_jl_tpu.render import default_tol  # noqa: E402

from test_event_detection import _example1_scene, _grazing_rays  # noqa: E402

OUT = os.path.join(_HERE, "torch_refine_ref.npz")
N_RAYS = 64
MAX_STEPS = 4000
RK4_DT = 2.0


def main():
    tol = default_tol(jnp.float64)
    cfg = IntegratorConfig(method="tsit5", rtol=tol, atol=tol,
                           max_steps=MAX_STEPS, refine_minima=True)
    mcm = make_metric("minkowski").component_major
    event = jpg.scene_event_cm(_example1_scene())
    y0 = _grazing_rays(N_RAYS)

    def rhs_cm(y):
        return jpg.geodesic_cm(mcm, y.T[:, None, :])[:, 0, :].T

    dt0 = jint.hairer_init_dt(rhs_cm, y0, cfg.rtol, cfg.atol, 5, cfg.lam_max)
    out = {"y0": np.asarray(y0), "dt0": np.asarray(dt0),
           "rtol": np.asarray(tol), "max_steps": np.asarray(MAX_STEPS),
           "rk4_dt": np.asarray(RK4_DT)}
    rk4 = cfg._replace(method="rk4", rk4_dt=RK4_DT)
    for name, c, d in (("tsit5", cfg, dt0),
                       ("rk4", rk4, jnp.full_like(dt0, RK4_DT))):
        for refine in (True, False):
            res = jpg.integrate_rays_cm(mcm, event, y0, d,
                                        c._replace(refine_minima=refine))
            pre = f"{name}_{'refine' if refine else 'plain'}"
            for f in ("y", "lam", "hit", "steps"):
                out[f"{pre}_{f}"] = np.asarray(getattr(res, f))
    np.savez(OUT, **out)

    def small(pre):
        rho = np.linalg.norm(out[f"{pre}_y"][:, 1:4], axis=-1)
        return int((out[f"{pre}_hit"] & (rho < 1.0)).sum())

    print(f"wrote {OUT}: small-sphere hits of {N_RAYS} rays: "
          + ", ".join(f"{m} {small(m + '_refine')} with refinement, "
                      f"{small(m + '_plain')} without"
                      for m in ("tsit5", "rk4")))


if __name__ == "__main__":
    main()
