"""Writes tests/torch_dual_oracle_ref.npz: the JAX package's Dual oracle
(ops/dual_oracle.py) and jax.grad's loss gradients, which
tests/test_torch_dual_oracle.py holds the port's oracle to, so that the
tier-1 suite runs no JAX oracle (about 100 s per render in eager JAX).

    python tests/make_torch_dual_ref.py

The configuration of tests/test_dual_oracle.py: example2 at 8x8, f64,
``default_inverse_cfg(max_steps=20, method="rk4", rk4_dt=0.25)``, M0 =
1.05, a = 0, sphere index 2:

* ``rgb``, ``drgb_dM``: ``render_dual_dM`` at M0, [64, 3];
* ``drgb_dz``: ``render_dual_sensitivity(wrt=("pos", 2, 3))``, [64, 3];
* ``target_M``: the route's image at M = 1.0; ``target_z``: 0.9 times its
  image at M0;
* ``grad_M``, ``grad_z``: jax.grad of the pixel MSE against those targets
  on the row-major differentiable route (the default ``backend="xla"``),
  with respect to M and to the sphere's z.

Runs on the CPU in a few minutes. Not collected by pytest.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracegr_jl_tpu.grad import (InverseParams, default_inverse_cfg,  # noqa: E402
                                    flat_pixel_grid,
                                    make_ray_render_for_params)
from raytracegr_jl_tpu.models.scenes import build, example2_spec  # noqa: E402
from raytracegr_jl_tpu.ops.dual_oracle import render_dual_sensitivity  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
F64 = jnp.float64
N = 8
N_STEPS = 20
RK4_DT = 0.25
M0 = 1.05
SPHERE = 2


def main():
    spec = example2_spec(N, N)
    cfg = default_inverse_cfg(F64, max_steps=N_STEPS, method="rk4",
                              rk4_dt=RK4_DT)
    assert cfg.backend == "xla"
    _, scene0, _ = build(spec, F64)
    params = InverseParams(M=jnp.asarray(M0, F64), a=jnp.asarray(0.0, F64),
                           sphere_pos=scene0.pos[SPHERE])
    render = make_ray_render_for_params(spec, cfg, SPHERE, F64)
    xg, ng = flat_pixel_grid(spec, F64)
    kw = dict(r_formula=spec.r_formula, rho_min=1e-3, rk4_dt=RK4_DT,
              n_steps=N_STEPS, interp_points=cfg.integrator.interp_points,
              bisect_iters=cfg.integrator.bisect_iters)
    out = {}
    rgb, dM = render_dual_sensitivity(scene0, xg, ng, M0, 0.0, wrt="M", **kw)
    out["rgb"], out["drgb_dM"] = np.asarray(rgb), np.asarray(dM)
    print("oracle d/dM done", flush=True)
    _, dz = render_dual_sensitivity(scene0, xg, ng, M0, 0.0,
                                    wrt=("pos", SPHERE, 3), **kw)
    out["drgb_dz"] = np.asarray(dz)
    print("oracle d/dz done", flush=True)

    target_M = render(params._replace(M=jnp.asarray(1.0, F64)), xg, ng)
    target_z = render(params, xg, ng) * 0.9

    def loss_M(m):
        return jnp.mean((render(params._replace(M=m), xg, ng)
                         - target_M) ** 2)

    def loss_z(z):
        p = params._replace(sphere_pos=params.sphere_pos.at[3].set(z))
        return jnp.mean((render(p, xg, ng) - target_z) ** 2)

    out["target_M"], out["target_z"] = (np.asarray(target_M),
                                        np.asarray(target_z))
    out["grad_M"] = np.asarray(jax.jit(jax.grad(loss_M))(params.M))
    out["grad_z"] = np.asarray(jax.jit(jax.grad(loss_z))(
        params.sphere_pos[3]))
    np.savez(os.path.join(HERE, "torch_dual_oracle_ref.npz"), **out)
    print("wrote torch_dual_oracle_ref.npz: " + ", ".join(
        f"{k} {v.shape}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main()
