"""Writes tests/torch_sharding_ref.npz and tests/torch_rowmajor_ref.npz:
the JAX package's values that tests/test_torch_sharding.py and
tests/test_torch_rowmajor.py hold the port's data parallelism and its
row-major route to, so that the tier-1 suite runs no JAX gradient
program for them.

    python tests/make_torch_slice8_ref.py

torch_sharding_ref.npz, on tests/test_sharding.py's
``test_sharded_value_and_grad`` setup (example2 at 16x8, f64,
``default_inverse_cfg(max_steps=32, rk4_dt=0.3)``), on the component-major
checkpointed path (``backend="xla_cm"``, ``grad_mode="ckpt"``):

* ``target``: the truth's image (M = 1, a = 0, sphere at x = 4), [128, 3];
* ``loss``, ``g_M``, ``g_a``, ``g_sphere_pos``: ``sharded_value_and_grad``
  over the 8-device CPU mesh at M = 1.02.

torch_rowmajor_ref.npz, the row-major route (``backend="xla"``):

* ``e1_*``: example1 at 8x8, f64, RK4 at a step of 0.1, tolerances 1e-9:
  ``rgb``, and the ``hit`` and ``steps`` of ``trace_batch``;
* ``e2_*``: example2 at 8x8, f64, Tsit5 at rtol = atol = 1e-9, 1,000 steps;
* ``grad_*``: the differentiable row-major render (``integrate_rays_scan``)
  of ``make_ray_loss_fn`` on example2 at 8x8, f64,
  ``default_inverse_cfg(max_steps=20, rk4_dt=0.5, stop_rho=0.5)`` at M =
  1.05 against the truth's image: ``target``, ``loss``, ``M``, ``a``,
  ``sphere_pos``.

Runs on the CPU in a few minutes. Not collected by pytest.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracegr_jl_tpu import IntegratorConfig, RenderConfig  # noqa: E402
from raytracegr_jl_tpu.grad import (InverseParams, default_inverse_cfg,  # noqa: E402
                                    flat_pixel_grid, make_ray_loss_fn,
                                    make_ray_render_for_params)
from raytracegr_jl_tpu.models.scenes import (build, example1_spec,  # noqa: E402
                                             example2_spec)
from raytracegr_jl_tpu.parallel.sharding import (make_mesh,  # noqa: E402
                                                 shard_pixels,
                                                 sharded_value_and_grad)
from raytracegr_jl_tpu.render import render_fn, trace_batch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
F64 = jnp.float64
TRUTH = InverseParams(M=jnp.asarray(1.0, F64), a=jnp.asarray(0.0, F64),
                      sphere_pos=jnp.asarray([0.0, 4.0, 0.0, 0.0], F64))
ROWMAJOR_CASES = {
    "e1": (example1_spec(8, 8), IntegratorConfig(
        method="rk4", rk4_dt=0.1, rtol=1e-9, atol=1e-9)),
    "e2": (example2_spec(8, 8), IntegratorConfig(
        method="tsit5", rtol=1e-9, atol=1e-9, max_steps=1000)),
}


def _loss_grads(out, prefix, loss, g):
    out[f"{prefix}loss"] = np.asarray(loss)
    for name in ("M", "a", "sphere_pos"):
        out[f"{prefix}{name}"] = np.asarray(getattr(g, name))


def sharding_ref():
    spec = example2_spec(16, 8)
    cfg = default_inverse_cfg(F64, max_steps=32, rk4_dt=0.3)
    cfg = cfg._replace(backend="xla_cm", integrator=cfg.integrator._replace(
        grad_mode="ckpt"))
    xg, ng = flat_pixel_grid(spec, F64)
    target = make_ray_render_for_params(spec, cfg, 2, F64)(TRUTH, xg, ng)
    mesh = make_mesh()
    assert mesh.devices.size == 8
    loss = make_ray_loss_fn(spec, cfg, 2, F64)
    p = TRUTH._replace(M=jnp.asarray(1.02, F64))
    lv, g = sharded_value_and_grad(loss, mesh)(
        p, *shard_pixels(mesh, xg, ng, target))
    out = {"target": np.asarray(target)}
    _loss_grads(out, "", lv, g)
    return out


def rowmajor_ref():
    out = {}
    for key, (spec, integ) in ROWMAJOR_CASES.items():
        metric, scene, canvas = build(spec, F64)
        cfg = RenderConfig(integrator=integ)
        out[f"{key}_rgb"] = np.asarray(render_fn(metric, scene, cfg)(
            canvas.pos, canvas.normal))
        y0 = jnp.concatenate([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        res = trace_batch(metric, scene, y0, cfg)
        out[f"{key}_hit"] = np.asarray(res.hit)
        out[f"{key}_steps"] = np.asarray(res.steps)
    spec = example2_spec(8, 8)
    cfg = default_inverse_cfg(F64, max_steps=20, rk4_dt=0.5, stop_rho=0.5)
    assert cfg.backend == "xla"
    xg, ng = flat_pixel_grid(spec, F64)
    target = make_ray_render_for_params(spec, cfg, 2, F64)(TRUTH, xg, ng)
    loss = make_ray_loss_fn(spec, cfg, 2, F64)
    lv, g = jax.jit(jax.value_and_grad(loss))(
        TRUTH._replace(M=jnp.asarray(1.05, F64)), xg, ng, target)
    out["grad_target"] = np.asarray(target)
    _loss_grads(out, "grad_", lv, g)
    return out


def main():
    for name, fn in (("torch_sharding_ref.npz", sharding_ref),
                     ("torch_rowmajor_ref.npz", rowmajor_ref)):
        out = fn()
        np.savez(os.path.join(HERE, name), **out)
        print(f"wrote {name}: " + ", ".join(
            f"{k} {v.shape}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main()
