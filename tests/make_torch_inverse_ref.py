"""Writes tests/torch_inverse_ref.npz: the JAX package's values that
tests/test_torch_inverse.py holds the port's inversion workflow to, so
that the tier-1 suite runs no JAX gradient program for them.

    python tests/make_torch_inverse_ref.py

On tests/test_inverse.py's configuration (example1 at 8x8, f64, RK4 with
24 steps of 0.5, soft shading; the sphere's z fitted alone, 4 Adam steps
of 2e-2 from z in {0.12, 0.04, -0.1}):

* ``vec_*``: ``fit_multistart(..., vectorized=True)`` (one vmapped fit);
* ``sched1_*``, ``sched2_*``: ``fit`` from z = 0.12 with
  ``optax.cosine_decay_schedule(2e-2, 4, alpha=0.1)``, 2 steps, then 2
  more resumed from the first call's ``final_params`` and ``opt_state``;
* ``target``: the truth's image both fits are held to.

Runs on the CPU in about two minutes. Not collected by pytest.
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from raytracegr_jl_tpu.grad import (InverseParams, default_inverse_cfg,  # noqa: E402
                                    make_render_for_params)
from raytracegr_jl_tpu.inverse import fit, fit_multistart  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example1_spec  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_inverse_ref.npz")
ZS = (0.12, 0.04, -0.1)
STEPS, LR = 4, 2e-2
SCHEDULE = dict(init_value=2e-2, decay_steps=4, alpha=0.1)


def _record(out, prefix, res):
    out[f"{prefix}_loss"] = np.asarray(res.loss)
    out[f"{prefix}_loss_history"] = np.asarray(res.loss_history)
    for name in ("M", "a", "sphere_pos"):
        out[f"{prefix}_params_{name}"] = np.asarray(getattr(res.params, name))
        out[f"{prefix}_final_{name}"] = np.asarray(
            getattr(res.final_params, name))
        out[f"{prefix}_history_{name}"] = np.asarray(
            getattr(res.params_history, name))


def main():
    spec = example1_spec(8, 8)
    cfg = default_inverse_cfg(jnp.float64, max_steps=24, rk4_dt=0.5,
                              soft_temp=0.05)
    truth = InverseParams(M=jnp.asarray(1.0), a=jnp.asarray(0.0),
                          sphere_pos=jnp.asarray([0.0, 0.0, 0.0, 0.0]))
    target = make_render_for_params(spec, cfg, 2, jnp.float64)(truth)
    inits = [truth._replace(sphere_pos=jnp.asarray([0.0, 0.0, 0.0, z]))
             for z in ZS]
    trainable = InverseParams(M=0.0, a=0.0,
                              sphere_pos=jnp.asarray([0., 0., 0., 1.]))
    out = {"target": np.asarray(target), "zs": np.asarray(ZS),
           "steps": np.asarray(STEPS), "lr": np.asarray(LR)}
    vec = fit_multistart(spec, target, inits, cfg, vectorized=True,
                         steps=STEPS, learning_rate=LR, trainable=trainable,
                         dtype=jnp.float64)
    _record(out, "vec", vec)
    sched = optax.cosine_decay_schedule(**SCHEDULE)
    kw = dict(learning_rate=sched, trainable=trainable, dtype=jnp.float64)
    part1 = fit(spec, target, inits[0], cfg, steps=2, **kw)
    part2 = fit(spec, target, part1.final_params, cfg, steps=2,
                opt_state=part1.opt_state, **kw)
    _record(out, "sched1", part1)
    _record(out, "sched2", part2)
    np.savez(OUT, **out)
    print(f"wrote {OUT}: vectorized losses "
          f"{np.asarray(vec.loss_history)}, scheduled "
          f"{np.asarray(part1.loss_history)} {np.asarray(part2.loss_history)}")


if __name__ == "__main__":
    main()
