"""Writes tests/torch_camera_ref.npz: the JAX package's camera (``pixel_rays``
of raytracegr_jl_tpu/models/camera.py, the null normalization of the pixel
batch in the Kerr-Schild metric) and its reverse mode per ray in M and a
(``jax.vjp``), which tests/test_torch_camera.py holds the port's
``pixel_rays_plain`` and ``pixel_rays_vjp`` to, so that the tier-1 suite
runs no JAX gradient program.

    python tests/make_torch_camera_ref.py

Per case (``as_written`` at a = 0 and a = 0.6, ``textbook`` at a = 0.6,
rho_min 0.25, f64): example2's 8x8 pixel batch four times over, each copy
a group with its own M and a (so every ray has its own), plus one ray per
group inside the ``rho_min`` floor; seeded cotangents ``ct`` [B, 4]; and
JAX's outputs: ``u`` [B, 4] and the per-ray cotangents ``g_M``, ``g_a``
[B]. Runs on the CPU in a few seconds. Not collected by pytest.
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

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu import grad as j_grad  # noqa: E402
from raytracegr_jl_tpu.models import camera as j_camera  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
N = 8
RHO_MIN = 0.25
CASES = (("as_written_a0", "as_written", 0.0),
         ("as_written_a06", "as_written", 0.6),
         ("textbook_a06", "textbook", 0.6))
GROUP_M = (1.0, 0.8, 1.25, 0.3)
GROUP_A = (1.0, 0.5, 1.5, 0.9)  # times the case's a
FLOOR_NORMAL = (0.0, -1.0, 0.1, 0.05)


def rays(r_formula, a0, rng):
    """The pixel batch per group, one floored ray each: (x, n, M, a)."""
    xg, ng = j_grad.flat_pixel_grid(J.example2_spec(N, N), jnp.float64)
    xs, ns, Ms, As = [], [], [], []
    for M, s in zip(GROUP_M, GROUP_A):
        a = a0 * s
        lim = a * a + RHO_MIN ** 2 if r_formula == "as_written" \
            else RHO_MIN ** 2
        metric = J.make_metric("kerr_schild", J.KerrSchildParams(M=M, a=a),
                               r_formula=r_formula, rho_min=RHO_MIN)
        while True:  # inside the floor, where u is finite
            p = rng.uniform(-1.0, 1.0, 3) * np.sqrt(lim)
            u = j_camera.pixel_rays(metric, jnp.asarray([0.0, *p]),
                                    jnp.asarray(FLOOR_NORMAL))[1]
            if p @ p < lim and bool(jnp.isfinite(u).all()):
                break
        x = np.concatenate([np.asarray(xg), [[0.0, *p]]])
        n = np.concatenate([np.asarray(ng), [FLOOR_NORMAL]])
        xs.append(x)
        ns.append(n)
        Ms.append(np.full(len(x), M))
        As.append(np.full(len(x), a))
    return [np.concatenate(v) for v in (xs, ns, Ms, As)]


def main():
    out = {}
    rng = np.random.default_rng(13)
    for name, r_formula, a0 in CASES:
        x, n, Mv, av = rays(r_formula, a0, rng)
        ct = rng.standard_normal(x.shape)
        ct[::7] = 0.0

        def camera(M, a):
            metric = J.make_metric("kerr_schild", J.KerrSchildParams(M=M, a=a),
                                   r_formula=r_formula, rho_min=RHO_MIN)
            return j_camera.pixel_rays(metric, jnp.asarray(x),
                                       jnp.asarray(n))[1]

        u, vjp = jax.vjp(camera, jnp.asarray(Mv), jnp.asarray(av))
        g_M, g_a = vjp(jnp.asarray(ct))
        print(name, "rays", len(x), "finite", bool(np.isfinite(u).all()),
              flush=True)
        out.update({f"{name}_x": x, f"{name}_n": n, f"{name}_M": Mv,
                    f"{name}_a": av, f"{name}_ct": ct,
                    f"{name}_u": np.asarray(u), f"{name}_g_M": np.asarray(g_M),
                    f"{name}_g_a": np.asarray(g_a)})
    np.savez_compressed(os.path.join(HERE, "torch_camera_ref.npz"), **out)


if __name__ == "__main__":
    main()
