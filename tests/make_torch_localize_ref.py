"""Writes tests/torch_localize_ref.npz: the JAX package's reverse mode of
its localization epilogue (``localize_events_cm`` of
raytracegr_jl_tpu/ops/pallas_geodesic.py, with ``_localize_from_cm`` and
the dead-ray cutoff, as ``integrate_rays_cm_ckpt_pallas`` runs it after its
segments), which tests/test_torch_localize.py holds the port's
``localize_vjp`` to, so that the tier-1 suite runs no JAX gradient program.

    python tests/make_torch_localize_ref.py

Per case (example2 at 8x8, f64, rk4 (64 steps) and tsit5 (200); example1
at 8x8, f64, rk4 (64); each with the training path's configuration,
``default_inverse_cfg``, capture-stop 0.5): the final packed state ``P``
[34, 64] of the port's plain forward (the inputs; the JAX function reads
them as its 14-tuple), seeded cotangents ``ct_y`` [8, 64] and ``ct_lam`` [64], the
parameter vector ``pvec`` (M, a, 8 fields per object), and JAX's outputs:
``y``, ``lam``, and ``jax.vjp``'s cotangents of the state's ``y`` and
``ev_y0`` and of ``pvec``. Runs on the CPU in about a minute. Not
collected by pytest.
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
import torch  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_adjoint as jpa  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
F64 = torch.float64
N = 8
CASES = (("example2_rk4", "example2", "rk4", 64),
         ("example2_tsit5", "example2", "tsit5", 200),
         ("example1_rk4", "example1", "rk4", 64))


def port_state(spec_name, method, steps):
    """The port's plain forward at N x N f64: (route, P [34, B])."""
    spec = (T.example2_spec if spec_name == "example2"
            else T.example1_spec)(N, N)
    cfg = T.default_inverse_cfg(F64, max_steps=steps, method=method,
                                rk4_dt=0.5, stop_rho=0.5).integrator
    metric, scene, canvas = T.build(spec, F64, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    seg = A.segment_length(cfg, None)
    route = A.Route(metric=metric, scene=scene, cfg=cfg, seg_len=seg,
                    n_seg=cfg.max_steps // seg, cuda=False)
    ck, _ = A.run_segments(route, y0.t())
    return spec, route, ck[route.n_seg].contiguous()


def jax_vjp(spec, route, P, ct_y, ct_lam):
    """JAX's epilogue on P and its VJP: (y, lam, ct of y, ct of ev_y0, ct
    of pvec), as integrate_rays_cm_ckpt_pallas differentiates it."""
    cfg = route.cfg
    jcfg = J.IntegratorConfig(**{f: getattr(cfg, f)
                                 for f in J.IntegratorConfig._fields
                                 if f in cfg._fields})
    scene = route.scene
    kinds = tuple(int(k) for k in scene.kind.tolist())
    pvec = A.flatten_params(route.metric, scene).numpy()
    kerr = route.metric.name == "kerr_schild"
    st = [jnp.asarray(P[i].numpy()) for i in range(A.N_PLANES)]
    y, ev_y0 = jnp.stack(st[0:8]), jnp.stack(st[22:30])
    rest = dict(lam=st[8], dt=st[9], k1=jnp.stack(st[10:18]), active=st[18],
                hit=st[19], steps=st[20], err_old=st[21], ev_dt=st[30],
                ev_lam=st[31], ev_lo=st[32], ev_hi=st[33])
    names = ("pos1", "pos2", "pos3", "radius", "time", "r_in", "r_out",
             "half")

    def epilogue(y, ev_y0, pv):
        if kerr:
            mcm = jpg.kerr_schild_cm(J.KerrSchildParams(M=pv[0], a=pv[1]),
                                     route.metric.r_formula,
                                     rho_min=route.metric.rho_min)
        else:
            mcm = jpg.minkowski_cm()

        def make_get(i):
            def get(field, comp=None):
                k = comp - 1 if field == "pos" else names.index(field)
                return pv[2 + len(names) * i + k]
            return get

        event = jpg.scene_event_from_get(kinds, make_get)
        dead = ((rest["hit"] <= 0) & (rest["active"] <= 0)
                & (rest["lam"] < cfg.lam_max - 1e-6))
        y = jnp.where(dead, jax.lax.stop_gradient(y), y)
        st14 = (y, rest["lam"], rest["dt"], rest["k1"], rest["active"],
                rest["hit"], rest["steps"], rest["err_old"],
                jnp.zeros((), jnp.float64), ev_y0, rest["ev_dt"],
                rest["ev_lam"], rest["ev_lo"], rest["ev_hi"])
        return jpg.localize_events_cm(mcm, event, jcfg, st14)

    (y_out, lam_out), vjp = jax.vjp(epilogue, y, ev_y0, jnp.asarray(pvec))
    g_y, g_ev, g_p = vjp((jnp.asarray(ct_y), jnp.asarray(ct_lam)))
    return [np.asarray(v) for v in (y_out, lam_out, g_y, g_ev, g_p)], pvec


def main():
    out = {}
    rng = np.random.default_rng(11)
    for name, spec_name, method, steps in CASES:
        spec, route, P = port_state(spec_name, method, steps)
        B = P.shape[1]
        ct_y = rng.standard_normal((8, B))
        ct_lam = rng.standard_normal(B)
        ct_y[:, ::5] = 0.0
        ct_lam[::5] = 0.0
        (y, lam, g_y, g_ev, g_p), pvec = jax_vjp(spec, route, P, ct_y,
                                                 ct_lam)
        hit = P[A.P_HIT].numpy() > 0
        print(name, "hits", int(hit.sum()), "of", B, flush=True)
        out.update({f"{name}_P": P.numpy(), f"{name}_ct_y": ct_y,
                    f"{name}_ct_lam": ct_lam, f"{name}_pvec": pvec,
                    f"{name}_y": y, f"{name}_lam": lam, f"{name}_g_y": g_y,
                    f"{name}_g_ev": g_ev, f"{name}_g_p": g_p})
    np.savez_compressed(os.path.join(HERE, "torch_localize_ref.npz"), **out)


if __name__ == "__main__":
    main()
