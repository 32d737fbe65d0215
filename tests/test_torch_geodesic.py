"""K1's building blocks in the PyTorch port against the JAX package: the
component-major right-hand side, the Tsit5 tableau and dense output, the
initial step, the scene event and the Newton polish's explicit derivative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example2_spec as j_example2  # noqa: E402
from raytracegr_jl_tpu.ops import integrate as jint  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
from raytracegr_jl_tpu.ops.metrics import KerrSchildParams as JParams  # noqa: E402
from raytracegr_jl_tpu_torch.models.objects import (Disk, Plane,  # noqa: E402
                                                    Sphere, make_scene)
from raytracegr_jl_tpu_torch.ops import geodesic_cm as tgc  # noqa: E402
from raytracegr_jl_tpu_torch.ops import integrate as tint  # noqa: E402
from raytracegr_jl_tpu_torch.ops.metrics import (KerrSchildParams,  # noqa: E402
                                                 make_metric)
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(seed=0, n=400):
    """[8, n] states: random, plus positions near the as_written horizon
    (rho ~ 1.56) and at the coordinate origin (inside the clamp)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(8, n)) * 3.0
    d = rng.normal(size=(3, n // 4))
    d /= np.linalg.norm(d, axis=0)
    y[1:4, : n // 4] = d * rng.uniform(1.4, 2.2, n // 4)
    y[1:4, n // 4: n // 4 + 20] *= 1e-5
    return y


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("a,rf", [(0.0, "as_written"), (0.8, "textbook"),
                                  (0.8, "as_written")])
def test_geodesic_cm_matches_jax(dtype, rtol, a, rf):
    y = _states().astype(dtype)
    j = np.asarray(jpg.geodesic_cm(jpg.kerr_schild_cm(JParams(1.0, a), rf),
                                   jnp.asarray(y)[:, :, None]))[:, :, 0]
    metric = make_metric("kerr_schild", KerrSchildParams(1.0, a),
                         r_formula=rf)
    t = tgc.geodesic_cm(metric, torch.from_numpy(y)).numpy()
    assert t.dtype == dtype
    # Relative to each component's scale over the batch: the RHS's sums
    # cancel, so single entries can be far smaller than their terms.
    scale = np.abs(j).max(axis=1, keepdims=True)
    err = np.abs(t.astype(np.float64) - j) / (np.abs(j) + scale)
    assert err.max() <= rtol, f"max scaled error {err.max():.3e}"


def test_geodesic_cm_minkowski_is_exact():
    y = _states(1)
    t = tgc.geodesic_cm(make_metric("minkowski"), torch.from_numpy(y)).numpy()
    j = np.asarray(jpg.geodesic_cm(jpg.minkowski_cm(),
                                   jnp.asarray(y)[:, :, None]))[:, :, 0]
    np.testing.assert_array_equal(t, j)
    assert not t[4:].any()


def test_tsit5_tables_equal_jax():
    assert tint.TS_A == jint.TS_A
    assert tint.TS_BTILDE == jint.TS_BTILDE
    assert tint.TS_C == jint.TS_C
    assert tint.ERR_BIG == jint.ERR_BIG
    # python-float thetas (the detection samples): identical arithmetic
    for npts in (9, 13):
        for i in range(npts + 1):
            th = i / npts
            assert tint.tsit5_bi(th) == tuple(float(b) for b in
                                              jint.tsit5_bi(th))
    th = np.linspace(0.0, 1.0, 101)
    for t, j in zip(tint.tsit5_bi(torch.from_numpy(th)),
                    jint.tsit5_bi(jnp.asarray(th))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-15,
                                   atol=1e-16)


def test_dense_output_derivatives_match_autodiff():
    th = torch.linspace(0.0, 1.0, 33, dtype=torch.float64)
    for fn, dfn in [(tint.tsit5_bi, tint.tsit5_dbi)]:
        for i in range(7):
            _, jv = torch.func.jvp(lambda t: fn(t)[i], (th,),
                                   (torch.ones_like(th),))
            np.testing.assert_allclose(dfn(th)[i].numpy(), jv.numpy(),
                                       rtol=1e-12, atol=1e-14)
    rng = np.random.default_rng(4)
    y0, y1, f0, f1 = (torch.from_numpy(rng.normal(size=(4, 33)))
                      for _ in range(4))
    dt = torch.from_numpy(rng.uniform(0.1, 2.0, 33))
    _, jv = torch.func.jvp(
        lambda t: tint.hermite_interp(y0, y1, f0, f1, dt, t), (th,),
        (torch.ones_like(th),))
    np.testing.assert_allclose(
        tint.hermite_dinterp(y0, y1, f0, f1, dt, th).numpy(), jv.numpy(),
        rtol=1e-12, atol=1e-13)


def test_hairer_init_dt_matches_jax():
    metric, scene, canvas = j_build(j_example2(16, 16), jnp.float64)
    y0 = jnp.concatenate([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    mcm = metric.component_major

    def rhs_cm(y):
        return jpg.geodesic_cm(mcm, y.T[:, None, :])[:, 0, :].T

    for tol in (1e-9, 1.8e-12):
        j = np.asarray(jint.hairer_init_dt(rhs_cm, y0, tol, tol, 5, 100.0))
        cfg = tint.IntegratorConfig(rtol=tol, atol=tol)
        t = initial_dt(make_metric("kerr_schild"),
                       torch.from_numpy(np.array(y0)), cfg).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-12)


def _scene_all_kinds():
    return make_scene([Sphere((0, 0, 0, 0), (1, 0, 0, 0), -10.0),
                       Plane(-20.0),
                       Sphere((0, 4, 0, 0), (1, 0, 0, 0), 0.5),
                       Disk((0, 0, 0, 0), 3.0, 12.0, 0.1)], device="cpu")


def test_scene_event_matches_jax():
    from raytracegr_jl_tpu.models.objects import Disk as JD
    from raytracegr_jl_tpu.models.objects import Plane as JPl
    from raytracegr_jl_tpu.models.objects import Sphere as JS
    from raytracegr_jl_tpu.models.objects import make_scene as jms

    js = jms([JS((0, 0, 0, 0), (1, 0, 0, 0), -10.0), JPl(-20.0),
              JS((0, 4, 0, 0), (1, 0, 0, 0), 0.5), JD((0, 0, 0, 0), 3.0,
                                                      12.0, 0.1)])
    x = _states(5)[:4] * 3
    j = np.asarray(jpg.scene_event_cm(js)(jnp.asarray(x)))
    t = tgc.scene_event_cm(_scene_all_kinds())(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(t, j)


def test_event_jvp_matches_autodiff():
    """The explicit event derivative (per kind, ties split) that the Newton
    polish uses equals torch.func.jvp of the event."""
    ev = tgc.scene_event_cm(_scene_all_kinds())
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(4, 500)) * 6)
    dx = torch.from_numpy(rng.normal(size=(4, 500)))
    val, dval = ev.jvp(x, dx)
    jv, jd = torch.func.jvp(ev, (x,), (dx,))
    np.testing.assert_array_equal(val.numpy(), jv.numpy())
    np.testing.assert_allclose(dval.numpy(), jd.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("method", ["tsit5", "rk4"])
def test_newton_polish_derivative_matches_autodiff(method):
    """d/dtheta event(interp(theta)) by the explicit formula (dense output
    by the product rule, event per kind) against torch.func.jvp."""
    spec = j_example2(4, 4)
    metric = make_metric("kerr_schild")
    jm, js, jc = j_build(spec, jnp.float64)
    scene = convert.scene_from_numpy({f: np.asarray(getattr(js, f))
                                      for f in js._fields})
    ev = tgc.scene_event_cm(scene)
    rng = np.random.default_rng(7)
    y0 = torch.from_numpy(_states(8, 64))
    dt = torch.from_numpy(rng.uniform(0.05, 1.0, 64))
    rhs = lambda s: tgc.geodesic_cm(metric, s)  # noqa: E731
    k1 = rhs(y0)
    step = tgc._tsit5_step_cm if method == "tsit5" else tgc._rk4_step_cm
    y1, _, k_last, ks = step(rhs, y0, dt, k1)
    interp, dinterp = tgc._interpolants(y0, y1, k1, k_last, dt, ks, 4)
    th = torch.from_numpy(rng.uniform(0.0, 1.0, 64))
    val, dval = ev.jvp(interp(th), dinterp(th))
    jv, jd = torch.func.jvp(lambda t: ev(interp(t)), (th,),
                            (torch.ones_like(th),))
    np.testing.assert_array_equal(val.numpy(), jv.numpy())
    np.testing.assert_allclose(dval.numpy(), jd.numpy(), rtol=1e-10,
                               atol=1e-10 * float(jd.abs().max()))


def test_registered_kind_reaches_the_plain_version_only():
    """A kind registered with register_kind (no hand-written derivative)
    joins the event and its derivative, by torch.func.jvp; the CUDA
    wrapper, which knows only the built-in kinds, refuses the scene."""
    from raytracegr_jl_tpu_torch.models import objects

    kind = 7
    objects.register_kind(kind, lambda t, x, y, z, get: x - get("time"))
    try:
        scene = _scene_all_kinds()
        scene = scene._replace(kind=torch.cat([scene.kind, torch.tensor(
            [kind], dtype=torch.int32)]), **{
            f: torch.cat([getattr(scene, f), getattr(scene, f)[-1:]])
            for f in ("pos", "vel", "radius", "time", "r_in", "r_out",
                      "half")})
        ev = tgc.scene_event_cm(scene)
        x = torch.from_numpy(_states(9)[:4] * 3)
        dx = torch.ones_like(x)
        val, dval = ev.jvp(x, dx)
        jv, jd = torch.func.jvp(ev, (x,), (dx,))
        np.testing.assert_array_equal(val.numpy(), jv.numpy())
        np.testing.assert_allclose(dval.numpy(), jd.numpy(), rtol=1e-12,
                                   atol=1e-12)
        assert (val <= x[1]).all()
        y0 = torch.from_numpy(_states(9, 8).T.copy())
        with pytest.raises(NotImplementedError, match="kinds"):
            tgc.integrate_rays_cuda(make_metric("minkowski"), scene, y0,
                                    torch.ones(8, dtype=torch.float64),
                                    tint.IntegratorConfig())
    finally:
        objects.KIND_DISTANCE.pop(kind)
        objects.KIND_DISTANCE_JVP.pop(kind)
