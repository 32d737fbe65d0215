"""The training path of the PyTorch port against the JAX package: soft
shading, the camera's gradients in M and a, the pixel-loss value and
gradients of ``make_ray_loss_fn`` (plus a finite difference), and three
Adam steps of ``inverse.fit``. Everything runs on the CPU in f64 at 8x8,
RK4 with 20 steps (the port takes its plain K3/K4 versions there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu import grad as j_grad  # noqa: E402
from raytracegr_jl_tpu import inverse as j_inverse  # noqa: E402
from raytracegr_jl_tpu.models import camera as j_camera  # noqa: E402
from raytracegr_jl_tpu.models import objects as j_objects  # noqa: E402
from raytracegr_jl_tpu_torch.models import camera as t_camera  # noqa: E402
from raytracegr_jl_tpu_torch.models import objects as t_objects  # noqa: E402
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 8
TRUTH = dict(M=1.0, a=0.0, sphere_pos=[0.0, 4.0, 0.0, 0.0])


def _cfgs(soft_temp=None):
    """The bench's differentiable configuration, cut to 20 RK4 steps of
    0.5, in both packages (the JAX one on its component-major path)."""
    j = j_grad.default_inverse_cfg(
        jnp.float64, max_steps=20, method="rk4", rk4_dt=0.5, stop_rho=0.5,
        soft_temp=soft_temp)._replace(backend="xla_cm")
    t = T.default_inverse_cfg(torch.float64, max_steps=20, method="rk4",
                              rk4_dt=0.5, stop_rho=0.5, soft_temp=soft_temp)
    assert tuple(t.integrator) == tuple(j.integrator)
    return j, t


def _j_params(M, a, sphere_pos):
    return j_grad.InverseParams(M=jnp.asarray(M), a=jnp.asarray(a),
                                sphere_pos=jnp.asarray(sphere_pos))


def _t_params(M, a, sphere_pos):
    pos = sphere_pos
    return convert.inverse_params_from_numpy(np.float64(M), np.float64(a),
                                             np.asarray(pos, np.float64),
                                             device="cpu")


def _scene_pair():
    spec = J.example2_spec(N, N)
    _, jscene, _ = J.build(spec, jnp.float64)
    fields = {f: np.asarray(getattr(jscene, f)) for f in jscene._fields}
    return jscene, convert.scene_from_numpy(fields, device="cpu")


def test_soft_shading_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 4)) * 3.0
    x[:16, 1:] = np.array([4.0, 0.0, 0.0]) + rng.normal(size=(16, 3)) * 0.3
    jscene, tscene = _scene_pair()
    for smooth in (False, True):
        j = np.asarray(j_objects.colors(jscene, jnp.asarray(x),
                                        smooth=smooth, freq=2.0))
        t = t_objects.colors(tscene, torch.from_numpy(x), smooth=smooth,
                             freq=2.0).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)
    j = np.asarray(j_objects.shade_soft(jscene, jnp.asarray(x), 0.01, 0.05))
    t = t_objects.shade_soft(tscene, torch.from_numpy(x), 0.01, 0.05).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)


def test_camera_gradients_reach_M_and_a():
    """``make_metric`` and ``pixel_rays`` carry gradients in M and a (the
    null normalization depends on the metric): a weighted sum of the rays'
    4-velocities differentiated by torch.autograd and by jax.grad."""
    spec = J.example2_spec(N, N)
    xg, ng = j_grad.flat_pixel_grid(spec, jnp.float64)
    w = np.random.default_rng(4).normal(size=(N * N, 4))

    def j_fn(M, a):
        metric = J.make_metric("kerr_schild", J.KerrSchildParams(M=M, a=a),
                               rho_min=0.25)
        return jnp.sum(j_camera.pixel_rays(metric, xg, ng)[1] * w)

    jg = jax.grad(j_fn, argnums=(0, 1))(jnp.asarray(1.05), jnp.asarray(0.3))
    M = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
    a = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(M=M, a=a),
                           rho_min=0.25)
    u = t_camera.pixel_rays(metric, torch.tensor(np.asarray(xg)),
                            torch.tensor(np.asarray(ng)))[1]
    gM, ga = torch.autograd.grad((u * torch.from_numpy(w)).sum(), (M, a))
    assert float(gM) != 0.0 and float(ga) != 0.0
    np.testing.assert_allclose([float(gM), float(ga)],
                               [float(jg[0]), float(jg[1])], rtol=1e-12)


def test_ray_loss_value_and_gradients_match_jax():
    """(c) ``make_ray_loss_fn`` at M = 1.05 against the truth's image:
    the loss and its (M, a, sphere_pos) gradients equal JAX's
    ``jax.value_and_grad`` to rtol 1e-8, and the port's M gradient equals a
    central finite difference of its own loss."""
    jcfg, tcfg = _cfgs()
    spec_j, spec_t = J.example2_spec(N, N), T.example2_spec(N, N)
    xg, ng = j_grad.flat_pixel_grid(spec_j, jnp.float64)
    render = j_grad.make_ray_render_for_params(spec_j, jcfg, 2, jnp.float64)
    target = render(_j_params(**TRUTH), xg, ng)
    jloss = j_grad.make_ray_loss_fn(spec_j, jcfg, 2, jnp.float64)
    step = _j_params(1.05, 0.0, TRUTH["sphere_pos"])
    jl, jg = jax.jit(jax.value_and_grad(jloss))(step, xg, ng, target)

    txg, tng = T.flat_pixel_grid(spec_t, torch.float64, "cpu")
    np.testing.assert_allclose(txg.numpy(), np.asarray(xg), rtol=1e-15)
    tloss = T.make_ray_loss_fn(spec_t, tcfg, 2, torch.float64, "cpu")
    tgt = torch.from_numpy(np.asarray(target))
    params = _t_params(1.05, 0.0, TRUTH["sphere_pos"])
    loss = tloss(params, txg, tng, tgt)
    loss.backward()
    loss = float(loss.detach())
    np.testing.assert_allclose(loss, float(jl), rtol=1e-9)
    assert loss > 0
    scale = float(np.abs(np.asarray(jg.sphere_pos)).max())
    for name in ("M", "a", "sphere_pos"):
        np.testing.assert_allclose(
            getattr(params, name).grad.numpy(),
            np.asarray(getattr(jg, name)), rtol=1e-9, atol=1e-10 * scale,
            err_msg=name)
    assert float(params.M.grad) != 0.0

    eps = 1e-6
    with torch.no_grad():
        up = tloss(_t_params(1.05 + eps, 0.0, TRUTH["sphere_pos"]), txg,
                   tng, tgt)
        dn = tloss(_t_params(1.05 - eps, 0.0, TRUTH["sphere_pos"]), txg,
                   tng, tgt)
    fd = (float(up) - float(dn)) / (2 * eps)
    np.testing.assert_allclose(float(params.M.grad), fd, rtol=1e-5)


def test_fit_adam_steps_match_jax():
    """(d) Three Adam steps of ``inverse.fit`` (soft shading, spin and the
    sphere's time frozen) against the JAX ``fit`` on the same
    configuration and target: every iterate within 1e-8."""
    jcfg, tcfg = _cfgs(soft_temp=0.05)
    spec_j, spec_t = J.example2_spec(N, N), T.example2_spec(N, N)
    target = j_grad.make_render_for_params(spec_j, jcfg, 2, jnp.float64)(
        _j_params(**TRUTH))
    init = (1.05, 0.0, [0.0, 4.03, 0.02, 0.05])
    mask = (1.0, 0.0, [0.0, 1.0, 1.0, 1.0])
    kw = dict(steps=3, learning_rate=3e-2)
    jres = j_inverse.fit(spec_j, target, _j_params(*init), jcfg,
                         trainable=_j_params(*mask), dtype=jnp.float64, **kw)
    tres = T.fit(spec_t, torch.from_numpy(np.asarray(target)),
                 _t_params(*init), tcfg, trainable=_t_params(*mask),
                 dtype=torch.float64, **kw)
    np.testing.assert_allclose(tres.loss_history.numpy(),
                               np.asarray(jres.loss_history), rtol=1e-8)
    for name in ("M", "a", "sphere_pos"):
        np.testing.assert_allclose(
            tres.params_history[name].numpy(),
            np.asarray(getattr(jres.params_history, name)), atol=1e-8,
            err_msg=name)
        np.testing.assert_allclose(
            getattr(tres.final_params, name).detach().numpy(),
            np.asarray(getattr(jres.final_params, name)), atol=1e-8,
            err_msg=name)
        np.testing.assert_allclose(
            getattr(tres.params, name).detach().numpy(),
            np.asarray(getattr(jres.params, name)), atol=1e-8, err_msg=name)
    assert float(tres.final_params.M.detach()) != init[0]
    assert float(tres.final_params.a.detach()) == 0.0


def test_fit_multistart_keeps_the_best_run():
    """The serial multistart (``vectorized=False``) returns the run of
    least loss, the first on ties (port only: each run is ``fit``, held to
    JAX above)."""
    spec = T.example2_spec(4, 4)
    _, tcfg = _cfgs(soft_temp=0.05)
    tcfg = tcfg._replace(integrator=tcfg.integrator._replace(max_steps=8))
    target = T.make_render_for_params(spec, tcfg, 2, torch.float64, "cpu")(
        _t_params(**TRUTH)).detach()
    inits = [_t_params(M, 0.0, TRUTH["sphere_pos"]) for M in (1.2, 1.02)]
    kw = dict(steps=2, dtype=torch.float64)
    runs = [T.fit(spec, target, ini, tcfg, **kw) for ini in inits]
    best = T.fit_multistart(spec, target, inits, tcfg, vectorized=False,
                            **kw)
    want = min(runs, key=lambda r: float(r.loss))
    assert float(best.loss) == float(want.loss)
    assert torch.equal(best.params.M, want.params.M)
    with pytest.raises(ValueError):
        T.fit_multistart(spec, target, [], tcfg, **kw)
