"""The port's gravitational-redshift shading (models/shading.py) against the
JAX package's on the same states at f64, and the physics cases of the JAX
package's tests/test_shading.py run through the port.

The states are random ones (positions outside the hole, random momenta)
and the end states of a 16x16 accretion-disk trace through the port's
plain integrator, with the camera rays as launch states. Tolerance: 1e-12
relative to each output's largest magnitude. The two libraries share the
expression trees; they differ in the order of the contractions' sums (the
port's are left to right, K5's order) and, for the colours, in atan2/acos
by a few ulp (tests/test_torch_render.py). The contractions' order itself
is held bitwise, at f32 and f64, to a reference written out term by
term."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu.models import shading as js  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models import shading as ts  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cm  # noqa: E402
from raytracegr_jl_tpu_torch.render import initial_dt, trace_batch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-12
M, A = 1.0, 0.8


def _metrics():
    kw = dict(r_formula="textbook")
    return (J.make_metric("kerr_schild", J.KerrSchildParams(M=M, a=A), **kw),
            T.make_metric("kerr_schild", T.KerrSchildParams(M=M, a=A), **kw))


@pytest.fixture(scope="module")
def states():
    """(y0, y) [B, 8] f64 pairs: random states, then the launch and end
    states of a 16x16 disk trace (port, plain integrator)."""
    rng = np.random.default_rng(0)
    n = 512
    x = rng.uniform(-15.0, 15.0, (n, 4))
    x[:, 1:] *= (2.5 + rng.uniform(0, 12, (n, 1))) / np.linalg.norm(
        x[:, 1:], axis=1, keepdims=True)
    y = np.concatenate([x, rng.normal(size=(n, 4))], 1)
    y0 = np.concatenate([x[::-1] * 1.5, rng.normal(size=(n, 4))], 1)
    metric, scene, canvas = T.build(T.accretion_disk_spec(16, 16),
                                    torch.float64, "cpu")
    d0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    cfg = T.IntegratorConfig(rtol=1e-8, atol=1e-8, max_steps=400,
                             stop_rho=1.0)
    res = integrate_rays_cm(metric, scene, d0, initial_dt(metric, d0, cfg),
                            cfg)
    assert int(res.hit.sum()) > 0
    return (np.concatenate([y0, d0.numpy()]),
            np.concatenate([y, res.y.numpy()]), scene)


def _close(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape and np.isfinite(t).all()
    scale = np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=RTOL * scale)


def _jax_scene(scene):
    return J.Scene(**{f: jnp.asarray(getattr(scene, f).numpy())
                      for f in scene._fields})


@pytest.mark.parametrize("fn", ["shade_redshift", "g_factors",
                                "camera_frequency", "keplerian_velocity"])
def test_shading_functions_match_jax(states, fn):
    y0, y, scene = states
    jm, tm = _metrics()
    js_scene = _jax_scene(scene)
    jy0, jy = jnp.asarray(y0), jnp.asarray(y)
    ty0, ty = torch.from_numpy(y0), torch.from_numpy(y)
    if fn == "shade_redshift":
        j = js.shade_redshift(jm, js_scene, jy0, jy, M, A)
        t = ts.shade_redshift(tm, scene, ty0, ty, M, A)
        assert (np.asarray(j).max(-1) > 0).sum() > 0  # some rays are lit
    elif fn == "g_factors":
        j = js.g_factors(jm, js_scene, jy0, jy, M, A)
        t = ts.g_factors(tm, scene, ty0, ty, M, A)
    elif fn == "camera_frequency":
        j = js.camera_frequency(jm, jy0)
        t = ts.camera_frequency(tm, ty0)
    else:
        x = jy[:, :4]
        j = js.keplerian_velocity(jm(x), x, jnp.zeros(4), M, A)
        t = ts.keplerian_velocity(tm(ty[:, :4]), ty[:, :4],
                                  torch.zeros(4, dtype=torch.float64), M, A)
    _close(t.numpy(), j)


def _contract_lr(u, g, v):
    """u^a g_ab v^b of [B, 4], [B, 4, 4] (or [4, 4]), [B, 4], term by term:
    each inner sum over b left to right, then the outer one over a (K5's
    order, csrc/camera_common.cuh quad)."""
    acc = None
    for a in range(4):
        gv = g[..., a, 0] * v[:, 0]
        for b in range(1, 4):
            gv = gv + g[..., a, b] * v[:, b]
        acc = u[:, a] * gv if acc is None else acc + u[:, a] * gv
    return acc


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_contractions_sum_left_to_right(states, dtype):
    """normalize_timelike, camera_frequency and g_factors on the seeded
    states equal a reference that writes each contraction out term by term
    (inner sums over b left to right, then over a), bit for bit: the order
    K5 adds in, so that the kernel can equal the plain version."""
    from raytracegr_jl_tpu_torch.ops.geometry import inv4_column0
    y0n, yn, scene = states
    _, tm = _metrics()
    y0 = torch.from_numpy(y0n).to(dtype)
    y = torch.from_numpy(yn).to(dtype)
    scene = scene._replace(**{f: v.to(dtype) for f, v in
                              scene._asdict().items() if f != "kind"})
    floor = ts._NORM2_FLOOR

    def normalize(g, v):
        n2 = -_contract_lr(v, g, v)
        return v / torch.sqrt(torch.clamp_min(n2, floor))[:, None]

    x0, k0 = y0[:, :4], y0[:, 4:]
    g0 = tm(x0)
    t = torch.stack(inv4_column0([[g0[:, a, b] for b in range(4)]
                                  for a in range(4)]), -1)
    w_obs = -_contract_lr(normalize(g0, t), g0, k0)
    assert torch.equal(_bits(ts.camera_frequency(tm, y0)), _bits(w_obs))

    x, k = y[:, :4], y[:, 4:]
    g = tm(x)
    v = torch.from_numpy(np.random.default_rng(1).normal(
        size=(x.shape[0], 4))).to(dtype)
    v[:, 0] = 3.0
    assert torch.equal(_bits(ts.normalize_timelike(g, v)),
                       _bits(normalize(g, v)))

    u = ts.emitter_velocities(tm, scene, x, M, A)  # [B, N, 4]
    w_emit = torch.stack([_contract_lr(u[:, j], g, k)
                          for j in range(u.shape[1])], -1)
    want = w_obs[:, None] / torch.clamp_min(w_emit, 1e-3)
    assert torch.equal(_bits(ts.g_factors(tm, scene, y0, y, M, A)),
                       _bits(want))
    kepler = ts.keplerian_velocity(g[:, None], x[:, None],
                                   scene.pos[1], M, A)[:, 0]
    rel = x[:, 1:] - scene.pos[1, 1:]
    rho = torch.sqrt(torch.clamp_min(rel[:, 0] ** 2 + rel[:, 1] ** 2, floor))
    omega = M ** 0.5 / (rho * torch.sqrt(rho) + A * M ** 0.5)
    vk = torch.stack([torch.ones_like(omega), -omega * rel[:, 1],
                      omega * rel[:, 0], torch.zeros_like(omega)], -1)
    assert torch.equal(_bits(kepler), _bits(normalize(g, vk)))


def _trace_one(metric, scene, pos, normal, **ikw):
    """One camera-normalised ray traced to termination by the port (plain
    integrator, f64): (y0, y) [1, 8]."""
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays

    x0, u0 = pixel_rays(metric, torch.tensor(pos, dtype=torch.float64),
                        torch.tensor(normal, dtype=torch.float64))
    y0 = torch.cat([x0, u0])[None, :]
    tol = T.default_tol(torch.float64)
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        method="tsit5", rtol=tol, atol=tol, **ikw))
    res = trace_batch(metric, scene, y0, cfg)
    assert bool(res.hit[0]), "the ray must hit for the shading test"
    return y0, res.y


def _disk_scene():
    return T.make_scene([
        T.Sphere(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0), radius=-30.0),
        T.Disk(pos=(0, 0, 0, 0), r_in=3.0, r_out=12.0, half=0.1)],
        torch.float64, "cpu")


@pytest.mark.parametrize("case", ["unit_norm", "spin_shift",
                                  "static_emitter", "doppler_sign"])
def test_redshift_physics(case):
    """tests/test_shading.py's cheap physics cases, on the port: the
    Keplerian 4-velocity's norm and angular velocity, the spin's shift of
    the prograde Omega, the static emitter's redshift sqrt(1 - 2M/r), and
    the Doppler sign of a Keplerian disk's two limbs."""
    a = 0.8 if case == "spin_shift" else 0.0
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(M=1.0, a=a),
                           r_formula="textbook")
    f64 = dict(dtype=torch.float64)
    if case in ("unit_norm", "spin_shift"):
        x = torch.tensor([0.0, 6.0, 0.0, 0.0], **f64)
        g = metric(x)
        u = ts.keplerian_velocity(g, x, torch.zeros(4, **f64), 1.0, a)
        assert abs(float(torch.einsum("a,ab,b->", u, g, u)) + 1.0) < 1e-12
        omega = float(u[2] / (6.0 * u[0]))
        assert abs(omega - 1.0 / (6.0 ** 1.5 + a)) < 1e-12
    elif case == "static_emitter":
        scene = T.make_scene([T.Sphere(pos=(0, 0, -4.0, 0),
                                       vel=(1, 0, 0, 0), radius=0.5)],
                             torch.float64, "cpu")
        y0, y = _trace_one(metric, scene, [0., 0., -50., 0.],
                           [0., 0., 1.0, 0.])
        gf = float(ts.g_factors(metric, scene, y0, y, 1.0, 0.0)[0, 0])
        x_hit, k_hit = y[0, :4], y[0, 4:]
        g_hit = metric(x_hit)
        u_static = ts.normalize_timelike(g_hit,
                                         torch.tensor([1., 0., 0., 0.], **f64))
        w_emit = float(torch.einsum("a,ab,b->", u_static, g_hit, k_hit))
        w_obs = float(ts.camera_frequency(metric, y0)[0])
        assert w_emit > 0 and w_obs > 0
        assert abs(gf - w_obs / w_emit) < 1e-10
        E0 = float(-(metric(y0[0, :4]) @ y0[0, 4:])[0])
        E1 = float(-(g_hit @ k_hit)[0])
        assert abs(E1 - E0) < 1e-8 * abs(E0)  # -k_t is conserved
        r_hit = float(torch.linalg.norm(x_hit[1:]))
        assert gf < 1.0 and abs(gf - (1 - 2.0 / r_hit) ** 0.5) < 0.05
    else:
        scene = _disk_scene()
        g_vals = {}
        for side in (-1.0, 1.0):  # x < 0 approaches the camera at y = -30
            y0, y = _trace_one(metric, scene, [0., side * 6.0, -30., 1.5],
                               [0., 0., 1.0, -0.044], stop_rho=1.0)
            g_vals[side] = float(ts.g_factors(metric, scene, y0, y, 1.0,
                                              0.0)[0, 1])
        assert g_vals[-1.0] > 1.05 and g_vals[1.0] < 0.95


def test_redshift_render_runs_through_render_fn():
    """render_fn with shading="redshift" is shade_redshift of the traced
    end states, M and a taken from the metric."""
    metric, scene, canvas = T.build(T.accretion_disk_spec(6, 6),
                                    torch.float64, "cpu")
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=1e-6, atol=1e-6, max_steps=200, stop_rho=1.0),
        shading="redshift")
    rgb = T.render_fn(metric, scene, cfg)(canvas.pos, canvas.normal)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    res = trace_batch(metric, scene, y0, cfg)
    want = ts.shade_redshift(metric, scene, y0, res.y, 1.0, 0.8)
    assert torch.equal(rgb.reshape(-1, 3), want)
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0


def test_redshift_render_is_differentiable():
    """The differentiable render with redshift shading takes its gradient
    through autograd of shade_redshift, as in the JAX package: M receives
    a finite, nonzero gradient, and the image equals the forward render's."""
    M = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(M, 0.8),
                           r_formula="textbook")
    _, scene, canvas = T.build(T.accretion_disk_spec(4, 4), torch.float64,
                               "cpu")
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=1e-6, atol=1e-6, max_steps=64, stop_rho=1.0),
        shading="redshift", differentiable=True)
    rgb = T.render_fn(metric, scene, cfg)(canvas.pos, canvas.normal)
    rgb.sum().backward()
    assert torch.isfinite(M.grad) and float(M.grad) != 0.0
    fwd = T.render_fn(metric, scene, cfg._replace(differentiable=False))(
        canvas.pos, canvas.normal)
    torch.testing.assert_close(rgb.detach(), fwd, rtol=0, atol=1e-12)
