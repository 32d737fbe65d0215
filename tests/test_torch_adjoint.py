"""The checkpointed adjoint of the PyTorch port (ops/adjoint.py) against the
JAX package: the plain forward segment against JAX ``make_step_cm``
iterations, and the plain hand adjoint (K4's arithmetic) against
``torch.autograd`` of the plain body and against ``jax.value_and_grad`` of
the JAX ``integrate_rays_cm_ckpt``. Inputs are made with numpy and fed to
both packages; everything runs on the CPU in f64 at 16x16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracegr_jl_tpu.grad import default_inverse_cfg as j_inverse_cfg  # noqa: E402
from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example2_spec as j_example2  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
from raytracegr_jl_tpu.ops.adjoint import integrate_rays_cm_ckpt  # noqa: E402
from raytracegr_jl_tpu.ops.metrics import KerrSchildParams as JParams  # noqa: E402
from raytracegr_jl_tpu.ops.metrics import make_metric as j_make_metric  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import (geodesic_cm,  # noqa: E402
                                                     make_step_cm,
                                                     scene_event_cm)
from raytracegr_jl_tpu_torch.ops.metrics import (KerrSchildParams,  # noqa: E402
                                                 make_metric)
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RHO_MIN = 0.25  # the JAX adjoint tests' clamp


def _rays(n=16):
    """example2's ray batch and scene, built by the JAX package and carried
    over as numpy, and a flat first step of 0.4."""
    _, scene, canvas = j_build(j_example2(n, n), jnp.float64)
    y0 = np.asarray(jnp.concatenate([canvas.pos, canvas.normal],
                                    -1).reshape(-1, 8))
    fields = {f: np.asarray(getattr(scene, f)) for f in scene._fields}
    return scene, y0, np.full(y0.shape[:1], 0.4), fields


def _cfg(method, max_steps=6, tol=None):
    """The JAX differentiable configuration at f64 and its port; ``tol``
    replaces the tolerance eps^(3/4)."""
    j = j_inverse_cfg(jnp.float64, max_steps=max_steps, method=method,
                      rk4_dt=0.4, stop_rho=0.0).integrator
    if tol is not None:
        j = j._replace(rtol=tol, atol=tol)
    return j, convert.integrator_config_from_fields(j._asdict())


def _metrics(M, a, rf):
    return (j_make_metric("kerr_schild", JParams(M=M, a=a), r_formula=rf,
                          rho_min=RHO_MIN),
            make_metric("kerr_schild", KerrSchildParams(M=M, a=a),
                        r_formula=rf, rho_min=RHO_MIN))


def _compare_states(got, want):
    """Masks and counts exactly, the rest to f64 rounding; Tsit5's next
    step and error norm to 1e-4: its error estimate is a difference of
    stage sums about 1e-12 of the state, so it keeps only 4-5 digits of
    either package's rounding."""
    for name, j in zip(got._fields, want):
        t = getattr(got, name).numpy().astype(np.float64)
        if name in ("active", "hit", "steps"):
            np.testing.assert_array_equal(t, j.astype(np.float64), name)
        else:
            rtol = 1e-4 if name in ("dt", "err_old") else 1e-12
            np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-13,
                                       err_msg=name)


@pytest.mark.parametrize("method", ["rk4", "tsit5"])
def test_forward_segment_matches_jax_step_body(method):
    """(a) The port's step body against the JAX ``make_step_cm`` body:
    each of six steps taken from the same (JAX) state gives the same next
    state to f64 rounding, masks and counts exactly. For RK4 the port's
    three checkpoint segments of two steps also end where six JAX steps
    do. (Tsit5's controller at eps^(3/4) turns a 1-ulp difference of one
    step size into 1e-6 after a few steps, so its trajectories are
    compared step by step.)"""
    jscene, y0, dt0, fields = _rays()
    jcfg, cfg = _cfg(method)
    jm, tm = _metrics(1.05, 0.0, "as_written")
    _, jbody, jinit = jpg.make_step_cm(jm.component_major,
                                       jpg.scene_event_cm(jscene), jcfg)
    jst = jinit(jnp.asarray(y0.T), jnp.asarray(dt0),
                jnp.ones(dt0.shape, bool))
    jbody = jax.jit(jbody)
    states = []
    for _ in range(7):
        states.append([np.asarray(v) for v in jst[:8] + jst[9:]])
        jst = jbody(jst)

    scene = convert.scene_from_numpy(fields, device="cpu")
    _, body = make_step_cm(tm, scene_event_cm(scene), cfg)
    for i in range(6):
        st = A.unpack_state(torch.from_numpy(np.concatenate(
            [np.asarray(v, np.float64).reshape(-1, y0.shape[0])
             for v in states[i]])))
        st = st._replace(steps=st.steps.to(torch.int32))
        _compare_states(body(st)[0], states[i + 1])
    assert int(states[6][5].sum()) > 0 or method == "tsit5"

    if method == "rk4":
        route = A.Route(metric=tm, scene=scene, cfg=cfg, seg_len=2,
                         n_seg=3, cuda=False)
        ck, used = A.run_segments(route, torch.from_numpy(y0.T.copy()),
                                  torch.from_numpy(dt0))
        assert int(used[0]) == 3
        _compare_states(A.unpack_state(ck[route.n_seg]), states[6])


@pytest.mark.parametrize("a,rf", [(0.0, "as_written"), (0.3, "textbook"),
                                  (0.6, "as_written")])
def test_rhs_vjp_matches_autograd(a, rf):
    """K4's hand adjoint of the right-hand side against torch.autograd of
    ``geodesic_cm``, near the hole and far from it, clamps included."""
    rng = np.random.default_rng(1)
    y = rng.normal(size=(8, 200)) * 2
    y[1:4] += np.array([4.0, 1.0, 0.5])[:, None]
    y[1:4, :40] *= 0.25
    ct = torch.from_numpy(rng.normal(size=(8, 200)))
    M = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
    at = torch.tensor(a, dtype=torch.float64, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    metric = make_metric("kerr_schild", KerrSchildParams(M, at),
                         r_formula=rf, rho_min=RHO_MIN)
    gy, gM, ga = torch.autograd.grad(geodesic_cm(metric, yt), (yt, M, at), ct)
    p = A.adj_params(metric, torch.float64, "cpu")
    hy, hM, ha = A.rhs_vjp(p, torch.from_numpy(y), ct)
    np.testing.assert_allclose(hy.numpy(), gy.numpy(), rtol=1e-12,
                               atol=1e-12 * float(gy.abs().max()))
    np.testing.assert_allclose(float(hM.sum()), float(gM), rtol=1e-12)
    np.testing.assert_allclose(float(ha.sum()), float(ga), rtol=1e-11,
                               atol=1e-14)


def _position_loss(y):
    """The JAX adjoint tests' position-sum loss: it exercises the loop's
    gradient path (stages), not only the localization epilogue."""
    return (y[:, :4] ** 2).sum() * 1e-3


@pytest.mark.parametrize("method,a,rf,with_jax", [
    ("rk4", 0.0, "as_written", True),
    ("tsit5", 0.0, "as_written", False),
    ("tsit5", 0.3, "textbook", True)])
def test_hand_adjoint_matches_autograd_and_jax(method, a, rf, with_jax):
    """(b) Gradients of the position-sum loss in (M, a) through the plain
    checkpointed path (the hand adjoint K4 runs) against torch.autograd
    replaying the plain body, and against ``jax.value_and_grad`` of the JAX
    ``integrate_rays_cm_ckpt``: example2 16x16, 6 steps in segments of 2,
    f64, rtol 1e-8. Tsit5 runs at tolerance 1e-8: at eps^(3/4) its
    controller amplifies the two packages' 1-ulp differences (see test
    (a)) beyond 1e-8. One Tsit5 case skips JAX, whose compile is the cost
    of this test."""
    jscene, y0, dt0, fields = _rays()
    jcfg, cfg = _cfg(method, tol=1e-8 if method == "tsit5" else None)

    def j_loss(Ma):
        jm, _ = _metrics(Ma[0], Ma[1], rf)
        res = integrate_rays_cm_ckpt(jm.component_major,
                                     jpg.scene_event_cm(jscene),
                                     jnp.asarray(y0), jnp.asarray(dt0),
                                     jcfg, seg_len=2)
        return _position_loss(res.y)

    if with_jax:
        jl, jg = jax.jit(jax.value_and_grad(j_loss))(
            (jnp.asarray(1.05), jnp.asarray(a)))

    scene = convert.scene_from_numpy(fields, device="cpu")
    out = {}
    for name, fn in (("ckpt", A.integrate_rays_ckpt),
                     ("autograd", A.integrate_rays_autograd)):
        M = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
        at = torch.tensor(a, dtype=torch.float64, requires_grad=True)
        _, tm = _metrics(M, at, rf)
        res = fn(tm, scene, torch.from_numpy(y0.copy()),
                 torch.from_numpy(dt0),
                 cfg, seg_len=2)
        loss = _position_loss(res.y)
        gM, ga = torch.autograd.grad(loss, (M, at))
        out[name] = (float(loss.detach()), float(gM), float(ga))
        assert res.n_iters == 6
    ckpt, oracle = out["ckpt"], out["autograd"]
    np.testing.assert_allclose(ckpt, oracle, rtol=1e-12, atol=1e-15)
    assert ckpt[1] != 0.0
    if with_jax:
        np.testing.assert_allclose(ckpt[0], float(jl), rtol=1e-10)
        np.testing.assert_allclose(ckpt[1:], [float(jg[0]), float(jg[1])],
                                   rtol=1e-8, atol=1e-12)


def test_hand_adjoint_matches_autograd_per_ray():
    """The plain backward's per-ray outputs (state cotangents and per-ray
    (M, a) cotangents) against autograd of the segments it replays, with a
    random cotangent on every differentiable plane, capture-stop on."""
    _, y0, dt0, fields = _rays(8)
    _, cfg = _cfg("rk4", max_steps=8)
    cfg = cfg._replace(stop_rho=0.5)
    scene = convert.scene_from_numpy(fields, device="cpu")
    M = torch.tensor(1.05, dtype=torch.float64, requires_grad=True)
    at = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    _, tm = _metrics(M, at, "as_written")
    init, body = make_step_cm(tm, scene_event_cm(scene), cfg)
    P0 = A.pack_state(init(torch.from_numpy(y0.T.copy()),
                           torch.from_numpy(dt0)))
    P0.retain_grad()
    st = A.unpack_state(P0)
    for _ in range(8):
        st, _ = body(st)
    P = A.pack_state(st)
    rng = np.random.default_rng(2)
    ct = torch.from_numpy(rng.normal(size=tuple(P.shape)))
    keep = torch.zeros(A.N_PLANES, 1, dtype=torch.float64)
    for lo in (A.P_Y, A.P_K1, A.P_EV_Y0):
        keep[lo:lo + 8] = 1
    ct = ct * keep
    gP0, gM, ga = torch.autograd.grad(P, (P0, M, at), ct)

    plain_tm = make_metric("kerr_schild", KerrSchildParams(
        M.detach(), at.detach()), rho_min=RHO_MIN)
    route = A.Route(metric=plain_tm, scene=scene, cfg=cfg, seg_len=4,
                     n_seg=2, cuda=False)
    ck, used = A.run_segments(route, torch.from_numpy(y0.T.copy()),
                              torch.from_numpy(dt0))
    assert torch.equal(ck[0], P0.detach())
    ct0, pbar = A.backward_plain(route, ck, used[1:], ct)
    np.testing.assert_allclose(ct0.numpy(), (gP0 * keep).numpy(),
                               rtol=1e-10, atol=1e-12)
    # autograd reaches M and a also through k1 = rhs(y0) of init; the
    # loop's share is the hand adjoint's, the rest is ct0's k1 plane.
    k1 = lambda M_, a_: geodesic_cm(  # noqa: E731
        make_metric("kerr_schild", KerrSchildParams(M_, a_),
                    rho_min=RHO_MIN), torch.from_numpy(y0.T.copy()))
    _, (iM, ia) = torch.autograd.functional.vjp(
        k1, (M.detach(), at.detach()), ct0[A.P_K1:A.P_K1 + 8])
    np.testing.assert_allclose(float(pbar[:, 0].sum() + iM), float(gM),
                               rtol=1e-10)
    np.testing.assert_allclose(float(pbar[:, 1].sum() + ia), float(ga),
                               rtol=1e-10)
    assert pbar.shape == (64, 2)
