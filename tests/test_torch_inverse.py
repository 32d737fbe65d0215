"""The port's inversion workflow against the JAX package: the lensing
scene's arrays, the vectorized multistart, learning-rate schedules and
resumed fits (through utils/checkpoint), and the grouped plain K3 and K4
that the vectorized multistart runs. On the CPU at 8x8 in f64, the port on
its plain versions.

The JAX fits' values are committed in tests/torch_inverse_ref.npz, written
by tests/make_torch_inverse_ref.py (the suite runs no JAX gradient program
for them): JAX's vmapped ``fit_multistart`` and a cosine-scheduled ``fit``
resumed through ``opt_state``, on tests/test_inverse.py's configuration
(example1 8x8, z fitted alone from 0.12, 0.04 and -0.1, 4 Adam steps of
2e-2)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu.models import scenes as j_scenes  # noqa: E402
from raytracegr_jl_tpu_torch.models.camera import pixel_rays  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.utils import checkpoint  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
REF = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "torch_inverse_ref.npz"))
NAMES = ("M", "a", "sphere_pos")


def _setup():
    """tests/test_inverse.py's fit configuration, in the port: (spec, cfg,
    JAX's target image, inits, z-only mask, fit keywords)."""
    spec = T.example1_spec(8, 8)
    cfg = T.default_inverse_cfg(F64, max_steps=24, rk4_dt=0.5,
                                soft_temp=0.05)
    target = torch.from_numpy(REF["target"])
    inits = [T.InverseParams(1.0, 0.0, [0.0, 0.0, 0.0, float(z)], F64, "cpu")
             for z in REF["zs"]]
    mask = T.InverseParams(0.0, 0.0, [0.0, 0.0, 0.0, 1.0], F64, "cpu")
    kw = dict(steps=int(REF["steps"]), learning_rate=float(REF["lr"]),
              trainable=mask, dtype=F64, device="cpu")
    return spec, cfg, target, inits, kw


def _check_against_ref(res, prefix):
    """A FitResult against JAX's: losses rtol 1e-8, parameters atol 1e-8
    (tests/test_torch_grad.py's bar for Adam steps)."""
    np.testing.assert_allclose(res.loss_history.numpy(),
                               REF[f"{prefix}_loss_history"], rtol=1e-8)
    np.testing.assert_allclose(float(res.loss), REF[f"{prefix}_loss"],
                               rtol=1e-8)
    for name in NAMES:
        for got, key in ((getattr(res.params, name), "params"),
                         (getattr(res.final_params, name), "final"),
                         (res.params_history[name], "history")):
            np.testing.assert_allclose(
                got.detach().numpy(), REF[f"{prefix}_{key}_{name}"],
                atol=1e-8, err_msg=f"{prefix} {key} {name}")


def test_lensing_spec_matches_jax():
    """``lensing_inverse_spec`` builds JAX's scene and canvas positions
    exactly, and its canvas normals within two units in the last place: the
    CPU build of torch rounds ``torch.sqrt`` of the normalization apart
    from the correctly rounded root on some inputs (``sqrt(1.0499853726322388)``
    gives 1.0246879391464694, the root is 1.02468793914646950...), which
    moves 8 of the 256 normal values by up to two units."""
    j_spec = j_scenes.lensing_inverse_spec(8, 8)
    t_spec = T.lensing_inverse_spec(8, 8)
    assert tuple(t_spec) == tuple(j_spec)
    _, j_scene, j_canvas = j_scenes.build(j_spec, jnp.float64)
    _, t_scene, t_canvas = T.build(t_spec, F64, "cpu")
    for f in j_scene._fields:
        np.testing.assert_array_equal(getattr(t_scene, f).numpy(),
                                      np.asarray(getattr(j_scene, f)), f)
    np.testing.assert_array_equal(t_canvas.pos.numpy(),
                                  np.asarray(j_canvas.pos))
    np.testing.assert_array_max_ulp(t_canvas.normal.numpy(),
                                    np.asarray(j_canvas.normal), maxulp=2)


def test_vectorized_multistart_matches_serial():
    """One grouped fit of the three starts against three serial fits: the
    same start, loss rtol 1e-12, parameters rtol 1e-9 and atol 1e-11 (the
    JAX package's own bar for its vmapped fit)."""
    spec, cfg, target, inits, kw = _setup()
    vec = T.fit_multistart(spec, target, inits, cfg, vectorized=True, **kw)
    ser = T.fit_multistart(spec, target, inits, cfg, vectorized=False, **kw)
    np.testing.assert_allclose(float(vec.loss), float(ser.loss), rtol=1e-12)
    np.testing.assert_allclose(vec.loss_history.numpy(),
                               ser.loss_history.numpy(), rtol=1e-10)
    for name in NAMES:
        for a, b in ((vec.params, ser.params),
                     (vec.final_params, ser.final_params)):
            np.testing.assert_allclose(
                getattr(a, name).detach().numpy(),
                getattr(b, name).detach().numpy(), rtol=1e-9, atol=1e-11,
                err_msg=name)
    for n in ("exp_avg", "exp_avg_sq"):
        for name in NAMES:
            np.testing.assert_allclose(vec.opt_state[n][name].numpy(),
                                       ser.opt_state[n][name].numpy(),
                                       rtol=1e-9, atol=1e-11)
    assert vec.opt_state["step"] == ser.opt_state["step"] == kw["steps"]


def test_vectorized_multistart_matches_jax():
    """The grouped fit against JAX's vmapped ``fit_multistart``."""
    spec, cfg, target, inits, kw = _setup()
    _check_against_ref(T.fit_multistart(spec, target, inits, cfg, **kw),
                       "vec")


def test_scheduled_resumed_fit_matches_jax():
    """``cosine_decay_schedule`` over 4 steps, 2 steps and then 2 resumed
    from ``opt_state``, against optax's schedule in the JAX ``fit``."""
    spec, cfg, target, inits, kw = _setup()
    kw["learning_rate"] = T.cosine_decay_schedule(2e-2, 4, alpha=0.1)
    kw["steps"] = 2
    part1 = T.fit(spec, target, inits[0], cfg, **kw)
    part2 = T.fit(spec, target, part1.final_params, cfg,
                  opt_state=part1.opt_state, **kw)
    _check_against_ref(part1, "sched1")
    _check_against_ref(part2, "sched2")


def test_cosine_schedule_is_optax_closed_form():
    import optax
    ours = T.cosine_decay_schedule(2e-2, 4, alpha=0.1)
    theirs = optax.cosine_decay_schedule(2e-2, 4, alpha=0.1)
    for step in range(7):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-15)


@pytest.mark.parametrize("scheduled", [False, True])
def test_resumed_fit_is_bit_identical(tmp_path, scheduled):
    """fit(4) against fit(2), a checkpoint written and read back
    (utils/checkpoint), and fit(2, opt_state=...): equal bit for bit,
    with a float learning rate and with the full-length schedule."""
    spec, cfg, target, inits, kw = _setup()
    if scheduled:
        kw["learning_rate"] = T.cosine_decay_schedule(2e-2, 4, alpha=0.1)
    init = T.InverseParams(1.0, 0.0, [0.0, 0.0, 0.02, 0.08], F64, "cpu")
    kw["trainable"] = T.InverseParams(0.0, 0.0, [0.0, 1.0, 1.0, 1.0], F64,
                                      "cpu")
    full = T.fit(spec, target, init, cfg, **{**kw, "steps": 4})
    part1 = T.fit(spec, target, init, cfg, **{**kw, "steps": 2})
    state = {"params": part1.final_params, "opt_state": part1.opt_state,
             "step": 2}
    path = checkpoint.save(str(tmp_path / "fit.pt"), state)
    back = checkpoint.restore(path, state)
    del part1, state
    assert back["step"] == 2
    part2 = T.fit(spec, target, back["params"], cfg,
                  opt_state=back["opt_state"], **{**kw, "steps": 2})
    assert torch.equal(part2.loss_history, full.loss_history[2:])
    for name in NAMES:
        assert torch.equal(getattr(part2.final_params, name),
                           getattr(full.final_params, name)), name
        for n in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(part2.opt_state[n][name],
                               full.opt_state[n][name])


def test_checkpoint_restores_structure_and_device(tmp_path):
    params = T.InverseParams(1.5, 0.3, [0.0, 1.0, 2.0, 3.0], F64, "cpu")
    state = {"params": params, "step": 7,
             "extra": (torch.arange(3), [1.0, torch.ones(2)])}
    path = checkpoint.save(str(tmp_path / "c.pt"), state)
    checkpoint.save(path, state)  # overwrites
    back = checkpoint.restore(path, state)
    assert isinstance(back["params"], T.InverseParams)
    for name in NAMES:
        got = getattr(back["params"], name)
        assert got.device.type == "cpu" and got.dtype == F64
        assert torch.equal(got, getattr(params, name))
    assert back["step"] == 7
    assert torch.equal(back["extra"][0], torch.arange(3))
    assert back["extra"][1][0] == 1.0
    assert torch.equal(back["extra"][1][1], torch.ones(2))


def _grouped_case(starts, n=8):
    """The lensing scene at n x n, f64, RK4 (60 steps of 1, to the
    sphere and past it), for each (M, z) start: the per-start routes and
    launch states ``[8, B]``, and the grouped route over all starts' rays
    (start-major) with its launch states."""
    spec = T.lensing_inverse_spec(n, n)
    cfg = T.default_inverse_cfg(F64, max_steps=60, rk4_dt=1.0,
                                stop_rho=0.5)
    integ = cfg.integrator._replace(lam_max=60.0)
    _, scene, _ = T.build(spec, F64, "cpu")
    xg, ng = T.flat_pixel_grid(spec, F64, "cpu")
    seg = A.segment_length(integ, integ.grad_seg_len)
    singles, rows = [], []
    for M, z in starts:
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(
            torch.tensor(M, dtype=F64), torch.tensor(0.0, dtype=F64)),
            r_formula="textbook", rho_min=0.25)
        sc = scene._replace(pos=scene.pos.clone())
        sc.pos[0, 3] = z
        x, u = pixel_rays(metric, xg, ng)
        y0 = torch.cat([x, u], -1)
        route = A.Route(metric=metric, scene=sc, cfg=integ, seg_len=seg,
                        n_seg=integ.max_steps // seg, cuda=False)
        singles.append((route, y0.t()))
        rows.append(A.flatten_params(metric, sc))
    route0 = singles[0][0]
    grouped = route0._replace(groups=torch.stack(rows))
    return singles, grouped, torch.cat([y0 for _, y0 in singles], dim=1)


def test_grouped_plain_k3_k4_equal_single_runs():
    """The grouped plain K3 and K4 over two starts of different (M, z)
    against each start's own plain run, ray by ray, bit for bit: the
    final state, the initial state's cotangent and the per-ray (M, a)
    cotangents, and K4's whole plain version (with the initial state's
    VJP: the launch states' cotangent)."""
    singles, grouped, y0 = _grouped_case([(0.5, 0.0), (0.53, 0.3)])
    B = singles[0][1].shape[1]
    ck_g, used_g = A.run_segments(grouped, y0)
    ct = torch.randn((A.N_PLANES, y0.shape[1]),
                     generator=torch.Generator().manual_seed(0), dtype=F64)
    ct0_g, pbar_g = A.backward_plain(grouped, ck_g, used_g[1:], ct)
    cty_g, pbar4_g = A.k4_plain(grouped, ck_g, used_g[1:], ct)
    fin_g = ck_g[grouped.n_seg]
    assert bool(fin_g[A.P_HIT].any())
    for k, (route, y) in enumerate(singles):
        rays = slice(k * B, (k + 1) * B)
        ck, used = A.run_segments(route, y)
        assert int(used[0]) <= int(used_g[0])
        assert torch.equal(used_g[1:][rays], used[1:])
        assert torch.equal(ck_g[0][:, rays], ck[0])
        assert torch.equal(fin_g[:, rays], ck[route.n_seg])
        ct0, pbar = A.backward_plain(route, ck, used[1:], ct[:, rays])
        assert torch.equal(ct0_g[:, rays], ct0)
        assert torch.equal(pbar_g[rays], pbar)
        cty, pbar4 = A.k4_plain(route, ck, used[1:], ct[:, rays])
        assert torch.equal(cty_g[:, rays], cty)
        assert torch.equal(pbar4_g[rays], pbar4)
    # The starts differ: so do their final states.
    assert not torch.equal(fin_g[:, :B], fin_g[:, B:])


def test_grouped_loss_gradients_match_per_start():
    """``make_multistart_loss_fn`` on two stacked starts of the lensing
    scene: each start's loss and its (M, z) gradients equal
    ``make_loss_fn``'s for that start alone (rtol 1e-12); RK4 with 60
    steps of 1."""
    spec = T.lensing_inverse_spec(8, 8)
    cfg = T.default_inverse_cfg(F64, max_steps=60, rk4_dt=1.0,
                                soft_temp=0.05, stop_rho=0.5)._replace(
        soft_freq=2.0)
    cfg = cfg._replace(integrator=cfg.integrator._replace(lam_max=60.0))
    truth = T.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], F64, "cpu")
    target = T.make_render_for_params(spec, cfg, 0, F64, "cpu")(
        truth).detach()
    starts = [(0.53, 0.03), (0.47, -0.05)]
    stacked = T.InverseParams([m for m, _ in starts], [0.0, 0.0],
                              [[0.0, 5.0, 12.0, z] for _, z in starts], F64,
                              "cpu")
    losses = T.make_multistart_loss_fn(spec, target, cfg, 0, F64, "cpu")(
        stacked)
    losses.sum().backward()
    one = T.make_loss_fn(spec, target, cfg, 0, F64, "cpu")
    for k, (m, z) in enumerate(starts):
        p = T.InverseParams(m, 0.0, [0.0, 5.0, 12.0, z], F64, "cpu")
        loss = one(p)
        loss.backward()
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(loss.detach()),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(stacked.M.grad[k]), float(p.M.grad),
                                   rtol=1e-12)
        np.testing.assert_allclose(stacked.sphere_pos.grad[k].numpy(),
                                   p.sphere_pos.grad.numpy(), rtol=1e-12,
                                   atol=1e-14)
        assert float(p.M.grad) != 0.0
