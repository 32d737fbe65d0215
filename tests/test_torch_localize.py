"""The localization epilogue of the differentiable path (ops/adjoint.py):
its plain forward (``localize_plain``, K6's plain version) and its
hand-written VJP (``localize_vjp``, K7's plain version), on the CPU.

* ``localize_vjp`` against torch autograd of the plain epilogue (the
  dead-ray cutoff, ``localize_events_cm`` over every ray, the selection),
  on final states of the port's plain forward at 8x8 and on synthetic
  event records that reach the polish's corners: f64 and f32, RK4 and
  Tsit5, Kerr-Schild and Minkowski, ungrouped and grouped; hits on the
  sphere, the time-plane, the sky sphere and the disk; a Newton step
  clipped by the inner and by the outer clamp, one exactly on the outer
  bound (torch's clamp passes the gradient there), and one with ``ok``
  false; rays that did not hit, alive, dead and escaped.
* ``localize_vjp`` (on ``localize_plain``'s record, as K7 runs it, and by
  its replay) against the JAX package's VJP of the same epilogue
  (``jax.vjp`` of its ``localize_events_cm``), from values committed in
  tests/torch_localize_ref.npz (written by tests/make_torch_localize_ref.py),
  so that this file runs no JAX program.
* The checkpointed plain route's loss gradients (``integrate_rays_ckpt``:
  K4's plain version, then the hand VJP) against every gradient by
  autograd (``integrate_rays_autograd(..., autograd_epilogue=True)``).
* ``per_ray``, which sums a parameter's per-ray cotangents in float64, and
  the vectorized multistart's gradients against the serial ones.

Tolerances. Each output block (the y and ev_y0 planes' cotangents) is
compared entry by entry against its reference's largest magnitude, and
each parameter's summed cotangent against the sum of its per-ray
magnitudes (the scale of the sum's rounding). f64: 1e-12 against autograd
(the two round apart in the order of their sums: measured up to 2.5e-14),
1e-10 against JAX (XLA's CPU kernels round apart from PyTorch's). f32:
2e-5 (f32 rounding, ~6e-8 per operation, through the step's chain of a few
thousand operations and the Newton polish's quotient: measured up to
3.7e-6)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models.camera import pixel_rays  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geodesic_cm as G  # noqa: E402
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64, F32 = torch.float64, torch.float32
RTOL = {F64: 1e-12, F32: 2e-5}
JAX_RTOL = 1e-10
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_localize_ref.npz")
SPECS = {"example2": T.example2_spec, "example1": T.example1_spec,
         "disk": T.accretion_disk_spec}


def _final_state(name: str, method: str, dtype, steps: int, n: int = 8):
    """The plain forward's final packed state of ``name`` at n x n with the
    training path's configuration: (route, P [34, B])."""
    cfg = T.default_inverse_cfg(dtype, max_steps=steps, method=method,
                                rk4_dt=0.5, stop_rho=0.5).integrator
    metric, scene, canvas = T.build(SPECS[name](n, n), dtype, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    seg = A.segment_length(cfg, None)
    route = A.Route(metric=metric, scene=scene, cfg=cfg, seg_len=seg,
                    n_seg=cfg.max_steps // seg, cuda=False)
    ck, _ = A.run_segments(route, y0.t())
    return route, ck[route.n_seg].contiguous()


def _grouped_state(method: str, dtype, n: int = 8):
    """Config 5's lensing scene at n x n for two (M, z) starts, as one
    grouped batch (start-major, one table row per start)."""
    cfg = T.default_inverse_cfg(dtype, max_steps=120, method=method,
                                rk4_dt=0.5, stop_rho=0.5).integrator
    cfg = cfg._replace(lam_max=60.0)
    spec = T.lensing_inverse_spec(n, n)
    _, scene, _ = T.build(spec, dtype, "cpu")
    xg, ng = T.flat_pixel_grid(spec, dtype, "cpu")
    starts, rows, y0s = [], [], []
    for M, z in ((0.5, 0.0), (0.55, 0.3)):
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(
            torch.tensor(M, dtype=dtype), torch.tensor(0.0, dtype=dtype)),
            r_formula="textbook", rho_min=0.25)
        sc = scene._replace(pos=scene.pos.clone())
        sc.pos[0, 3] = z
        x, u = pixel_rays(metric, xg, ng)
        y0 = torch.cat([x, u], -1)
        y0s.append(y0.t())
        rows.append(A.flatten_params(metric, sc))
        starts.append((metric, sc))
    seg = A.segment_length(cfg, None)
    route = A.Route(metric=starts[0][0], scene=starts[0][1], cfg=cfg,
                    seg_len=seg, n_seg=cfg.max_steps // seg, cuda=False,
                    groups=torch.stack(rows).contiguous())
    ck, _ = A.run_segments(route, torch.cat(y0s, dim=1))
    return route, ck[route.n_seg].contiguous()


def _synthetic(method: str):
    """example1's scene (sky sphere r = -10, time-plane t = -20, sphere r =
    0.5 at the origin) in flat space, with event records made by hand and
    no bisection (``bisect_iters=0``: theta0 is each bracket's upper end),
    so that the polish reaches its corners. Rays: 0 ok false (the sphere's
    tangent point at theta0 = 1: value and slope 0); 1 the plane with the
    inner clamp (delta -1.9) and the outer (u 1.1); 2 the outer clamp only
    (delta -0.4, u 1.3); 3 on the outer bound (u = 1 with RK4); 4 the plane
    with a zero cotangent; 5 no hit, alive; 6 no hit, dead (stopped
    mid-flight); 7 no hit, escaped (spanned lam_max)."""
    cfg = T.default_inverse_cfg(F64, max_steps=16, method=method,
                                rk4_dt=0.5).integrator._replace(
                                    bisect_iters=0)
    metric, scene, _ = T.build(T.example1_spec(2, 2), F64, "cpu")
    rec = [  # ev_y0, ev_lo, ev_hi
        ([0.0, -1.0, 0.5, 0.0, -1.0, 1.0, 0.0, 0.0], 0.75, 1.0),
        ([-18.0, 0.0, 0.0, 3.0, -1.0, 0.0, 0.0, 1.0], 0.0, 0.1),
        ([-18.7, 0.0, 0.0, 3.0, -1.0, 0.0, 0.0, 1.0], 0.8, 0.9),
        ([-19.0, 0.0, 0.0, 3.0, -1.0, 0.0, 0.0, 1.0], 0.25, 0.5),
        ([-18.0, 0.0, 0.0, 3.0, -1.0, 0.0, 0.0, 1.0], 0.0, 0.1)]
    B = 8
    P = torch.zeros(A.N_PLANES, B, dtype=F64)
    gen = np.random.default_rng(5)
    P[A.P_Y:A.P_Y + 8] = torch.from_numpy(gen.uniform(-3, 3, (8, B)))
    P[A.P_EV_Y0:A.P_EV_Y0 + 8] = P[A.P_Y:A.P_Y + 8]
    P[A.P_EV_DT] = 1.0
    for i, (y, lo, hi) in enumerate(rec):
        P[A.P_EV_Y0:A.P_EV_Y0 + 8, i] = torch.tensor(y, dtype=F64)
        P[A.P_EV_LO, i], P[A.P_EV_HI, i] = lo, hi
        P[A.P_HIT, i] = 1.0
        P[A.P_EV_LAM, i] = 5.0
    P[A.P_LAM, 5:] = torch.tensor([10.0, 10.0, cfg.lam_max], dtype=F64)
    P[A.P_ACTIVE, 5] = 1.0
    route = A.Route(metric=metric, scene=scene, cfg=cfg, seg_len=4,
                    n_seg=4, cuda=False)
    return route, P


def _cotangents(P, seed=0):
    gen = np.random.default_rng(seed)
    B = P.shape[1]
    ct_y = torch.from_numpy(gen.standard_normal((8, B))).to(P.dtype)
    ct_lam = torch.from_numpy(gen.standard_normal(B)).to(P.dtype)
    ct_y[:, ::7] = 0
    ct_lam[::7] = 0
    return ct_y, ct_lam


def _autograd(route, P, ct_y, ct_lam):
    """torch autograd of the plain epilogue, with M, a and the objects'
    fields of each group as leaves (one group where the route has none):
    (y, lam, ct of P [34, B], ct of the table [G, 2 + 8 N])."""
    table = (route.groups if route.groups is not None
             else A.flatten_params(route.metric, route.scene)[None])
    table = table.detach().clone().requires_grad_()
    P = P.clone().requires_grad_()
    metric, scene = A.route_rows(route._replace(groups=table), P.shape[1])
    st = A.unpack_state(P)
    cfg = route.cfg
    dead = ~st.hit & ~st.active & (st.lam < cfg.lam_max - 1e-6)
    y = torch.where(dead, st.y.detach(), st.y)
    th, ys = G.localize_events_cm(metric, G.scene_event_cm(scene), cfg,
                                  st.ev_y0, st.ev_dt, st.ev_lo, st.ev_hi)
    y = torch.where(st.hit, ys, y)
    lam = torch.where(st.hit, st.ev_lam + th * st.ev_dt, st.lam)
    g_P, g_t = torch.autograd.grad((y * ct_y).sum() + (lam * ct_lam).sum(),
                                   (P, table))
    return y.detach(), lam.detach(), g_P, g_t


def _per_group(route, pbar):
    """The per-ray parameter cotangents summed per group, ``[G, P]``, and
    the sums of their magnitudes."""
    G_ = 1 if route.groups is None else route.groups.shape[0]
    rows = pbar.reshape(pbar.shape[0], G_, -1)
    return rows.sum(2).t(), rows.abs().sum(2).t()


def _assert_vjp_close(route, ct_P, pbar, g_P, g_t, rtol):
    for lo in (A.P_Y, A.P_EV_Y0):
        got, want = ct_P[lo:lo + 8], g_P[lo:lo + 8]
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=rtol * scale)
    summed, mag = _per_group(route, pbar)
    assert bool(((summed - g_t).abs() <= rtol * mag).all()), (
        float(((summed - g_t).abs() / mag.clamp_min(1e-300)).max()))
    rest = torch.ones(A.N_PLANES, dtype=torch.bool)
    rest[A.P_Y:A.P_Y + 8] = False
    rest[A.P_EV_Y0:A.P_EV_Y0 + 8] = False
    assert not bool(ct_P[rest].any())


def _hit_objects(route, P, y):
    """The objects the hit rays of an ungrouped route ended on: each the
    one of least |distance| at y*."""
    d = T.distances(route.scene, y.t()[:, :4])
    return set(torch.argmin(d.abs(), -1)[P[A.P_HIT] > 0].tolist())


CASES = {
    "example2-rk4-f64": lambda: _final_state("example2", "rk4", F64, 64),
    "example2-tsit5-f64": lambda: _final_state("example2", "tsit5", F64,
                                               200),
    "example1-rk4-f64": lambda: _final_state("example1", "rk4", F64, 64),
    "example1-tsit5-f64": lambda: _final_state("example1", "tsit5", F64,
                                               64),
    "disk-rk4-f64": lambda: _final_state("disk", "rk4", F64, 64),
    "example2-rk4-f32": lambda: _final_state("example2", "rk4", F32, 64),
    "example2-tsit5-f32": lambda: _final_state("example2", "tsit5", F32,
                                               48),
    "grouped-rk4-f64": lambda: _grouped_state("rk4", F64),
    "grouped-tsit5-f32": lambda: _grouped_state("tsit5", F32),
    "synthetic-rk4-f64": lambda: _synthetic("rk4"),
    "synthetic-tsit5-f64": lambda: _synthetic("tsit5"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_localize_vjp_matches_autograd(case):
    """The hand VJP against torch autograd of the plain epilogue, and the
    plain forward equal to the epilogue's values bit for bit; every case
    has hit rays, and zeros go where the cutoff and the selection put
    them. The VJP reads the forward's record, as K7 does, and equals its
    replay route."""
    route, P = CASES[case]()
    ct_y, ct_lam = _cotangents(P)
    y, lam, rec = A.localize_plain(route, P)
    y_r, lam_r, g_P, g_t = _autograd(route, P, ct_y, ct_lam)
    assert torch.equal(y, y_r) and torch.equal(lam, lam_r)
    ct_P, pbar = A.localize_vjp(route, P, ct_y, ct_lam, rec)
    replay = A.localize_vjp(route, P, ct_y, ct_lam)
    assert torch.equal(ct_P, replay[0]) and torch.equal(pbar, replay[1])
    hit = P[A.P_HIT] > 0
    assert bool(hit.any())
    _assert_vjp_close(route, ct_P, pbar, g_P, g_t, RTOL[P.dtype])
    st = A.unpack_state(P)
    dead = ~st.hit & ~st.active & (st.lam < route.cfg.lam_max - 1e-6)
    keep = ~st.hit & ~dead
    assert torch.equal(ct_P[A.P_Y:A.P_Y + 8],
                       torch.where(keep, ct_y, torch.zeros_like(ct_y)))
    zero_ct = ~((ct_y != 0).any(0) | (ct_lam != 0))
    assert not bool(ct_P[A.P_EV_Y0:A.P_EV_Y0 + 8][:, ~hit | zero_ct].any())
    assert not bool(pbar[:, ~hit | zero_ct].any())
    if case == "example2-rk4-f64":  # the sky sphere, the plane, the sphere
        assert _hit_objects(route, P, y) == {0, 1, 2}
    if case == "disk-rk4-f64":
        assert 1 in _hit_objects(route, P, y)


@pytest.mark.parametrize("method", ["rk4", "tsit5"])
def test_synthetic_records_reach_the_polish_corners(method):
    """The synthetic records do what ``_synthetic`` says: ray 0's ok is
    false, ray 1 meets both clamps, ray 2 the outer one only, ray 3 lies
    exactly on the outer bound (RK4; Tsit5's rounds just above it), ray 6
    is dead and rays 5 and 7 are not."""
    route, P = _synthetic(method)
    st = A.unpack_state(P)
    metric, scene = route.metric, route.scene
    cfg = route.cfg
    y1, k1, k_last, ks, _ = G.crossing_stages(metric, cfg, st.ev_y0,
                                              st.ev_dt)
    interp, dinterp = G._interpolants(st.ev_y0, y1, k1, k_last, st.ev_dt,
                                      ks, 4)
    event = G.scene_event_cm(scene)
    th0 = G.bisect_bracket(event, interp, cfg, st.ev_lo, st.ev_hi)
    val, dval = event.jvp(interp(th0), dinterp(th0))
    ok = torch.abs(dval) > 1e-3 * (1.0 + torch.abs(val))
    delta = torch.where(ok, val, torch.zeros_like(val)) / torch.where(
        ok, dval, torch.ones_like(dval))
    u = th0 - torch.clamp(delta, -1.0, 1.0)
    assert not bool(ok[0]) and bool(ok[1:5].all())
    assert float(delta[1]) < -1.0 and float(u[1]) > 1.0
    assert -1.0 <= float(delta[2]) and float(u[2]) > 1.0
    if method == "rk4":  # Tsit5's weights sum to 1 only to rounding
        assert float(u[3]) == 1.0
    dead = ~st.hit & ~st.active & (st.lam < cfg.lam_max - 1e-6)
    assert dead.tolist() == [False] * 6 + [True, False]


@pytest.fixture(scope="module")
def jax_ref():
    return dict(np.load(REF))


@pytest.mark.parametrize("case", ["example2_rk4", "example2_tsit5",
                                  "example1_rk4"])
def test_localize_vjp_matches_jax(jax_ref, case):
    """The port's epilogue and its hand VJP against the JAX package's
    epilogue and ``jax.vjp`` of it, on the same final states and
    cotangents (tests/make_torch_localize_ref.py)."""
    r = {k[len(case) + 1:]: torch.from_numpy(v) for k, v in jax_ref.items()
         if k.startswith(case + "_")}
    name, method = case.split("_")
    steps = 200 if method == "tsit5" else 64
    cfg = T.default_inverse_cfg(F64, max_steps=steps, method=method,
                                rk4_dt=0.5, stop_rho=0.5).integrator
    metric, scene, _ = T.build(SPECS[name](8, 8), F64, "cpu")
    seg = A.segment_length(cfg, None)
    route = A.Route(metric=metric, scene=scene, cfg=cfg, seg_len=seg,
                    n_seg=cfg.max_steps // seg, cuda=False)
    P = r["P"]
    assert torch.equal(A.flatten_params(metric, scene), r["pvec"])
    y, lam, rec = A.localize_plain(route, P)
    torch.testing.assert_close(y, r["y"], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lam, r["lam"], rtol=1e-12, atol=1e-12)
    g_P = torch.zeros_like(P)
    g_P[A.P_Y:A.P_Y + 8] = r["g_y"]
    g_P[A.P_EV_Y0:A.P_EV_Y0 + 8] = r["g_ev"]
    for kept in (rec, None):  # K7's route on the record, and the replay
        ct_P, pbar = A.localize_vjp(route, P, r["ct_y"], r["ct_lam"], kept)
        _assert_vjp_close(route, ct_P, pbar, g_P, r["g_p"][None], JAX_RTOL)


def _loss_grads(method: str, grouped: bool, autograd: bool):
    """The traced (y, lam) at 8x8 f64 and the gradients of a seeded linear
    loss of them in y0, M, a and the scene's positions and radii, by the
    checkpointed plain route or by autograd throughout."""
    dtype = F64
    cfg = T.default_inverse_cfg(dtype, max_steps=64 if method == "rk4"
                                else 48, method=method, rk4_dt=0.5,
                                stop_rho=0.5).integrator
    spec = T.example2_spec(8, 8)
    metric0, scene0, canvas = T.build(spec, dtype, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    B = y0.shape[0]
    M = torch.tensor(1.05, dtype=dtype, requires_grad=True)
    a = torch.tensor(0.02, dtype=dtype, requires_grad=True)
    pos = scene0.pos.clone().requires_grad_()
    radius = scene0.radius.clone().requires_grad_()
    y0 = y0.clone().requires_grad_()
    kw = {}
    if grouped:  # two groups of the same parameters, per-ray rows
        Mr, ar = M.expand(B), a.expand(B)
        scene = scene0._replace(pos=pos.expand(B, -1, -1),
                                radius=radius.expand(B, -1),
                                **{f: getattr(scene0, f).expand(B, -1)
                                   for f in ("time", "r_in", "r_out",
                                             "half")})
        kw["groups"] = 2
    else:
        Mr, ar = M, a
        scene = scene0._replace(pos=pos, radius=radius)
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(Mr, ar),
                           rho_min=0.25)
    dt0 = initial_dt(metric, y0.detach(), cfg)
    if autograd:
        res = A.integrate_rays_autograd(metric, scene, y0, dt0, cfg,
                                        autograd_epilogue=True, **kw)
    else:
        res = A.integrate_rays_ckpt(metric, scene, y0, dt0, cfg, **kw)
    gen = np.random.default_rng(2)
    w_y = torch.from_numpy(gen.standard_normal((B, 8)))
    w_l = torch.from_numpy(gen.standard_normal(B))
    loss = (res.y * w_y).sum() + (res.lam * w_l).sum()
    return (res.y.detach(), res.lam.detach(),
            torch.autograd.grad(loss, (y0, M, a, pos, radius)))


@pytest.mark.parametrize("method,grouped", [("rk4", False), ("tsit5", False),
                                            ("rk4", True)])
def test_ckpt_route_matches_autograd_throughout(method, grouped):
    """The plain checkpointed route (K4's plain version on the loop, the
    hand VJP on the epilogue) against autograd of the loop and of the
    epilogue: the same traced values bit for bit and the same gradients at
    f64, each within 1e-12 of its reference's largest entry."""
    y_c, lam_c, g_c = _loss_grads(method, grouped, False)
    y_a, lam_a, g_a = _loss_grads(method, grouped, True)
    assert torch.equal(y_c, y_a) and torch.equal(lam_c, lam_a)
    for c, a in zip(g_c, g_a):
        scale = float(a.abs().max())
        torch.testing.assert_close(c, a, rtol=0, atol=1e-12 * scale)


def test_per_ray_sums_each_group_in_float64():
    """``per_ray`` repeats each row ``rays`` times and sums each group's
    cotangents in float64, rounded once to the working type."""
    gen = np.random.default_rng(3)
    v = torch.tensor(gen.standard_normal((3, 2)), dtype=F32,
                     requires_grad=True)
    out = A.per_ray(v, 4)
    assert torch.equal(out, v.detach().repeat_interleave(4, dim=0))
    g = torch.from_numpy(gen.standard_normal((12, 2)) * 10.0 ** gen.integers(
        -8, 8, (12, 2))).to(F32)
    (gv,) = torch.autograd.grad(out, v, g)
    want = g.double().reshape(3, 4, 2).sum(1).to(F32)
    assert torch.equal(gv, want)


def test_multistart_gradients_are_the_serial_ones():
    """Config 5's lensing scene at 8x8 f32, two starts, one at z = 0 (where
    the scene's mirror symmetry leaves z no gradient but rounding): the
    vectorized multistart's gradient of each start against that start's
    serial loss. The per-ray cotangents are equal ray for ray and each
    parameter's are summed in float64 (``per_ray``), so the symmetric
    start's z gradient is bit for bit the serial one's (its per-ray terms
    and their rounding cancel in mirror pairs), and the rest agree to f32
    rounding of the per-ray sums of the shading's and the localization's
    cotangents."""
    f32 = F32
    spec = T.lensing_inverse_spec(8, 8)
    cfg = T.default_inverse_cfg(f32, max_steps=120, rk4_dt=0.5,
                                soft_temp=0.05, stop_rho=0.5)
    cfg = cfg._replace(soft_freq=2.0, integrator=cfg.integrator._replace(
        lam_max=60.0))
    with torch.no_grad():
        target = T.make_render_for_params(spec, cfg, 0, f32, "cpu")(
            T.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], f32, "cpu"))
    starts = [T.InverseParams(0.53, 0.0, [0.0, 5.0, 12.0, 0.0], f32, "cpu"),
              T.InverseParams(0.47, 0.0, [0.0, 5.0, 12.0, 0.03], f32,
                              "cpu")]
    serial_loss = T.make_loss_fn(spec, target, cfg, 0, f32, "cpu")
    serial = []
    for p in starts:
        q = p.copy()
        serial_loss(q).backward()
        serial.append(torch.cat([q.M.grad[None], q.sphere_pos.grad]))
    stacked = T.InverseParams(*(torch.stack([getattr(p, k).detach()
                                             for p in starts])
                                for k in ("M", "a", "sphere_pos")),
                              dtype=f32, device="cpu")
    T.make_multistart_loss_fn(spec, target, cfg, 0, f32, "cpu")(
        stacked).sum().backward()
    for i, want in enumerate(serial):
        got = torch.cat([stacked.M.grad[i:i + 1], stacked.sphere_pos.grad[i]])
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
    z = stacked.sphere_pos.grad[0, 3]
    assert float(z) != 0.0 and torch.equal(z, serial[0][4])
