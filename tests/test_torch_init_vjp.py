"""The initial state of the checkpointed adjoint (ops/adjoint.py): its
plain build (``init_plain``, K3's prologue's plain version) and its
hand-written reverse mode (``init_vjp``, K4's epilogue's plain version),
on the CPU.

* ``init_plain`` equals ``make_step_cm``'s init under torch autograd bit
  for bit, and ``init_vjp`` follows torch autograd of it at f64: RK4 and
  Tsit5; Kerr-Schild at M = 1 with a = 0 and a = 0.8, and Minkowski;
  ungrouped, and grouped at 3 groups with (M, a) per ray. The rays are
  example2's (example1's for Minkowski) pixel batch and three rays where
  the right-hand side's clamps bite (inside the ``rho_min`` floor, on the
  spin axis, far out).
* The plain ``integrate_rays_ckpt`` (the initial state by ``init_vjp``)
  against ``integrate_rays_autograd`` (the initial state under autograd):
  the loss bitwise, its gradients in y0, M and a at f64, 8x8.

Tolerance: 1e-12. The two sides round apart only in the order of their
sums (autograd adds the cotangents of y0's three uses in the order its
graph runs them): y0's cotangent against its largest entry, each ray's
(M, a) cotangents against their largest over the rays, a shared
parameter's sum against the sum of the per-ray magnitudes. No JAX: the
loop and the epilogue are held to the JAX package in
tests/test_torch_adjoint.py and tests/test_torch_grad.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import (initial_dt,  # noqa: E402
                                                     make_step_cm,
                                                     scene_event_cm)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
RTOL = 1e-12
RHO_MIN = 0.25
GROUPS = 3
GROUP_M = (1.0, 1.05, 0.95)
GROUP_A = (0.0, 0.4, 0.8)
# Rays where the right-hand side's clamps bite: inside the rho_min floor,
# on the spin axis, and far out.
EXTRA_RAYS = ((0.0, 0.1, 0.05, 0.02, 1.0, 0.0, -1.0, 0.0),
              (0.0, 0.0, 0.0, 3.0, 1.0, 0.0, 0.0, -1.0),
              (0.0, 40.0, -30.0, 5.0, 1.0, -0.6, 0.8, 0.0))


def init_case(metric_name: str, a: float, grouped: bool, method: str,
              device="cpu", n: int = 6):
    """``(route, y0 [8, B], M, a)``: the pixel batch at n x n and
    EXTRA_RAYS as launch states, the training path's configuration, and
    the metric's M and a as tensors (per ray ``[B]`` on a grouped route,
    whose table holds GROUPS rows of GROUP_M and GROUP_A, else 0-d)."""
    spec = (T.example2_spec if metric_name == "kerr_schild"
            else T.example1_spec)(n, n)
    cfg = T.default_inverse_cfg(F64, max_steps=40, method=method,
                                rk4_dt=2.5, stop_rho=0.5).integrator
    _, scene, canvas = T.build(spec, F64, device)
    y0 = torch.cat([torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8),
                    torch.tensor(EXTRA_RAYS, dtype=F64, device=device)])
    B = y0.shape[0]
    if grouped:
        rpg = B // GROUPS
        M = torch.tensor(GROUP_M, dtype=F64,
                         device=device).repeat_interleave(rpg)
        at = torch.tensor(GROUP_A, dtype=F64,
                          device=device).repeat_interleave(rpg)
    else:
        M = torch.tensor(1.0, dtype=F64, device=device)
        at = torch.tensor(a, dtype=F64, device=device)
    metric = (T.make_metric("kerr_schild", T.KerrSchildParams(M, at),
                            rho_min=RHO_MIN)
              if metric_name == "kerr_schild"
              else T.make_metric("minkowski", rho_min=RHO_MIN))
    seg = A.segment_length(cfg, cfg.grad_seg_len)
    table = (A.flatten_params(metric, scene, GROUPS).contiguous() if grouped
             else None)
    route_metric = metric if not grouped else metric._replace(
        params=T.KerrSchildParams(table[0, 0], table[0, 1]))
    route = A.Route(metric=route_metric, scene=scene, cfg=cfg, seg_len=seg,
                    n_seg=cfg.max_steps // seg,
                    cuda=torch.device(device).type == "cuda", groups=table)
    return route, y0.t().contiguous(), M, at


def init_gaps(route, y0, M, at, seed: int = 0) -> dict:
    """``init_plain`` and ``init_vjp`` against torch autograd of
    ``make_step_cm``'s init (with M and a as given, per ray or shared) on
    one random cotangent of every plane: whether the two initial states
    are equal bit for bit, and the relative gaps of y0's, M's and a's
    cotangents (see the module docstring)."""
    kerr = route.metric.name == "kerr_schild"
    gen = torch.Generator(device=y0.device).manual_seed(seed)
    ct = torch.randn((A.N_PLANES, y0.shape[1]), generator=gen, dtype=F64,
                     device=y0.device)
    yt = y0.clone().requires_grad_()
    Mt, at_ = M.clone().requires_grad_(), at.clone().requires_grad_()
    metric = (route.metric._replace(params=T.KerrSchildParams(Mt, at_))
              if kerr else route.metric)
    with torch.no_grad():
        dt0 = initial_dt(metric, y0.t(), route.cfg)
    init, _ = make_step_cm(metric, scene_event_cm(route.scene), route.cfg)
    P = A.pack_state(init(yt, dt0))
    want = torch.autograd.grad((P * ct).sum(), (yt, Mt, at_),
                               allow_unused=True)
    P0 = A.init_plain(route, y0)
    zero = torch.zeros((y0.shape[1], 2), dtype=F64, device=y0.device)
    ct_y0, pbar = A.init_vjp(route, y0, ct, zero)
    out = {"equal": torch.equal(P0, P.detach()),
           "y0": float((ct_y0 - want[0]).abs().max()
                       / want[0].abs().max())}
    for k, name in enumerate(("M", "a")):
        got, ref = pbar[:, k], want[1 + k]
        if ref is None:  # Minkowski: no (M, a) cotangents
            out[name] = float(got.abs().max())
        elif ref.dim() == 0:
            out[name] = float((got.sum() - ref).abs()
                              / got.abs().sum().clamp_min(1e-300))
        else:
            out[name] = float((got - ref).abs().max()
                              / ref.abs().max().clamp_min(1e-300))
    return out


@pytest.mark.parametrize("method", ["rk4", "tsit5"])
@pytest.mark.parametrize("metric_name,a,grouped", [
    ("kerr_schild", 0.0, False), ("kerr_schild", 0.8, False),
    ("kerr_schild", None, True), ("minkowski", 0.0, False)],
    ids=["ks-a0", "ks-a0.8", "ks-grouped", "minkowski"])
def test_init_vjp_matches_autograd(metric_name, a, grouped, method):
    route, y0, M, at = init_case(metric_name, a, grouped, method)
    gaps = init_gaps(route, y0, M, at)
    assert gaps["equal"]
    for name in ("y0", "M", "a"):
        assert gaps[name] <= RTOL, (name, gaps)


def _ray_loss(res):
    return (res.y[:, :4] ** 2).sum() * 1e-3 + res.lam.sum() * 1e-2


@pytest.mark.parametrize("method,max_steps", [("rk4", 24), ("tsit5", 16)])
def test_ckpt_gradients_match_autograd_with_init(method, max_steps):
    """The plain checkpointed route, whose initial state is built by
    ``init_plain`` and differentiated by ``init_vjp`` (dt0=None: each
    ray's own first step), against ``integrate_rays_autograd``, whose
    initial state is ``make_step_cm``'s init under autograd: example2 8x8
    f64, a = 0.3; the loss bitwise, its gradients in y0, M and a within
    1e-12."""
    cfg = T.default_inverse_cfg(F64, max_steps=max_steps, method=method,
                                rk4_dt=0.5, stop_rho=0.5).integrator
    _, scene, canvas = T.build(T.example2_spec(8, 8), F64, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    out = []
    for fn in (A.integrate_rays_ckpt, A.integrate_rays_autograd):
        M = torch.tensor(1.05, dtype=F64, requires_grad=True)
        at = torch.tensor(0.3, dtype=F64, requires_grad=True)
        yy = y0.clone().requires_grad_()
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(M, at),
                               rho_min=RHO_MIN)
        loss = _ray_loss(fn(metric, scene, yy, None, cfg,
                            seg_len=cfg.grad_seg_len))
        out.append((loss.detach(), *torch.autograd.grad(loss, (yy, M, at))))
    (l_c, gy_c, gM_c, ga_c), (l_a, gy_a, gM_a, ga_a) = out
    assert torch.equal(l_c, l_a)
    assert float(gM_c) != 0.0 and float(ga_c) != 0.0
    np.testing.assert_allclose(gy_c.numpy(), gy_a.numpy(), rtol=0,
                               atol=RTOL * float(gy_a.abs().max()))
    np.testing.assert_allclose([float(gM_c), float(ga_c)],
                               [float(gM_a), float(ga_a)], rtol=RTOL)
