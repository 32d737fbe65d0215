"""The camera of the differentiable path (models/camera.py): the null
normalization of the pixel batch (``pixel_rays_plain``, K8's plain
version) and its hand-written reverse per ray in M and a
(``pixel_rays_vjp``, K9's plain version), on the CPU.

* ``pixel_rays_vjp`` against torch autograd of ``pixel_rays_plain`` at
  f64: ``as_written`` and ``textbook``, a = 0 and 0.6, M and a shared and
  one per ray (4 groups), on example2's pixel batch plus a ray where the
  ``rho_min`` floor bites and one where ``clamp_det`` bites (found by
  bisection where the determinant of an off-shell Kerr-Schild metric
  changes sign); Minkowski's cotangents are zero.
* The port's forward and per-ray cotangents against the JAX package's
  ``pixel_rays`` and its ``jax.vjp``, from values committed in
  tests/torch_camera_ref.npz (written by tests/make_torch_camera_ref.py),
  so that this file runs no JAX program.
* ``pixel_rays`` of a ``Metric`` value (``_Camera``) against the plain
  forward and the float64 sums of the per-ray cotangents; a start of a
  vectorized batch (M and a per ray through ``per_ray``) gets its serial
  camera gradient; a pixel batch that requires grad is refused.

Tolerance: 1e-12, each ray's (M, a) cotangents against the larger of the
two (the hand VJP and autograd round apart only in the order of their
sums: measured up to 4.5e-13 in the clamped rays, whose cotangents reach
1e20, and below 1e-15 on the pixel batch); u against its largest
magnitude."""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models import camera as C  # noqa: E402
from raytracegr_jl_tpu_torch.ops.adjoint import per_ray  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geometry import (det3, det_min,  # noqa: E402
                                                  inv4, inv4_column0)


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
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_camera_ref.npz")
ROW_NORMAL = (0.0, -1.0, 0.1, 0.05)
GROUP_M = (1.0, 0.8, 1.25, 0.3)
GROUP_A = (1.0, 0.5, 1.5, 0.9)  # times the case's a


def _metric(r_formula, M, a):
    return T.make_metric("kerr_schild", T.KerrSchildParams(M=M, a=a),
                         r_formula=r_formula, rho_min=RHO_MIN)


def _det(metric, x):
    """The determinant ``inv4`` clamps (row 0's cofactors)."""
    g = metric(x)
    m = [[g[..., i, j] for j in range(4)] for i in range(4)]
    return sum(m[0][c] * ((-1) ** c) * det3(m, 0, c) for c in range(4))


def _finite(metric, x):
    n = torch.tensor(ROW_NORMAL, dtype=F64).expand(x.shape)
    return bool(torch.isfinite(C.pixel_rays_plain(metric, x, n)).all())


def _floor_row(metric, rng):
    """A ray inside ``clamped_rho2``'s floor whose u is finite."""
    a = float(metric.params.a)
    lim = (a * a + RHO_MIN ** 2 if metric.r_formula == "as_written"
           else RHO_MIN ** 2)
    while True:
        p = rng.uniform(-1.0, 1.0, 3) * math.sqrt(lim)
        x = torch.tensor([[0.0, *p]], dtype=F64)
        if p @ p < lim and _finite(metric, x):
            return x[0]


def _det_row(metric, rng):
    """A ray where ``clamp_det`` bites: bisection between a point of
    negative and one of positive determinant (the rounding of the
    radius formula or its floor leaves k off the light cone), stopped
    where -det_min < det < -1e-15, where u is finite."""
    while True:
        x = torch.from_numpy(rng.uniform(-2.0, 2.0, (4000, 4)))
        x[:, 0] = 0.0
        d = _det(metric, x)
        if not bool((d < 0).any() and (d > 0).any()):
            continue
        lo = x[torch.nonzero(d < 0)[0, 0]].clone()
        hi = x[torch.nonzero(d > 0)[0, 0]].clone()
        for _ in range(200):
            mid = (lo + hi) / 2
            dm = float(_det(metric, mid[None]))
            if -det_min(F64) < dm < -1e-15:
                if _finite(metric, mid[None]):
                    return mid
                break
            lo, hi = (mid, hi) if dm < 0 else (lo, mid)


def _batch(r_formula, a0, groups, seed=5):
    """example2's 8x8 pixel batch plus a floored and a clamped ray, per
    group: (x [B, 4], n [B, 4], M [B], a [B], rays per group)."""
    rng = np.random.default_rng(seed)
    xg, ng = T.flat_pixel_grid(T.example2_spec(8, 8), F64, "cpu")
    xs, ns, Ms, As = [], [], [], []
    for M, s in list(zip(GROUP_M, GROUP_A))[:groups]:
        metric = _metric(r_formula, M, a0 * s)
        rows = torch.stack([_floor_row(metric, rng), _det_row(metric, rng)])
        xs.append(torch.cat([xg, rows]))
        ns.append(torch.cat([ng, torch.tensor([ROW_NORMAL] * 2,
                                              dtype=F64)]))
        Ms.append(torch.full((len(xs[-1]),), M, dtype=F64))
        As.append(torch.full((len(xs[-1]),), a0 * s, dtype=F64))
    return (*(torch.cat(v) for v in (xs, ns, Ms, As)), len(xs[0]))


def _close(got, want):
    """Entry by entry against the block's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def _close_rays(got, want):
    """Per-ray cotangents ``[2, B]``: each ray's pair against the larger
    of its two magnitudes, the scale of the chain both come from (in a
    clamped ray a_bar is the cancellation of terms of M_bar's size)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(want).all()
    scale = np.abs(want).max(axis=0)
    bad = np.abs(got - want) > RTOL * scale
    assert not bad.any(), (np.nonzero(bad), got[bad], want[bad])


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_ray"])
@pytest.mark.parametrize("a0", [0.0, 0.6])
@pytest.mark.parametrize("r_formula", ["as_written", "textbook"])
def test_vjp_matches_autograd(r_formula, a0, shared):
    """``pixel_rays_vjp``'s per-ray (M, a) cotangents against autograd of
    ``pixel_rays_plain`` with a leaf per ray, at f64; in the two special
    rows of each group the floor and ``clamp_det`` do bite."""
    x, n, Mv, av, rows = _batch(r_formula, a0, 1 if shared else 4)
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(x.shape))
    ct[::9] = 0.0
    Ml, al = Mv.clone().requires_grad_(), av.clone().requires_grad_()
    u = C.pixel_rays_plain(_metric(r_formula, Ml, al), x, n)
    assert bool(torch.isfinite(u).all())
    want = torch.autograd.grad((u * ct).sum(), (Ml, al))
    given = ((Mv[0], av[0]) if shared else (Mv, av))
    got = C.pixel_rays_vjp(_metric(r_formula, *given), x, n, ct)
    assert got.shape == (2, x.shape[0])
    _close_rays(got, torch.stack(want))
    # The special rows: the floor bites, and so does clamp_det.
    eps2 = RHO_MIN ** 2
    floor = av * av + eps2 if r_formula == "as_written" else eps2 + 0 * av
    raw = (x[:, 1:] ** 2).sum(1)
    d = _det(_metric(r_formula, Mv, av), x)
    assert bool((raw[rows - 2::rows] < floor[rows - 2::rows]).all())
    assert bool((d[rows - 1::rows].abs() < det_min(F64)).all())


def test_minkowski_has_zero_cotangents():
    """Minkowski: u as the plain forward computes it, no cotangent."""
    xg, ng = T.flat_pixel_grid(T.example1_spec(8, 8), F64, "cpu")
    metric = T.make_metric("minkowski")
    ct = torch.ones_like(xg)
    assert torch.equal(C.pixel_rays_vjp(metric, xg, ng, ct),
                       torch.zeros((2, 64), dtype=F64))
    _, u = C.pixel_rays(metric, xg, ng)
    assert torch.equal(u, C.pixel_rays_plain(metric, xg, ng))


@pytest.mark.parametrize("case", ["as_written_a0", "as_written_a06",
                                  "textbook_a06"])
def test_matches_jax(case):
    """The forward and the per-ray cotangents against the JAX package's
    ``pixel_rays`` and ``jax.vjp`` (committed), M and a per ray over 4
    groups, with a floored ray in each."""
    ref = np.load(REF)
    get = lambda k: torch.from_numpy(ref[f"{case}_{k}"])  # noqa: E731
    r_formula = case.rsplit("_", 1)[0]
    metric = _metric(r_formula, get("M"), get("a"))
    u = C.pixel_rays_plain(metric, get("x"), get("n"))
    _close(u, ref[f"{case}_u"])
    got = C.pixel_rays_vjp(metric, get("x"), get("n"), get("ct"))
    _close_rays(got, np.stack([ref[f"{case}_g_M"], ref[f"{case}_g_a"]]))


def test_camera_function_matches_plain_and_sums():
    """``pixel_rays`` of a ``Metric`` value equals the plain forward, and
    its M and a gradients are the float64 sums of ``pixel_rays_vjp``'s
    per-ray cotangents; a metric function takes the same forward under
    autograd."""
    x, n, Mv, av, _ = _batch("as_written", 0.6, 1)
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape))
    M = torch.tensor(1.0, dtype=F64, requires_grad=True)
    a = torch.tensor(0.6, dtype=F64, requires_grad=True)
    metric = _metric("as_written", M, a)
    pos, u = C.pixel_rays(metric, x, n)
    assert pos is x
    assert torch.equal(u, C.pixel_rays_plain(metric, x, n))
    gM, ga = torch.autograd.grad((u * ct).sum(), (M, a))
    per = C.pixel_rays_vjp(metric, x, n, ct)
    assert torch.equal(gM, per[0].sum(dtype=F64))
    assert torch.equal(ga, per[1].sum(dtype=F64))
    _, u_fn = C.pixel_rays(lambda p: metric(p), x, n)
    assert torch.equal(u_fn, u)


def test_inv4_column0_is_inv4s_first_column():
    x, _, Mv, av, _ = _batch("textbook", 0.6, 1)
    g = _metric("textbook", Mv, av)(x)
    m = [[g[..., i, j] for j in range(4)] for i in range(4)]
    assert torch.equal(torch.stack(inv4_column0(m), -1), inv4(g)[..., :, 0])


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_vectorized_start_gets_its_serial_camera_gradient(dtype):
    """Three starts stacked (M and a per ray through ``per_ray``, as
    ``make_multistart_loss_fn`` builds them) against each start alone
    with shared M and a: u and the camera's M and a gradients, bitwise."""
    xg, ng = T.flat_pixel_grid(T.example2_spec(8, 8), dtype, "cpu")
    B = xg.shape[0]
    Ms, As = [1.0, 1.05, 0.95], [0.0, 0.3, 0.6]
    ct = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3 * B, 4))).to(dtype)
    M = torch.tensor(Ms, dtype=dtype, requires_grad=True)
    a = torch.tensor(As, dtype=dtype, requires_grad=True)
    _, u = C.pixel_rays(_metric("as_written", per_ray(M, B), per_ray(a, B)),
                        xg.repeat(3, 1), ng.repeat(3, 1))
    gM, ga = torch.autograd.grad((u * ct).sum(), (M, a))
    for i in range(3):
        Mi = torch.tensor(Ms[i], dtype=dtype, requires_grad=True)
        ai = torch.tensor(As[i], dtype=dtype, requires_grad=True)
        _, ui = C.pixel_rays(_metric("as_written", Mi, ai), xg, ng)
        gi = torch.autograd.grad((ui * ct[i * B:(i + 1) * B]).sum(),
                                 (Mi, ai))
        assert torch.equal(ui, u[i * B:(i + 1) * B])
        assert torch.equal(gi[0], gM[i]) and torch.equal(gi[1], ga[i])


def test_camera_refuses_a_pixel_batch_that_requires_grad():
    """The pixel batch is data: ``_Camera`` gives it no cotangent, so a
    ``pos`` or ``normal`` that requires grad is refused."""
    xg, ng = T.flat_pixel_grid(T.example2_spec(4, 4), F64, "cpu")
    metric = _metric("as_written", 1.0, 0.0)
    for args in ((xg.clone().requires_grad_(), ng),
                 (xg, ng.clone().requires_grad_())):
        with pytest.raises(ValueError, match="must not require grad"):
            C.pixel_rays(metric, *args)
