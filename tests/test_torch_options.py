"""The options of the port's differentiable path and of its compacted
render, on the CPU at f64 (the plain K3/K4 and K2 versions run here):

* ``grad_groups`` (the plain route's sorted parts, each its own forward
  and backward pass) and ``sort_rays`` (the kernel route's sorted launch,
  held here through ``integrate_rays_ckpt(..., sort_parts=1)``, the same
  code around the plain versions) leave the loss and the gradients
  bitwise as they are without them: rays are independent, and the per-ray
  (M, a) cotangents are summed in the caller's order;
* ``grad_mode="scan"`` (autograd through every rematerialized step)
  agrees with the hand adjoint of ``"ckpt"`` to rtol 1e-12;
* ``fast_epilogue`` renders the disk on the CPU bitwise as the default
  (it changes nothing, on the card either: every forward redshift render
  there shades through K5), and the
  compacted trace with ``dt0=None`` equals it with the eager initial step.

RK4 throughout the bitwise checks: the plain Tsit5 controller's pow on the
CPU may round a ray apart by its place in a vector, which would move a
sorted ray's steps; the kernels (one thread per ray) have no such
dependence (tests/test_torch_cuda.py holds the sorted kernel route)."""

import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as adj  # noqa: E402
from raytracegr_jl_tpu_torch.render import (MIN_RAYS_PER_GRAD_GROUP,  # noqa: E402
                                            initial_dt)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
SCAN_RTOL = 1e-12


def _cfg(**integ):
    cfg = T.default_inverse_cfg(F64, max_steps=20, method="rk4", rk4_dt=0.5,
                                stop_rho=0.5, soft_temp=0.05)
    return cfg._replace(integrator=cfg.integrator._replace(**integ))


def _loss_and_grads(n, cfg):
    """example2 at n x n: the pixel loss of make_ray_loss_fn against a
    target rendered at the truth, and its gradients in M, a and the
    sphere's position."""
    spec = T.example2_spec(n, n)
    xg, ng = T.flat_pixel_grid(spec, F64, "cpu")
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, _cfg(), 2, F64, "cpu")(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], F64, "cpu"),
            xg, ng)
    p = T.InverseParams(1.05, 0.02, [0.0, 4.0, 0.1, 0.0], F64, "cpu")
    loss = T.make_ray_loss_fn(spec, cfg, 2, F64, "cpu")(p, xg, ng, target)
    loss.backward()
    return loss.detach(), [p.M.grad, p.a.grad, p.sphere_pos.grad]


def _assert_bitwise(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb), (float(la), float(lb))
    for x, y in zip(ga, gb):
        assert torch.equal(x, y), (x, y)


def test_grad_groups_bitwise(monkeypatch):
    """grad_groups=2 over 24x24 = 576 rays (at least 2 x 256: split) runs
    two backward passes and gives the ungrouped loss and gradients."""
    n, parts = 24, 2
    assert n * n >= parts * MIN_RAYS_PER_GRAD_GROUP
    calls = []
    back = adj.backward_plain
    monkeypatch.setattr(adj, "backward_plain",
                        lambda route, ck, *a: calls.append(ck.shape[2])
                        or back(route, ck, *a))
    grouped = _loss_and_grads(n, _cfg(grad_groups=parts))
    assert calls == [288, 288]
    calls.clear()
    _assert_bitwise(grouped, _loss_and_grads(n, _cfg()))
    assert calls == [576]


def test_sorted_parts_bitwise():
    """One sorted part (the kernel route's sort_rays, here around the plain
    versions) and three, against one pass in the caller's order: the trace
    and the gradients in y0, M and a, bitwise."""
    metric, scene, canvas = T.build(T.example2_spec(16, 16), F64, "cpu")
    integ = _cfg().integrator

    def run(sort_parts):
        M = torch.tensor(1.05, dtype=F64, requires_grad=True)
        a = torch.tensor(0.02, dtype=F64, requires_grad=True)
        m = T.make_metric("kerr_schild", T.KerrSchildParams(M, a),
                          rho_min=0.25)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        y0 = y0.clone().requires_grad_()
        res = T.integrate_rays_ckpt(m, scene, y0, initial_dt(m, y0, integ),
                                    integ, integ.grad_seg_len,
                                    sort_parts=sort_parts)
        loss = (res.y[:, :4] ** 2).sum() * 1e-3 + res.lam.sum() * 1e-2
        return res, torch.autograd.grad(loss, (y0, M, a))

    ref, g_ref = run(None)
    for parts in (1, 3):
        res, g = run(parts)
        for f in ("y", "lam", "hit", "steps", "n_iters"):
            a, b = getattr(res, f), getattr(ref, f)
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f
        for x, y in zip(g, g_ref):
            assert torch.equal(x, y)


def test_sort_rays_on_the_plain_route_changes_nothing():
    """sort_rays on the plain route is ignored, as by the JAX package's
    ckpt route."""
    _assert_bitwise(_loss_and_grads(8, _cfg(sort_rays=True)),
                    _loss_and_grads(8, _cfg()))


@pytest.mark.parametrize("method", ["rk4", "tsit5"])
def test_scan_matches_ckpt(method):
    """grad_mode="scan" (autograd through every step, each
    rematerialized) against the hand adjoint at 4x4; the step sizes stay
    detached, so both differentiate the same function."""
    extra = {} if method == "rk4" else dict(method="tsit5", max_steps=32)
    scan = _loss_and_grads(4, _cfg(grad_mode="scan", **extra))
    ckpt = _loss_and_grads(4, _cfg(grad_mode="ckpt", **extra))
    torch.testing.assert_close(scan[0], ckpt[0], rtol=SCAN_RTOL, atol=0)
    for x, y in zip(scan[1], ckpt[1]):
        torch.testing.assert_close(x, y, rtol=SCAN_RTOL, atol=1e-15)


def test_scan_remat_is_the_plain_tape():
    """Rematerialization changes memory, not values: the same gradients
    bitwise with and without it."""
    metric, scene, canvas = T.build(T.example2_spec(4, 4), F64, "cpu")
    integ = _cfg().integrator

    def grads(remat):
        M = torch.tensor(1.05, dtype=F64, requires_grad=True)
        m = T.make_metric("kerr_schild", T.KerrSchildParams(M, 0.0),
                          rho_min=0.25)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        res = adj.integrate_rays_autograd(m, scene, y0,
                                          initial_dt(m, y0, integ), integ,
                                          remat=remat)
        return torch.autograd.grad((res.y[:, :4] ** 2).sum(), M)[0]

    assert torch.equal(grads(True), grads(False))


def test_fast_epilogue_on_the_cpu_is_the_default():
    """A 16x16 disk, compacted: fast_epilogue shades through the plain
    version on CPU tensors, so the image is bitwise the default's; so is
    the trace with dt0=None (the eager initial step on the torch
    backend)."""
    metric, scene, canvas = T.build(T.accretion_disk_spec(16, 16), F64,
                                    "cpu")
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=1e-8, atol=1e-8, max_steps=400, stop_rho=1.0, sort_rays=True),
        shading="redshift")
    fast = T.render_compacted(metric, scene, canvas, cfg, first_chunk=16,
                              fast_epilogue=True).rgb
    default = T.render_compacted(metric, scene, canvas, cfg,
                                 first_chunk=16).rgb
    assert torch.equal(fast, default)
    assert float(default.max()) > 0.0
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    integ = cfg.integrator._replace(max_steps=48)
    own = T.trace_batch_compacted(metric, scene, y0, None, integ,
                                  first_chunk=16)
    given = T.trace_batch_compacted(metric, scene, y0,
                                    initial_dt(metric, y0, integ), integ,
                                    first_chunk=16)
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(own, f), getattr(given, f)), f
