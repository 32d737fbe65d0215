"""The port's row-major route against its own component-major route and
with a metric written as a plain function, on the CPU at f64.

* ``backend="rowmajor"`` against the plain component-major integrator
  (``backend="torch"``) on example2 at 12x8, Tsit5 at rtol = atol = 1e-9:
  rgb within 1e-9 (the JAX package's bar between its two routes,
  tests/test_pallas.py).
* A lambda around ``kerr_schild`` renders bit for bit like the
  ``Metric`` on the row-major route, the camera takes it, and every other
  backend raises (no quiet reroute).
* The forward route's host reads: one ``active.any()`` per iteration
  (plus the one that ends the loop) and one crossing test per step."""

import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models.camera import make_canvas  # noqa: E402
from raytracegr_jl_tpu_torch.ops import integrate  # noqa: E402
from raytracegr_jl_tpu_torch.render import trace_batch  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the route's tensors are tiny, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rowmajor_matches_component_major():
    metric, scene, canvas = T.build(T.example2_spec(12, 8), F64, "cpu")
    integ = T.IntegratorConfig(method="tsit5", rtol=1e-9, atol=1e-9,
                               max_steps=1000)
    rgb = {b: T.trace_rays(metric, scene, canvas, T.RenderConfig(
        integrator=integ, backend=b)).rgb for b in ("rowmajor", "torch")}
    assert bool(torch.isfinite(rgb["rowmajor"]).all())
    torch.testing.assert_close(rgb["rowmajor"], rgb["torch"], rtol=0,
                               atol=1e-9)


def test_metric_function_renders_like_the_metric():
    spec = T.example2_spec(4, 3)
    metric, scene, _ = T.build(spec, F64, "cpu")
    params = metric.params

    def fn(x):
        return T.kerr_schild(x, params)

    def canvas(m):
        return make_canvas(m, spec.cam_pos, spec.cam_widthx, spec.cam_widthy,
                           spec.cam_normal, spec.ni, spec.nj, F64, "cpu")

    c_metric, c_fn = canvas(metric), canvas(fn)
    assert torch.equal(c_fn.pos, c_metric.pos)
    assert torch.equal(c_fn.normal, c_metric.normal)
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        method="rk4", rk4_dt=0.5, max_steps=60), backend="rowmajor")
    a = T.trace_rays(fn, scene, c_fn, cfg).rgb
    b = T.trace_rays(metric, scene, c_metric, cfg).rgb
    assert torch.equal(a, b)
    for backend in ("cuda", "torch", None):
        with pytest.raises(ValueError, match="rowmajor"):
            T.trace_rays(fn, scene, c_fn, cfg._replace(backend=backend))
    with pytest.raises(ValueError, match="rowmajor"):
        T.render_fn(fn, scene, cfg._replace(backend="cuda"))


def test_forward_route_host_reads():
    metric, scene, canvas = T.build(T.example1_spec(3, 3), F64, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        method="rk4", rk4_dt=0.5), backend="rowmajor")
    loops = integrate.integrate_rays.host_reads
    sweeps = integrate._locate_event.host_reads
    res = trace_batch(metric, scene, y0, cfg)
    assert bool(res.hit.any())
    assert 0 < res.n_iters < cfg.integrator.max_steps
    assert integrate.integrate_rays.host_reads - loops == res.n_iters + 1
    assert integrate._locate_event.host_reads - sweeps == res.n_iters
