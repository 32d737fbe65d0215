"""The port's generic-metric row-major route (``backend="rowmajor"``:
ops/geometry.py's ``geodesic`` by reverse-mode derivatives of the
metric, ops/integrate.py's ``integrate_rays`` and
``integrate_rays_scan``) against the JAX package's row-major route
(``backend="xla"``), at f64 on the CPU. The JAX values are committed in
tests/torch_rowmajor_ref.npz (written by tests/make_torch_slice8_ref.py),
so this file runs no JAX program.

Tolerances. Renders (example1 at 8x8 with RK4, example2 at 8x8 with
Tsit5, both at tolerances 1e-9): rgb within 1e-9 and equal hits on every
ray (tests/test_pallas.py's bar between the JAX package's row-major and
component-major routes), equal step counts on every ray that does not end
on the black hole's horizon (Kerr-Schild radius below 1.04 r+, where a
1-ulp change of the initial state alone moves the count;
tests/test_torch_integrate.py). The differentiable route (example2 at
8x8, RK4 with 20 steps of 0.5, M = 1.05 against the truth's image): the
loss and its (M, a, sphere_pos) gradients within rtol 1e-9
(tests/test_torch_grad.py's bar)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops.metrics import kerr_schild_radius  # noqa: E402
from raytracegr_jl_tpu_torch.render import _shade, trace_batch  # noqa: E402

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_rowmajor_ref.npz")
F64 = torch.float64
HORIZON_BAND = 1.04
CASES = {
    "e1": (T.example1_spec(8, 8), T.IntegratorConfig(
        method="rk4", rk4_dt=0.1, rtol=1e-9, atol=1e-9)),
    "e2": (T.example2_spec(8, 8), T.IntegratorConfig(
        method="tsit5", rtol=1e-9, atol=1e-9, max_steps=1000)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the route's tensors are tiny, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


def _horizon(spec, y: torch.Tensor) -> np.ndarray:
    """Rays that end within HORIZON_BAND r+ of the hole (none in flat
    space)."""
    if spec.metric_name == "minkowski":
        return np.zeros(y.shape[0], bool)
    M, a = spec.metric_params.M, spec.metric_params.a
    x = y[:, 1:4]
    r = kerr_schild_radius((x * x).sum(1), x[:, 2], a,
                           r_formula=spec.r_formula).numpy()
    return r < HORIZON_BAND * (M + np.sqrt(M * M - a * a))


@pytest.mark.parametrize("key", list(CASES))
def test_render_matches_jax_xla(ref, key):
    spec, integ = CASES[key]
    metric, scene, canvas = T.build(spec, F64, "cpu")
    cfg = T.RenderConfig(integrator=integ, backend="rowmajor")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    res = trace_batch(metric, scene, y0, cfg)
    rgb = _shade(metric, scene, y0, res.y, cfg).reshape(spec.ni, spec.nj, 3)
    np.testing.assert_allclose(rgb.numpy(), ref[f"{key}_rgb"], rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(res.hit.numpy(), ref[f"{key}_hit"])
    assert int(res.hit.sum()) > 0
    rest = ~_horizon(spec, res.y)
    np.testing.assert_array_equal(res.steps.numpy()[rest],
                                  ref[f"{key}_steps"][rest])


def test_scan_gradients_match_jax(ref):
    spec = T.example2_spec(8, 8)
    cfg = T.default_inverse_cfg(F64, max_steps=20, rk4_dt=0.5,
                                stop_rho=0.5)._replace(backend="rowmajor")
    xg, ng = T.flat_pixel_grid(spec, F64, "cpu")
    params = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], F64, "cpu")
    loss = T.make_ray_loss_fn(spec, cfg, 2, F64, "cpu")(
        params, xg, ng, torch.from_numpy(ref["grad_target"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref["grad_loss"]),
                               rtol=1e-9)
    scale = float(np.abs(ref["grad_sphere_pos"]).max())
    for name in ("M", "a", "sphere_pos"):
        np.testing.assert_allclose(
            getattr(params, name).grad.numpy(), ref[f"grad_{name}"],
            rtol=1e-9, atol=1e-10 * scale, err_msg=name)
    assert float(params.M.grad) != 0.0
