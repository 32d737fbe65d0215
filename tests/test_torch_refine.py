"""The port's ``refine_minima`` (the trisection of the detection sweep's
argmin bracket, ops/geodesic_cm.py ``_detect_scan``) against the JAX
package's ``xla_cm`` integrator with the same option, and its behaviour
on its own: the thin slab that only refinement sees, and the detection
gate, which refinement turns off.

The JAX values are committed in tests/torch_refine_ref.npz (written by
tests/make_torch_refine_ref.py), so this file runs no JAX program.

Tolerances. On the 64 grazing rays of tests/test_event_detection.py (all
true hits of example1's radius-0.5 sphere) the hit flags must agree ray
for ray, and y and lam to 1e-8 (tests/test_torch_integrate.py's bar),
on every ray. With RK4 at a fixed step the step counts agree too. With
Tsit5 in flat space they need not: a straight ray's error estimate is
pure rounding, so the controller's step sizes follow the last bits of
the stage sums, which XLA and PyTorch round differently (measured: 13
of 64 rays take one more step in the port, the crossing and lam equal
to 1e-14)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models.camera import pixel_rays  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cm  # noqa: E402
from raytracegr_jl_tpu_torch.render import trace_batch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_refine_ref.npz")
ATOL = 1e-8


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


def _example1_scene():
    return T.make_scene([T.Sphere((0, 0, 0, 0), (1, 0, 0, 0), -10.0),
                         T.Plane(-20.0),
                         T.Sphere((0, 0, 0, 0), (1, 0, 0, 0), 0.5)],
                        torch.float64, "cpu")


def _cfg(ref, method, refine):
    tol = float(ref["rtol"])
    return T.IntegratorConfig(method=method, rtol=tol, atol=tol,
                              max_steps=int(ref["max_steps"]),
                              rk4_dt=float(ref["rk4_dt"]),
                              refine_minima=refine)


def _trace(ref, method, refine, **kw):
    y0 = torch.tensor(ref["y0"])
    dt0 = (torch.tensor(ref["dt0"]) if method == "tsit5"
           else torch.full((y0.shape[0],), float(ref["rk4_dt"]),
                           dtype=torch.float64))
    return integrate_rays_cm(T.make_metric("minkowski"), _example1_scene(),
                             y0, dt0, _cfg(ref, method, refine)._replace(**kw))


def _small_sphere_hits(hit, y):
    """Hits on the radius-0.5 sphere (the others end on the sky sphere)."""
    return np.asarray(hit) & (np.linalg.norm(np.asarray(y)[:, 1:4], axis=-1)
                              < 1.0)


@pytest.mark.parametrize("method", ["tsit5", "rk4"])
def test_refine_matches_jax_xla_cm(ref, method):
    res = _trace(ref, method, True)
    pre = f"{method}_refine"
    np.testing.assert_array_equal(res.hit.numpy(), ref[f"{pre}_hit"])
    np.testing.assert_allclose(res.y.numpy(), ref[f"{pre}_y"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(res.lam.numpy(), ref[f"{pre}_lam"], rtol=0,
                               atol=ATOL)
    if method == "rk4":
        np.testing.assert_array_equal(res.steps.numpy(), ref[f"{pre}_steps"])
    # Every grazing ray is a true hit, and refinement sees each one.
    assert _small_sphere_hits(res.hit, res.y).all()


@pytest.mark.parametrize("method", ["tsit5", "rk4"])
def test_sampling_alone_misses_grazing_hits(ref, method):
    """Without refinement the sweep's samples miss some of the same hits,
    in the port as in the JAX package."""
    res = _trace(ref, method, False)
    assert not _small_sphere_hits(res.hit, res.y).all()
    assert not _small_sphere_hits(ref[f"{method}_plain_hit"],
                                  ref[f"{method}_plain_y"]).all()


def test_thin_slab_hits_only_with_refinement():
    """tests/test_event_detection.py's thin object: a ray crossing a
    half = 0.02 disk almost face-on. Flat-space steps grow far beyond the
    slab's window in lambda, so the samples step over it and only the
    trisection of their argmin bracket finds it."""
    metric = T.make_metric("minkowski")
    scene = T.make_scene([T.Disk((0, 0, 0, 0), 1.0, 6.0, 0.02)],
                         torch.float64, "cpu")
    x0, u0 = pixel_rays(metric,
                        torch.tensor([0.0, 3.0, 0.0, 5.0],
                                     dtype=torch.float64),
                        torch.tensor([0.0, 0.0, 0.0, -1.0],
                                     dtype=torch.float64))
    y0 = torch.cat([x0, u0])[None, :]
    tol = T.default_tol(torch.float64)
    base = T.IntegratorConfig(method="tsit5", rtol=tol, atol=tol,
                              max_steps=4000)
    hits = [bool(trace_batch(metric, scene, y0, T.RenderConfig(
        integrator=base._replace(refine_minima=r))).hit[0])
        for r in (False, True)]
    assert hits == [False, True]


@pytest.mark.parametrize("method", ["tsit5", "rk4"])
def test_refine_turns_the_gate_off(ref, method):
    """refine_minima with event_gate equals it without the gate, bitwise:
    the trisection must run on every step, so the gate is off."""
    a = _trace(ref, method, True)
    b = _trace(ref, method, True, event_gate=True)
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
