"""The port's generic-metric geometry (ops/geometry.py: ``dmetric``,
``christoffel``, ``geodesic``, ``Ray``, ``r2s``, ``s2r``) against the JAX
package's at 16 seeded points, f64, for Kerr-Schild (M = 1, a = 0.8)
and Minkowski; JAX runs live (vmapped point functions, no gradient
program).

Tolerance: rtol 1e-13 of each array's largest entry. The port evaluates
the same expressions on a batch where JAX vmaps single points, and its
derivatives come from reverse mode (JAX's from forward mode), so the two
round apart by a few ulp; entries that cancel to near zero are held to
the array's scale, not their own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu.ops import geometry as jgeo  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geometry as tgeo  # noqa: E402

RTOL = 1e-13
N_POINTS = 16
METRICS = {
    "kerr_schild": (T.KerrSchildParams(M=1.0, a=0.8),
                    J.KerrSchildParams(M=1.0, a=0.8)),
    "minkowski": (None, None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the route's tensors are tiny, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=0):
    """16 events at radius 2-8 around the hole and 16 null-ish velocities."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_POINTS, 4))
    x[:, 1:] *= rng.uniform(2.0, 8.0, (N_POINTS, 1)) / np.linalg.norm(
        x[:, 1:], axis=1, keepdims=True)
    u = rng.normal(size=(N_POINTS, 4))
    return x, np.concatenate([x, u], axis=1)


def _metrics(name):
    tp, jp = METRICS[name]
    return T.make_metric(name, tp), J.make_metric(name, jp)


def _close(t, j):
    j = np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-300)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=RTOL,
                               atol=RTOL * scale)


@pytest.mark.parametrize("name", list(METRICS))
def test_dmetric_christoffel_geodesic_match_jax(name):
    tm, jm = _metrics(name)
    x, s = _points()
    g, dg = T.dmetric(tm, torch.from_numpy(x))
    jg, jdg = jax.vmap(lambda p: jgeo.dmetric(jm, p))(jnp.asarray(x))
    _close(g, jg)
    _close(dg, jdg)
    if name == "minkowski":
        assert float(dg.detach().abs().max()) == 0.0
    else:
        assert float(dg.detach().abs().max()) > 0.0
    _close(T.christoffel(tm, torch.from_numpy(x)),
           jax.vmap(lambda p: jgeo.christoffel(jm, p))(jnp.asarray(x)))
    _close(T.geodesic(torch.from_numpy(s), tm),
           jgeo.geodesic_batched(jm)(jnp.asarray(s)))
    _close(tgeo.geodesic_batched(tm)(torch.from_numpy(s)),
           jax.vmap(lambda p: jgeo.geodesic(p, jm))(jnp.asarray(s)))
    # One event as in the JAX package ([4] -> [4, 4, 4]).
    _close(T.dmetric(tm, torch.from_numpy(x[3]))[1], jdg[3])


def test_dmetric_carries_parameter_gradients():
    """Reverse mode through the derivative: d/dM of a sum of Christoffel
    symbols, against a central difference."""
    x = torch.from_numpy(_points(1)[0])

    def total(M):
        m = T.make_metric("kerr_schild", T.KerrSchildParams(M=M, a=0.8))
        return T.christoffel(m, x).sum()

    M = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    total(M).backward()
    eps = 1e-6
    with torch.no_grad():
        fd = (total(torch.tensor(1.0 + eps, dtype=torch.float64))
              - total(torch.tensor(1.0 - eps, dtype=torch.float64))) / (
                  2 * eps)
    np.testing.assert_allclose(float(M.grad), float(fd), rtol=1e-7)


def test_ray_packing_round_trips():
    _, s = _points(2)
    st = torch.from_numpy(s)
    r = T.s2r(st)
    assert isinstance(r, T.Ray) and r.x.shape == (N_POINTS, 4)
    assert torch.equal(T.r2s(r), st)
    jr = jgeo.s2r(jnp.asarray(s))
    np.testing.assert_array_equal(r.x.numpy(), np.asarray(jr.x))
    np.testing.assert_array_equal(r.u.numpy(), np.asarray(jr.u))
    back = T.s2r(T.r2s(T.Ray(x=r.x, u=r.u)))
    assert torch.equal(back.x, r.x) and torch.equal(back.u, r.u)
