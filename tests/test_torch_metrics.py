"""The PyTorch port's metrics, geometry and state conversion against the JAX
package, on the same numpy inputs, at f64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raytracegr_jl_tpu.models.objects import make_scene as j_make_scene  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example2_spec as j_example2_spec  # noqa: E402
from raytracegr_jl_tpu.ops import geometry as jgeo  # noqa: E402
from raytracegr_jl_tpu.ops import integrate as jint  # noqa: E402
from raytracegr_jl_tpu.ops import metrics as jmet  # noqa: E402
from raytracegr_jl_tpu.ops.pallas_geodesic import kerr_schild_cm  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geometry as tgeo  # noqa: E402
from raytracegr_jl_tpu_torch.ops import metrics as tmet  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import ks_parts  # noqa: E402
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [(0.0, "as_written"), (0.0, "textbook"), (0.8, "as_written"),
         (0.8, "textbook")]


def _points(seed: int = 0) -> np.ndarray:
    """[N, 4] events: random, near the horizon (rho ~ 1.4-2.6, where both
    radius formulas put r ~ 2M), and inside the clamp (rho < rho_min and,
    for a = 0.8, rho < a)."""
    rng = np.random.default_rng(seed)
    rand = rng.normal(size=(64, 4)) * 3.0
    dirs = rng.normal(size=(64, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    near = np.concatenate([rng.normal(size=(64, 1)),
                           dirs * rng.uniform(1.4, 2.6, (64, 1))], axis=1)
    tiny = np.concatenate([rng.normal(size=(32, 1)),
                           dirs[:32] * rng.uniform(0.0, 5e-4, (32, 1))], 1)
    inner = np.concatenate([rng.normal(size=(32, 1)),
                            dirs[32:] * rng.uniform(0.0, 0.7, (32, 1))], 1)
    return np.concatenate([rand, near, tiny, inner])


@pytest.mark.parametrize("a,rf", CASES)
def test_kerr_schild_matches_jax(a, rf):
    x = _points()
    j = np.asarray(jmet.kerr_schild(jnp.asarray(x), jmet.KerrSchildParams(
        1.0, a), r_formula=rf))
    t = tmet.kerr_schild(torch.from_numpy(x), tmet.KerrSchildParams(1.0, a),
                         r_formula=rf).numpy()
    # atol covers entries that cancel to ~0 (f k_i k_j with k_i ~ 0).
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-15)
    metric = tmet.make_metric("kerr_schild", tmet.KerrSchildParams(1.0, a),
                              r_formula=rf)
    np.testing.assert_array_equal(metric(torch.from_numpy(x)).numpy(), t)


def test_minkowski_is_eta():
    x = torch.from_numpy(_points())
    g = tmet.make_metric("minkowski")(x).numpy()
    np.testing.assert_array_equal(g, np.asarray(jmet.minkowski(
        jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("a,rf", CASES)
def test_ks_parts_match_jax(a, rf):
    x = _points(1).T  # component-major [4, N]
    jf, jdf, jk, jdk, jcoef = kerr_schild_cm(jmet.KerrSchildParams(1.0, a),
                                             rf).ks_parts(
        [jnp.asarray(x[i]) for i in range(4)])
    metric = tmet.make_metric("kerr_schild", tmet.KerrSchildParams(1.0, a),
                              r_formula=rf)
    tf, tdf, tk, tdk, tcoef = ks_parts(metric, [torch.from_numpy(x[i])
                                                for i in range(4)])

    def close(t, j, what):
        np.testing.assert_allclose(np.asarray(t), np.broadcast_to(
            np.asarray(j), x.shape[1:]), rtol=1e-12, atol=1e-15,
            err_msg=what)

    close(tf, jf, "f")
    close(tcoef, jcoef, "coef")
    for c in range(3):
        close(tdf[c], jdf[c], f"df[{c}]")
        for b in range(3):
            close(tdk[c][b], jdk[c][b], f"dk[{c}][{b}]")
    for i in range(1, 4):
        close(tk[i], jk[i], f"k[{i}]")


def test_radius_helpers_match_jax():
    rng = np.random.default_rng(2)
    rho2 = rng.uniform(0.0, 40.0, 200)
    z = rng.normal(size=200)
    for a, rf in CASES:
        for rho_min in (0.0, 1e-3):
            jr2 = jmet.clamped_rho2(jnp.asarray(rho2), a, 1e-3, rf)
            tr2 = tmet.clamped_rho2(torch.from_numpy(rho2),
                                    torch.tensor(a, dtype=torch.float64),
                                    1e-3, rf)
            np.testing.assert_array_equal(tr2.numpy(), np.asarray(jr2))
            jp = jmet.kerr_schild_radius_partials(
                jr2, jnp.asarray(z), a, r_formula=rf, rho_min=rho_min)
            tp = tmet.kerr_schild_radius_partials(
                tr2, torch.from_numpy(z), torch.tensor(a, dtype=torch.float64),
                r_formula=rf, rho_min=rho_min)
            for t, j in zip(tp, jp):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-12, atol=1e-15)


def test_inv4_and_bounds_match_jax():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(50, 4, 4))
    g = m @ np.swapaxes(m, -1, -2) + 4 * np.eye(4)
    np.testing.assert_allclose(tgeo.inv4(torch.from_numpy(g)).numpy(),
                               np.asarray(jgeo.inv4(jnp.asarray(g))),
                               rtol=1e-12)
    for tdt, jdt in [(torch.float32, jnp.float32), (torch.float64,
                                                    jnp.float64)]:
        assert tgeo.sanitize_bounds(tdt) == jgeo.sanitize_bounds(jdt)


def test_convert_carries_jax_state():
    spec = j_example2_spec(4, 4)
    jscene = j_make_scene(spec.objects, jnp.float64)
    scene = convert.scene_from_numpy({f: np.asarray(getattr(jscene, f))
                                      for f in jscene._fields})
    for f in jscene._fields:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(jscene, f)))
    assert scene.kind.dtype == torch.int32
    p = convert.ks_params_from_numpy(np.asarray(1.0), np.asarray(0.5))
    assert p == tmet.KerrSchildParams(1.0, 0.5)
    jcfg = jint.IntegratorConfig(method="rk4", rtol=1e-9, max_steps=7)
    cfg = convert.integrator_config_from_fields(jcfg._asdict())
    assert tuple(cfg) == tuple(jcfg)
    with pytest.raises(ValueError):
        convert.integrator_config_from_fields({"bogus": 1})
