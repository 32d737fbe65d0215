"""The port's plain K1 (integrate_rays_cm) against the JAX package's
component-major integrator on the same initial states and steps: the plain
XLA twin of the Pallas kernel (``integrate_rays_cm``, backend ``xla_cm``) at
f64, and the Pallas kernel itself in interpret mode at f32.

Tolerances. The adaptive controller amplifies ulp-level differences (XLA
and PyTorch round pow, sums and fused expressions differently) into other
step sequences on ill-conditioned rays. Those are the rays that end on the
black hole's horizon (Kerr-Schild radius within 4% of r+ = M + sqrt(M^2 -
a^2); in example2, as_written radius, M = 1, that is rho < 1.6 against
rho_h = 1.5616): their u^t grows to ~1e4 and, measured, a 1-ulp change of
y0 alone moves 2.3% of all step counts at 16x16 and u^t by 3.7e-4. Those
rays are held to ending on the horizon in the port too and to the same
shaded colour within 1e-6; every other ray to equal step counts on >= 99%
of them and 1e-8 in y and lam. The horizon rays are a minority: measured,
the checked share is 228 of 256 rays (0.89) in example2 16x16, all rays in
example1 and 62 of 64 (0.97) in the disk scene at 8x8; the tests require
at least 0.85."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raytracegr_jl_tpu.models.objects import shade as j_shade  # noqa: E402
from raytracegr_jl_tpu.models.scenes import accretion_disk_spec as j_accretion_disk  # noqa: E402
from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example1_spec as j_example1  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example2_spec as j_example2  # noqa: E402
from raytracegr_jl_tpu.ops import integrate as jint  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
from raytracegr_jl_tpu_torch.models.objects import shade  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cm  # noqa: E402
from raytracegr_jl_tpu_torch.ops.metrics import (kerr_schild_radius,  # noqa: E402
                                                 make_metric)
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HORIZON_BAND = 1.04  # final Kerr-Schild radius below this * r+: on the horizon
MIN_CHECKED_SHARE = 0.85  # rays off the horizon, held to equal steps


def _inputs(spec, dtype, cfg):
    """JAX-side (metric, scene, y0 [B, 8], dt0 [B]) for a spec."""
    metric, scene, canvas = j_build(spec, dtype)
    y0 = jnp.concatenate([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    mcm = metric.component_major
    if cfg.method == "rk4":
        dt0 = jnp.full(y0.shape[:1], cfg.rk4_dt, dtype)
    else:
        def rhs_cm(y):
            return jpg.geodesic_cm(mcm, y.T[:, None, :])[:, 0, :].T
        dt0 = jint.hairer_init_dt(rhs_cm, y0, cfg.rtol, cfg.atol, 5,
                                  cfg.lam_max)
    return metric, scene, y0, dt0


def _port_scene(jscene):
    return convert.scene_from_numpy({f: np.asarray(getattr(jscene, f))
                                     for f in jscene._fields})


def _port(spec, jscene, y0, dt0, cfg):
    """The port's plain K1 on the JAX side's state, carried across."""
    metric = make_metric(spec.metric_name, convert.ks_params_from_numpy(
        spec.metric_params.M, spec.metric_params.a), r_formula=spec.r_formula)
    return integrate_rays_cm(
        metric, _port_scene(jscene), convert.tensor(y0), convert.tensor(dt0),
        convert.integrator_config_from_fields(cfg._asdict()))


def _horizon(spec, y) -> np.ndarray:
    """Rays that ended on the black hole's horizon (none in flat space):
    final Kerr-Schild radius, by the spec's own formula, below
    HORIZON_BAND * r+."""
    if spec.metric_name == "minkowski":
        return np.zeros(y.shape[0], bool)
    M, a = spec.metric_params.M, spec.metric_params.a
    x = torch.tensor(np.asarray(y[:, 1:4]), dtype=torch.float64)
    r = kerr_schild_radius((x * x).sum(1), x[:, 2], a,
                           r_formula=spec.r_formula).numpy()
    return r < HORIZON_BAND * (M + np.sqrt(M * M - a * a))


def _check_against_xla_cm(spec, cfg):
    """The port's plain K1 against JAX xla_cm at f64 on one spec, with the
    bars of the module docstring."""
    metric, scene, y0, dt0 = _inputs(spec, jnp.float64, cfg)
    j = jpg.integrate_rays_cm(metric.component_major,
                              jpg.scene_event_cm(scene), y0, dt0, cfg)
    t = _port(spec, scene, y0, dt0, cfg)
    assert t.y.shape == (spec.ni * spec.nj, 8)
    assert t.y.dtype == torch.float64
    jy, ty = np.asarray(j.y), t.y.numpy()
    assert int(t.hit.sum()) > 0
    assert (np.asarray(j.hit) != t.hit.numpy()).sum() <= 1
    horizon = _horizon(spec, jy)
    rest = ~horizon
    assert rest.mean() >= MIN_CHECKED_SHARE, (
        f"only {rest.mean():.4f} of rays are off the horizon and checked")
    steps_eq = np.asarray(j.steps) == t.steps.numpy()
    assert steps_eq[rest].mean() >= 0.99, (
        f"steps agree on {steps_eq[rest].mean():.4f} of off-horizon rays")
    ok = rest & steps_eq
    np.testing.assert_allclose(ty[ok], jy[ok], rtol=0, atol=1e-8)
    np.testing.assert_allclose(t.lam.numpy()[ok], np.asarray(j.lam)[ok],
                               rtol=0, atol=1e-8)
    # Horizon rays: the port's rays end there too, in the same colour.
    np.testing.assert_array_equal(_horizon(spec, ty)[horizon], True)
    rgb_j = np.asarray(j_shade(scene, j.y[:, :4], 0.01))
    rgb_t = shade(_port_scene(scene), t.y[:, :4], 0.01).numpy()
    np.testing.assert_allclose(rgb_t[horizon], rgb_j[horizon], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("spec_fn,method", [(j_example2, "tsit5"),
                                            (j_example1, "rk4")])
def test_plain_integrator_matches_jax_xla_cm(spec_fn, method):
    _check_against_xla_cm(spec_fn(16, 16), jint.IntegratorConfig(
        method=method, rtol=1e-9, atol=1e-9, max_steps=4000))


def test_plain_integrator_matches_jax_xla_cm_disk():
    """The accretion disk around a spinning hole (a = 0.8, textbook radius,
    capture-stop), the one scene with a disk object, at 8x8. max_steps 400
    stops the two horizon rays early (they would run to any cap); rtol
    1e-8, since at 1e-9, measured, two of the 62 sky rays end one step
    apart with end states within 1.5e-10."""
    _check_against_xla_cm(j_accretion_disk(8, 8), jint.IntegratorConfig(
        method="tsit5", rtol=1e-8, atol=1e-8, max_steps=400, stop_rho=1.0))


def test_plain_integrator_matches_pallas_interpret_f32():
    """f32 against the Pallas kernel itself, run in interpret mode as
    tests/test_pallas.py runs it. At f32 and rtol 3e-6 step counts are
    roundoff-driven: measured on this case, the JAX package's own Pallas
    kernel and xla_cm path agree on 78% of step counts, and the port
    against itself with y0 moved by 1 ulp on 69%. So, as
    tests/test_pallas.py does, the pass condition is the image: hit flags
    agree (all but one ray) and >= 97% of shaded pixels within 1e-3; where
    step counts agree, off-horizon end states within 1e-3."""
    from raytracegr_jl_tpu.models.objects import shade_lanes

    cfg = jint.IntegratorConfig(method="tsit5", rtol=3e-6, atol=3e-6,
                                max_steps=400)
    spec = j_example2(16, 8)
    metric, scene, y0, dt0 = _inputs(spec, jnp.float32, cfg)
    j = jpg.integrate_rays_pallas(metric.component_major,
                                  jpg.scene_event_cm(scene, literal=True),
                                  y0, dt0, cfg, interpret=True)
    t = _port(spec, scene, y0, dt0, cfg)
    assert t.y.dtype == torch.float32
    jy, ty = np.asarray(j.y), t.y.numpy()
    assert (np.asarray(j.hit) != t.hit.numpy()).sum() <= 1
    rgb_j = np.asarray(shade_lanes(scene, j.y[:, :4], 0.01))
    rgb_t = shade(_port_scene(scene), t.y[:, :4]).numpy()
    assert (np.abs(rgb_j - rgb_t).max(-1) < 1e-3).mean() >= 0.97
    ok = ~_horizon(spec, jy) & (np.asarray(j.steps) == t.steps.numpy())
    assert ok.sum() >= 64
    np.testing.assert_allclose(ty[ok], jy[ok], rtol=0, atol=1e-3)
