"""The port's compacted integration (compaction.py) on the CPU, where each
chunk runs K2's plain version: against the port's single masked loop
(``integrate_rays_cm``) bitwise, its chunk sequence against the JAX
package's schedule rules, the impact-parameter sort against the JAX
package's, and the 16x16 accretion-disk render with redshift shading
against the JAX package's ``xla_cm`` render at f64.

The JAX compacted trace itself is not run here: it needs its Pallas
kernel, which costs ~40 s per call in interpret mode; the JAX package's own
tests pin it to its single launch and to ``xla_cm``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu.models.scenes import accretion_disk_spec as j_disk  # noqa: E402
from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.shading import shade_redshift as j_shade_redshift  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
from raytracegr_jl_tpu.render import trace_batch as j_trace_batch  # noqa: E402
from raytracegr_jl_tpu.utils.stats import trace_stats as j_trace_stats  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch import compaction  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import (impact_parameter,  # noqa: E402
                                                     impact_parameter_order,
                                                     integrate_rays_cm)
from raytracegr_jl_tpu_torch.ops.metrics import kerr_schild_radius  # noqa: E402
from raytracegr_jl_tpu_torch.render import _shade, initial_dt  # noqa: E402
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Horizon rule and bars of tests/test_torch_integrate.py.
HORIZON_BAND = 1.04
MIN_CHECKED_SHARE = 0.85

# (label, spec, dtype, integrator, first_chunk). example2 48x48 f32 is the
# JAX package's own compaction case (tests/test_compaction.py); first_chunk
# 32 makes it pack once, first_chunk 16 not. The disk at f64 has rays that
# run to max_steps.
CASES = {
    "example2-48-f32-fc16": (T.example2_spec(48, 48), torch.float32,
                             T.IntegratorConfig(rtol=3e-6, atol=3e-6,
                                                max_steps=400), 16),
    "example2-48-f32-fc32": (T.example2_spec(48, 48), torch.float32,
                             T.IntegratorConfig(rtol=3e-6, atol=3e-6,
                                                max_steps=400), 32),
    "disk-16-f64-fc16": (T.accretion_disk_spec(16, 16), torch.float64,
                         T.IntegratorConfig(rtol=1e-8, atol=1e-8,
                                            max_steps=400, stop_rho=1.0), 16),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request):
    """The single loop's and the compacted trace's results on one case,
    with the compacted trace's chunk records."""
    spec, dtype, cfg, first_chunk = CASES[request.param]
    metric, scene, canvas = T.build(spec, dtype, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, cfg)
    single = integrate_rays_cm(metric, scene, y0, dt0, cfg)
    chunks = []
    comp = T.trace_batch_compacted(metric, scene, y0, dt0, cfg,
                                   first_chunk=first_chunk, chunks=chunks)
    return request.param, cfg, first_chunk, single, comp, chunks


def test_compacted_equals_single_loop_bitwise(traced):
    _, _, _, single, comp, _ = traced
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(comp, f), getattr(single, f)), f
    assert int(comp.hit.sum()) > 0


def test_chunk_schedule_follows_jax(traced):
    """The JAX schedule (compaction.py:243-286): budgets start at
    first_chunk; the batch is packed, to whole units of 1024 rays, only
    when the active rays fit in half of it, and the budget then doubles
    (to 4096 at most); when packing stalls the rest of max_steps runs in
    one launch. n_iters is the iterations run."""
    label, cfg, first_chunk, _, comp, chunks = traced
    unit = compaction.PACK_UNIT
    size = -(-chunks[0]["rays"] // unit) * unit
    budget, total, packs = first_chunk, 0, 0
    for i, rec in enumerate(chunks):
        budget = min(budget, cfg.max_steps - total)
        assert rec["budget"] == budget, (label, i)
        total += budget
        last = i == len(chunks) - 1
        assert last == (rec["active"] == 0 or total >= cfg.max_steps)
        if last:
            break
        need = max(1, -(-rec["active"] // unit)) * unit
        if need <= size // 2:
            assert chunks[i + 1]["rays"] == need
            size, budget, packs = need, min(2 * budget,
                                            compaction.MAX_BUDGET), packs + 1
        else:
            assert chunks[i + 1]["rays"] == rec["rays"]
            budget = cfg.max_steps - total
    assert comp.n_iters == total
    assert packs == (1 if label == "example2-48-f32-fc32" else 0)


def test_trace_stats_matches_jax(traced):
    """The port's trace_stats against the JAX package's on the same
    results, called both ways (with wall_s and cfg; with neither, when
    escapes are judged against lam_max 100 and method and max_steps are
    left out): every field but the device, which is "cpu" here."""
    _, cfg, _, _, comp, _ = traced
    j_res = J.TraceResult(*(jnp.asarray(getattr(comp, f).numpy())
                            for f in ("y", "lam", "hit", "steps")),
                          n_iters=jnp.asarray(comp.n_iters))
    j_cfg = J.IntegratorConfig(**{f: getattr(cfg, f)
                                  for f in J.IntegratorConfig._fields
                                  if f in cfg._fields})
    for want, got in ((j_trace_stats(j_res, wall_s=0.25, cfg=j_cfg),
                       T.trace_stats(comp, wall_s=0.25, cfg=cfg)),
                      (j_trace_stats(j_res), T.trace_stats(comp))):
        assert got.pop("device") == "cpu"
        want.pop("device")
        assert got == want
        assert got["rays"] == comp.steps.numel() and got["hit_frac"] > 0
    full = T.trace_stats(comp, wall_s=0.25, cfg=cfg)
    assert full["wall_s"] == 0.25
    assert full["rays_per_s"] == round(comp.steps.numel() / 0.25, 1)
    assert full["method"] == cfg.method
    bare = T.trace_stats(comp)
    assert not {"wall_s", "rays_per_s", "method", "max_steps"} & set(bare)


def test_sorted_equals_unsorted():
    """Rays are integrated independently: the plain loop on the batch in
    impact-parameter order, put back in camera order, equals it on the
    batch as given, and the plain loop ignores sort_rays."""
    metric, scene, canvas = T.build(T.example2_spec(32, 32), torch.float32,
                                    "cpu")
    cfg = T.IntegratorConfig(rtol=3e-6, atol=3e-6, max_steps=400)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, cfg)
    plain = integrate_rays_cm(metric, scene, y0, dt0, cfg)
    order, inv = impact_parameter_order(y0)
    assert not torch.equal(order, torch.arange(y0.shape[0]))
    sorted_ = integrate_rays_cm(metric, scene, y0[order], dt0[order], cfg)
    flagged = integrate_rays_cm(metric, scene, y0, dt0,
                                cfg._replace(sort_rays=True))
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(sorted_, f)[inv], getattr(plain, f)), f
        assert torch.equal(getattr(flagged, f), getattr(plain, f)), f


def test_impact_parameter_key_matches_jax():
    """The sort key (the impact parameter about the origin) against the
    JAX package's, through its permutation: the port's key taken in JAX's
    order is sorted and equals the port's sorted key to 1e-14. The key is
    arithmetic, so near-ties may be ordered differently; the results do not
    depend on the order."""
    rng = np.random.default_rng(1)
    y0 = rng.normal(size=(3000, 8)) * 5.0
    j_order, j_inv = (np.asarray(a) for a in
                      jpg.impact_parameter_order(jnp.asarray(y0)))
    t = torch.from_numpy(y0)
    order, inv = impact_parameter_order(t)
    key = impact_parameter(t).numpy()
    np.testing.assert_array_equal(np.diff(key[order.numpy()]) >= 0, True)
    np.testing.assert_allclose(key[j_order], key[order.numpy()], rtol=0,
                               atol=1e-14 * key.max())
    np.testing.assert_array_equal(order.numpy()[inv.numpy()],
                                  np.arange(y0.shape[0]))
    np.testing.assert_array_equal(j_order[j_inv], np.arange(y0.shape[0]))


def _horizon(spec, y) -> np.ndarray:
    M, a = spec.metric_params.M, spec.metric_params.a
    x = torch.tensor(np.asarray(y[:, 1:4]), dtype=torch.float64)
    r = kerr_schild_radius((x * x).sum(1), x[:, 2], a,
                           r_formula=spec.r_formula).numpy()
    return r < HORIZON_BAND * (M + np.sqrt(M * M - a * a))


def test_compacted_redshift_render_matches_jax_xla_cm():
    """The 16x16 accretion disk (a = 0.8) at f64 with redshift shading:
    the port's compacted trace (plain chunks) and redshift shading against
    the JAX package's xla_cm trace and shade_redshift, on the
    carried-across canvas. Bars of
    tests/test_torch_integrate.py: rays that end on the horizon end there
    in both and are shaded alike (black) within 1e-6; the rest agree in
    step counts on >= 99% of them, and where they do, in y within 1e-8 and
    on >= 99% of pixels in colour within 1e-6, the bar of
    tests/test_torch_render.py (a checker edge, a floored modulo, turns an
    ulp of position into a full colour step: measured, 1 of 246 pixels)."""
    cfg = J.IntegratorConfig(method="tsit5", rtol=1e-8, atol=1e-8,
                             max_steps=400, stop_rho=1.0)
    spec = j_disk(16, 16)
    metric, scene, canvas = j_build(spec, jnp.float64)
    rc = J.RenderConfig(integrator=cfg, backend="xla_cm", shading="redshift")
    y0 = jnp.concatenate([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    j = j_trace_batch(metric, scene, y0, rc)
    p = spec.metric_params
    rgb_j = np.asarray(j_shade_redshift(metric, scene, y0, j.y, p.M, p.a))

    t_metric = T.make_metric(spec.metric_name, T.KerrSchildParams(p.M, p.a),
                             r_formula=spec.r_formula)
    t_scene = convert.scene_from_numpy({f: np.asarray(getattr(scene, f))
                                        for f in scene._fields})
    t_canvas = convert.canvas_from_numpy(canvas.pos, canvas.normal)
    t_rc = T.RenderConfig(
        integrator=convert.integrator_config_from_fields(cfg._asdict()),
        shading="redshift")
    ty0 = torch.cat([t_canvas.pos, t_canvas.normal], -1).reshape(-1, 8)
    t = T.trace_batch_compacted(t_metric, t_scene, ty0,
                                initial_dt(t_metric, ty0, t_rc.integrator),
                                t_rc.integrator)
    rgb_t = _shade(t_metric, t_scene, ty0, t.y, t_rc).numpy()
    assert np.isfinite(rgb_t).all() and rgb_t.max() > 0.05

    jy, ty = np.asarray(j.y), t.y.numpy()
    assert (np.asarray(j.hit) != t.hit.numpy()).sum() <= 1
    horizon = _horizon(spec, jy)
    rest = ~horizon
    assert rest.mean() >= MIN_CHECKED_SHARE, rest.mean()
    steps_eq = np.asarray(j.steps) == t.steps.numpy()
    assert steps_eq[rest].mean() >= 0.99, steps_eq[rest].mean()
    ok = rest & steps_eq
    np.testing.assert_allclose(ty[ok], jy[ok], rtol=0, atol=1e-8)
    close = np.abs(rgb_t[ok] - rgb_j[ok]).max(-1) <= 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of pixels within 1e-6"
    np.testing.assert_array_equal(_horizon(spec, ty)[horizon], True)
    np.testing.assert_allclose(rgb_t[horizon], rgb_j[horizon], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("shading", ["reference", "redshift"])
def test_render_compacted_equals_render_fn(shading):
    """The compacted render is the initial step, trace_batch_compacted and
    the shading of the config, and equals render_fn's image bitwise."""
    metric, scene, canvas = T.build(T.accretion_disk_spec(8, 8),
                                    torch.float64, "cpu")
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=1e-6, atol=1e-6, max_steps=100, stop_rho=1.0), shading=shading)
    out = T.render_compacted(metric, scene, canvas, cfg, first_chunk=8)
    want = T.render_fn(metric, scene, cfg)(canvas.pos, canvas.normal)
    assert out.rgb.shape == (8, 8, 3) and torch.equal(out.rgb, want)
