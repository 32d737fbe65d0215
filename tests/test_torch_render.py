"""The port's slice end to end against the JAX package: camera, shading,
and trace_rays for example1 (RK4, flat space) and example2 (Tsit5,
Kerr-Schild) at 16x16 f64, the JAX side on its component-major path
(backend ``xla_cm``); plus the PNG codec the goldens are read with."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu.models.objects import shade_lanes  # noqa: E402
from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example1_spec as j_example1  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example2_spec as j_example2  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models.scenes import build as t_build  # noqa: E402
from raytracegr_jl_tpu_torch.utils import convert, image  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {"example1": (j_example1, T.example1_spec, "rk4"),
         "example2": (j_example2, T.example2_spec, "tsit5")}


def _jax_scene_fields(scene):
    return {f: np.asarray(getattr(scene, f)) for f in scene._fields}


@pytest.fixture(scope="module", params=sorted(SPECS))
def rendered(request):
    """JAX and port renders of one example at 16x16 f64 from the same
    carried-across scene and canvas."""
    j_spec_fn, t_spec_fn, method = SPECS[request.param]
    cfg = J.IntegratorConfig(method=method, rtol=1e-9, atol=1e-9,
                             max_steps=4000)
    metric, scene, canvas = j_build(j_spec_fn(16, 16), jnp.float64)
    j_canvas = J.trace_rays(metric, scene, canvas, J.RenderConfig(
        integrator=cfg, backend="xla_cm"))
    spec = t_spec_fn(16, 16)
    t_metric = T.make_metric(spec.metric_name, spec.metric_params,
                             r_formula=spec.r_formula)
    t_scene = convert.scene_from_numpy(_jax_scene_fields(scene))
    t_canvas = convert.canvas_from_numpy(canvas.pos, canvas.normal)
    t_cfg = T.RenderConfig(
        integrator=convert.integrator_config_from_fields(cfg._asdict()))
    out = T.trace_rays(t_metric, t_scene, t_canvas, t_cfg)
    return request.param, canvas, j_canvas, out, scene, t_scene


def test_camera_matches_jax(rendered):
    name, canvas, *_ = rendered
    j_spec_fn, t_spec_fn, _ = SPECS[name]
    _, _, c = t_build(t_spec_fn(16, 16), torch.float64, "cpu")
    np.testing.assert_allclose(c.pos.numpy(), np.asarray(canvas.pos),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(c.normal.numpy(), np.asarray(canvas.normal),
                               rtol=1e-13, atol=1e-15)


def test_shading_matches_jax(rendered):
    """The same end states through both shadings. The two libraries'
    atan2/acos differ by a few ulp (measured: 2.5% of atan2 results), and
    the checker's 12 theta / pi scales an angle ulp to ~2e-15, hence 1e-14
    rather than 1e-15."""
    _, _, _, _, scene, t_scene = rendered
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4000, 4)) * 4
    x[:1000, 1:] *= 10.0 / np.linalg.norm(x[:1000, 1:], axis=1,
                                          keepdims=True)  # on the sky
    x[1000:1500, 0] = -20.0  # on the time-plane
    j = np.asarray(shade_lanes(scene, jnp.asarray(x), 0.01))
    t = T.shade(t_scene, torch.from_numpy(x), 0.01).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)


def test_render_matches_jax(rendered):
    _, _, j_canvas, out, _, _ = rendered
    jrgb, trgb = np.asarray(j_canvas.rgb), out.rgb.numpy()
    assert trgb.shape == (16, 16, 3) and np.isfinite(trgb).all()
    close = np.abs(trgb - jrgb).max(-1) <= 1e-6
    assert close.mean() >= 0.99, f"{close.mean():.4f} of pixels within 1e-6"


def test_render_spec_defaults_match_jax():
    """render_spec's defaults (RK4 in flat space, eps^(3/4) tolerance) as
    in the JAX package; example1 is cheap enough to render whole."""
    cfg = J.RenderConfig(integrator=J.IntegratorConfig(
        method="rk4", rtol=J.default_tol(jnp.float64),
        atol=J.default_tol(jnp.float64)), backend="xla_cm")
    j = J.render_spec(j_example1(12, 12), jnp.float64, cfg)
    t = T.render_spec(T.example1_spec(12, 12), torch.float64, device="cpu")
    np.testing.assert_allclose(t.rgb.numpy(), np.asarray(j.rgb), rtol=0,
                               atol=1e-14)
    assert T.default_tol(torch.float32) == J.default_tol(jnp.float32)


def test_png_codec_without_native(tmp_path):
    """The pure-python codec reads the committed goldens exactly as the
    JAX package's loader does, and round-trips what it writes."""
    for name in ("sphere", "sphere2", "golden64_e1", "golden64_e2"):
        with open(f"scenes/{name}.png", "rb") as f:
            data = f.read()
        img = image.decode_png(data)
        np.testing.assert_array_equal(
            img.astype(np.float64) / 255.0,
            J.load_png(f"scenes/{name}.png"))
        np.testing.assert_array_equal(image.decode_png(image.encode_png(img)),
                                      img)
    rgb = torch.rand(7, 5, 3, dtype=torch.float64)
    path = T.save_png(str(tmp_path / "x.png"), rgb)
    np.testing.assert_array_equal(
        np.round(T.load_png(path) * 255).astype(np.uint8),
        T.canvas_to_image(rgb))


def test_examples_write_pngs(tmp_path, capsys):
    for fn in (T.example1, T.example2):
        out = str(tmp_path / f"{fn.__name__}.png")
        canvas = fn(8, 8, torch.float32, outfile=out, device="cpu")
        assert canvas.rgb.shape == (8, 8, 3)
        assert canvas.rgb.dtype == torch.float32
        np.testing.assert_array_equal(
            np.round(T.load_png(out) * 255).astype(np.uint8),
            T.canvas_to_image(canvas.rgb))
        assert out in capsys.readouterr().out
