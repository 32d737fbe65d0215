"""The accretion-disk render at f32 on the CPU against scenes/disk_1024.png,
which the JAX package rendered at f32 on a TPU, on a sample of its rays:
the port's compacted trace (plain chunks) with redshift shading, and the
JAX package's own ``xla_cm`` render as the witness of what f32 on another
chip gives. Each must be within 2 LSB of the image on all but 1% of the
sampled rays, the bar that chip_smoke.py holds the port's full 1024x1024
render on the card to.

The sample is 16,384 of the 1,048,576 rays (seeded); rays that have not
finished (hit, escaped or captured) within ``MAX_STEPS`` are left out, so
the photon-ring rays of more than 1,000 steps, which the card's count
covers, are not sampled here. Run with ``-s`` to see the counts."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu.models.scenes import accretion_disk_spec as j_disk  # noqa: E402
from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.shading import shade_redshift as j_shade_redshift  # noqa: E402
from raytracegr_jl_tpu.render import trace_batch as j_trace_batch  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 1024
SAMPLES = 16_384
MAX_STEPS = 1_000
BAR = 0.01  # share of sampled rays beyond 2 LSB of the image
PNG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "scenes", "disk_1024.png")


def _sample():
    return np.random.default_rng(0).choice(N * N, SAMPLES, replace=False)


def _jax_render(idx):
    """JAX package, f32 without x64 as it rendered the image."""
    with jax.enable_x64(False):
        f32 = jnp.float32
        metric, scene, canvas = j_build(j_disk(N, N), f32)
        y0 = jnp.concatenate([canvas.pos, canvas.normal],
                             -1).reshape(-1, 8)[idx]
        tol = J.default_tol(f32)
        cfg = J.RenderConfig(integrator=J.IntegratorConfig(
            method="tsit5", rtol=tol, atol=tol, max_steps=MAX_STEPS,
            stop_rho=1.0), backend="xla_cm", shading="redshift")
        res = j_trace_batch(metric, scene, y0, cfg)
        p = metric.params
        rgb = j_shade_redshift(metric, scene, y0, res.y, p.M, p.a)
        assert res.y.dtype == f32
        return (np.asarray(rgb), np.asarray(res.y), np.asarray(res.lam),
                np.asarray(res.hit), cfg.integrator.lam_max)


def _port_render(idx):
    """The port's compacted trace (chunk_plain on the CPU), f32."""
    f32 = torch.float32
    metric, scene, canvas = T.build(T.accretion_disk_spec(N, N), f32, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal],
                   -1).reshape(-1, 8)[torch.from_numpy(idx)]
    tol = float(torch.finfo(f32).eps) ** 0.75
    integ = T.IntegratorConfig(method="tsit5", rtol=tol, atol=tol,
                               max_steps=MAX_STEPS, stop_rho=1.0,
                               sort_rays=True)
    res = T.trace_batch_compacted(metric, scene, y0,
                                  initial_dt(metric, y0, integ), integ)
    p = metric.params
    rgb = T.shade_redshift(metric, scene, y0, res.y, p.M, p.a)
    return (rgb.numpy(), res.y.numpy(), res.lam.numpy(), res.hit.numpy(),
            integ.lam_max)


@pytest.mark.parametrize("render", [_port_render, _jax_render],
                         ids=["port", "jax"])
def test_disk_f32_within_2lsb_of_tpu_image(render):
    idx = _sample()
    rgb, y, lam, hit, lam_max = render(idx)
    finished = hit | (lam >= lam_max - 1e-5) | ((y[:, 1:4] ** 2).sum(1) < 1.0)
    img = np.round(np.clip(rgb, 0.0, 1.0) * 255).astype(np.int32)
    gold = np.round(T.load_png(PNG) * 255).astype(np.int32)
    g = gold[idx % N, idx // N]  # the image is [nj, ni]; rays [ni, nj]
    beyond = (np.abs(img - g).max(-1) > 2)[finished]
    print(f"beyond 2 LSB: {int(beyond.sum())} of {beyond.size} finished "
          f"sampled rays ({beyond.mean():.6f})")
    assert beyond.size >= 0.9 * SAMPLES
    assert beyond.mean() <= BAR
