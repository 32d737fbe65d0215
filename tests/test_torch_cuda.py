"""K1 on the card: the CUDA kernel against its plain PyTorch version on the
same CUDA tensors. Both round operation by operation alike (the kernel is
built with --fmad=false), so they agree bitwise. Needs a CUDA device; run
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(tests/conftest.py imports jax, which a GPU machine need not have)."""

import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import (integrate_rays_cm,  # noqa: E402
                                                     integrate_rays_cuda)
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402

# The condition is a string: pytest evaluates it when the test runs, not
# when the module is imported.
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA device")]

TOL32 = float(torch.finfo(torch.float32).eps) ** 0.75


@pytest.mark.parametrize("spec,dtype,integ", [
    (T.example2_spec(32, 32), torch.float32,
     T.IntegratorConfig(rtol=TOL32, atol=TOL32, max_steps=20_000)),
    (T.example1_spec(32, 32), torch.float64, T.IntegratorConfig(method="rk4")),
    (T.example1_spec(16, 16), torch.float64,
     T.IntegratorConfig(rtol=1e-10, atol=1e-10)),
    (T.example2_spec(16, 16), torch.float64,
     T.IntegratorConfig(rtol=1e-9, atol=1e-9, max_steps=4000)),
    (T.example2_spec(16, 16, a=0.8, r_formula="textbook"), torch.float64,
     T.IntegratorConfig(rtol=1e-9, atol=1e-9, max_steps=4000, stop_rho=0.5)),
    # The only scene with a disk object; max_steps bounds its horizon rays.
    (T.accretion_disk_spec(24, 24), torch.float32,
     T.IntegratorConfig(rtol=TOL32, atol=TOL32, max_steps=400, stop_rho=1.0)),
    (T.accretion_disk_spec(16, 16), torch.float64,
     T.IntegratorConfig(rtol=1e-8, atol=1e-8, max_steps=400, stop_rho=1.0)),
])
def test_kernel_matches_plain_bitwise(spec, dtype, integ):
    metric, scene, canvas = T.build(spec, dtype, torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    before = integrate_rays_cuda.launches
    k = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    torch.cuda.synchronize()
    assert integrate_rays_cuda.launches == before + 1
    p = integrate_rays_cm(metric, scene, y0, dt0, integ)
    assert torch.equal(k.hit, p.hit)
    assert torch.equal(k.steps, p.steps)
    assert torch.equal(k.y, p.y)
    assert torch.equal(k.lam, p.lam)


def test_cuda_backend_render_matches_torch_backend():
    metric, scene, canvas = T.build(T.example2_spec(24, 24), torch.float32,
                                    torch.device("cuda"))
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=TOL32, atol=TOL32, max_steps=20_000))
    before = integrate_rays_cuda.launches
    rgb = T.trace_rays(metric, scene, canvas, cfg).rgb
    assert integrate_rays_cuda.launches == before + 1
    rgb_plain = T.trace_rays(metric, scene, canvas,
                             cfg._replace(backend="torch")).rgb
    assert torch.equal(rgb, rgb_plain)
