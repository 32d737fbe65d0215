"""Guards of the PyTorch port: it never imports jax, its configs mirror the
JAX package's, and the CUDA path launches its kernels or raises — on CPU
tensors, without nvcc, for options the kernels do not take — with no
quiet fallback to the plain versions."""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu as J  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import (CFG_SLOTS, N_CFG,  # noqa: E402
                                                     OBJ_FIELDS,
                                                     integrate_rays_cm,
                                                     integrate_rays_cuda,
                                                     kernel_params)
from raytracegr_jl_tpu_torch.render import resolve_backend  # noqa: E402
from raytracegr_jl_tpu_torch.utils import cuda_build  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODULES = ["raytracegr_jl_tpu_torch", "raytracegr_jl_tpu_torch.render",
           "raytracegr_jl_tpu_torch.models.scenes",
           "raytracegr_jl_tpu_torch.ops.geodesic_cm",
           "raytracegr_jl_tpu_torch.ops.adjoint",
           "raytracegr_jl_tpu_torch.compaction",
           "raytracegr_jl_tpu_torch.models.shading",
           "raytracegr_jl_tpu_torch.utils.stats",
           "raytracegr_jl_tpu_torch.grad",
           "raytracegr_jl_tpu_torch.inverse",
           "raytracegr_jl_tpu_torch.step_graph",
           "raytracegr_jl_tpu_torch.utils.convert",
           "raytracegr_jl_tpu_torch.utils.cuda_build",
           "raytracegr_jl_tpu_torch.utils.image",
           "raytracegr_jl_tpu_torch.parallel.sharding",
           "raytracegr_jl_tpu_torch.ops.geometry",
           "raytracegr_jl_tpu_torch.ops.integrate",
           "raytracegr_jl_tpu_torch.ops.dual",
           "raytracegr_jl_tpu_torch.ops.dual_oracle"]
# The generic-metric API and the Dual the JAX package exports, and the
# sharding entry points.
NAMES = {"raytracegr_jl_tpu_torch": ["dmetric", "christoffel", "geodesic",
                                     "Ray", "r2s", "s2r", "integrate_rays",
                                     "Dual", "g_factors",
                                     "keplerian_velocity"],
         "raytracegr_jl_tpu_torch.parallel.sharding": [
             "init_distributed", "make_mesh", "pad_rows", "shard_pixels",
             "global_pixels", "crop_rows", "gather_rows", "sharded_render",
             "sharded_value_and_grad"]}


def _small(dtype=torch.float64):
    metric, scene, canvas = T.build(T.example2_spec(2, 2), dtype, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    return metric, scene, y0, torch.full((4,), 0.01, dtype=dtype)


def test_import_never_loads_jax():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in MODULES)
            + "".join(f"from {m} import {', '.join(names)}\n"
                      for m, names in NAMES.items())
            + "assert 'jax' not in sys.modules, sorted(m for m in "
            "sys.modules if m.startswith('jax'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_configs_mirror_jax():
    assert T.IntegratorConfig._fields == J.IntegratorConfig._fields
    assert tuple(T.IntegratorConfig()) == tuple(J.IntegratorConfig())
    assert (set(T.RenderConfig._fields)
            == set(J.RenderConfig._fields) - {"pallas_interpret"})
    assert T.TraceResult._fields == J.TraceResult._fields


def test_cuda_wrapper_raises_on_cpu_tensors():
    metric, scene, y0, dt0 = _small()
    before = integrate_rays_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        integrate_rays_cuda(metric, scene, y0, dt0, T.IntegratorConfig())
    assert integrate_rays_cuda.launches == before


def test_cuda_backend_does_not_fall_back():
    metric, scene, canvas = T.build(T.example2_spec(2, 2), torch.float64,
                                    "cpu")
    cfg = T.RenderConfig(backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        T.trace_rays(metric, scene, canvas, cfg)
    assert resolve_backend(T.RenderConfig(), canvas.pos) == "torch"
    assert resolve_backend(cfg, canvas.pos) == "cuda"


def test_ported_options_run():
    """refine_minima, grad_mode="scan", grad_groups, sort_rays on the
    differentiable path and fast_epilogue, which raised before they were
    ported, run; a bad shading or grad_mode raises."""
    metric, scene, y0, dt0 = _small()
    res = integrate_rays_cm(metric, scene, y0, dt0,
                            T.IntegratorConfig(refine_minima=True,
                                               max_steps=50))
    assert bool(torch.isfinite(res.y).all())
    canvas = T.build(T.example2_spec(2, 2), torch.float64, "cpu")[2]
    grad = T.IntegratorConfig(method="rk4", rk4_dt=0.5, max_steps=20)
    for cfg in (T.RenderConfig(differentiable=True,
                               integrator=grad._replace(grad_mode="scan")),
                T.RenderConfig(differentiable=True,
                               integrator=grad._replace(grad_groups=2)),
                T.RenderConfig(differentiable=True,
                               integrator=grad._replace(sort_rays=True))):
        rgb = T.trace_rays(metric, scene, canvas, cfg).rgb
        assert rgb.shape == (2, 2, 3) and bool(torch.isfinite(rgb).all())
    rgb = T.make_compact_renderer(metric, scene, T.RenderConfig(
        integrator=grad, shading="redshift"), fast_epilogue=True)(canvas).rgb
    assert rgb.shape == (2, 2, 3) and bool(torch.isfinite(rgb).all())
    with pytest.raises(ValueError, match="shading"):
        T.trace_rays(metric, scene, canvas, T.RenderConfig(shading="gold"))
    with pytest.raises(ValueError, match="grad_mode"):
        T.trace_rays(metric, scene, canvas, T.RenderConfig(
            differentiable=True, integrator=grad._replace(grad_mode="tape")))


@pytest.mark.parametrize("cfg", [
    T.RenderConfig(integrator=T.IntegratorConfig(sort_rays=True)),
    T.RenderConfig(shading="redshift")], ids=["sort_rays", "redshift"])
def test_forward_options_render(cfg):
    """sort_rays (ignored by the plain integrator) and redshift shading,
    which raised before the disk render was ported, render."""
    metric, scene, canvas = T.build(T.example2_spec(2, 2), torch.float64,
                                    "cpu")
    rgb = T.trace_rays(metric, scene, canvas, cfg).rgb
    assert rgb.shape == (2, 2, 3) and bool(torch.isfinite(rgb).all())
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0


def test_k2_wrapper_raises_on_cpu_tensors():
    """K2 and the compacted render on CPU tensors raise before any launch
    rather than falling back to the plain chunk."""
    from raytracegr_jl_tpu_torch.compaction import chunk_cuda
    metric, scene, y0, dt0 = _small()
    cfg = T.IntegratorConfig(max_steps=4)
    before = chunk_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        chunk_cuda(metric, scene, cfg, 4, y_cm=y0.t(), dt0=dt0)
    with pytest.raises(ValueError, match="CUDA"):
        T.trace_batch_compacted(metric, scene, y0, dt0, cfg, backend="cuda")
    canvas = T.build(T.example2_spec(2, 2), torch.float64, "cpu")[2]
    with pytest.raises(ValueError, match="CUDA"):
        T.render_compacted(metric, scene, canvas,
                           T.RenderConfig(integrator=cfg, backend="cuda"))
    assert chunk_cuda.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load("geodesic")


def test_kernel_params_layout():
    """The kernel's parameter block: configuration, 8 fields per object,
    8 slots per detection sample whose last is theta = i / npts."""
    metric, scene, _, _ = _small()
    for method, npts in (("tsit5", 9), ("rk4", 5)):
        cfg = T.IntegratorConfig(method=method, interp_points=npts)
        blk = kernel_params(metric, scene, cfg, torch.float32)
        n_obj = scene.n_objects
        assert len(blk) == N_CFG + 8 * n_obj + 8 * npts
        base = N_CFG + 8 * n_obj
        assert [blk[base + 8 * i + 7] for i in range(npts)] == [
            (i + 1) / npts for i in range(npts)]
        # second object (the plane): pos1..3 = 0, radius 1, time -20
        assert blk[N_CFG + 8:N_CFG + 13] == [0.0, 0.0, 0.0, 1.0, -20.0]
        assert blk[CFG_SLOTS.index("LAM_END")] == cfg.lam_max - 1e-6


def test_kernel_params_match_the_cuda_source():
    """The python side of the parameter block names the slots of the
    kernels' enum Prm (csrc/geodesic_common.cuh), in order, and the object
    fields of its comment."""
    import os
    import re

    from raytracegr_jl_tpu_torch.ops import geodesic_cm

    with open(os.path.join(cuda_build.CSRC, "geodesic_common.cuh")) as f:
        src = f.read()
    assert f"MAX_OBJ = {geodesic_cm._MAX_OBJECTS};" in src
    assert f"MAX_SMP = {geodesic_cm._MAX_SAMPLES};" in src
    enum = re.search(r"enum Prm \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",")]
    assert names[-1] == f"N_CFG = {N_CFG}"
    assert tuple(n[2:] for n in names[:-1]) == CFG_SLOTS
    assert ", ".join(OBJ_FIELDS) in src


def test_factories_default_to_the_card():
    """Without a device the factories ask for the CUDA card and raise where
    there is none, rather than building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    spec = T.example2_spec(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.build(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_scene(spec.objects)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0])
    assert T.build(spec, device="cpu")[2].pos.device.type == "cpu"


def test_adjoint_layout_matches_the_cuda_source():
    """The packed state's planes and K4's segment cap name the values of
    csrc/adjoint.cu's enum Plane and MAX_SEG."""
    import os
    import re

    from raytracegr_jl_tpu_torch.ops import adjoint

    with open(os.path.join(cuda_build.CSRC, "adjoint.cu")) as f:
        assert f"MAX_SEG = {adjoint.MAX_SEG};" in f.read()
    # The packed layout is shared by K2, K3 and K4.
    with open(os.path.join(cuda_build.CSRC, "geodesic_common.cuh")) as f:
        src = f.read()
    enum = re.search(r"enum Plane \{(.*?)\};", src, re.S).group(1)
    planes = dict(item.strip().split(" = ") for item in enum.split(","))
    for name, value in planes.items():
        py_name = "P_" + name[3:] if name.startswith("PL_") else name
        assert getattr(adjoint, py_name) == int(value), name


def test_ckpt_cuda_wrapper_raises_on_cpu_tensors():
    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                      forward_segment_cuda)
    metric, scene, y0, dt0 = _small()
    before = (forward_segment_cuda.launches, backward_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        T.integrate_rays_ckpt_cuda(metric, scene, y0, dt0,
                                   T.IntegratorConfig(max_steps=4))
    canvas = T.build(T.example2_spec(2, 2), torch.float64, "cpu")[2]
    integ = T.IntegratorConfig(max_steps=4)
    for cfg in (T.RenderConfig(differentiable=True, backend="cuda",
                               integrator=integ),
                T.RenderConfig(differentiable=True, integrator=integ._replace(
                    grad_mode="ckpt_cuda"))):
        with pytest.raises(ValueError, match="CUDA"):
            T.trace_rays(metric, scene, canvas, cfg)
    assert (forward_segment_cuda.launches, backward_cuda.launches) == before
