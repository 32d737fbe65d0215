"""What the kernels' launches rest on, on the CPU: the scene's object kinds
kept on the host, a launch setup that reads nothing back from the tensors
it is built from, the initial step with its norms summed in a fixed order
(K1 repeats it in its prologue) against the JAX package's, and the rule
by which K3's single launch finds how many segments the per-segment chain
runs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu.models.scenes import build as j_build  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example1_spec as j_example1  # noqa: E402
from raytracegr_jl_tpu.models.scenes import example2_spec as j_example2  # noqa: E402
from raytracegr_jl_tpu.ops import integrate as jint  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
from raytracegr_jl_tpu_torch.models.objects import object_kinds  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geodesic_cm as G  # noqa: E402
from raytracegr_jl_tpu_torch.ops.integrate import mean8  # noqa: E402
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402
from raytracegr_jl_tpu_torch.utils import convert  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {"example1": T.example1_spec(4, 4), "example2": T.example2_spec(4, 4),
         "disk": T.accretion_disk_spec(4, 4)}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_host_kinds_equal_the_kind_tensor(name):
    _, scene, _ = T.build(SPECS[name], torch.float32, "cpu")
    assert scene.kind.host_kinds == tuple(scene.kind.tolist())
    assert object_kinds(scene) == tuple(scene.kind.tolist())
    assert G.check_kernel_config(T.make_metric("minkowski"), scene,
                                 T.IntegratorConfig()) == scene.kind.host_kinds


class _NoRead(torch.Tensor):
    """A tensor whose values may be computed with but not read back to the
    host: the calls a launch setup would need to read a tensor on the card
    raise."""

    READS = {torch.Tensor.tolist, torch.Tensor.item, torch.Tensor.numpy,
             torch.Tensor.cpu, torch.Tensor.__bool__, torch.Tensor.__float__,
             torch.Tensor.__int__, torch.Tensor.__index__}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in cls.READS:
            raise AssertionError(f"read back: {func.__name__}")
        return super().__torch_function__(func, types, args, kwargs or {})


def _no_read(scene):
    fields = {f: getattr(scene, f).as_subclass(_NoRead)
              for f in scene._fields}
    fields["kind"].host_kinds = scene.kind.host_kinds
    return scene._replace(**fields)


@pytest.mark.parametrize("library,method", [("geodesic", "tsit5"),
                                            ("adjoint", "rk4"),
                                            ("compaction", "tsit5")])
def test_launch_setup_reads_nothing_back(library, method):
    """check_kernel_config and launch_config on a scene whose tensors
    refuse to be read, with M and a as tensors (the training path's) and
    as floats: the same bytes and flags as from the plain scene."""
    metric, scene, canvas = T.build(T.example2_spec(4, 4), torch.float32,
                                    "cpu")
    cfg = T.IntegratorConfig(method=method, interp_points=4)
    like = canvas.pos.reshape(-1, 4)
    guarded = _no_read(scene)
    with pytest.raises(AssertionError, match="read back"):
        guarded.pos.tolist()
    as_t = lambda v: torch.tensor(  # noqa: E731
        v, dtype=torch.float64).as_subclass(_NoRead)
    for (M, a), tensors in (((1.0, 0.0), False), ((1.05, 0.25), True)):
        params = T.KerrSchildParams(M=as_t(M), a=as_t(a)) if tensors else \
            T.KerrSchildParams(M=M, a=a)
        m = metric._replace(params=params)
        kinds = G.check_kernel_config(m, guarded, cfg)
        prm, flags = G.launch_config(m, guarded, cfg, like, library)
        want_prm, want_flags = G.launch_config(
            m._replace(params=T.KerrSchildParams(M=M, a=a)), scene, cfg,
            like, library)
        assert kinds == tuple(scene.kind.tolist())
        assert flags == want_flags
        assert torch.equal(prm.as_subclass(torch.Tensor), want_prm)


def _jax_rays(which, dtype):
    build = {"example1": j_example1, "example2": j_example2}[which]
    metric, _, canvas = j_build(build(8, 8), dtype)
    y0 = jnp.concatenate([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    return metric, y0


@pytest.mark.parametrize("which", ["example1", "example2"])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-15),
                                        (np.float32, 2.5e-7)])
def test_initial_step_with_ordered_means_matches_jax(which, dtype, rtol):
    """The port's initial step sums its three means left to right
    (``mean8``); the JAX package takes ``jnp.mean``. At f64 they agree to
    a relative 1e-15 on the rays of example1 and example2; at f32 to two
    ulps (the means and the RHS round apart)."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    tol = float(np.finfo(dtype).eps) ** 0.75
    metric, y0 = _jax_rays(which, jdt)
    mcm = metric.component_major

    def rhs_cm(y):
        return jpg.geodesic_cm(mcm, y.T[:, None, :])[:, 0, :].T

    want = np.asarray(jint.hairer_init_dt(rhs_cm, y0, tol, tol, 5, 100.0))
    t_metric = T.make_metric("minkowski" if which == "example1"
                             else "kerr_schild")
    got = initial_dt(t_metric, torch.from_numpy(np.array(y0)),
                     T.IntegratorConfig(rtol=tol, atol=tol)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_mean8_sums_left_to_right():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.uniform(0, 1, (64, 8)).astype(np.float32))
    s = q[:, 0].clone()
    for c in range(1, 8):
        s += q[:, c]
    assert torch.equal(mean8(q), s / 8)


def _chain(method, max_steps):
    """example2 8x8 f64 on the plain training configuration: the route and
    the initial packed state."""
    cfg = T.default_inverse_cfg(torch.float64, max_steps=max_steps,
                                method=method, rk4_dt=100.0 / max_steps,
                                stop_rho=0.5).integrator
    metric, scene, canvas = T.build(T.example2_spec(8, 8), torch.float64,
                                    "cpu")
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(M=1.05),
                           rho_min=0.25)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    seg = A.segment_length(cfg, cfg.grad_seg_len)
    route = A.Route(metric=metric, scene=scene, cfg=cfg, seg_len=seg,
                    n_seg=max_steps // seg, cuda=False)
    return route, y0.t().contiguous()


@pytest.mark.parametrize("method,max_steps", [("rk4", 20), ("tsit5", 48)])
def test_used_segments_rule_matches_the_chain(method, max_steps):
    """K3 runs every ray through its own segments and takes n_used as the
    largest end segment. Each ray's end segment is that of the chain on the
    ray alone, since a ray's segments depend on its own state only; their
    largest equals the count of the chain on the whole batch, and the end
    segments read from the batch's checkpoints equal the rays' own."""
    route, y0 = _chain(method, max_steps)
    ck, used = A.run_segments(route, y0)
    n_used = int(used[0])
    ends = A.end_segments(ck, n_used, route.n_seg)
    assert torch.equal(ends, used[1:])
    alone = torch.tensor([int(A.run_segments(route, y0[:, i:i + 1])[1][0])
                          for i in range(y0.shape[1])], dtype=torch.int32)
    assert torch.equal(ends, alone)
    assert A.used_segments(alone, route.n_seg) == n_used
    assert 0 < int(alone.min()) and n_used <= route.n_seg
    assert A.used_segments(alone[:0], route.n_seg) == 0


def test_scene_from_numpy_keeps_host_kinds():
    _, scene, _ = T.build(T.accretion_disk_spec(2, 2), torch.float64, "cpu")
    back = convert.scene_from_numpy(
        {f: getattr(scene, f).numpy() for f in scene._fields})
    assert back.kind.host_kinds == scene.kind.host_kinds
    assert back.kind.dtype == torch.int32
