"""The port's detection gate (``IntegratorConfig.event_gate``) against the
JAX package's, and what every kernel launch shares: the packed parameter
block that fills the kernels' constant memory, the scene codes of the
compile-time scenes, and the block size of every launch.

The gate skips the per-step detection sweep where the step's dense output
provably stays clear of every object: the envelopes of the dense-output
basis bound the box the step's positions stay in, and the scene's interval
bound over that box is a lower bound of the event. Both over-approximate,
so the gate must be bitwise-invisible; grazing rays are the adversarial
case (the event dips barely below zero inside a step)."""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import raytracegr_jl_tpu as J  # noqa: E402
from raytracegr_jl_tpu.ops import pallas_geodesic as jpg  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geodesic_cm as G  # noqa: E402
from raytracegr_jl_tpu_torch.ops.integrate import (BMAX_TSIT5,  # noqa: E402
                                                   HERMITE_ENV)
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402
from raytracegr_jl_tpu_torch.utils import cuda_build  # noqa: E402

from test_event_detection import _grazing_rays  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The object sets of the JAX package's scene-bound test, one kind at a time
# and all together.
OBJECTS = {
    "caelum": [("Sphere", dict(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0),
                               radius=-10.0))],
    "plane": [("Plane", dict(time=-20.0))],
    "sphere": [("Sphere", dict(pos=(0, 1.5, 0, 0), vel=(1, 0, 0, 0),
                               radius=0.5))],
    "disk": [("Disk", dict(pos=(0, 0, 0, 0), r_in=2.0, r_out=5.0,
                           half=0.1))],
}
OBJECTS["all"] = [o for k in ("caelum", "plane", "sphere", "disk")
                  for o in OBJECTS[k]]


def test_envelopes_equal_jax():
    assert BMAX_TSIT5 == jpg._BMAX_TSIT5
    assert HERMITE_ENV == jpg._HERMITE_ENV


@pytest.mark.parametrize("which", sorted(OBJECTS))
def test_scene_bound_matches_jax(which):
    """The port's scene bound equals JAX's ``crossing_bound`` on random
    boxes at f64, and is at most the event at random points of each box."""
    objs = OBJECTS[which]
    j_scene = J.make_scene([getattr(J, k)(**kw) for k, kw in objs],
                           dtype=jnp.float64)
    t_scene = T.make_scene([getattr(T, k)(**kw) for k, kw in objs],
                           torch.float64, "cpu")
    j_bound = jpg.scene_event_cm(j_scene).crossing_bound
    event = G.scene_event_cm(t_scene)
    rng = np.random.default_rng(11)
    center = rng.uniform(-12, 12, size=(4, 256))
    width = rng.uniform(0, 3, size=(4, 256))
    lo, hi = center - width, center + width
    want = np.asarray(j_bound([jnp.asarray(r) for r in lo],
                              [jnp.asarray(r) for r in hi]))
    got = event.bound([torch.from_numpy(r) for r in lo],
                      [torch.from_numpy(r) for r in hi]).numpy()
    np.testing.assert_array_equal(got, want)
    for _ in range(8):
        pt = torch.from_numpy(lo + 2 * width * rng.uniform(0, 1, (4, 256)))
        assert (got <= event(pt).numpy()).all()


def _trace(metric, scene, y0, integ, gate):
    dt0 = initial_dt(metric, y0, integ)
    res = G.integrate_rays_cm(metric, scene, y0, dt0,
                              integ._replace(event_gate=gate))
    return res


def _same(a, b):
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gate_bitwise_on_grazing_rays(dtype):
    """The JAX package's grazing case (tests/test_event_detection.py): rays
    aimed just inside the small sphere's silhouette in flat space, on the
    plain port, gate on against gate off."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    y0 = torch.from_numpy(np.array(_grazing_rays(48, jdt)))
    metric = T.make_metric("minkowski")
    scene = T.make_scene(T.example1_spec().objects, dtype, "cpu")
    tol = T.default_tol(dtype)
    integ = T.IntegratorConfig(rtol=tol, atol=tol, max_steps=4000)
    on, off = (_trace(metric, scene, y0, integ, g) for g in (True, False))
    _same(on, off)
    assert bool(on.hit.all())


def test_gate_bitwise_kerr_rk4():
    """RK4's Hermite envelope on Kerr-Schild's curved steps: the example2
    render's rays at 16x16, as the JAX package's gate test."""
    metric, scene, canvas = T.build(T.example2_spec(16, 16), torch.float64,
                                    "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    integ = T.IntegratorConfig(method="rk4", rk4_dt=0.25, max_steps=64)
    _same(*(_trace(metric, scene, y0, integ, g) for g in (True, False)))


def test_gate_bitwise_on_the_disk():
    """The 16x16 accretion disk (its thin slab and ring), compacted as the
    main path runs it, gate on against gate off."""
    from raytracegr_jl_tpu_torch import compaction as C
    metric, scene, canvas = T.build(T.accretion_disk_spec(16, 16),
                                    torch.float32, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    tol = float(torch.finfo(torch.float32).eps) ** 0.75
    integ = T.IntegratorConfig(rtol=tol, atol=tol, max_steps=400,
                               stop_rho=1.0)
    dt0 = initial_dt(metric, y0, integ)
    on, off = (C.trace_batch_compacted(metric, scene, y0, dt0,
                                       integ._replace(event_gate=g),
                                       first_chunk=16)
               for g in (True, False))
    _same(on, off)
    assert bool(on.hit.any())


def test_may_cross_clears_far_steps_only():
    """A step far from every object is cleared; one that ends inside the
    small sphere is not."""
    scene = T.make_scene(T.example1_spec().objects, torch.float64, "cpu")
    bound = G.scene_event_cm(scene).bound
    y0 = torch.tensor([[0.0], [0.0], [-3.0], [0.0], [1.0], [0.0], [1.0],
                       [0.0]], dtype=torch.float64)
    k = torch.cat([y0[4:], torch.zeros_like(y0[4:])])
    ks = (k,) * 7
    for dt, expect in ((0.05, False), (3.0, True)):
        dt_t = torch.tensor([dt], dtype=torch.float64)
        y1 = y0 + dt_t * k
        assert bool(G.may_cross(bound, y0, y1, k, k, dt_t, ks)) == expect
        assert bool(G.may_cross(bound, y0, y1, k, k, dt_t, None)) == expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pack_params_layout(dtype):
    """csrc Params<T>: N_CFG configuration slots, 16 object rows of 8, 32
    sample rows of 8, then 16 int32 kinds, refine_minima's trisection
    steps (0 when it is off) and a zero pad; M and a given as tensors are
    written on the tensor's device."""
    metric, scene, _ = T.build(T.example2_spec(2, 2), dtype, "cpu")
    cfg = T.IntegratorConfig(interp_points=5, event_gate=True)
    blk = G.kernel_params(metric, scene, cfg, dtype)
    out = G.pack_params(metric, scene, cfg, dtype, "cpu")
    assert out.dtype == torch.uint8
    assert out.numel() == G.PARAMS_BYTES[dtype] == (
        (G.N_CFG + 8 * 16 + 8 * 32) * dtype.itemsize + (16 + 2) * 4)
    vals = out[:G.PARAM_VALUES * dtype.itemsize].view(dtype)
    ints = out[G.PARAM_VALUES * dtype.itemsize:].view(torch.int32)
    kinds = ints[:16]
    assert ints[16:].tolist() == [0, 0]
    refine = G.pack_params(metric, scene, cfg._replace(refine_minima=True),
                           dtype, "cpu")
    assert refine[G.PARAM_VALUES * dtype.itemsize:].view(
        torch.int32)[16:].tolist() == [cfg.min_refine_iters, 0]
    want = torch.tensor(blk, dtype=dtype)
    n_obj, npts = scene.n_objects, cfg.interp_points
    assert torch.equal(vals[:G.N_CFG], want[:G.N_CFG])
    obj = G.N_CFG + 8 * n_obj
    assert torch.equal(vals[G.N_CFG:obj], want[G.N_CFG:obj])
    assert not vals[obj:G.N_CFG + 8 * 16].any()
    smp = G.N_CFG + 8 * 16
    assert torch.equal(vals[smp:smp + 8 * npts], want[obj:])
    assert not vals[smp + 8 * npts:].any()
    assert kinds.tolist() == scene.kind.tolist() + [0] * (16 - n_obj)
    assert vals[G.CFG_SLOTS.index("GATE")] == 1.0
    assert vals[G.CFG_SLOTS.index("BMAX0")] == torch.tensor(BMAX_TSIT5[0],
                                                             dtype=dtype)
    M, a = torch.tensor(1.25, dtype=dtype), torch.tensor(0.5, dtype=dtype)
    tm = metric._replace(params=T.KerrSchildParams(M, a))
    vals = G.pack_params(tm, scene, cfg, dtype, "cpu")[
        :G.PARAM_VALUES * dtype.itemsize].view(dtype)
    assert vals[0] == 1.25 and vals[1] == 0.5


def test_pack_params_limits():
    metric, scene, _ = T.build(T.example2_spec(2, 2), torch.float32, "cpu")
    for npts in (0, 33):
        with pytest.raises(ValueError, match="interp_points"):
            G.pack_params(metric, scene, T.IntegratorConfig(
                interp_points=npts), torch.float32, "cpu")
    many = T.make_scene([T.Plane(time=-20.0 - i) for i in range(17)],
                        torch.float32, "cpu")
    with pytest.raises(ValueError, match="objects"):
        G.pack_params(metric, many, T.IntegratorConfig(), torch.float32,
                      "cpu")


def test_scene_codes():
    """Each library's fixed scenes: f32 Kerr-Schild launches of their kinds
    and sample counts only; everything else SC_ANY."""
    f32, f64 = torch.float32, torch.float64
    ex2, disk = (0, 1, 0), (0, 2)
    assert G.scene_code(ex2, 9, f32, True, "geodesic") == G.SC_SPS9
    assert G.scene_code(disk, 9, f32, True, "geodesic") == G.SC_SD9
    assert G.scene_code(disk, 9, f32, True, "compaction") == G.SC_SD9
    assert G.scene_code(ex2, 4, f32, True, "adjoint") == G.SC_SPS4
    for args in ((ex2, 9, f64, True, "geodesic"),
                 (ex2, 9, f32, False, "geodesic"),
                 (ex2, 8, f32, True, "geodesic"),
                 (ex2, 9, f32, True, "compaction"),
                 (ex2, 9, f32, True, "adjoint"),
                 ((0, 1), 9, f32, True, "geodesic")):
        assert G.scene_code(*args) == G.SC_ANY, args
    # refine_minima takes SC_REFINE in every library, type and scene.
    for args in ((ex2, 9, f32, True, "geodesic"), (disk, 9, f64, True,
                                                    "compaction"),
                 (ex2, 4, f32, False, "adjoint")):
        assert G.scene_code(*args, refine=True) == G.SC_REFINE, args


def test_scene_codes_match_the_cuda_source():
    """The scene codes and each library's FIXED_SCENES name csrc's."""
    with open(os.path.join(cuda_build.CSRC, "geodesic_common.cuh")) as f:
        src = f.read()
    enum = re.search(r"enum \{ (SC_ANY = 0[^}]*)\}", src).group(1)
    codes = dict(item.strip().split(" = ") for item in enum.split(","))
    assert {k: int(v) for k, v in codes.items()} == {
        "SC_ANY": G.SC_ANY, "SC_SPS9": G.SC_SPS9, "SC_SD9": G.SC_SD9,
        "SC_SPS4": G.SC_SPS4, "SC_S4": G.SC_S4, "SC_REFINE": G.SC_REFINE}
    for lib, fixed in G.FIXED_SCENES.items():
        with open(os.path.join(cuda_build.CSRC, f"{lib}.cu")) as f:
            mask = re.search(r"constexpr int FIXED_SCENES = ([^;]*);",
                             f.read()).group(1)
        names = re.findall(r"1 << (SC_\w+)", mask)
        assert sorted(int(codes[n]) for n in names) == sorted(fixed), lib
    assert f"MAX_THREADS = {G.MAX_THREADS};" in src
