"""The port's Dual oracle (raytracegr_jl_tpu_torch/ops/dual_oracle.py): an
end-to-end render with d/dM or d/d(sphere z) in hand-rolled forward mode.

Configuration (the JAX package's tests/test_dual_oracle.py): example2,
f64, ``default_inverse_cfg(max_steps=20, method="rk4", rk4_dt=0.25)``,
M0 = 1.05, a = 0, sphere 2; 20 steps keep every ray short of the plunge
region, where two equivalent implementations diverge by roundoff.

* Against the JAX package's oracle at 8x8 (tests/torch_dual_oracle_ref.npz,
  written by tests/make_torch_dual_ref.py, so that no JAX oracle runs
  here): rgb and d/dM within 1e-12, d/dz within 1e-11, and the oracle's
  loss gradients ``mean(2 (rgb - target) drgb)`` within rtol 1e-9 of
  jax.grad's (the JAX tests' bars).
* Against the port's own differentiable paths on the CPU, at the bars of
  the card's check (chip_smoke.py): the plain checkpointed route
  (``grad_mode="ckpt"``, K3 and K4's plain versions) at 8x8 and 16x16 and
  the row-major route (``backend="rowmajor"``) at 8x8. The primal within
  1e-12 on every pixel; the loss gradients for M (target at M = 1) and z
  (target 0.9 times the render) and two seeded random projections
  ``sum(w * rgb)`` within relative 1e-9 of the oracle's.
* The oracle names no derivative code of the port (a source check).
"""

import ast
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import dual, dual_oracle  # noqa: E402
from raytracegr_jl_tpu_torch.ops.dual_oracle import (  # noqa: E402
    render_dual_dM, render_dual_sensitivity)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_dual_oracle_ref.npz")
F64 = torch.float64
N_STEPS = 20
RK4_DT = 0.25
M0 = 1.05
SPHERE = 2
PRIMAL_ATOL = 1e-12
GRAD_RTOL = 1e-9
SEED = 9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the oracle's tensors are tiny, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle(n: int, device):
    """The oracle's rgb, d rgb/dM and d rgb/dz at example2 n x n."""
    spec = T.example2_spec(n, n)
    cfg = T.default_inverse_cfg(F64, max_steps=N_STEPS, method="rk4",
                                rk4_dt=RK4_DT)
    _, scene0, _ = T.build(spec, F64, device)
    xg, ng = T.flat_pixel_grid(spec, F64, device)
    kw = dict(r_formula=spec.r_formula, rho_min=1e-3, rk4_dt=RK4_DT,
              n_steps=N_STEPS, interp_points=cfg.integrator.interp_points,
              bisect_iters=cfg.integrator.bisect_iters)
    rgb, dM = render_dual_dM(scene0, xg, ng, M0, 0.0, **kw)
    _, dz = render_dual_sensitivity(scene0, xg, ng, M0, 0.0,
                                    wrt=("pos", SPHERE, 3), **kw)
    return rgb, dM, dz


def route(n: int, device, **cfg_fields):
    """The differentiable route's primal, targets and gradients at example2
    n x n: the loss gradients for M (target at M = 1) and z (target 0.9
    times the render at M0), and both of the projection ``sum(w * rgb)``
    for seeded weights w."""
    spec = T.example2_spec(n, n)
    cfg = T.default_inverse_cfg(F64, max_steps=N_STEPS, method="rk4",
                                rk4_dt=RK4_DT)
    if "backend" in cfg_fields:
        cfg = cfg._replace(backend=cfg_fields.pop("backend"))
    cfg = cfg._replace(integrator=cfg.integrator._replace(**cfg_fields))
    _, scene0, _ = T.build(spec, F64, device)
    xg, ng = T.flat_pixel_grid(spec, F64, device)
    render = T.make_ray_render_for_params(spec, cfg, SPHERE, F64, device)
    loss = T.make_ray_loss_fn(spec, cfg, SPHERE, F64, device)

    def params(M):
        return T.InverseParams(M, 0.0, scene0.pos[SPHERE], F64, device)

    with torch.no_grad():
        target_M = render(params(1.0), xg, ng)
    p = params(M0)
    rgb = render(p, xg, ng)
    w = torch.from_numpy(np.random.default_rng(SEED).uniform(
        -1.0, 1.0, tuple(rgb.shape))).to(device)
    (rgb * w).sum().backward()
    rgb = rgb.detach()
    out = {"rgb": rgb, "target_M": target_M, "target_z": 0.9 * rgb, "w": w,
           "proj_M": float(p.M.grad), "proj_z": float(p.sphere_pos.grad[3])}
    for name in ("M", "z"):
        p = params(M0)
        loss(p, xg, ng, out[f"target_{name}"]).backward()
        out[f"loss_{name}"] = float(p.M.grad if name == "M"
                                    else p.sphere_pos.grad[3])
    return out


def gaps(orc, r) -> dict:
    """The route against the oracle: the primal's largest gap, and the
    relative gaps of the loss gradients and projections."""
    rgb, dM, dz = orc
    want = {"loss_M": float(torch.mean(2.0 * (rgb - r["target_M"]) * dM)),
            "loss_z": float(torch.mean(2.0 * (rgb - r["target_z"]) * dz)),
            "proj_M": float((r["w"] * dM).sum()),
            "proj_z": float((r["w"] * dz).sum())}
    out = {"primal": float((r["rgb"] - rgb).abs().max())}
    for k, v in want.items():
        assert v != 0.0, k
        out[k] = abs(r[k] - v) / abs(v)
    return out


def assert_not_vacuous(orc):
    """At least 3 sphere hits and real signal in both tangents, as in the
    JAX package's oracle tests."""
    rgb, dM, dz = orc
    assert int(((rgb[:, 2] - 1.0).abs() < 0.01).sum()) >= 3
    assert float(dM.abs().max()) > 0.1
    assert float(dz.abs().max()) > 1.0


_oracles = {}


def cpu_oracle(n):
    if n not in _oracles:
        _oracles[n] = oracle(n, "cpu")
    return _oracles[n]


@pytest.fixture(scope="module")
def ref():
    return dict(np.load(REF))


def test_oracle_matches_jax_oracle(ref):
    rgb, dM, dz = cpu_oracle(8)
    assert_not_vacuous((rgb, dM, dz))
    np.testing.assert_allclose(rgb.numpy(), ref["rgb"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(dM.numpy(), ref["drgb_dM"], rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(dz.numpy(), ref["drgb_dz"], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("name", ["M", "z"])
def test_oracle_loss_gradient_matches_jax_grad(ref, name):
    rgb, dM, dz = cpu_oracle(8)
    d = dM if name == "M" else dz
    target = torch.from_numpy(ref[f"target_{name}"])
    g = float(torch.mean(2.0 * (rgb - target) * d))
    assert float(ref[f"grad_{name}"]) != 0.0
    np.testing.assert_allclose(g, float(ref[f"grad_{name}"]), rtol=GRAD_RTOL)


@pytest.mark.parametrize("n,fields", [
    (8, {"grad_mode": "ckpt"}),
    (16, {"grad_mode": "ckpt"}),
    (8, {"backend": "rowmajor"}),
], ids=["ckpt-8x8", "ckpt-16x16", "rowmajor-8x8"])
def test_oracle_matches_the_route(n, fields):
    orc = cpu_oracle(n)
    assert_not_vacuous(orc)
    g = gaps(orc, route(n, "cpu", **dict(fields)))
    assert g["primal"] <= PRIMAL_ATOL, g
    for k in ("loss_M", "loss_z", "proj_M", "proj_z"):
        assert g[k] <= GRAD_RTOL, (k, g)


def test_oracle_reads_the_scene_once():
    """The scene's fields reach the host once per render: the oracle's loops
    then issue no device-to-host copy on the card."""
    reads = []

    class Counted(torch.Tensor):
        def tolist(self):
            reads.append(1)
            return super().tolist()

    spec = T.example2_spec(2, 2)
    _, scene, _ = T.build(spec, F64, "cpu")
    scene = scene._replace(**{k: getattr(scene, k).as_subclass(Counted)
                              for k in ("kind", "pos", "radius", "time")})
    xg, ng = T.flat_pixel_grid(spec, F64, "cpu")
    render_dual_dM(scene, xg, ng, M0, 0.0, n_steps=2)
    assert len(reads) == 4


def test_oracle_is_independent_of_the_port_derivatives():
    """Neither module's code (docstrings aside) names torch's automatic
    differentiation or a module of the port that computes derivatives
    (ops.geometry's dmetric, ops.geodesic_cm's Kerr-Schild parts,
    ops.adjoint); the oracle imports only the Dual layer and the metric
    names of ops.metrics."""
    banned = {"autograd", "func", "vjp", "jvp", "grad", "backward",
              "requires_grad", "geometry", "geodesic_cm", "adjoint"}
    for mod in (dual, dual_oracle):
        tree = ast.parse(inspect.getsource(mod))
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                names.add(node.id)
            elif isinstance(node, ast.Attribute):
                names.add(node.attr)
            elif isinstance(node, ast.Import):
                assert all(a.name in ("math", "numpy", "torch")
                           for a in node.names), ast.dump(node)
            elif isinstance(node, ast.ImportFrom):
                names.update(a.name for a in node.names)
                if node.level == 0:
                    assert node.module in ("__future__", "typing", "torch")
                else:
                    assert (node.level, node.module) in (
                        (1, "dual"), (1, "metrics"), (1, None))
                    if node.module is None:
                        assert [a.name for a in node.names] == ["dual"]
        assert not names & banned, (mod.__name__, names & banned)
