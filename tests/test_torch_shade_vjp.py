"""The reference shading's hand-written reverse (models/objects.py): the
plain VJPs of K12 (``shade_vjp``, ``shade_soft_vjp``) against torch
autograd of the plain forward (``shade``, ``shade_soft``) at f64, and the
route between them (``_Shaded``, ``shade_reference``) on the CPU.

* The VJPs against autograd on end points made with numpy from a seed:
  example2's scene (sky sphere, time-plane, sphere), config 5's lensing
  scene, the accretion disk, and a thick disk with points on its tie lines
  (the ring's two bounds equal, the slab equal to the ring, both, and
  z = 0), hard and soft, with the fields shared and with ``pos`` per ray
  for 3 groups (``[B, N, 4]``); every field's per-ray cotangent.
* Miss rays (hard) and zero cotangents give exact zeros.
* Where autograd forms 0 x inf (a point on a sphere's polar axis) the
  VJPs give finite cotangents: the known difference.
* ``shade_reference`` on CPU tensors equals the plain forward bitwise, and
  its gradients reach x and the fields (a per-ray field's per ray, a
  shared one's summed in float64).
* The soft shading written out over the objects against torch's
  ``softmax``, ``logsumexp`` and ``einsum``.

Tolerance: 1e-12, each output's largest gap over its largest magnitude
(the VJPs and autograd round apart only in the order of their sums:
measured below 1e-15 here and on the card's 200x200 batches)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models import objects as O  # noqa: E402
from raytracegr_jl_tpu_torch.ops.adjoint import per_ray  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
RTOL = 1e-12
GROUPS = 3
RAYS = 60  # per group
TEMPS = {"hard": None, "soft": 0.05}
FREQS = {"example2": 12.0, "lensing": 2.0, "disk": 12.0, "thick": 12.0}
THICK = (O.Sphere(pos=(0, 0, 0, 0), vel=(1, 0, 0, 0), radius=-30.0),
         O.Disk(pos=(0, 0, 0, 0), r_in=1.0, r_out=2.0, half=2.0))


def _scene(name):
    if name == "thick":
        return O.make_scene(THICK, F64, "cpu")
    spec = {"example2": T.example2_spec, "lensing": T.lensing_inverse_spec,
            "disk": T.accretion_disk_spec}[name](8, 8)
    return T.build(spec, F64, "cpu")[1]


def _points(name, scene, n, seed):
    """``[n, 4]`` end points: near each object's surface (hits), on the
    sky, and scattered (misses); for the thick disk also its tie lines."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)) * 4.0
    pos = scene.pos.numpy()
    k = n // 4
    for j in range(scene.n_objects):
        rows = slice(j * k // scene.n_objects, (j + 1) * k // scene.n_objects)
        r = abs(float(scene.radius[j]))
        d = rng.normal(size=(rows.stop - rows.start, 3))
        d *= (r * (1 + 1e-3 * rng.normal(size=(len(d), 1)))
              / np.linalg.norm(d, axis=1, keepdims=True))
        x[rows, 1:] = pos[j, 1:] + d
    if name == "example2":
        x[k:k + 8, 0] = -20.0 + 1e-3 * rng.normal(size=8)  # the time-plane
    if name == "thick":
        # rho2 = 2.5: r_in^2 - rho2 = rho2 - r_out^2 = -1.5; |z| - half
        # below, at and with z = 0 the slab's sign.
        ties = [(1.5, 0.5, 0.25), (1.5, 0.5, 0.5), (1.5, 0.5, -0.5),
                (0.5, 1.5, 0.0), (1.5, 0.5, 0.0)]
        x[-len(ties):, 1:] = ties
    return torch.from_numpy(x)


def _case(name, layout, seed=0):
    """(scene, x): the fields shared, or ``pos`` per ray for ``GROUPS``
    groups of ``RAYS`` rays, each group's objects moved a little."""
    scene = _scene(name)
    B = GROUPS * RAYS
    x = _points(name, scene, B, seed)
    if layout == "grouped":
        shift = torch.from_numpy(np.random.default_rng(seed + 1).normal(
            size=(GROUPS, scene.n_objects, 4)) * 1e-3)
        scene = scene._replace(pos=per_ray(scene.pos[None] + shift, RAYS))
    return scene, x


def _cotangent(B, seed=2):
    ct = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, 3)))
    ct[::9] = 0
    return ct


def _plain(scene, x, mode, freq):
    if mode == "hard":
        return O.shade(scene, x)
    return O.shade_soft(scene, x, temp=TEMPS[mode], color_freq=freq)


def _vjp(scene, x, ct, mode, freq):
    if mode == "hard":
        return O.shade_vjp(scene, x, ct)
    return O.shade_soft_vjp(scene, x, ct, temp=TEMPS[mode], color_freq=freq)


def _autograd(scene, x, ct, mode, freq):
    """torch.autograd of the plain forward, x and every field a leaf per
    ray: ``(ct_x, {field: per-ray cotangent})``."""
    B = x.shape[0]
    xl = x.clone().requires_grad_()
    leaves = {}
    for f in O.SHADE_FIELDS:
        v = getattr(scene, f).detach()
        if v.dim() == O.FIELD_DIMS.get(f, 1):
            v = v.expand((B,) + tuple(v.shape))
        leaves[f] = v.contiguous().requires_grad_()
    out = _plain(scene._replace(**leaves), xl, mode, freq)
    grads = torch.autograd.grad((out * ct).sum(), [xl, *leaves.values()],
                                allow_unused=True)
    return grads[0], {f: torch.zeros_like(leaves[f]) if g is None else g
                      for f, g in zip(O.SHADE_FIELDS, grads[1:])}


def _gap(got, want):
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    return diff / scale if scale > 0 else diff


@pytest.mark.parametrize("layout", ["shared", "grouped"])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("name", ["example2", "lensing", "disk", "thick"])
def test_vjp_matches_autograd(name, mode, layout):
    scene, x = _case(name, layout)
    ct = _cotangent(x.shape[0])
    freq = FREQS[name]
    got = _vjp(scene, x, ct, mode, freq)
    want = _autograd(scene, x, ct, mode, freq)
    assert bool(torch.isfinite(want[0]).all())
    assert _gap(got[0], want[0]) <= RTOL
    for f in O.SHADE_FIELDS:
        assert got[1][f].shape == want[1][f].shape, f
        assert _gap(got[1][f], want[1][f]) <= RTOL, f
    # Real signal: x and pos take a cotangent.
    assert float(got[0].abs().max()) > 0
    assert float(got[1]["pos"].abs().max()) > 0


def test_tie_lines_split_as_torch():
    """On the thick disk's tie lines, alone: the soft VJP's ring bounds and
    slab cotangents split in half as autograd's torch.maximum does."""
    scene = _scene("thick")
    x = torch.tensor([[0.0, 1.5, 0.5, 0.25], [0.0, 1.5, 0.5, 0.5],
                      [0.0, 1.5, 0.5, 0.0], [0.0, 0.5, 1.5, -0.5]], dtype=F64)
    ct = torch.tensor([[1.0, -0.5, 0.25]] * 4, dtype=F64)
    got = _vjp(scene, x, ct, "soft", 12.0)
    want = _autograd(scene, x, ct, "soft", 12.0)
    assert _gap(got[0], want[0]) <= RTOL
    for f in ("pos", "r_in", "r_out", "half"):
        assert _gap(got[1][f], want[1][f]) <= RTOL, f
    # Both bounds of the ring take half of its cotangent at rho2 = 2.5.
    assert float(got[1]["r_in"][0, 1]) != 0.0
    assert float(got[1]["r_in"][0, 1]) == pytest.approx(
        -0.5 * float(got[1]["r_out"][0, 1]), rel=1e-12)


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_miss_rays_and_zero_cotangents_give_exact_zeros(mode):
    scene, x = _case("example2", "grouped")
    ct = _cotangent(x.shape[0])
    got = _vjp(scene, x, ct, mode, 12.0)
    dead = (ct == 0).all(-1)
    if mode == "hard":
        dead |= torch.min(O.distances(scene, x), -1).values >= 0.01
    assert 0 < int(dead.sum()) < x.shape[0]
    assert not got[0][dead].any()
    for f in O.SHADE_FIELDS:
        assert not got[1][f][dead].any(), f


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_pole_gets_finite_cotangents(mode):
    """A point on the small sphere's polar axis (z / r = 1): autograd of
    the plain forward forms 0 x inf there, the VJPs give theta and phi no
    cotangent and stay finite."""
    scene = _scene("example2")
    x = torch.tensor([[0.0, 4.0, 0.0, 0.5], [0.0, 4.0, 0.3, 0.4]],
                     dtype=F64)
    ct = torch.tensor([[0.3, -0.7, 0.2], [0.3, -0.7, 0.2]], dtype=F64)
    got = _vjp(scene, x, ct, mode, 12.0)
    want = _autograd(scene, x, ct, mode, 12.0)
    assert not bool(torch.isfinite(want[0][0]).all())
    assert bool(torch.isfinite(got[0]).all())
    assert all(bool(torch.isfinite(v).all()) for v in got[1].values())
    assert _gap(got[0][1:], want[0][1:]) <= RTOL


@pytest.mark.parametrize("layout", ["shared", "grouped"])
@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_route_forward_equals_plain_bitwise(mode, layout):
    scene, x = _case("example2", layout)
    got = O.shade_reference(scene, x, temp=TEMPS[mode])
    assert torch.equal(got, _plain(scene, x, mode, 12.0))


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_route_gradients_reach_x_and_the_fields(mode):
    """Through ``shade_reference``: x's and a per-ray pos's gradients are
    the VJP's; a shared radius's is its per-ray cotangents summed in
    float64; a field that takes no gradient gets none."""
    scene, x = _case("example2", "grouped")
    ct = _cotangent(x.shape[0])
    xl = x.clone().requires_grad_()
    pos = scene.pos.clone().requires_grad_()
    radius = scene.radius.clone().requires_grad_()
    out = O.shade_reference(scene._replace(pos=pos, radius=radius), xl,
                            temp=TEMPS[mode])
    (out * ct).sum().backward()
    want = _vjp(scene, x, ct, mode, 12.0)
    assert torch.equal(xl.grad, want[0])
    assert torch.equal(pos.grad, want[1]["pos"])
    assert torch.equal(radius.grad,
                       want[1]["radius"].sum(0, dtype=torch.float64))
    assert scene.time.grad is None


def test_soft_shading_matches_torchs_reductions():
    """``shade_soft`` written out over the objects against the formula
    with ``torch.softmax``, ``torch.logsumexp`` and ``torch.einsum``."""
    scene, x = _case("example2", "shared")
    temp, hit_dmin = 0.05, 0.01
    d = O.distances(scene, x)
    n = scene.n_objects
    w = torch.softmax(-d / temp, dim=-1)
    dim = (torch.arange(n, dtype=F64) + 1) / n
    col = O.colors(scene, x, smooth=True, freq=12.0) * dim[:, None]
    obj = torch.einsum("...n,...nc->...c", w, col)
    p = torch.sigmoid((hit_dmin + temp * torch.logsumexp(-d / temp, -1))
                      / temp)
    want = p[..., None] * obj + (1 - p[..., None]) * torch.tensor(
        [1.0, 0.0, 0.0], dtype=F64)
    got = O.shade_soft(scene, x, hit_dmin, temp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=4 * float(torch.finfo(F64).eps))
    assert math.isfinite(float(got.sum()))


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_render_shades_through_the_route(soft, monkeypatch):
    """The render's reference shading goes through ``shade_reference`` on
    the component-major backends and equals the plain shading there; the
    row-major backend shades with the plain forward under autograd."""
    from raytracegr_jl_tpu_torch import render
    metric, scene, canvas = T.build(T.example2_spec(8, 8), F64, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    y = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 8)) * 6)
    calls = []
    route = O.shade_reference
    monkeypatch.setattr(render, "shade_reference",
                        lambda *a: calls.append(1) or route(*a))
    cfg = T.RenderConfig(soft_temp=0.05 if soft else None)
    rgb = render._shade(metric, scene, y0, y, cfg)
    assert calls == [1]
    want = (O.shade_soft(scene, y[:, :4], 0.01, 0.05) if soft
            else O.shade(scene, y[:, :4], 0.01))
    assert torch.equal(rgb, want)
    rowmajor = render._shade(metric, scene, y0, y,
                             cfg._replace(backend="rowmajor"))
    assert calls == [1] and torch.equal(rowmajor, want)
