"""What the shading's and the camera's VJPs read from their forwards, on
the CPU: K11's record for K12 (models/objects.py ``shade_record``), and
the camera's cotangent as the training path hands it to K9.

* ``shade_vjp`` given the record equals its recomputing route bit for bit,
  at f32 and f64, on tests/test_torch_shade_vjp.py's scenes with the
  fields shared and ``pos`` per ray, miss rays and zero cotangents, and the
  pole case; the record is each ray's nearest object, -1 for a miss.
* ``shade_reference`` keeps a record only where a gradient will be taken
  (hard shading), and its backward reads it and evaluates no distance; its
  gradients equal the recomputing VJP's.
* ``pixel_rays_vjp`` of a view of [8, B] planes (the layout K9 reads
  through its strides) equals that of the contiguous cotangent, bitwise.

No JAX program runs here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models import camera as C  # noqa: E402
from raytracegr_jl_tpu_torch.models import objects as O  # noqa: E402
from test_torch_camera import _batch, _metric  # noqa: E402
from test_torch_shade_vjp import _case, _cotangent, _scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64, F32 = torch.float64, torch.float32
DTYPES = {"f64": F64, "f32": F32}


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_camera_vjp_reads_a_planes_view_of_its_cotangent(dtype):
    """K9 reads its cotangent through its strides: the training path hands
    the camera's backward a view of its [8, B] planes' gradient. Its plain
    version gives that view the contiguous cotangent's result bit for bit
    (the layout the card's check holds K9 to)."""
    dt = DTYPES[dtype]
    x, n, Mv, av, _ = (v.to(dt) if isinstance(v, torch.Tensor) else v
                       for v in _batch("textbook", 0.6, 4))
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(
        x.shape)).to(dt)
    ct[::9] = 0.0
    planes = torch.cat([x, ct], -1).t().contiguous().t()[:, 4:]
    assert planes.stride() == (1, x.shape[0])
    metric = _metric("textbook", Mv, av)
    assert _bitwise(C.pixel_rays_vjp(metric, x, n, planes),
                    C.pixel_rays_vjp(metric, x, n, ct))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("layout", ["shared", "grouped"])
@pytest.mark.parametrize("name", ["example2", "lensing", "disk", "thick"])
def test_shade_vjp_given_the_record_is_bitwise(name, layout, dtype):
    dt = DTYPES[dtype]
    scene, x = _case(name, layout)
    scene = scene._replace(**{f: getattr(scene, f).to(dt)
                              for f in O.SHADE_FIELDS})
    x = x.to(dt)
    ct = _cotangent(x.shape[0]).to(dt)
    rec = O.shade_record(scene, x)
    d = O.distances(scene, x)
    hit = d.min(-1).values < 0.01
    assert rec.dtype == torch.int8 and rec.shape == (x.shape[0],)
    assert torch.equal(rec.long(), torch.where(hit, d.argmin(-1), -1))
    assert 0 < int(hit.sum()) < x.shape[0]
    want = O.shade_vjp(scene, x, ct)
    got = O.shade_vjp(scene, x, ct, rec=rec)
    assert _bitwise(got[0], want[0])
    for f in O.SHADE_FIELDS:
        assert _bitwise(got[1][f], want[1][f]), f
    # Miss rays and zero cotangents: exact zeros either way.
    dead = ~hit | (ct == 0).all(-1)
    assert not got[0][dead].any()
    assert not got[1]["pos"][dead].any()


def test_shade_record_at_the_pole():
    """The pole case of tests/test_torch_shade_vjp.py: the record route
    gives the recomputing route's finite cotangents."""
    scene = _scene("example2")
    x = torch.tensor([[0.0, 4.0, 0.0, 0.5], [0.0, 4.0, 0.3, 0.4]],
                     dtype=F64)
    ct = torch.tensor([[0.3, -0.7, 0.2], [0.3, -0.7, 0.2]], dtype=F64)
    rec = O.shade_record(scene, x)
    assert rec.tolist() == [2, 2]
    want = O.shade_vjp(scene, x, ct)
    got = O.shade_vjp(scene, x, ct, rec=rec)
    assert bool(torch.isfinite(got[0]).all())
    assert _bitwise(got[0], want[0])
    for f in O.SHADE_FIELDS:
        assert _bitwise(got[1][f], want[1][f]), f


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_shade_route_keeps_its_record_for_the_backward(soft, monkeypatch):
    """``shade_reference`` keeps the hard shading's record where a gradient
    will be taken, and its backward evaluates no distance; a forward
    render keeps none, and the soft shading none (its VJP recomputes)."""
    scene, x = _case("example2", "grouped")
    ct = _cotangent(x.shape[0])
    temp = 0.05 if soft else None
    made = []
    record = O.shade_record
    monkeypatch.setattr(O, "shade_record",
                        lambda *a: made.append(1) or record(*a))
    with torch.no_grad():
        O.shade_reference(scene, x.clone().requires_grad_(), temp=temp)
    assert made == []
    O.shade_reference(scene, x, temp=temp)
    assert made == []
    xl = x.clone().requires_grad_()
    pos = scene.pos.clone().requires_grad_()
    out = O.shade_reference(scene._replace(pos=pos), xl, temp=temp)
    assert made == ([] if soft else [1])
    calls = []
    distances = O.distances
    monkeypatch.setattr(O, "distances",
                        lambda *a: calls.append(1) or distances(*a))
    (out * ct).sum().backward()
    if not soft:
        assert calls == []
    monkeypatch.setattr(O, "distances", distances)
    want = (O.shade_soft_vjp(scene, x, ct, temp=temp) if soft
            else O.shade_vjp(scene, x, ct))
    assert torch.equal(xl.grad, want[0])
    assert torch.equal(pos.grad, want[1]["pos"])
