"""K4's launch on the CPU: its work order (the rays by end segment,
largest first, a stable sort; the plain version of the card's counting
sort); the plain version of K4 (``backward_plain``) run in work order,
which gives each ray the values it gets in pixel order, bit for bit
(example2 6x6, f64); and the work order's C entry point against the
wrapper's signature. The kernels themselves run on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geodesic_cm import (make_step_cm,  # noqa: E402
                                                     scene_event_cm)
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ends(kind: str) -> np.ndarray:
    rng = np.random.default_rng(12)
    if kind == "random":
        return rng.integers(0, 21, size=40_000).astype(np.int32)
    if kind == "one end":
        return np.full(1_000, 7, dtype=np.int32)
    if kind == "sorted":
        return np.sort(rng.integers(0, 9, size=4_096)).astype(np.int32)
    if kind == "every end":
        return rng.permutation(np.arange(40_000) % 21).astype(np.int32)
    return rng.integers(0, 9, size=1_027).astype(np.int32)  # "ragged"


@pytest.mark.parametrize("kind", ["random", "one end", "sorted", "every end",
                                  "ragged"])
def test_work_order_is_a_stable_permutation_largest_end_first(kind):
    ends = _ends(kind)
    order = A.work_order(torch.from_numpy(ends))
    assert order.dtype == torch.int64 and order.shape == ends.shape
    got = order.numpy()
    # numpy's stable sort of the negated ends: largest end first, and in
    # index order within one end.
    np.testing.assert_array_equal(got, np.argsort(-ends, kind="stable"))
    assert np.array_equal(np.sort(got), np.arange(ends.size))
    e = ends[got]
    assert (np.diff(e) <= 0).all()
    assert (np.diff(got)[np.diff(e) == 0] > 0).all()
    assert torch.equal(A.work_order(torch.from_numpy(ends)), order)


def test_plain_k4_in_work_order_gives_each_ray_its_values():
    """``backward_plain`` over the rays in work order returns each ray's
    cotangents and (M, a) cotangents of the pixel-order run, bit for bit:
    K4's order moves rays between threads, never their arithmetic."""
    f64 = torch.float64
    integ = T.default_inverse_cfg(f64, max_steps=60, method="rk4",
                                  rk4_dt=0.25, stop_rho=0.5).integrator
    _, scene, canvas = T.build(T.example2_spec(6, 6), f64, "cpu")
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(
        M=torch.tensor(1.05, dtype=f64), a=torch.tensor(0.3, dtype=f64)),
        rho_min=0.25)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    seg = A.segment_length(integ, integ.grad_seg_len)
    route = A.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                    n_seg=integ.max_steps // seg, cuda=False)
    init, _ = make_step_cm(metric, scene_event_cm(scene), integ)
    P0 = A.pack_state(init(y0.t(), initial_dt(metric, y0, integ)))
    k = torch.arange(P0.shape[1])
    P0[A.P_LAM] = integ.lam_max - (1 + (k * 7) % 60).to(f64) * 0.25
    ck, used = A.chain_plain(route, P0)
    ends = used[1:]
    assert int((torch.bincount(ends) > 0).sum()) >= 3  # several walks
    ct = torch.from_numpy(np.random.default_rng(3).standard_normal(
        P0.shape))
    c, p = A.backward_plain(route, ck, ends, ct)
    order = A.work_order(ends)
    c_o, p_o = A.backward_plain(route, ck[:, :, order], ends[order],
                                ct[:, order])
    assert torch.equal(c_o, c[:, order]) and torch.equal(p_o, p[order])


def test_k4_constants_match_the_cuda_source():
    """The work order's C entry point (csrc/adjoint.cu rtgr_k4_order, one
    launch) takes the arguments of its ctypes signature: the end segments
    and the order (pointers), the rays and the bins, the stream."""
    import ctypes
    import os
    import re

    from raytracegr_jl_tpu_torch.utils import cuda_build

    with open(os.path.join(cuda_build.CSRC, "adjoint.cu")) as f:
        src = f.read()
    m = re.search(r'extern "C" int rtgr_k4_order\(([^)]*)\)', src)
    assert m is not None
    kinds = [ctypes.c_int if a.split()[0] == "int" else ctypes.c_void_p
             for a in m.group(1).split(",")]
    assert kinds == cuda_build._SIGNATURES["adjoint"]["rtgr_k4_order"]
    assert "counts" not in m.group(1)


def test_work_order_kernel_refuses_cpu_tensors():
    """The work order's kernel wrapper takes the card's tensors only (the
    CPU's order is ``work_order``), and launches nothing here."""
    before = A.work_order_cuda.launches
    with pytest.raises(ValueError, match="card"):
        A.work_order_cuda(torch.zeros(8, dtype=torch.int32), 3)
    assert A.work_order_cuda.launches == before
