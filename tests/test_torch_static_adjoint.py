"""The checkpointed adjoint's static contract on the CPU (example2 8x8,
f64), which lets a CUDA graph hold a training step on the card: every
ray's final state in the fixed slot ``ck[n_seg]``, the backward pass
walking each ray back from its own end segment (``used[1:]``), the segment
count kept as a tensor, every ray localized, the parameter block's host
part built once per configuration, and the graphed step refusing CPU
tensors. The plain versions (K3's and K4's, which the kernels equal bit for
bit on the card) are held to the early-exit contract they replaced, bit
for bit, and to the JAX package's gradient in
``tests/torch_dual_oracle_ref.npz``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geodesic_cm as G  # noqa: E402
from raytracegr_jl_tpu_torch.render import initial_dt  # noqa: E402
from raytracegr_jl_tpu_torch.step_graph import GraphedStep  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
REF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_dual_oracle_ref.npz")


def _chain(stopped: bool):
    """example2 8x8 f64 rk4/20 (dt 2.5, capture-stop 0.5) in 5 segments of
    4 steps, where the rays end in segments 1, 2 and 3 and the chain runs
    3: the route, the launch states ``[8, B]`` and the initial packed
    state; ``stopped``: every ray at the end of its span and every third
    inactive from the start (a state that K3's prologue does not make:
    ``chain_plain`` starts from it)."""
    cfg = T.default_inverse_cfg(F64, max_steps=20, method="rk4", rk4_dt=2.5,
                                stop_rho=0.5).integrator
    _, scene, canvas = T.build(T.example2_spec(8, 8), F64, "cpu")
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(M=1.05),
                           rho_min=0.25)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    route = A.Route(metric=metric, scene=scene, cfg=cfg, seg_len=4,
                    n_seg=5, cuda=False)
    y0 = y0.t().contiguous()
    P0 = A.init_plain(route, y0)
    if stopped:
        P0[A.P_LAM] = cfg.lam_max
        P0[A.P_ACTIVE, ::3] = 0
    return route, y0, P0


def _early_exit(route, P0, ct):
    """The contract the static one replaced: the chain of segments stopped
    once no ray is active, the final state in ``ck[n_used]``, and the
    backward pass over segments ``n_used - 1 .. 0`` of the whole batch,
    each ray's inactive segments kept the identity by its ACTIVE flag."""
    ck = torch.empty((route.n_seg + 1,) + tuple(P0.shape), dtype=P0.dtype)
    ck[0] = P0
    n = 0
    while n < route.n_seg and bool(ck[n, A.P_ACTIVE].any()):
        ck[n + 1] = A.forward_segment(route, ck[n])
        n += 1
    p = A.adj_params(route.metric, F64, "cpu")
    _, body = G.make_step_cm(route.metric, G.scene_event_cm(route.scene),
                             route.cfg)
    ct_y, ct_k = ct[A.P_Y:A.P_Y + 8], ct[A.P_K1:A.P_K1 + 8]
    ct_ev = ct[A.P_EV_Y0:A.P_EV_Y0 + 8]
    pM = torch.zeros(P0.shape[1], dtype=F64)
    pa = torch.zeros_like(pM)
    for s in range(n - 1, -1, -1):
        st = A.unpack_state(ck[s])
        recs = []
        for _ in range(route.seg_len):
            nxt, rec = body(st)
            recs.append((st.y, st.k1, rec))
            st = nxt
        for y, k1, rec in reversed(recs):
            yb, kb, gM, ga = A.step_vjp(p, False, y, k1, rec.dt_try, ct_y,
                                        ct_k)
            yb = torch.where(rec.hit_now, yb + ct_ev, yb)
            ct_ev = torch.where(rec.hit_now, torch.zeros_like(ct_ev), ct_ev)
            ct_y = torch.where(rec.do, yb, ct_y)
            ct_k = torch.where(rec.do, kb, ct_k)
            pM = torch.where(rec.do, pM + gM, pM)
            pa = torch.where(rec.do, pa + ga, pa)
    ct0 = torch.zeros_like(ct)
    ct0[A.P_Y:A.P_Y + 8] = ct_y
    ct0[A.P_K1:A.P_K1 + 8] = ct_k
    ct0[A.P_EV_Y0:A.P_EV_Y0 + 8] = ct_ev
    return ck[n], n, ct0, torch.stack([pM, pa], dim=1)


def _bits(t):
    return t.view(torch.int64)


@pytest.mark.parametrize("stopped", [False, True], ids=["full", "stopped"])
def test_static_contract_equals_early_exit_bitwise(stopped):
    """The plain forward's ``ck[n_seg]`` and ``used``, and the plain
    backward walking each ray from its end segment, against the early-exit
    chain's final state, segment count and backward pass: bit for bit. A
    checkpoint past a ray's end is never read: filled with NaN there, the
    backward pass gives the same bits."""
    route, y0, P0 = _chain(stopped)
    ct = torch.from_numpy(np.random.default_rng(4).normal(
        size=tuple(P0.shape)))
    ck, used = (A.chain_plain(route, P0) if stopped
                else A.run_segments(route, y0))
    assert torch.equal(_bits(ck[0]), _bits(P0))
    fin, n_used, ct0_ref, pbar_ref = _early_exit(route, P0, ct)
    assert used.dtype == torch.int32 and used.shape == (1 + P0.shape[1],)
    assert int(used[0]) == n_used
    if stopped:
        assert n_used == 1
    else:
        assert 1 < n_used < route.n_seg
        assert int(used[1:].min()) < int(used[1:].max())
    assert torch.equal(used[1:], A.end_segments(ck, n_used, route.n_seg))
    assert torch.equal(_bits(ck[route.n_seg]), _bits(fin))
    ct0, pbar = A.backward_plain(route, ck, used[1:], ct)
    assert torch.equal(_bits(ct0), _bits(ct0_ref))
    assert torch.equal(_bits(pbar), _bits(pbar_ref))
    unread = ck.clone()
    unread[~A.read_mask(used[1:], route.n_seg)] = float("nan")
    ct0_u, pbar_u = A.backward_plain(route, unread, used[1:], ct)
    assert torch.equal(_bits(ct0_u), _bits(ct0))
    assert torch.equal(_bits(pbar_u), _bits(pbar))


def test_loss_gradient_matches_jax():
    """The training path's M gradient through the plain K3 and K4 at the
    JAX package's oracle configuration (example2 8x8 f64 rk4/20, dt 0.25,
    M0 = 1.05, the target rendered at M = 1), against JAX's jax.grad in
    tests/torch_dual_oracle_ref.npz, at the JAX tests' rtol 1e-9."""
    ref = np.load(REF)
    spec = T.example2_spec(8, 8)
    cfg = T.default_inverse_cfg(F64, max_steps=20, method="rk4",
                                rk4_dt=0.25)
    _, scene0, _ = T.build(spec, F64, "cpu")
    xg, ng = T.flat_pixel_grid(spec, F64, "cpu")
    p = T.InverseParams(1.05, 0.0, scene0.pos[2], F64, "cpu")
    loss = T.make_ray_loss_fn(spec, cfg, 2, F64, "cpu")(
        p, xg, ng, torch.from_numpy(ref["target_M"]))
    loss.backward()
    np.testing.assert_allclose(float(p.M.grad), float(ref["grad_M"]),
                               rtol=1e-9)


def test_localization_without_a_hit():
    """A batch with no hit (4 steps of 0.25 from the camera, short of every
    object): every ray is still localized, and the selection leaves the
    loop's values as they are, bit for bit (the plain K1 loop's), and the
    gradients finite and equal to autograd of the loop without any
    localization (the dead-ray cutoff applied alike)."""
    cfg = T.default_inverse_cfg(F64, max_steps=4, method="rk4",
                                rk4_dt=0.25).integrator
    _, scene, canvas = T.build(T.example2_spec(8, 8), F64, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = torch.full((64,), 0.25, dtype=F64)

    def run(fn):
        M = torch.tensor(1.05, dtype=F64, requires_grad=True)
        a = torch.tensor(0.2, dtype=F64, requires_grad=True)
        y = y0.clone().requires_grad_(True)
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(M, a),
                               rho_min=1e-3)
        yf, lam, hit = fn(metric, y)
        loss = (yf[:, :4] ** 2).sum() * 1e-3 + lam.sum() * 1e-2
        return yf.detach(), lam.detach(), hit, torch.autograd.grad(
            loss, (M, a, y))

    def ckpt(metric, y):
        res = T.integrate_rays_ckpt(metric, scene, y, dt0, cfg, seg_len=2)
        return res.y, res.lam, res.hit

    def loop(metric, y):
        init, body = G.make_step_cm(metric, G.scene_event_cm(scene), cfg)
        st = init(y.t(), dt0)
        for _ in range(cfg.max_steps):
            st, _ = body(st)
        dead = ~st.hit & ~st.active & (st.lam < cfg.lam_max - 1e-6)
        return (torch.where(dead, st.y.detach(), st.y).t(), st.lam,
                st.hit)

    y_c, lam_c, hit, g_c = run(ckpt)
    y_l, lam_l, _, g_l = run(loop)
    assert not bool(hit.any())
    plain = G.integrate_rays_cm(T.make_metric(
        "kerr_schild", T.KerrSchildParams(1.05, 0.2), rho_min=1e-3), scene,
        y0, dt0, cfg)
    assert torch.equal(_bits(y_c), _bits(plain.y))
    assert torch.equal(_bits(lam_c), _bits(plain.lam))
    assert torch.equal(y_c, y_l) and torch.equal(lam_c, lam_l)
    for c, ref in zip(g_c, g_l):
        assert bool(torch.isfinite(c).all())
        np.testing.assert_allclose(c.numpy(), ref.numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("mode", ["ckpt", "scan"])
def test_n_iters_is_a_tensor(mode):
    """``TraceResult.n_iters`` is a 0-d int32 tensor on the batch's device
    (JAX's device array), equal to the former int: the segments the chain
    runs times their length."""
    route, y0, _ = _chain(False)
    _, used = A.run_segments(route, y0)
    cfg = route.cfg
    _, scene, canvas = T.build(T.example2_spec(8, 8), F64, "cpu")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    fn = (T.integrate_rays_ckpt if mode == "ckpt"
          else A.integrate_rays_autograd)
    res = fn(route.metric, scene, y0, initial_dt(route.metric, y0, cfg),
             cfg, seg_len=route.seg_len)
    assert torch.is_tensor(res.n_iters) and res.n_iters.dim() == 0
    assert res.n_iters.dtype == torch.int32
    assert res.n_iters.device == y0.device
    want = int(used[0]) * route.seg_len
    assert res.n_iters == want and int(res.n_iters) == want


def _parent_block(metric, scene, cfg, dtype):
    """The parameter block as it was built before the host part was kept:
    the host part packed anew, then the object rows and the tensor M and a
    written in."""
    kinds = G.check_kernel_config(metric, scene, cfg)
    params = metric.params
    tensors = {i: v for i, v in enumerate((params.M, params.a))
               if isinstance(v, torch.Tensor)}
    if tensors:
        metric = metric._replace(params=params._replace(
            **{("M", "a")[i]: 0.0 for i in tensors}))
    vals = [0.0] * G.PARAM_VALUES
    vals[:G.N_CFG] = G._config_slots(metric, cfg, dtype)
    smp = G.N_CFG + 8 * G._MAX_OBJECTS
    samples = G._sample_slots(cfg)
    vals[smp:smp + len(samples)] = samples
    refine = int(cfg.min_refine_iters) if cfg.refine_minima else 0
    ints = torch.tensor(list(kinds) + [0] * (G._MAX_OBJECTS - len(kinds))
                        + [refine, 0], dtype=torch.int32)
    out = torch.cat([torch.tensor(vals, dtype=dtype).view(torch.uint8),
                     ints.view(torch.uint8)])
    out_vals = out[:G.PARAM_VALUES * dtype.itemsize].view(dtype)
    out_vals[G.N_CFG:G.N_CFG + 8 * len(kinds)] = G._object_rows(
        scene, dtype).reshape(-1)
    for i, v in tensors.items():
        out_vals[i] = v.detach()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["floats", "tensors"])
def test_kept_parameter_block_has_the_parent_bytes(dtype, as_tensors):
    """``pack_params`` with its host part kept: the bytes the block had
    when it was packed anew, on the first pass and the next, after M, a
    and the sphere's row change in place (a graph replay's case), and on a
    new configuration (a new host part)."""
    cfg = T.default_inverse_cfg(dtype, max_steps=20, stop_rho=0.5)
    _, scene, _ = T.build(T.example2_spec(4, 4), dtype, "cpu")
    if as_tensors:
        params = T.KerrSchildParams(torch.tensor(1.05, dtype=dtype),
                                    torch.tensor(0.2, dtype=dtype))
    else:
        params = T.KerrSchildParams(1.05, 0.2)
    metric = T.make_metric("kerr_schild", params, rho_min=0.25)
    integ = cfg.integrator
    for _ in range(2):
        assert torch.equal(G.pack_params(metric, scene, integ, dtype, "cpu"),
                           _parent_block(metric, scene, integ, dtype))
    with torch.no_grad():
        scene.pos[2, 3] += 0.5
        if as_tensors:
            params.M.fill_(0.97)
            params.a.fill_(-0.1)
    new = G.pack_params(metric, scene, integ, dtype, "cpu")
    assert torch.equal(new, _parent_block(metric, scene, integ, dtype))
    other = integ._replace(method="tsit5", interp_points=9)
    assert torch.equal(G.pack_params(metric, scene, other, dtype, "cpu"),
                       _parent_block(metric, scene, other, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_parameter_block_cache_is_bounded_over_float_masses(dtype):
    """A sweep of 1,000 float values of M and a (one block each, as 1,000
    renders of one scene would pack them) keeps at most one new host part:
    the kept parts are keyed by everything but M and a, which every pass
    writes into its block; each block carries its own M and a, rounded to
    the working type, and otherwise the bytes it had when packed anew."""
    cfg = T.default_inverse_cfg(dtype, max_steps=20, stop_rho=0.5)
    _, scene, _ = T.build(T.example2_spec(4, 4), dtype, "cpu")
    integ = cfg.integrator
    kept = len(G._HOST_BLOCKS)
    for i in range(1000):
        params = T.KerrSchildParams(0.5 + 1e-3 * i, 0.25 - 5e-4 * i)
        metric = T.make_metric("kerr_schild", params, rho_min=0.25)
        block = G.pack_params(metric, scene, integ, dtype, "cpu")
        vals = block[:G.PARAM_VALUES * dtype.itemsize].view(dtype)
        assert float(vals[0]) == float(torch.tensor(params.M, dtype=dtype))
        assert float(vals[1]) == float(torch.tensor(params.a, dtype=dtype))
        if i % 250 == 0:
            assert torch.equal(block, _parent_block(metric, scene, integ,
                                                    dtype))
    assert len(G._HOST_BLOCKS) <= kept + 1


def test_graphed_step_refuses_cpu_tensors():
    """A CUDA graph is a device program: the graphed step raises on
    parameters on the CPU and names their device, before running
    anything; the fits step eagerly there."""
    p = T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], F64, "cpu")
    calls = []
    with pytest.raises(ValueError, match="cpu"):
        GraphedStep(lambda q: calls.append(q), p)
    assert not calls
    cfg = T.default_inverse_cfg(F64)
    assert not T.inverse.graphed(cfg, p)
