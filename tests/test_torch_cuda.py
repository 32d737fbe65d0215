"""The kernels on the card against their plain PyTorch versions on the
same CUDA tensors. Both round operation by operation alike (the kernels are
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


def _ckpt_case(n, dtype, method, max_steps, refine=False, rk4_dt=None):
    from raytracegr_jl_tpu_torch.ops import adjoint as A
    cfg = T.default_inverse_cfg(dtype, max_steps=max_steps, method=method,
                                rk4_dt=rk4_dt or 100.0 / max_steps,
                                stop_rho=0.5)
    integ = cfg.integrator._replace(refine_minima=refine)
    _, scene, canvas = T.build(T.example2_spec(n, n), dtype,
                               torch.device("cuda"))
    metric = T.make_metric("kerr_schild", T.KerrSchildParams(M=1.05),
                           rho_min=0.25)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    seg = A.segment_length(integ, integ.grad_seg_len)
    route = A.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                    n_seg=max_steps // seg, cuda=True)
    return A, route, y0.t().contiguous(), (scene, y0, dt0, integ)


def _state_ct(A, y0, gen=None):
    """A random cotangent of the packed state ``[34, B]`` of the rays at
    ``y0 [8, B]``."""
    return torch.randn((A.N_PLANES, y0.shape[1]), generator=gen,
                       dtype=y0.dtype, device=y0.device)


CKPT_CASES = [(32, torch.float32, "rk4", 40), (32, torch.float32, "tsit5", 16),
              (16, torch.float64, "rk4", 40), (16, torch.float64, "tsit5", 16)]


def _read_equal(A, route, ck, used, ck_p, used_p):
    """K3's checkpoints against the per-segment chain's: the same n_used and
    end segments (``used``), and bitwise on every value that K4 and the
    forward's result read (the whole state of a ray up to its end segment,
    and every ray's final state at n_seg: ``read_mask``)."""
    mask = A.read_mask(used_p[1:], route.n_seg)
    bits = torch.int32 if ck.dtype == torch.float32 else torch.int64
    return torch.equal(used, used_p) and torch.equal(ck[mask].view(bits),
                                                     ck_p[mask].view(bits))


@pytest.mark.parametrize("n,dtype,method,max_steps", CKPT_CASES)
def test_k3_k4_match_plain_bitwise(n, dtype, method, max_steps):
    A, route, y0, _ = _ckpt_case(n, dtype, method, max_steps)
    before = (A.forward_segment_cuda.launches, A.backward_cuda.launches)
    ck, used = A.run_segments(route, y0)
    ck_p, used_p = A.run_segments(route._replace(cuda=False), y0)
    torch.cuda.synchronize()
    assert A.forward_segment_cuda.launches == before[0] + 1
    assert _read_equal(A, route, ck, used, ck_p, used_p)
    assert torch.equal(ck[0], A.init_plain(route, y0))
    ct = _state_ct(A, y0)
    c, p = A.backward_cuda(route, ck, used[1:], ct)
    c_p, p_p = A.k4_plain(route, ck_p, used_p[1:], ct)
    torch.cuda.synchronize()
    assert A.backward_cuda.launches == before[1] + 1
    assert torch.equal(c, c_p) and torch.equal(p, p_p)


@pytest.mark.parametrize("n,dtype,method,max_steps", CKPT_CASES)
def test_k4_gradients_match_autograd(n, dtype, method, max_steps):
    A, _, _, (scene, y0, dt0, integ) = _ckpt_case(n, dtype, method,
                                                  max_steps)
    out = []
    for fn in (A.integrate_rays_ckpt_cuda, A.integrate_rays_autograd):
        M = torch.tensor(1.05, dtype=dtype, device=y0.device,
                         requires_grad=True)
        a = torch.tensor(0.2, dtype=dtype, device=y0.device,
                         requires_grad=True)
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(M, a),
                               rho_min=0.25)
        res = fn(metric, scene, y0, dt0, integ, seg_len=integ.grad_seg_len)
        loss = (res.y[:, :4] ** 2).sum() * 1e-3
        out.append(torch.stack(torch.autograd.grad(loss, (M, a))))
    rtol = 1e-10 if dtype == torch.float64 else 2e-3
    torch.testing.assert_close(out[0], out[1], rtol=rtol, atol=0.0)


def test_train_step_launches_k3_and_k4():
    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                      forward_segment_cuda)
    dev = torch.device("cuda")
    spec = T.example2_spec(24, 24)
    cfg = T.default_inverse_cfg(torch.float32, max_steps=48, method="tsit5",
                                stop_rho=0.5)
    xg, ng = T.flat_pixel_grid(spec, torch.float32, dev)
    truth = T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], device=dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, device=dev)(
            truth, xg, ng)
    grads = []
    # grad_mode "auto" takes the kernels on CUDA tensors; backend "torch"
    # or grad_mode "ckpt" the plain versions.
    for backend, mode in ((None, "auto"), ("torch", "auto"), (None, "ckpt")):
        c = cfg._replace(backend=backend, integrator=cfg.integrator._replace(
            grad_mode=mode))
        p = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], device=dev)
        before = (forward_segment_cuda.launches, backward_cuda.launches)
        T.make_ray_loss_fn(spec, c, device=dev)(p, xg, ng, target).backward()
        launched = (forward_segment_cuda.launches - before[0],
                    backward_cuda.launches - before[1])
        assert launched == ((1, 1) if not grads else (0, 0))
        grads.append(torch.cat([p.M.grad[None], p.a.grad[None],
                                p.sphere_pos.grad]))
    assert bool(torch.isfinite(grads[0]).all())
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])


def test_train_step_runs_no_eager_initial_state():
    """On the card the training step's initial state is K3's prologue and
    its VJP K10, launched with each K4: neither ``init_plain``,
    ``make_step_cm``'s init nor ``initial_dt`` runs, ungrouped or grouped
    (a vectorized multistart of two starts)."""
    from raytracegr_jl_tpu_torch import render
    from raytracegr_jl_tpu_torch.ops import adjoint as A
    dev = torch.device("cuda")
    spec = T.example2_spec(16, 16)
    cfg = T.default_inverse_cfg(torch.float32, max_steps=48, method="tsit5",
                                stop_rho=0.5)
    xg, ng = T.flat_pixel_grid(spec, torch.float32, dev)
    truth = T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], device=dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, device=dev)(
            truth, xg, ng)
    calls = []
    saved = [(m, n, getattr(m, n)) for m, n in (
        (A, "init_plain"), (A, "make_step_cm"), (A, "initial_dt"),
        (render, "initial_dt"))]
    for m, n, fn in saved:
        setattr(m, n, lambda *a, _n=n, _f=fn, **k: calls.append(_n)
                or _f(*a, **k))
    before = (A.forward_segment_cuda.launches, A.backward_cuda.launches,
              A.init_vjp_cuda.launches)
    try:
        p = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], device=dev)
        T.make_ray_loss_fn(spec, cfg, device=dev)(p, xg, ng,
                                                 target).backward()
        tgt = T.make_render_for_params(spec, cfg, 2, torch.float32, dev)(
            truth).detach()
        T.fit_multistart(spec, tgt, [p.copy(), p.copy()], cfg, steps=1,
                         sphere_index=2, dtype=torch.float32, device=dev,
                         graph=False)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    assert not calls
    assert A.forward_segment_cuda.launches > before[0]
    assert A.backward_cuda.launches - before[1] == (
        A.init_vjp_cuda.launches - before[2]) > 0


@pytest.mark.parametrize("method", ["rk4", "tsit5"])
def test_init_vjp_matches_autograd_on_the_card(method):
    """``init_plain`` bitwise to ``make_step_cm``'s init and ``init_vjp``
    within 1e-12 of torch autograd of it on the card at f64, ungrouped and
    grouped (tests/test_torch_init_vjp.py's cases); K4 and K10
    (``backward_cuda``) are held to ``k4_plain``, which ends with
    ``init_vjp``, bitwise elsewhere."""
    from test_torch_init_vjp import RTOL, init_case, init_gaps
    for name, a, grouped in (("kerr_schild", 0.8, False),
                             ("kerr_schild", None, True),
                             ("minkowski", 0.0, False)):
        route, y0, M, at = init_case(name, a, grouped, method,
                                     device="cuda")
        gaps = init_gaps(route, y0, M, at)
        assert gaps["equal"], (name, grouped)
        for k in ("y0", "M", "a"):
            assert gaps[k] <= RTOL, (name, grouped, k, gaps)


K2_CASES = [(T.accretion_disk_spec(32, 32), torch.float32, TOL32),
            (T.accretion_disk_spec(16, 16), torch.float64, 1e-8)]


@pytest.mark.parametrize("spec,dtype,tol", K2_CASES)
def test_k2_matches_plain_bitwise(spec, dtype, tol):
    """K2 against chunk_plain on the same inputs: the first chunk (state
    built in the kernel), one resumed chunk, and a whole compacted trace
    with first_chunk 16; every plane of the state and y_fin, lam_fin."""
    from raytracegr_jl_tpu_torch import compaction as C
    integ = T.IntegratorConfig(rtol=tol, atol=tol, max_steps=400,
                               stop_rho=1.0)
    metric, scene, canvas = T.build(spec, dtype, torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    y_cm = y0.t().contiguous()
    before = C.chunk_cuda.launches
    k = C.chunk_cuda(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0)
    p = C.chunk_plain(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    k2 = C.chunk_cuda(metric, scene, integ, 32, P=k[0])
    p2 = C.chunk_plain(metric, scene, integ, 32, P=p[0])
    torch.cuda.synchronize()
    assert C.chunk_cuda.launches == before + 2
    for a, b in zip(k2, p2):
        assert torch.equal(a, b)
    rk = T.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                 first_chunk=16)
    rp = T.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                 first_chunk=16, backend="torch")
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), f


def test_compacted_matches_k1_sorted_and_unsorted():
    """The compacted chain (K2) against one K1 launch over the sorted batch
    and over the batch as given: bitwise on every ray, and the images of
    make_compact_renderer and render_fn are equal."""
    from raytracegr_jl_tpu_torch import compaction as C
    metric, scene, canvas = T.build(T.accretion_disk_spec(64, 64),
                                    torch.float32, torch.device("cuda"))
    integ = T.IntegratorConfig(rtol=TOL32, atol=TOL32, max_steps=2000,
                               stop_rho=1.0, sort_rays=True)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    chunks = []
    comp = T.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                   first_chunk=32, chunks=chunks)
    srt = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    uns = integrate_rays_cuda(metric, scene, y0, dt0,
                              integ._replace(sort_rays=False))
    assert any(b["rays"] < a["rays"] for a, b in zip(chunks, chunks[1:]))
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(comp, f), getattr(srt, f)), f
        assert torch.equal(getattr(srt, f), getattr(uns, f)), f
    cfg = T.RenderConfig(integrator=integ, shading="redshift")
    before = C.chunk_cuda.launches
    img = C.make_compact_renderer(metric, scene, cfg)(canvas).rgb
    assert C.chunk_cuda.launches > before
    assert torch.equal(img, T.render_fn(metric, scene, cfg)(canvas.pos,
                                                             canvas.normal))


def test_k2_gate_on_matches_gate_off():
    """The compacted trace through K2 with the detection gate on and off,
    and the plain trace with the gate on: bitwise on every ray."""
    from raytracegr_jl_tpu_torch import compaction as C
    integ = T.IntegratorConfig(rtol=TOL32, atol=TOL32, max_steps=2000,
                               stop_rho=1.0, sort_rays=True)
    metric, scene, canvas = T.build(T.accretion_disk_spec(48, 48),
                                    torch.float32, torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    on, off = (C.trace_batch_compacted(metric, scene, y0, dt0,
                                       integ._replace(event_gate=g),
                                       first_chunk=32)
               for g in (True, False))
    plain = C.trace_batch_compacted(metric, scene, y0, dt0,
                                    integ._replace(event_gate=True,
                                                   max_steps=400),
                                    first_chunk=32, backend="torch")
    cut = C.trace_batch_compacted(metric, scene, y0, dt0,
                                  integ._replace(event_gate=True,
                                                 max_steps=400),
                                  first_chunk=32)
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
        assert torch.equal(getattr(cut, f), getattr(plain, f)), f


@pytest.mark.parametrize("n,dtype", [(64, torch.float32),
                                     (32, torch.float64)])
def test_k4_tsit5_matches_plain_bitwise(n, dtype):
    """K4's Tsit5 adjoint (its stages unrolled at compile time) at the
    training path's configuration (tsit5/48), against its plain version
    (``k4_plain``: the walk and the initial state's VJP) on the same
    checkpoints."""
    A, route, y0, _ = _ckpt_case(n, dtype, "tsit5", 48)
    ck, used = A.run_segments(route, y0)
    gen = torch.Generator(device=y0.device).manual_seed(1)
    ct = _state_ct(A, y0, gen)
    c, p = A.backward_cuda(route, ck, used[1:], ct)
    c_p, p_p = A.k4_plain(route, ck, used[1:], ct)
    torch.cuda.synchronize()
    assert torch.equal(c, c_p) and torch.equal(p, p_p)


@pytest.mark.parametrize("dtype,method,max_steps", [
    (torch.float32, "rk4", 40), (torch.float32, "tsit5", 48),
    (torch.float64, "rk4", 40), (torch.float64, "tsit5", 48)])
def test_gate_on_matches_gate_off_k1_k3_k4(dtype, method, max_steps):
    """The detection gate in K1, K3 and K4 on example2 at 32x32 (sphere,
    plane, sphere: every object bound of the gate), with RK4's Hermite
    envelope and Tsit5's; f32 through the compile-time scenes, f64 through
    SC_ANY. Gate on against gate off through the kernels, and against the
    plain version with the gate on: bitwise."""
    dev = torch.device("cuda")
    tol = TOL32 if dtype == torch.float32 else 1e-9
    integ = T.IntegratorConfig(method=method, rtol=tol, atol=tol, rk4_dt=0.5,
                               max_steps=400 if method == "rk4" else 4000)
    metric, scene, canvas = T.build(T.example2_spec(32, 32), dtype, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    gated = integ._replace(event_gate=True)
    on = integrate_rays_cuda(metric, scene, y0, dt0, gated)
    off = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    plain = integrate_rays_cm(metric, scene, y0, dt0, gated)
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
        assert torch.equal(getattr(on, f), getattr(plain, f)), f

    A, route, y0, _ = _ckpt_case(32, dtype, method, max_steps)
    g_route = route._replace(cfg=route.cfg._replace(event_gate=True))
    ck_on, used_on = A.run_segments(g_route, y0)
    ck_off, used_off = A.run_segments(route, y0)
    ck_p, used_p = A.run_segments(g_route._replace(cuda=False), y0)
    assert torch.equal(used_on, used_off)
    assert _read_equal(A, route, ck_on, used_on, ck_p, used_p)
    assert _read_equal(A, route, ck_off, used_off, ck_p, used_p)
    gen = torch.Generator(device=dev).manual_seed(2)
    ct = _state_ct(A, y0, gen)
    c_on, p_on = A.backward_cuda(g_route, ck_on, used_on[1:], ct)
    c_off, p_off = A.backward_cuda(route, ck_off, used_off[1:], ct)
    c_p, p_p = A.k4_plain(g_route, ck_p, used_p[1:], ct)
    torch.cuda.synchronize()
    assert torch.equal(c_on, c_off) and torch.equal(p_on, p_off)
    assert torch.equal(c_on, c_p) and torch.equal(p_on, p_p)


def test_launches_on_two_streams_keep_their_parameters():
    """A library's launches share one constant copy of the parameters. A
    long K1 launch on one stream, then short ones with another mass on a
    second stream, queued without a sync: each result equals the same
    launch run alone (the library serializes its launches across
    streams, so no copy overwrites the constants of a running kernel)."""
    dev = torch.device("cuda")
    integ = T.IntegratorConfig(rtol=TOL32, atol=TOL32, max_steps=20_000)
    metric, scene, canvas = T.build(T.example2_spec(128, 128), torch.float32,
                                    dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    heavy = metric._replace(params=metric.params._replace(M=1.3))
    ys, dts = y0[:512].contiguous(), dt0[:512].contiguous()
    want_long = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    want_short = integrate_rays_cuda(heavy, scene, ys, dts, integ)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(s1):
        got_long = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    with torch.cuda.stream(s2):
        got_short = [integrate_rays_cuda(heavy, scene, ys, dts, integ)
                     for _ in range(3)]
    torch.cuda.synchronize()
    assert not torch.equal(want_short.y, want_long.y[:512])
    for got, want in [(got_long, want_long)] + [(g, want_short)
                                                 for g in got_short]:
        for f in ("y", "lam", "hit", "steps"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_k3_and_k4_on_two_streams_keep_their_parameters():
    """K3 and K4 take one constant copy of the parameters in their library
    (per type), whichever kernel launches. A K3 pass on one stream, then K4
    launches with another mass on a second stream, queued without a sync,
    and the same with K4 first: each result equals the same launch run
    alone (the library serializes the launches of all its kernels across
    streams, not each kernel's alone)."""
    A, route, y0, _ = _ckpt_case(128, torch.float32, "rk4", 200)
    heavy = route._replace(metric=route.metric._replace(
        params=route.metric.params._replace(M=1.3)))
    ck_ref, used_ref = A.run_segments(route, y0)
    gen = torch.Generator(device=y0.device).manual_seed(4)
    ct = _state_ct(A, y0, gen)
    want = A.backward_cuda(heavy, ck_ref, used_ref[1:], ct)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(s1):
        ck, used = A.run_segments(route, y0)
    with torch.cuda.stream(s2):
        got = [A.backward_cuda(heavy, ck_ref, used_ref[1:], ct)
               for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(used, used_ref)
    assert _read_equal(A, route, ck, used, ck_ref, used_ref)
    for c, p in got:
        assert torch.equal(c, want[0]) and torch.equal(p, want[1])
    with torch.cuda.stream(s1):
        c, p = A.backward_cuda(heavy, ck_ref, used_ref[1:], ct)
    with torch.cuda.stream(s2):
        runs = [A.run_segments(route, y0) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(c, want[0]) and torch.equal(p, want[1])
    for ck, used in runs:
        assert _read_equal(A, route, ck, used, ck_ref, used_ref)


def _example2_rays(n_rays, dtype):
    """The first ``n_rays`` of example2's 200x200 batch."""
    metric, scene, canvas = T.build(T.example2_spec(200, 200), dtype,
                                    torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    return metric, scene, y0[:n_rays].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rays", [1, 31, 33, 4103, 40_000])
def test_k1_own_initial_step_matches_plain_bitwise(n_rays, dtype):
    """K1 with dt0=None takes each ray's initial step in its prologue: the
    same as the plain initial_dt followed by the plain integrator, bit for
    bit on every ray, steps included (Tsit5, example2); and two launches
    give the same result."""
    tol = TOL32 if dtype == torch.float32 else 1e-9
    integ = T.IntegratorConfig(rtol=tol, atol=tol, max_steps=20_000)
    metric, scene, y0 = _example2_rays(n_rays, dtype)
    before = integrate_rays_cuda.launches
    k = integrate_rays_cuda(metric, scene, y0, None, integ)
    again = integrate_rays_cuda(metric, scene, y0, None, integ)
    torch.cuda.synchronize()
    assert integrate_rays_cuda.launches == before + 2
    p = integrate_rays_cm(metric, scene, y0, initial_dt(metric, y0, integ),
                          integ)
    for f in ("hit", "steps", "y", "lam"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
        assert torch.equal(getattr(k, f), getattr(again, f)), f


def test_k1_own_initial_step_rk4_and_sorted():
    """dt0=None with RK4 (the constant rk4_dt) and with sort_rays."""
    metric, scene, canvas = T.build(T.accretion_disk_spec(48, 48),
                                    torch.float32, torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    for integ in (T.IntegratorConfig(method="rk4", rk4_dt=0.5,
                                     max_steps=400, stop_rho=1.0),
                  T.IntegratorConfig(rtol=TOL32, atol=TOL32, max_steps=400,
                                     stop_rho=1.0, sort_rays=True)):
        k = integrate_rays_cuda(metric, scene, y0, None, integ)
        g = integrate_rays_cuda(metric, scene, y0,
                                initial_dt(metric, y0, integ), integ)
        torch.cuda.synchronize()
        for f in ("hit", "steps", "y", "lam"):
            assert torch.equal(getattr(k, f), getattr(g, f)), f


def test_render_launches_once_without_host_syncs():
    """render_fn on the card: one K1 launch per call, no eager initial step,
    and no host sync once its launch setup is built."""
    import warnings

    from raytracegr_jl_tpu_torch import render
    metric, scene, canvas = T.build(T.example2_spec(32, 32), torch.float32,
                                    torch.device("cuda"))
    fn = T.render_fn(metric, scene, T.RenderConfig(
        integrator=T.IntegratorConfig(rtol=TOL32, atol=TOL32)))
    fn(canvas.pos, canvas.normal)
    torch.cuda.synchronize()
    calls = []
    orig = render.initial_dt
    render.initial_dt = lambda *a, **k: calls.append(1) or orig(*a, **k)
    before = integrate_rays_cuda.launches
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(canvas.pos, canvas.normal)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        render.initial_dt = orig
    assert integrate_rays_cuda.launches == before + 1
    assert not calls
    assert not [w for w in caught
                if "synchronizing cuda operation" in str(w.message).lower()]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,max_steps", [("rk4", 200), ("tsit5", 48)])
def test_k3_one_launch_matches_the_chain(method, max_steps, dtype):
    """K3's single launch against the plain per-segment chain at the
    training configurations: its initial state (built in its prologue,
    with each ray's own first step or the one given), n_used, the end
    segments and every value a reader takes, bitwise; a batch where every
    ray stops in segment 0 (a span of one step); no host sync in a pass;
    two launches equal."""
    import warnings
    n = 48 if dtype == torch.float32 else 24
    A, route, y0, (_, _, dt0, _) = _ckpt_case(n, dtype, method, max_steps)
    short = route._replace(cfg=route.cfg._replace(lam_max=1e-3))
    for rt, dt, stopped in ((route, None, False), (route, dt0, False),
                            (short, None, True)):
        ck = torch.empty((rt.n_seg + 1, A.N_PLANES, y0.shape[1]),
                         dtype=dtype, device=y0.device)
        before = A.forward_segment_cuda.launches
        used = A.forward_segment_cuda(rt, ck, y0, dt)
        assert A.forward_segment_cuda.launches == before + 1
        n_used = int(used[0])
        ck_p, used_p = A.run_segments(rt._replace(cuda=False), y0, dt)
        n_p = int(used_p[0])
        assert _read_equal(A, rt, ck, used, ck_p, used_p)
        assert torch.equal(ck[0], A.init_plain(rt, y0))
        assert torch.equal(used[1:], A.end_segments(ck_p, n_p, rt.n_seg))
        assert n_used == A.used_segments(used[1:], rt.n_seg)
        if stopped:
            assert n_used == 1
        ck2, used2 = A.run_segments(rt, y0, dt)
        assert _read_equal(A, rt, ck2, used2, ck_p, used_p)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            A.run_segments(route, y0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "synchronizing cuda operation" in str(w.message).lower()]
    assert len(syncs) == 0


def _lensing_grouped(dtype, method, starts, n=16, refine=False):
    """The lensing scene at n x n for each (M, z) start, RK4/120 or
    Tsit5/400 (at f64's tolerance 120 Tsit5 steps do not reach the
    sphere): per start (route, launch states [8, B]) on the card, and
    the grouped route over all starts' rays with their launch states."""
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    from raytracegr_jl_tpu_torch.ops import adjoint as A
    dev = torch.device("cuda")
    integ = T.default_inverse_cfg(
        dtype, max_steps=120 if method == "rk4" else 400, method=method,
        rk4_dt=0.5, stop_rho=0.5).integrator
    integ = integ._replace(lam_max=60.0, refine_minima=refine)
    spec = T.lensing_inverse_spec(n, n)
    _, scene, _ = T.build(spec, dtype, dev)
    xg, ng = T.flat_pixel_grid(spec, dtype, dev)
    seg = A.segment_length(integ, integ.grad_seg_len)
    singles, rows = [], []
    for M, z in starts:
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(
            torch.tensor(M, dtype=dtype, device=dev),
            torch.tensor(0.0, dtype=dtype, device=dev)),
            r_formula="textbook", rho_min=0.25)
        sc = scene._replace(pos=scene.pos.clone())
        sc.pos[0, 3] = z
        x, u = pixel_rays(metric, xg, ng)
        y0 = torch.cat([x, u], -1)
        singles.append((A.Route(metric=metric, scene=sc, cfg=integ,
                                seg_len=seg, n_seg=integ.max_steps // seg,
                                cuda=True), y0.t().contiguous()))
        rows.append(A.flatten_params(metric, sc))
    grouped = singles[0][0]._replace(groups=torch.stack(rows).contiguous())
    return A, singles, grouped, torch.cat([y for _, y in singles], dim=1)


@pytest.mark.parametrize("dtype,method", [
    (torch.float32, "rk4"), (torch.float32, "tsit5"),
    (torch.float64, "rk4"), (torch.float64, "tsit5")])
def test_grouped_k3_k4_match_grouped_plain_bitwise(dtype, method):
    """The grouped K3 (with k3_close) and K4 over four starts of different
    (M, z) against their grouped plain versions, and each start's rays
    against its own ungrouped launch: bitwise."""
    _check_grouped_k3_k4(dtype, method, refine=False)


def _check_grouped_k3_k4(dtype, method, refine):
    starts = [(0.5, 0.0), (0.53, 0.03), (0.47, -0.05), (0.51, 0.1)]
    A, singles, grouped, y0 = _lensing_grouped(dtype, method, starts,
                                               refine=refine)
    before = (A.forward_segment_cuda.launches, A.backward_cuda.launches)
    ck, used = A.run_segments(grouped, y0)
    ck_p, used_p = A.run_segments(grouped._replace(cuda=False), y0)
    torch.cuda.synchronize()
    assert A.forward_segment_cuda.launches == before[0] + 1
    assert _read_equal(A, grouped, ck, used, ck_p, used_p)
    fin = ck[grouped.n_seg]
    assert bool(fin[A.P_HIT].any())
    gen = torch.Generator(device=y0.device).manual_seed(3)
    ct = _state_ct(A, y0, gen)
    c, p = A.backward_cuda(grouped, ck, used[1:], ct)
    c_p, p_p = A.k4_plain(grouped._replace(cuda=False), ck_p, used_p[1:],
                          ct)
    torch.cuda.synchronize()
    assert A.backward_cuda.launches == before[1] + 1
    assert torch.equal(c, c_p) and torch.equal(p, p_p)
    B = singles[0][1].shape[1]
    for s, (route, y) in enumerate(singles):
        rays = slice(s * B, (s + 1) * B)
        ck_s, used_s = A.run_segments(route, y)
        c_s, p_s = A.backward_cuda(route, ck_s, used_s[1:],
                                   ct[:, rays].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(ck_s[0], ck[0][:, rays])
        assert torch.equal(ck_s[route.n_seg], fin[:, rays])
        assert torch.equal(c_s, c[:, rays]) and torch.equal(p_s, p[rays])


def _k4_matches_plain(A, route, y0=None, P=None, seed=5):
    """K3 from the launch states ``y0`` against its plain chain, or, for a
    packed start ``P`` that K3's prologue does not make (rays near their
    span's end, or inactive from the start), the plain chain from ``P``
    alone (``chain_plain``); then K4 as the wrapper launches it (one
    launch of the work order's kernels, then K4 in that order) on those
    checkpoints, bitwise equal to ``k4_plain`` on the plain chain's.
    Returns the rays' end segments and K4's output."""
    plain = route._replace(cuda=False)
    if P is None:
        ck, used = A.run_segments(route, y0)
        ck_p, used_p = A.run_segments(plain, y0)
        torch.cuda.synchronize()
        assert _read_equal(A, route, ck, used, ck_p, used_p)
    else:
        ck_p, used_p = A.chain_plain(plain, P)
        ck, used = ck_p, used_p
        y0 = P[A.P_Y:A.P_Y + 8]
    gen = torch.Generator(device=y0.device).manual_seed(seed)
    ct = _state_ct(A, y0, gen)
    want = A.k4_plain(plain, ck_p, used_p[1:], ct)
    ends = used[1:]
    before = (A.work_order_cuda.launches, A.backward_cuda.launches)
    got = A.backward_cuda(route, ck, ends, ct)
    assert (A.work_order_cuda.launches,
            A.backward_cuda.launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return ends, got


@pytest.mark.parametrize("method,max_steps", [("rk4", 200), ("tsit5", 48)])
def test_k4_training_batch_matches_plain_bitwise(method, max_steps):
    """K4 on the training step's batch (example2 200x200 f32, 40,000 rays,
    the bench's rk4/200 and tsit5/48) in the work order the wrapper makes,
    bitwise equal to the plain version."""
    A, route, y0, _ = _ckpt_case(200, torch.float32, method, max_steps)
    ends, _ = _k4_matches_plain(A, route, y0)
    assert ends.shape == (40_000,) and int(torch.unique(ends).numel()) > 1


@pytest.mark.parametrize("n,bins,kind", [
    (40_000, 21, "random"), (4_096, 9, "one end"), (1_027, 9, "random"),
    (16_384, 1_251, "random"), (3_000, 5, "sorted"), (1, 3, "random"),
    (1, 1, "random"), (1_023, 26, "random"), (1_025, 7, "random"),
    (16_384, 26, "random"), (20_000, 26, "random"),
    (1_048_576, 26, "random"), (1_048_576, 7, "sorted"),
    (40_000, 1, "random")])
def test_work_order_kernel_matches_the_stable_sort(n, bins, kind):
    """The counting sort's order (K4's, one launch of one cluster) equals
    ``work_order``'s stable sort of the ends, largest first, exactly: from
    one ray to 1,048,576, one bin (every ray with the same end) to 1,251,
    every end (random), all rays at one end, ends already sorted."""
    from raytracegr_jl_tpu_torch.ops import adjoint as A
    gen = torch.Generator(device="cuda").manual_seed(n)
    ends = torch.randint(0, bins, (n,), generator=gen, device="cuda",
                         dtype=torch.int32)
    if kind == "one end":
        ends.fill_(bins // 2)
    elif kind == "sorted":
        ends = ends.sort().values.contiguous()
    before = A.work_order_cuda.launches
    got = A.work_order_cuda(ends, bins - 1)
    assert A.work_order_cuda.launches == before + 1
    assert torch.equal(got, A.work_order(ends))


# K4's work-order cases, example2 RK4 (n x n, steps of dt): 225 rays, not a
# multiple of any block size, at config 5's segments of 15; every ray 15
# steps from the end of its span, which none reaches a surface in, so all
# end in segment 2 of 10; and spans cut at 1 to 100 steps with every fifth
# ray inactive from the start, so that the ends cover every segment (f32
# and f64).
K4_ORDER_CASES = [("ragged", 15, torch.float32, 120, 0.2),
                  ("one end", 16, torch.float32, 100, 0.1),
                  ("every end", 16, torch.float32, 100, 0.1),
                  ("every end", 16, torch.float64, 100, 0.1)]


@pytest.mark.parametrize("case,n,dtype,max_steps,dt", K4_ORDER_CASES)
def test_k4_work_order_matches_plain_bitwise(case, n, dtype, max_steps, dt):
    A, route, y0, (_, _, _, integ) = _ckpt_case(n, dtype, "rk4", max_steps,
                                                rk4_dt=dt)
    B = y0.shape[1]
    P = None
    if case != "ragged":  # K4 from the plain chain of a packed start
        P = A.init_plain(route, y0)
    if case == "one end":
        P[A.P_LAM] = integ.lam_max - 15 * dt
    elif case == "every end":
        k = torch.arange(B, device=P.device)
        P[A.P_LAM] = integ.lam_max - (1 + (k * 7) % max_steps).to(
            P.dtype) * dt
        P[A.P_ACTIVE, ::5] = 0
    ends, _ = _k4_matches_plain(A, route, y0, P)
    hist = torch.bincount(ends, minlength=route.n_seg + 1)
    if case == "ragged":
        assert B % 32 and int((hist > 0).sum()) > 2
    elif case == "one end":
        assert int(hist[2]) == B
    else:
        assert bool((hist > 0).all()), hist.tolist()


# config 5's starts at 16: M in [0.48, 0.52], z in [-0.06, 0.06].
CONFIG5_STARTS = [(0.5 + 0.01 * ((k % 5) - 2), 0.02 * ((k % 7) - 3))
                  for k in range(16)]


@pytest.mark.parametrize("starts", [1, 4, 16])
def test_grouped_k4_work_order_matches_plain_bitwise(starts):
    """Grouped K4 at config 5 (32x32 a start, rk4/120) at 1, 4 and 16
    starts of different (M, z): bitwise equal to the grouped plain
    version, and each start's rays to its own ungrouped
    launch. In work order a warp may hold rays of several starts, so each
    ray must read its own group's row (the permuted index)."""
    A, singles, grouped, y0 = _lensing_grouped(
        torch.float32, "rk4", CONFIG5_STARTS[:starts], n=32)
    _, (c, p) = _k4_matches_plain(A, grouped, y0)
    gen = torch.Generator(device=y0.device).manual_seed(5)
    ct = _state_ct(A, y0, gen)
    B = singles[0][1].shape[1]
    for s, (route, y) in enumerate(singles):
        rays = slice(s * B, (s + 1) * B)
        ck_s, used_s = A.run_segments(route, y)
        c_s, p_s = A.backward_cuda(route, ck_s, used_s[1:],
                                   ct[:, rays].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(c_s, c[:, rays]) and torch.equal(p_s, p[rays])


def test_config5_recovery_through_the_kernels():
    """BASELINE config 5 on the card (tests/test_inverse.py:69-107): the
    lensing scene at 32x32 f32, M and z fitted from 0.53 and 0.03 in 60
    Adam steps of 5e-3 through K3 and K4, one launch each per step: M
    within 1% of 0.5 and |z| < 0.01; and the vectorized multistart of two
    starts picks the run the serial one picks, one K3 and K4 launch per
    step, with loss histories within 1e-4 of the serial ones relative to
    their largest loss (chip_smoke.py's VEC_SERIAL_RTOL: the camera, the
    means and the cotangent sums reduce over other batch shapes). The
    counted fits step eagerly (``graph=False``): a graph's replays issue no
    launch from Python."""
    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                      forward_segment_cuda)
    dev = torch.device("cuda")
    f32 = torch.float32
    spec = T.lensing_inverse_spec(32, 32)
    cfg = T.default_inverse_cfg(f32, max_steps=120, rk4_dt=0.5,
                                soft_temp=0.05, stop_rho=0.5)._replace(
        soft_freq=2.0)
    cfg = cfg._replace(integrator=cfg.integrator._replace(lam_max=60.0))
    truth = T.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], f32, dev)
    with torch.no_grad():
        target = T.make_render_for_params(spec, cfg, 0, f32, dev)(truth)
    kw = dict(sphere_index=0, learning_rate=5e-3, dtype=f32,
              trainable=T.InverseParams(1.0, 0.0, [0.0, 0.0, 0.0, 1.0], f32,
                                        dev))
    init = T.InverseParams(0.53, 0.0, [0.0, 5.0, 12.0, 0.03], f32, dev)
    before = (forward_segment_cuda.launches, backward_cuda.launches)
    res = T.fit(spec, target, init, cfg, steps=60, graph=False, **kw)
    assert (forward_segment_cuda.launches - before[0],
            backward_cuda.launches - before[1]) == (60, 60)
    m = float(res.params.M.detach())
    z = float(res.params.sphere_pos.detach()[3])
    assert abs(m - 0.5) / 0.5 < 0.01, f"M recovered to {m}"
    assert abs(z) < 0.01, f"z recovered to {z}"
    assert float(res.params.a.detach()) == 0.0
    inits = [init, T.InverseParams(0.47, 0.0, [0.0, 5.0, 12.0, -0.04], f32,
                                   dev)]
    before = (forward_segment_cuda.launches, backward_cuda.launches)
    vec = T.fit_multistart(spec, target, inits, cfg, steps=4, graph=False,
                           **kw)
    assert (forward_segment_cuda.launches - before[0],
            backward_cuda.launches - before[1]) == (4, 4)
    ser = T.fit_multistart(spec, target, inits, cfg, steps=4,
                           vectorized=False, **kw)
    assert torch.equal(vec.params_history["M"][0], ser.params_history["M"][0])
    rel = (vec.loss_history - ser.loss_history).abs().max() / (
        ser.loss_history.abs().max())
    assert float(rel) <= 1e-4, float(rel)


# ---------------------------------------------------------------------------
# refine_minima (SC_REFINE), K2's own initial step, K5, the sorted route
# ---------------------------------------------------------------------------

DTYPES = [torch.float32, torch.float64]


def _tol(dtype):
    return TOL32 if dtype == torch.float32 else 1e-10


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", [T.example1_spec(32, 32),
                                  T.example2_spec(32, 32)],
                         ids=["example1", "example2"])
def test_k1_refine_matches_plain_bitwise(spec, dtype):
    """K1 with refine_minima (the SC_REFINE kernel) against the plain
    version, bitwise; example1's silhouette band holds grazing rays."""
    integ = T.IntegratorConfig(rtol=_tol(dtype), atol=_tol(dtype),
                               max_steps=4000, refine_minima=True)
    metric, scene, canvas = T.build(spec, dtype, torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    k = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    own = integrate_rays_cuda(metric, scene, y0, None, integ)
    p = integrate_rays_cm(metric, scene, y0, dt0, integ)
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
        assert torch.equal(getattr(own, f), getattr(p, f)), f


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_refine_matches_plain_bitwise(dtype):
    """K2 with refine_minima: the first chunk and a resumed one against
    chunk_plain, every plane."""
    from raytracegr_jl_tpu_torch import compaction as C
    tol = TOL32 if dtype == torch.float32 else 1e-8
    integ = T.IntegratorConfig(rtol=tol, atol=tol, max_steps=400,
                               stop_rho=1.0, refine_minima=True)
    metric, scene, canvas = T.build(T.accretion_disk_spec(32, 32), dtype,
                                    torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    y_cm = y0.t().contiguous()
    k = C.chunk_cuda(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0)
    p = C.chunk_plain(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    k2 = C.chunk_cuda(metric, scene, integ, 32, P=k[0])
    p2 = C.chunk_plain(metric, scene, integ, 32, P=p[0])
    for a, b in zip(k2, p2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method,max_steps", [("rk4", 40), ("tsit5", 16)])
def test_k3_k4_refine_match_plain_bitwise(method, max_steps, dtype):
    """K3 (one launch, k3_close) and K4 with refine_minima: K4's replay
    makes K3's refined decisions."""
    A, route, y0, _ = _ckpt_case(32, dtype, method, max_steps, refine=True)
    ck, used = A.run_segments(route, y0)
    ck_p, used_p = A.run_segments(route._replace(cuda=False), y0)
    assert _read_equal(A, route, ck, used, ck_p, used_p)
    ct = _state_ct(A, y0)
    c, p = A.backward_cuda(route, ck, used[1:], ct)
    c_p, p_p = A.k4_plain(route, ck_p, used_p[1:], ct)
    assert torch.equal(c, c_p) and torch.equal(p, p_p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_k3_k4_refine_match_plain_bitwise(dtype):
    """The grouped K3 and K4 with refine_minima (GroupParams through the
    SC_REFINE kernels)."""
    _check_grouped_k3_k4(dtype, "rk4", refine=True)


@pytest.mark.parametrize("dtype,method", [(torch.float32, "tsit5"),
                                          (torch.float64, "tsit5"),
                                          (torch.float32, "rk4")])
def test_k2_own_initial_step_matches_plain_bitwise(dtype, method):
    """K2's first chunk with dt0=None against initial_dt then chunk_plain,
    and the compacted trace with dt0=None against it given."""
    from raytracegr_jl_tpu_torch import compaction as C
    tol = TOL32 if dtype == torch.float32 else 1e-8
    integ = T.IntegratorConfig(method=method, rtol=tol, atol=tol,
                               max_steps=400, stop_rho=1.0, rk4_dt=0.25)
    metric, scene, canvas = T.build(T.accretion_disk_spec(32, 32), dtype,
                                    torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, integ)
    y_cm = y0.t().contiguous()
    k = C.chunk_cuda(metric, scene, integ, 16, y_cm=y_cm, dt0=None)
    p = C.chunk_plain(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    own = T.trace_batch_compacted(metric, scene, y0, None, integ,
                                  first_chunk=16)
    given = T.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                    first_chunk=16)
    for f in ("y", "lam", "hit", "steps"):
        assert torch.equal(getattr(own, f), getattr(given, f)), f


def _k5_case(scene_kind, dtype):
    """K5's inputs: ``(metric, scene, y0, y)``, the launch states and K1's
    end states (rows), or for the disk the compacted trace's (transposed
    planes). "disk": a 32x32 accretion disk (the Keplerian branch);
    "sphere": example2 at 32x32 with its sphere moving (a stored ``vel``:
    the non-disk branch, with the time-plane); "minkowski": example1 at
    32x32, its small sphere moving."""
    dev = torch.device("cuda")
    tol = TOL32 if dtype == torch.float32 else 1e-8
    integ = T.IntegratorConfig(rtol=tol, atol=tol, max_steps=2000,
                               stop_rho=1.0, sort_rays=True)
    spec = {"disk": T.accretion_disk_spec, "sphere": T.example2_spec,
            "minkowski": T.example1_spec}[scene_kind](32, 32)
    metric, scene, canvas = T.build(spec, dtype, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    if scene_kind == "disk":
        y = T.trace_batch_compacted(metric, scene, y0, None, integ).y
    else:
        vel = scene.vel.clone()
        vel[2] = torch.tensor([1.0, 0.0, 0.3, 0.2], dtype=dtype)
        scene = scene._replace(vel=vel)
        y = integrate_rays_cuda(metric, scene, y0, None, integ).y
    return metric, scene, y0, y


@pytest.mark.parametrize("scene_kind", ["disk", "sphere", "minkowski"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_matches_plain_bitwise(dtype, scene_kind):
    """K5 against shade_redshift on the same CUDA tensors, every bit of
    every colour: the states as the render holds them (strided) and as
    contiguous rows; some rays lit and, on the disk, some black."""
    from raytracegr_jl_tpu_torch.models.shading import (shade_redshift,
                                                        shade_redshift_cuda)
    metric, scene, y0, y = _k5_case(scene_kind, dtype)
    want = shade_redshift(metric, scene, y0, y, metric.params.M,
                          metric.params.a)
    before = shade_redshift_cuda.launches
    got = shade_redshift_cuda(metric, scene, y0, y)
    rows = shade_redshift_cuda(metric, scene, y0, y.contiguous())
    torch.cuda.synchronize()
    assert shade_redshift_cuda.launches == before + 2
    assert _bits_equal(got, want) and _bits_equal(rows, want)
    lit = want.abs().sum(1) > 0
    assert int(lit.sum()) > 0
    assert scene_kind != "disk" or int((~lit).sum()) > 0


def test_redshift_renders_shade_through_k5_once():
    """render_fn and the default make_compact_renderer shade a redshift
    render through one K5 launch each and no eager shading, with no host
    sync in render_fn once its launch setup and K5's block are kept, and
    give the same image bitwise (fast_epilogue too); a differentiable
    redshift render on the card takes the plain shading under autograd and
    gets a finite gradient of M, with no K5 launch."""
    import warnings

    from raytracegr_jl_tpu_torch import compaction as C
    from raytracegr_jl_tpu_torch import render
    from raytracegr_jl_tpu_torch.models.shading import shade_redshift_cuda
    dev = torch.device("cuda")
    metric, scene, canvas = T.build(T.accretion_disk_spec(32, 32),
                                    torch.float32, dev)
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=TOL32, atol=TOL32, max_steps=2000, stop_rho=1.0,
        sort_rays=True), shading="redshift")
    fn = T.render_fn(metric, scene, cfg)
    fn(canvas.pos, canvas.normal)
    torch.cuda.synchronize()
    eager = []
    orig = render.shade_redshift
    render.shade_redshift = lambda *a, **k: eager.append(1) or orig(*a, **k)
    try:
        before = (integrate_rays_cuda.launches, shade_redshift_cuda.launches)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                img = fn(canvas.pos, canvas.normal)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert (integrate_rays_cuda.launches - before[0],
                shade_redshift_cuda.launches - before[1]) == (1, 1)
        assert not [w for w in caught if "synchronizing cuda operation"
                    in str(w.message).lower()]
        images = []
        for fast in (False, True):
            before = shade_redshift_cuda.launches
            images.append(C.make_compact_renderer(
                metric, scene, cfg, fast_epilogue=fast)(canvas).rgb)
            assert shade_redshift_cuda.launches == before + 1
    finally:
        render.shade_redshift = orig
    assert not eager
    assert _bits_equal(images[0], img) and _bits_equal(images[1], img)
    assert float(img.max()) > 0.0

    M = torch.tensor(1.0, dtype=torch.float32, device=dev,
                     requires_grad=True)
    dmetric = T.make_metric("kerr_schild", T.KerrSchildParams(
        M, metric.params.a), r_formula=metric.r_formula,
        rho_min=metric.rho_min)
    dcfg = cfg._replace(differentiable=True, integrator=cfg.integrator
                        ._replace(max_steps=200, sort_rays=False))
    before = shade_redshift_cuda.launches
    rgb = T.render_fn(dmetric, scene, dcfg)(canvas.pos, canvas.normal)
    rgb.sum().backward()
    assert shade_redshift_cuda.launches == before
    assert bool(torch.isfinite(M.grad)) and float(M.grad) != 0.0


@pytest.mark.parametrize("method,max_steps", [("rk4", 40), ("tsit5", 16)])
def test_sorted_gradients_through_k3_k4_bitwise(method, max_steps):
    """sort_rays on the kernel route: the pixel loss and its gradients
    bitwise those unsorted, one K3 and one K4 launch each."""
    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                     forward_segment_cuda)
    dev = torch.device("cuda")
    spec = T.example2_spec(32, 32)
    cfg = T.default_inverse_cfg(torch.float32, max_steps=max_steps,
                                method=method, rk4_dt=100.0 / max_steps,
                                stop_rho=0.5, soft_temp=0.05)
    xg, ng = T.flat_pixel_grid(spec, torch.float32, dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, 2, device=dev)(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0],
                            torch.float32, dev), xg, ng)
    out = []
    for sort in (False, True):
        c = cfg._replace(integrator=cfg.integrator._replace(sort_rays=sort))
        p = T.InverseParams(1.05, 0.02, [0.0, 4.0, 0.1, 0.0], torch.float32,
                            dev)
        before = (forward_segment_cuda.launches, backward_cuda.launches)
        loss = T.make_ray_loss_fn(spec, c, 2, device=dev)(p, xg, ng, target)
        loss.backward()
        assert (forward_segment_cuda.launches - before[0],
                backward_cuda.launches - before[1]) == (1, 1)
        out.append(torch.cat([loss.detach()[None], p.M.grad[None],
                              p.a.grad[None], p.sphere_pos.grad]))
    assert torch.equal(out[0], out[1])


def test_sharded_nccl_world_size_1_bitwise():
    """parallel/sharding.py over NCCL at world size 1: the sharded
    training step equals the unsharded loss and gradients bitwise (one K3
    and one K4 launch on every ray), and the sharded render gathered
    equals render_fn's."""
    import socket

    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                     forward_segment_cuda)
    from raytracegr_jl_tpu_torch.parallel import sharding as S
    dev, f32 = torch.device("cuda"), torch.float32
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert not S.init_distributed(f"localhost:{port}", 1, 0, local_rank=0)
    try:
        mesh = S.make_mesh()
        spec = T.example2_spec(32, 32)
        cfg = T.default_inverse_cfg(f32, max_steps=40, rk4_dt=2.5,
                                    stop_rho=0.5)
        xg, ng = T.flat_pixel_grid(spec, f32, dev)
        with torch.no_grad():
            target = T.make_ray_render_for_params(spec, cfg, 2, f32, dev)(
                T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev),
                xg, ng)
        loss_fn = T.make_ray_loss_fn(spec, cfg, 2, f32, dev)

        def params():
            return T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)

        p = params()
        ref = loss_fn(p, xg, ng, target)
        ref.backward()
        before = (forward_segment_cuda.rays, backward_cuda.rays)
        loss, g = S.sharded_value_and_grad(loss_fn, mesh)(
            params(), *S.shard_pixels(mesh, xg, ng, target))
        assert (forward_segment_cuda.rays - before[0],
                backward_cuda.rays - before[1]) == (1024, 1024)
        assert torch.equal(loss, ref.detach())
        for name in ("M", "a", "sphere_pos"):
            assert torch.equal(getattr(g, name), getattr(p, name).grad)
        metric, scene, canvas = T.build(spec, f32, dev)
        fn = T.render_fn(metric, scene, T.RenderConfig(
            integrator=T.IntegratorConfig(rtol=TOL32, atol=TOL32,
                                          max_steps=20_000)))
        rgb = S.gather_rows(mesh, S.sharded_render(fn, mesh)(
            *S.shard_pixels(mesh, canvas.pos, canvas.normal)))
        assert torch.equal(rgb, fn(canvas.pos, canvas.normal))
    finally:
        torch.distributed.destroy_process_group()


def test_rowmajor_route_on_the_card():
    """backend="rowmajor" on CUDA tensors at 8x8 f64: the render within
    1e-9 of K1's with equal hits, and the scan's (M, a, sphere_pos)
    gradients within rtol 1e-9 of the kernel route's (K3/K4)."""
    from raytracegr_jl_tpu_torch.render import _shade, trace_batch
    dev, f64 = torch.device("cuda"), torch.float64
    spec = T.example2_spec(8, 8)
    metric, scene, canvas = T.build(spec, f64, dev)
    integ = T.IntegratorConfig(rtol=1e-9, atol=1e-9, max_steps=1000)
    cfg = T.RenderConfig(integrator=integ, backend="rowmajor")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    res = trace_batch(metric, scene, y0, cfg)
    k1 = integrate_rays_cuda(metric, scene, y0, None, integ)
    assert torch.equal(res.hit, k1.hit)
    torch.testing.assert_close(_shade(metric, scene, y0, res.y, cfg),
                               _shade(metric, scene, y0, k1.y, cfg),
                               rtol=0, atol=1e-9)
    xg, ng = T.flat_pixel_grid(spec, f64, dev)
    gcfg = T.default_inverse_cfg(f64, max_steps=20, rk4_dt=0.5, stop_rho=0.5)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, gcfg, 2, f64, dev)(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f64, dev), xg, ng)
    grads = []
    for c in (gcfg._replace(backend="rowmajor"), gcfg):
        p = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f64, dev)
        T.make_ray_loss_fn(spec, c, 2, f64, dev)(p, xg, ng, target).backward()
        grads.append(torch.cat([p.M.grad[None], p.a.grad[None],
                                p.sphere_pos.grad]))
    scale = float(grads[1].abs().max())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-9,
                               atol=1e-10 * scale)


def test_dual_oracle_matches_k3_k4():
    """The training path's f64 gradients through K3 and K4 (the default
    route on CUDA tensors) against the Dual oracle, a differentiation that
    shares no code with them, at example2 8x8 rk4/20: the primal within
    1e-12, the loss gradients for M and z and the projections within
    relative 1e-9 (tests/test_torch_dual_oracle.py's bars)."""
    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                      forward_segment_cuda)
    from test_torch_dual_oracle import (GRAD_RTOL, PRIMAL_ATOL,
                                        assert_not_vacuous, gaps, oracle,
                                        route)
    dev = torch.device("cuda")
    orc = oracle(8, dev)
    assert orc[0].device.type == "cuda"
    assert_not_vacuous(orc)
    before = (forward_segment_cuda.launches, backward_cuda.launches)
    r = route(8, dev)
    assert forward_segment_cuda.launches > before[0]
    assert backward_cuda.launches > before[1]
    g = gaps(orc, r)
    assert g["primal"] <= PRIMAL_ATOL, g
    for k in ("loss_M", "loss_z", "proj_M", "proj_z"):
        assert g[k] <= GRAD_RTOL, (k, g)


# ---------------------------------------------------------------------------
# The training step as one CUDA graph (step_graph.py)
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(bits), b.view(bits))


def _config5(n=32):
    dev = torch.device("cuda")
    f32 = torch.float32
    spec = T.lensing_inverse_spec(n, n)
    cfg = T.default_inverse_cfg(f32, max_steps=120, rk4_dt=0.5,
                                soft_temp=0.05, stop_rho=0.5)._replace(
        soft_freq=2.0)
    cfg = cfg._replace(integrator=cfg.integrator._replace(lam_max=60.0))
    truth = T.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], f32, dev)
    with torch.no_grad():
        target = T.make_render_for_params(spec, cfg, 0, f32, dev)(truth)
    kw = dict(sphere_index=0, learning_rate=5e-3, dtype=f32,
              trainable=T.InverseParams(1.0, 0.0, [0.0, 0.0, 0.0, 1.0], f32,
                                        dev))
    return spec, cfg, target, kw


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["fit", "multistart"])
def test_graphed_fit_matches_eager_bitwise(vectorized):
    """Config 5 at 32x32 for 3 Adam steps, each step a replay of one CUDA
    graph of the loss and its backward pass, against the eager loop: the
    loss and parameter histories, the final parameters and Adam's state,
    bit for bit (``fit`` and the vectorized multistart of two starts)."""
    spec, cfg, target, kw = _config5()
    dev = torch.device("cuda")
    init = T.InverseParams(0.53, 0.0, [0.0, 5.0, 12.0, 0.03], torch.float32,
                           dev)
    assert T.inverse.graphed(cfg, init)

    def run(graph):
        if not vectorized:
            return T.fit(spec, target, init, cfg, steps=3, graph=graph, **kw)
        inits = [init, T.InverseParams(0.47, 0.0, [0.0, 5.0, 12.0, -0.04],
                                       torch.float32, dev)]
        return T.fit_multistart(spec, target, inits, cfg, steps=3,
                                graph=graph, **kw)

    g, e = run(True), run(False)
    assert _bits_equal(g.loss_history, e.loss_history)
    assert g.opt_state["step"] == e.opt_state["step"] == 3
    for n in ("M", "a", "sphere_pos"):
        assert _bits_equal(g.params_history[n], e.params_history[n]), n
        assert _bits_equal(getattr(g.final_params, n).detach(),
                           getattr(e.final_params, n).detach()), n
        for k in ("exp_avg", "exp_avg_sq"):
            assert _bits_equal(g.opt_state[k][n], e.opt_state[k][n]), (k, n)


def test_graphed_replays_do_not_sync():
    """A graphed training step at example2 32x32 f32 rk4/40: the first
    replay's loss and gradients equal the eager step's bitwise; replays
    2..n run under sync debug mode "error" (a host sync raises) and keep
    the same bits; K3 and K4 were counted in the warm-up passes and the
    capture only."""
    from raytracegr_jl_tpu_torch.ops.adjoint import (backward_cuda,
                                                      forward_segment_cuda)
    from raytracegr_jl_tpu_torch.step_graph import (WARMUP_PASSES,
                                                    GraphedStep)
    dev = torch.device("cuda")
    f32 = torch.float32
    spec = T.example2_spec(32, 32)
    cfg = T.default_inverse_cfg(f32, max_steps=40, rk4_dt=2.5, stop_rho=0.5)
    xg, ng = T.flat_pixel_grid(spec, f32, dev)
    truth = T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, 2, f32, dev)(
            truth, xg, ng)
    loss_fn = T.make_ray_loss_fn(spec, cfg, 2, f32, dev)

    def params():
        return T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)

    def grads(p):
        return torch.cat([p.M.grad[None], p.a.grad[None], p.sphere_pos.grad])

    pe = params()
    loss_e = loss_fn(pe, xg, ng, target)
    loss_e.backward()
    pg = params()
    before = (forward_segment_cuda.launches, backward_cuda.launches)
    step = GraphedStep(lambda p: loss_fn(p, xg, ng, target), pg)
    counted = (WARMUP_PASSES + 1, WARMUP_PASSES + 1)
    assert (forward_segment_cuda.launches - before[0],
            backward_cuda.launches - before[1]) == counted

    def replay():
        for q in pg.parameters():
            q.grad.zero_()
        return step.replay()

    assert _bits_equal(replay(), loss_e.detach())
    assert _bits_equal(grads(pg), grads(pe))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (forward_segment_cuda.launches - before[0],
            backward_cuda.launches - before[1]) == counted
    assert _bits_equal(step.loss, loss_e.detach())
    assert _bits_equal(grads(pg), grads(pe))


def test_graphed_replay_after_a_float_mass_sweep():
    """The parameter blocks' host parts are kept by configuration, not by
    the value of a float M or a (which each pass writes itself): 1,000
    blocks packed for 1,000 float masses add at most one kept host part,
    and a graphed training step captured before them replays bit for bit
    after them."""
    from raytracegr_jl_tpu_torch.ops import geodesic_cm as G
    from raytracegr_jl_tpu_torch.step_graph import GraphedStep
    dev = torch.device("cuda")
    f32 = torch.float32
    spec = T.example2_spec(32, 32)
    cfg = T.default_inverse_cfg(f32, max_steps=40, rk4_dt=2.5, stop_rho=0.5)
    xg, ng = T.flat_pixel_grid(spec, f32, dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, 2, f32, dev)(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev), xg, ng)
    loss_fn = T.make_ray_loss_fn(spec, cfg, 2, f32, dev)
    pg = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    step = GraphedStep(lambda p: loss_fn(p, xg, ng, target), pg)

    def replay():
        for q in pg.parameters():
            q.grad.zero_()
        loss = step.replay().clone()
        return loss, torch.cat([pg.M.grad[None], pg.a.grad[None],
                                pg.sphere_pos.grad])

    want = replay()
    _, scene, _ = T.build(spec, f32, dev)
    kept = len(G._HOST_BLOCKS)
    for i in range(1000):
        metric = T.make_metric("kerr_schild",
                               T.KerrSchildParams(0.5 + 1e-3 * i, 0.0),
                               rho_min=0.25)
        blk = G.pack_params(metric, scene, cfg.integrator, f32, dev)
    assert len(G._HOST_BLOCKS) <= kept + 1
    assert float(blk[:4].view(f32)) == float(torch.tensor(1.499, dtype=f32))
    got = replay()
    assert _bits_equal(got[0], want[0]) and _bits_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# K6 and K7: the localization epilogue and its VJP
# ---------------------------------------------------------------------------

def _final(A, route, y0):
    """K3's pass from the launch states y0: every ray's final packed state
    [34, B]."""
    ck, _ = A.run_segments(route, y0)
    return ck[route.n_seg].contiguous()


def _loc_cotangents(P, seed=3):
    gen = torch.Generator(device=P.device).manual_seed(seed)
    ct_y = torch.randn((8, P.shape[1]), generator=gen, dtype=P.dtype,
                       device=P.device)
    ct_lam = torch.randn(P.shape[1], generator=gen, dtype=P.dtype,
                         device=P.device)
    ct_y[:, ::7] = 0
    ct_lam[::7] = 0
    return ct_y, ct_lam


def _check_k6_k7(A, route, P):
    """K6 and K7 against localize_plain and localize_vjp on the same CUDA
    tensors, bit for bit (K6's record too, on the hit rays: K6 writes no
    other; K7 given K6's record against the plain VJP given the plain
    record and against its replay), each launched once; returns K6's and
    K7's outputs."""
    plain = route._replace(cuda=False)
    before = (A.localize_cuda.launches, A.localize_vjp_cuda.launches)
    y, lam, rec = A.localize_cuda(route, P)
    ct_y, ct_lam = _loc_cotangents(P)
    c, p = A.localize_vjp_cuda(route, P, ct_y, ct_lam, rec)
    torch.cuda.synchronize()
    assert (A.localize_cuda.launches - before[0],
            A.localize_vjp_cuda.launches - before[1]) == (1, 1)
    y_p, lam_p, rec_p = A.localize_plain(plain, P)
    c_p, p_p = A.localize_vjp(plain, P, ct_y, ct_lam, rec_p)
    c_r, p_r = A.localize_vjp(plain, P, ct_y, ct_lam)
    hit = P[A.P_HIT] > 0
    assert bool(hit.any())
    assert _bits_equal(y, y_p) and _bits_equal(lam, lam_p)
    assert _bits_equal(rec[:, hit], rec_p[:, hit])
    assert _bits_equal(c, c_p) and _bits_equal(p, p_p)
    assert _bits_equal(c, c_r) and _bits_equal(p, p_r)
    return y, lam, c, p


# K3's cases, with the f64 Tsit5 run long enough for its rays to hit.
LOC_CASES = CKPT_CASES[:3] + [(16, torch.float64, "tsit5", 200)]


@pytest.mark.parametrize("n,dtype,method,max_steps", LOC_CASES)
@pytest.mark.parametrize("refine", [False, True], ids=["", "refine"])
def test_k6_k7_match_plain_bitwise(n, dtype, method, max_steps, refine):
    """K6 and K7 on K3's final states (example2, f32 and f64, RK4 and
    Tsit5, with and without refine_minima, whose SC_REFINE code K6 and K7
    launch as SC_ANY) against their plain versions: bitwise."""
    A, route, y0, _ = _ckpt_case(n, dtype, method, max_steps, refine=refine)
    _check_k6_k7(A, route, _final(A, route, y0))


@pytest.mark.parametrize("dtype,method", [(torch.float32, "tsit5"),
                                          (torch.float64, "rk4")])
@pytest.mark.parametrize("iters", [0, 1, 39, 40])
def test_k6_bisection_counts_match_plain_bitwise(dtype, method, iters):
    """At 0, 1, 39 and 40 bisections K6's results and record, and K7's
    from that record, equal the plain versions' bit for bit."""
    A, route, y0, _ = _ckpt_case(16, dtype, method, 200 if method ==
                                 "tsit5" else 40)
    P = _final(A, route, y0)
    route = route._replace(cfg=route.cfg._replace(bisect_iters=iters))
    _check_k6_k7(A, route, P)


@pytest.mark.parametrize("dtype,method", [(torch.float32, "rk4"),
                                          (torch.float64, "tsit5")])
def test_k6_k7_minkowski_match_plain_bitwise(dtype, method):
    """The same in flat space (example1: no M and a cotangents)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as A
    integ = T.default_inverse_cfg(dtype, max_steps=40, method=method,
                                  rk4_dt=2.5, stop_rho=0.5).integrator
    metric, scene, canvas = T.build(T.example1_spec(32, 32), dtype,
                                    torch.device("cuda"))
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    seg = A.segment_length(integ, integ.grad_seg_len)
    route = A.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                    n_seg=integ.max_steps // seg, cuda=True)
    P = _final(A, route, y0.t().contiguous())
    _, _, _, p = _check_k6_k7(A, route, P)
    assert not bool(p[:2].any())


@pytest.mark.parametrize("dtype,method", [
    (torch.float32, "rk4"), (torch.float32, "tsit5"),
    (torch.float64, "rk4"), (torch.float64, "tsit5")])
def test_grouped_k6_k7_match_plain_and_each_start(dtype, method):
    """Grouped K6 and K7 over four starts of different (M, z) against the
    grouped plain versions (bitwise), and each start's rays against that
    start's own ungrouped launches (bitwise, per ray)."""
    starts = [(0.5, 0.0), (0.53, 0.03), (0.47, -0.05), (0.51, 0.1)]
    A, singles, grouped, y0 = _lensing_grouped(dtype, method, starts)
    P = _final(A, grouped, y0)
    y, lam, c, p = _check_k6_k7(A, grouped, P)
    ct_y, ct_lam = _loc_cotangents(P)
    B = singles[0][1].shape[1]
    for s, (route, _) in enumerate(singles):
        rays = slice(s * B, (s + 1) * B)
        Ps = P[:, rays].contiguous()
        ys, lams, recs = A.localize_cuda(route, Ps)
        cs, ps = A.localize_vjp_cuda(route, Ps, ct_y[:, rays].contiguous(),
                                     ct_lam[rays].contiguous(), recs)
        torch.cuda.synchronize()
        assert _bits_equal(ys, y[:, rays]) and _bits_equal(lams, lam[rays])
        assert _bits_equal(cs, c[:, rays]) and _bits_equal(ps, p[:, rays])


def test_k7_matches_autograd_f64():
    """K7 against torch autograd of the plain epilogue on the card at f64
    (example2 32x32 RK4 and Tsit5), within 1e-12 of each output block's
    largest entry (the parameters: of the sum of their per-ray
    magnitudes)."""
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (OBJ_FIELDS,
                                                         localize_events_cm,
                                                         scene_event_cm)
    for method, steps in (("rk4", 40), ("tsit5", 200)):
        A, route, y0, _ = _ckpt_case(32, torch.float64, method, steps)
        P = _final(A, route, y0)
        ct_y, ct_lam = _loc_cotangents(P)
        rec = A.localize_cuda(route, P)[2]
        c, p = A.localize_vjp_cuda(route, P, ct_y, ct_lam, rec)
        pv = A.flatten_params(route.metric, route.scene).detach()
        pv.requires_grad_()
        Pl = P.clone().requires_grad_()
        metric = route.metric._replace(params=T.KerrSchildParams(pv[0],
                                                                 pv[1]))
        sc = route.scene
        rows = pv[2:].reshape(sc.n_objects, 8)
        scene = sc._replace(pos=torch.cat([sc.pos[:, :1], rows[:, :3]], 1),
                            **{f: rows[:, 3 + k]
                               for k, f in enumerate(OBJ_FIELDS[3:])})
        st = A.unpack_state(Pl)
        dead = ~st.hit & ~st.active & (st.lam < route.cfg.lam_max - 1e-6)
        y = torch.where(dead, st.y.detach(), st.y)
        th, ys = localize_events_cm(metric, scene_event_cm(scene), route.cfg,
                                    st.ev_y0, st.ev_dt, st.ev_lo, st.ev_hi)
        y = torch.where(st.hit, ys, y)
        lam = torch.where(st.hit, st.ev_lam + th * st.ev_dt, st.lam)
        g_P, g_p = torch.autograd.grad(
            (y * ct_y).sum() + (lam * ct_lam).sum(), (Pl, pv))
        for lo in (A.P_Y, A.P_EV_Y0):
            want = g_P[lo:lo + 8]
            torch.testing.assert_close(
                c[lo:lo + 8], want, rtol=0,
                atol=1e-12 * float(want.abs().max()))
        assert bool(((p.sum(1) - g_p).abs()
                     <= 1e-12 * p.abs().sum(1)).all())


def test_k6_k7_under_capture_and_on_two_streams():
    """K6 and K7 captured in a CUDA graph replay what they compute eagerly;
    and launched on two streams without a sync, K6 after a long K3 pass
    and K7 with another mass, each equals its launch run alone (the
    library serializes all its kernels' launches across streams)."""
    A, route, y0, _ = _ckpt_case(128, torch.float32, "rk4", 200)
    P = _final(A, route, y0)
    ct_y, ct_lam = _loc_cotangents(P)
    args = A.localize_args(route, P)
    y_e, lam_e, rec_e = A.localize_cuda(route, P, args)
    c_e, p_e = A.localize_vjp_cuda(route, P, ct_y, ct_lam, rec_e, args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rec_s = A.localize_cuda(route, P, args)[2]
        A.localize_vjp_cuda(route, P, ct_y, ct_lam, rec_s, args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_g, lam_g, rec_g = A.localize_cuda(route, P, args)
        c_g, p_g = A.localize_vjp_cuda(route, P, ct_y, ct_lam, rec_g, args)
    from raytracegr_jl_tpu_torch.step_graph import _params_fence
    stream = torch.cuda.current_stream()
    _params_fence(torch.float32, stream)
    graph.replay()
    _params_fence(torch.float32, stream)
    torch.cuda.synchronize()
    hit = P[A.P_HIT] > 0
    assert _bits_equal(y_g, y_e) and _bits_equal(lam_g, lam_e)
    assert _bits_equal(rec_g[:, hit], rec_e[:, hit])
    assert _bits_equal(c_g, c_e) and _bits_equal(p_g, p_e)

    heavy = route._replace(metric=route.metric._replace(
        params=route.metric.params._replace(M=1.3)))
    rec_h = A.localize_cuda(heavy, P)[2]
    want_h = A.localize_vjp_cuda(heavy, P, ct_y, ct_lam, rec_h)
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(s1):
        A.run_segments(route, y0)
        got_6 = A.localize_cuda(route, P)
    with torch.cuda.stream(s2):
        got_7 = [A.localize_vjp_cuda(heavy, P, ct_y, ct_lam, rec_h)
                 for _ in range(3)]
    torch.cuda.synchronize()
    assert not _bits_equal(want_h[1], p_e)
    assert _bits_equal(got_6[0], y_e) and _bits_equal(got_6[1], lam_e)
    assert _bits_equal(got_6[2][:, hit], rec_e[:, hit])
    for c, p in got_7:
        assert _bits_equal(c, want_h[0]) and _bits_equal(p, want_h[1])


def test_train_step_launches_k6_and_k7():
    """A training step on CUDA tensors launches K6 and K7 once each; the
    plain route none; the two give the same loss and gradients bitwise."""
    from raytracegr_jl_tpu_torch.ops import adjoint as A
    dev = torch.device("cuda")
    spec = T.example2_spec(24, 24)
    cfg = T.default_inverse_cfg(torch.float32, max_steps=48, method="tsit5",
                                stop_rho=0.5)
    xg, ng = T.flat_pixel_grid(spec, torch.float32, dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, device=dev)(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], device=dev),
            xg, ng)
    out = []
    for backend in (None, "torch"):
        p = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], device=dev)
        before = (A.localize_cuda.launches, A.localize_vjp_cuda.launches)
        loss = T.make_ray_loss_fn(spec, cfg._replace(backend=backend),
                                  device=dev)(p, xg, ng, target)
        loss.backward()
        out.append((A.localize_cuda.launches - before[0],
                    A.localize_vjp_cuda.launches - before[1],
                    loss.detach(), torch.cat([p.M.grad[None], p.a.grad[None],
                                              p.sphere_pos.grad])))
    assert out[0][:2] == (1, 1) and out[1][:2] == (0, 0)
    assert _bits_equal(out[0][2], out[1][2])
    assert _bits_equal(out[0][3], out[1][3])


def _camera_batch(case):
    """(metric, pos, normal) of a K8/K9 case on the card: example2 as the
    training path builds it (M 1.05, rho_min 0.25) at n x n, example1
    (Minkowski), or config 5's lensing scene at 4 starts of 32x32 each
    (textbook, M and a per ray)."""
    name, n, dtype, a = case
    dev = torch.device("cuda")
    full = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    if name == "grouped":
        xg, ng = T.flat_pixel_grid(T.lensing_inverse_spec(n, n), dtype, dev)
        B = xg.shape[0]
        M = full([0.5, 0.53, 0.47, 0.51]).repeat_interleave(B)
        av = full([a * k / 3 for k in range(4)]).repeat_interleave(B)
        metric = T.make_metric("kerr_schild", T.KerrSchildParams(M, av),
                               r_formula="textbook", rho_min=0.25)
        return metric, xg.repeat(4, 1), ng.repeat(4, 1)
    spec = (T.example2_spec if name == "example2" else T.example1_spec)(n, n)
    xg, ng = T.flat_pixel_grid(spec, dtype, dev)
    if name == "example1":
        return T.make_metric("minkowski"), xg, ng
    return T.make_metric("kerr_schild", T.KerrSchildParams(full(1.05),
                                                           full(a)),
                         rho_min=0.25), xg, ng


@pytest.mark.parametrize("case", [
    ("example2", 200, torch.float32, 0.0), ("example2", 8, torch.float64, 0.0),
    ("example2", 64, torch.float64, 0.6), ("example1", 64, torch.float32, 0.0),
    ("grouped", 32, torch.float32, 0.0), ("grouped", 32, torch.float64, 0.3)],
    ids=lambda c: f"{c[0]}-{c[1]}-{str(c[2])[6:]}-a{c[3]}")
def test_k8_k9_match_plain_bitwise(case):
    """K8 against ``pixel_rays_plain`` and K9 against ``pixel_rays_vjp`` on
    the same CUDA tensors, bit for bit (every ninth ray's cotangent zero;
    K9's cotangent contiguous and a view of [8, B] planes, which it reads
    through its strides); ``pixel_rays`` of a Metric value launches K8,
    its backward K9."""
    from raytracegr_jl_tpu_torch.models import camera as C
    metric, pos, normal = _camera_batch(case)
    gen = torch.Generator(device=pos.device).manual_seed(4)
    ct = torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                     device=pos.device)
    ct[::9] = 0
    u = C.pixel_rays_cuda(metric, pos, normal)
    assert bool(torch.isfinite(u).all())
    assert _bits_equal(u, C.pixel_rays_plain(metric, pos, normal))
    want = C.pixel_rays_vjp(metric, pos, normal, ct)
    planes = torch.cat([pos, ct], -1).t().contiguous().t()[:, 4:]
    for c in (ct, planes):
        assert _bits_equal(C.pixel_rays_vjp_cuda(metric, pos, normal, c),
                           want)
    before = (C.pixel_rays_cuda.launches, C.pixel_rays_vjp_cuda.launches)
    M = torch.as_tensor(metric.params.M, dtype=pos.dtype,
                        device=pos.device).clone().requires_grad_()
    _, u2 = C.pixel_rays(metric._replace(params=metric.params._replace(M=M)),
                         pos, normal)
    (u2 * ct).sum().backward()
    assert (C.pixel_rays_cuda.launches - before[0],
            C.pixel_rays_vjp_cuda.launches - before[1]) == (1, 1)
    assert _bits_equal(u2.detach(), u)


def test_graphed_rk4_step_with_k8_k9_matches_eager():
    """The rk4/200 training step at 200x200 f32 captured as one CUDA graph,
    the camera's K8 and K9 inside it: the replay's loss and gradients equal
    the eager step's bitwise, also after M changes in place (K8 and K9 read
    M by pointer); K8 and K9 are counted in the warm-ups and the capture
    only."""
    from raytracegr_jl_tpu_torch.models import camera as C
    from raytracegr_jl_tpu_torch.step_graph import (WARMUP_PASSES,
                                                    GraphedStep)
    dev = torch.device("cuda")
    f32 = torch.float32
    spec = T.example2_spec(200, 200)
    cfg = T.default_inverse_cfg(f32, max_steps=200, rk4_dt=0.5, stop_rho=0.5)
    xg, ng = T.flat_pixel_grid(spec, f32, dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, 2, f32, dev)(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev), xg,
            ng)
    loss_fn = T.make_ray_loss_fn(spec, cfg, 2, f32, dev)

    def params(M=1.05):
        return T.InverseParams(M, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)

    def grads(p):
        return torch.cat([p.M.grad[None], p.a.grad[None], p.sphere_pos.grad])

    def eager(M):
        p = params(M)
        loss = loss_fn(p, xg, ng, target)
        loss.backward()
        return loss.detach(), grads(p)

    want, moved = eager(1.05), eager(1.06)
    pg = params()
    before = (C.pixel_rays_cuda.launches, C.pixel_rays_vjp_cuda.launches)
    step = GraphedStep(lambda p: loss_fn(p, xg, ng, target), pg)
    counted = (WARMUP_PASSES + 1, WARMUP_PASSES + 1)

    def replay():
        for q in pg.parameters():
            q.grad.zero_()
        return step.replay()

    assert _bits_equal(replay(), want[0]) and _bits_equal(grads(pg), want[1])
    with torch.no_grad():
        pg.M.fill_(1.06)
    assert _bits_equal(replay(), moved[0])
    assert _bits_equal(grads(pg), moved[1])
    assert not _bits_equal(moved[0], want[0])
    assert (C.pixel_rays_cuda.launches - before[0],
            C.pixel_rays_vjp_cuda.launches - before[1]) == counted


def _shade_case(case):
    """(scene, x, temp, freq) of a K11/K12 case on the card: K1's end
    states of example2 at 32x32 (shared fields, x in K1's [B, 8] rows; or
    pos per ray and x in the training path's [8, B] planes), config 5's
    lensing scene at 4 starts of 16x16 (each start's sphere per ray, soft
    at frequency 2), or the accretion disk at 24x24 (every field per ray)."""
    from raytracegr_jl_tpu_torch.ops.adjoint import per_ray
    name, dtype, mode = case
    dev = torch.device("cuda")
    tol = float(torch.finfo(dtype).eps) ** 0.75
    temp = 0.05 if mode == "soft" else None
    spec, integ = {
        "example2": (T.example2_spec(32, 32), T.IntegratorConfig(
            rtol=tol, atol=tol, max_steps=20_000)),
        "planes": (T.example2_spec(32, 32), T.IntegratorConfig(
            rtol=tol, atol=tol, max_steps=20_000)),
        "grouped": (T.lensing_inverse_spec(16, 16), T.IntegratorConfig(
            method="rk4", rk4_dt=0.5, max_steps=120, lam_max=60.0,
            stop_rho=0.5)),
        "disk": (T.accretion_disk_spec(24, 24), T.IntegratorConfig(
            rtol=tol, atol=tol, max_steps=400, stop_rho=1.0))}[name]
    metric, scene, canvas = T.build(spec, dtype, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    y = integrate_rays_cuda(metric, scene, y0, None, integ).y
    B = y.shape[0]
    if name == "example2":
        return scene, y[:, :4], temp, 12.0
    if name == "planes":
        return (scene._replace(pos=per_ray(scene.pos[None], B)),
                y.t().contiguous().t()[:, :4], temp, 12.0)
    if name == "grouped":
        pos = scene.pos.expand(4, -1, -1).clone()
        pos[:, 0, 3] = torch.tensor([-0.03, -0.01, 0.01, 0.03], dtype=dtype,
                                    device=dev)
        return (scene._replace(pos=per_ray(pos, B)),
                y.repeat(4, 1).t().contiguous().t()[:, :4], temp, 2.0)
    ramp = 1 + 1e-3 * torch.arange(B, dtype=dtype, device=dev)[:, None] / B
    return scene._replace(**{
        f: (getattr(scene, f)[None] * (ramp[..., None] if f == "pos"
                                        else ramp)).contiguous()
        for f in ("pos", "radius", "time", "r_in", "r_out", "half")}), \
        y[:, :4], temp, 12.0


@pytest.mark.parametrize("case", [
    (name, dtype, mode)
    for name in ("example2", "planes", "grouped", "disk")
    for dtype in (torch.float32, torch.float64)
    for mode in ("hard", "soft") if not (name == "grouped" and mode == "hard")],
    ids=lambda c: f"{c[0]}-{str(c[1])[6:]}-{c[2]}")
def test_k11_k12_match_plain_bitwise(case):
    """K11 against ``shade`` / ``shade_soft`` and K12 against
    ``shade_vjp`` / ``shade_soft_vjp`` on the same CUDA tensors, bit for
    bit, every field's per-ray cotangent (every ninth ray's cotangent
    zero, whose outputs are exact zeros); a field left out is not
    written. Hard: K11 keeping its record equals ``shade_record``, K12
    reads it (without one it raises), and ``shade_vjp`` given it equals
    the recomputing plain VJP."""
    from raytracegr_jl_tpu_torch.models import objects as O
    scene, x, temp, freq = _shade_case(case)
    gen = torch.Generator(device=x.device).manual_seed(5)
    ct = torch.randn((x.shape[0], 3), generator=gen, dtype=x.dtype,
                     device=x.device)
    ct[::9] = 0
    before = (O.shade_cuda.launches, O.shade_vjp_cuda.launches)
    rgb, rec = O.shade_cuda(scene, x, temp=temp, color_freq=freq)
    assert rec is None
    if temp is None:
        rgb_r, rec = O.shade_cuda(scene, x, color_freq=freq, record=True)
        assert _bits_equal(rgb_r, rgb)
        assert torch.equal(rec, O.shade_record(scene, x))
        with pytest.raises(ValueError, match="record"):
            O.shade_vjp_cuda(scene, x, ct)
    got = O.shade_vjp_cuda(scene, x, ct, temp=temp, color_freq=freq,
                           rec=rec)
    only = O.shade_vjp_cuda(scene, x, ct, temp=temp, color_freq=freq,
                            fields=("radius",), rec=rec)
    torch.cuda.synchronize()
    assert (O.shade_cuda.launches - before[0],
            O.shade_vjp_cuda.launches - before[1]) == (
                1 + (temp is None), 2)
    if temp is None:
        want_rgb, want = O.shade(scene, x), O.shade_vjp(scene, x, ct)
        given = O.shade_vjp(scene, x, ct, rec=rec)
        assert _bits_equal(given[0], want[0])
        for f in O.SHADE_FIELDS:
            assert _bits_equal(given[1][f], want[1][f]), f
    else:
        want_rgb = O.shade_soft(scene, x, temp=temp, color_freq=freq)
        want = O.shade_soft_vjp(scene, x, ct, temp=temp, color_freq=freq)
    assert bool(torch.isfinite(rgb).all())
    assert _bits_equal(rgb, want_rgb)
    assert _bits_equal(got[0], want[0])
    for f in O.SHADE_FIELDS:
        assert _bits_equal(got[1][f], want[1][f]), f
    assert _bits_equal(only[0], want[0]) and list(only[1]) == ["radius"]
    assert _bits_equal(only[1]["radius"], want[1]["radius"])
    assert not got[0][::9].any()


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_train_step_shades_through_k11_k12(soft, monkeypatch):
    """One training step at example2 16x16 f64 rk4/40 on the card: the
    shading launches K11 once and K12 once; the loss equals the one with
    the plain shading under autograd bitwise and the gradients agree
    within 1e-10."""
    from raytracegr_jl_tpu_torch import render
    from raytracegr_jl_tpu_torch.models import objects as O
    dev = torch.device("cuda")
    f64 = torch.float64
    spec = T.example2_spec(16, 16)
    cfg = T.default_inverse_cfg(f64, max_steps=40, rk4_dt=2.5, stop_rho=0.5,
                                soft_temp=0.05 if soft else None)
    xg, ng = T.flat_pixel_grid(spec, f64, dev)
    with torch.no_grad():
        target = T.make_ray_render_for_params(spec, cfg, 2, f64, dev)(
            T.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f64, dev), xg,
            ng)

    def step():
        p = T.InverseParams(1.05, 0.0, [0.0, 4.0, 0.1, 0.0], f64, dev)
        loss = T.make_ray_loss_fn(spec, cfg, 2, f64, dev)(p, xg, ng, target)
        loss.backward()
        return loss.detach(), torch.cat([p.M.grad[None], p.a.grad[None],
                                         p.sphere_pos.grad])

    before = (O.shade_cuda.launches, O.shade_vjp_cuda.launches)
    loss, g = step()
    assert (O.shade_cuda.launches - before[0],
            O.shade_vjp_cuda.launches - before[1]) == (1, 1)

    def plain(scene, x, hit_dmin, temp, freq):
        if temp is None:
            return O.shade(scene, x, hit_dmin)
        return O.shade_soft(scene, x, hit_dmin, temp, color_freq=freq)

    monkeypatch.setattr(render, "shade_reference", plain)
    loss_p, g_p = step()
    assert _bits_equal(loss, loss_p)
    assert float((g - g_p).abs().max()) <= 1e-10 * float(g_p.abs().max())


def test_render_shades_through_k11(monkeypatch):
    """render_fn on the card shades with one K11 launch, which keeps no
    record, bitwise the plain ``shade`` of K1's end states."""
    from raytracegr_jl_tpu_torch.models import objects as O
    metric, scene, canvas = T.build(T.example2_spec(24, 24), torch.float32,
                                    torch.device("cuda"))
    cfg = T.RenderConfig(integrator=T.IntegratorConfig(
        rtol=TOL32, atol=TOL32, max_steps=20_000))
    k11 = O.shade_cuda
    kept = []

    def spy(*args):
        out = k11(*args)
        kept.append(out[1] is not None)
        return out

    before = spy.launches = k11.launches
    monkeypatch.setattr(O, "shade_cuda", spy)
    rgb = T.render_fn(metric, scene, cfg)(canvas.pos, canvas.normal)
    k11.launches = spy.launches
    monkeypatch.setattr(O, "shade_cuda", k11)
    assert O.shade_cuda.launches == before + 1 and kept == [False]
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    y = integrate_rays_cuda(metric, scene, y0, None, cfg.integrator).y
    assert _bits_equal(rgb.reshape(-1, 3), O.shade(scene, y[:, :4]))


def test_records_on_two_streams_and_under_capture():
    """K11's record, a tensor of its own call: K8/K9 and K11/K12 launched
    on two streams without a sync, each stream with its own spin and end
    positions, and captured in one CUDA graph, each equal their launches
    run alone."""
    from raytracegr_jl_tpu_torch.models import camera as C
    from raytracegr_jl_tpu_torch.models import objects as O
    cams = [_camera_batch(("example2", 200, torch.float32, 0.0)),
            _camera_batch(("example2", 200, torch.float32, 0.6))]
    shades = [_shade_case(("planes", torch.float32, "hard")),
              _shade_case(("example2", torch.float32, "hard"))]

    cts = []
    for k in (0, 1):
        pos, x = cams[k][1], shades[k][1]
        gen = torch.Generator(device=pos.device).manual_seed(k)
        cts.append((torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                                device=pos.device),
                    torch.randn((x.shape[0], 3), generator=gen,
                                dtype=x.dtype, device=x.device)))

    def run(k):
        metric, pos, normal = cams[k]
        scene, x, _, _ = shades[k]
        ct_u, ct = cts[k]
        u = C.pixel_rays_cuda(metric, pos, normal)
        rgb, srec = O.shade_cuda(scene, x, record=True)
        return (u, C.pixel_rays_vjp_cuda(metric, pos, normal, ct_u),
                rgb, *O.shade_vjp_cuda(scene, x, ct, fields=("pos",),
                                       rec=srec)[:1])

    want = [run(0), run(1)]
    torch.cuda.synchronize()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s1):
        got0 = [run(0) for _ in range(3)]
    with torch.cuda.stream(s2):
        got1 = [run(1) for _ in range(3)]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        caught = run(1)
    graph.replay()
    torch.cuda.synchronize()
    assert not _bits_equal(want[0][1], want[1][1])
    for k, runs in ((0, got0), (1, got1 + [caught])):
        for got in runs:
            assert all(_bits_equal(g, w) for g, w in zip(got, want[k]))


def test_graphed_config5_multistart_with_k11_k12_matches_eager():
    """Config 5's vectorized multistart (4 starts at 16x16, soft shading)
    captured as one CUDA graph: the replay's losses and gradients equal
    the eager step's bitwise, also after the poses change in place (K11
    and K12 read the per-ray fields by pointer); K11 and K12 are counted
    in the warm-ups and the capture only."""
    from raytracegr_jl_tpu_torch.models import objects as O
    from raytracegr_jl_tpu_torch.step_graph import (WARMUP_PASSES,
                                                    GraphedStep)
    spec, cfg, target, _ = _config5(16)
    dev = torch.device("cuda")
    f32 = torch.float32
    loss_fn = T.make_multistart_loss_fn(spec, target, cfg, 0, f32, dev)

    def params(dz=0.0):
        return T.InverseParams(
            torch.tensor([0.53, 0.47, 0.5, 0.51]), torch.zeros(4),
            torch.tensor([[0.0, 5.0, 12.0, 0.03 + dz], [0.0, 5.0, 12.0, -0.04],
                          [0.0, 5.0, 12.0, 0.0], [0.0, 5.0, 12.0, 0.01]]),
            f32, dev)

    def grads(p):
        return torch.cat([p.M.grad, p.a.grad, p.sphere_pos.grad.reshape(-1)])

    def eager(dz=0.0):
        p = params(dz)
        loss = loss_fn(p).sum()
        loss.backward()
        return loss.detach(), grads(p)

    want, moved = eager(), eager(0.01)
    pg = params()
    before = (O.shade_cuda.launches, O.shade_vjp_cuda.launches)
    step = GraphedStep(lambda p: loss_fn(p).sum(), pg)

    def replay():
        for q in pg.parameters():
            q.grad.zero_()
        return step.replay()

    assert _bits_equal(replay(), want[0]) and _bits_equal(grads(pg), want[1])
    with torch.no_grad():
        pg.sphere_pos.copy_(params(0.01).sphere_pos)
    assert _bits_equal(replay(), moved[0])
    assert _bits_equal(grads(pg), moved[1])
    assert not _bits_equal(moved[0], want[0])
    assert (O.shade_cuda.launches - before[0],
            O.shade_vjp_cuda.launches - before[1]) == (WARMUP_PASSES + 1,) * 2
