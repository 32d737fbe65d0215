"""Before and after on one card: the port's kernel times, and K2's
packed-tail diagnosis, for any checkout of the repo (this one, or an older
one unpacked with ``git archive`` into an ignored directory), so that two
versions can be compared in one run on one card.

    python3 kernel_times.py times [--tree DIR] [--out FILE]
    python3 kernel_times.py diagnose [--tree DIR] [--out FILE]
    python3 kernel_times.py diagnose-k1 [--tree DIR] [--out FILE]
    python3 kernel_times.py k4 [--tree DIR] [--out FILE]
    python3 kernel_times.py k4-kernel [--tree DIR] [--out FILE]
    python3 kernel_times.py sass [--tree DIR] [--libs A,B] [--out FILE]
    python3 kernel_times.py shade [--tree DIR] [--alone] [--out FILE]
    python3 kernel_times.py camera [--tree DIR] [--alone] [--out FILE]
    python3 kernel_times.py localize [--tree DIR] [--out FILE]
    python3 kernel_times.py digests [--tree DIR] [--out FILE]
    python3 kernel_times.py k5 [--tree DIR] [--out FILE]
    python3 kernel_times.py compare-images A.images.pt B.images.pt

``times``: medians of 5, with CUDA events, of the kernels and paths at the
main paths' shapes: K2 on the 1024x1024 disk (chunks summed, and the last
chunk alone; with the detection gate on and off), the compacted disk
render, K1 on example2 at 200x200 and 1024x1024 (the kernel alone from the
profiler, the call as the tree's render_fn makes it, the call given dt0,
the render), K3 (its launches of a forward pass summed), K4, and K6 and
K7 where the tree has them (in events and alone from the profiler) in the
rk4/200 and tsit5/48 training steps at 200x200 f32, and K8 and K9 (the
camera) where the tree has them; those steps end to
end, eager and as a graph replay in turns, with the replay's device ms,
kernels and K8/K9 launches (profiler), the eager step's loss to the last
bit and a digest of its gradients, and the
memory the steps take; and an
Adam step of config 5 (32x32 f32) at 1, 4 and 16 starts, eager and
graphed in turns, with the graphed step's device ms and kernels and each
start's first loss to the last bit and a digest of the first gradients.

``k4``: K4's diagnosis (``k4_times``: its f32 RK4 kernels' ptxas lines
and SASS mix; K4 alone at rk4/200 and tsit5/48 on the training batch, on
that batch pre-permuted by end segment, cut and replicated; grouped at
config 5 at 1, 4 and 16 starts with its bound), then the training
steps and config 5's Adam steps as ``times`` gives them. Builds only the
libraries those paths run. ``k4-kernel``: the diagnosis alone (builds
only the adjoint library).

``diagnose-k1``: chip_smoke.py's diagnosis of K1 (``diagnose_k1``: its
time four ways, the step census, warp-iterations, scheduler cycles per
warp-iteration, the capped runs, torch.mean's order, a profile of one
rk4/200 forward pass of the training path), with K1's ptxas and SASS
lines.

``compare-images`` (the CPU suffices): two trees' ``times`` images
(``<out>.images.pt``): each training configuration's and config 5's
starts' losses, their gap, and the pixels that differ and that flip
(``compare_images``), which tell a loss that moved by rounding from one
that moved because a few pixels crossed an edge.

``sass``: for every kernel of the tree's libraries (those of ``--libs
a,b`` where it is given), its ``ptxas -v`` line (registers, stack,
spills) and its static SASS: the count of instructions and a digest of
their text, so that two trees' builds of a kernel can be told identical or
not (the ungrouped K3 and K4 of a tree with grouped variants against the
parent's; K5 against the parent's after its code moved into a header).

``shade``: K11 and K12 alone (``shade_times``: on the training batch,
K12 also on misses only and with a zero cotangent, beside a copy over its
bytes and the launch floor; on config 5's batches at 1, 4 and 16 starts;
alone and per launch in a graph of 100; each tree's K11 keeping its
record and K12 reading it where the tree has one), then the 200x200
render (K1, the render, K11 alone where the tree has it), the training
steps (with K11 and K12 alone where the tree has them) and config 5's
Adam steps as ``times`` gives them; builds only the libraries those run.
``--alone``: the kernels alone only (builds geodesic, camera, objects).

``camera``: K8 and K9 alone and per launch in a graph of 100 on the
training batch and config 5's at 1, 4 and 16 starts, beside the launch
floor (a one-element fill), with digests of their outputs; the camera
library's ptxas lines and the SASS mix of K8 and K9 (K8's is the forward
the parent's K9 recomputes); then K9's and K12's calls in the rk4/200
training step: the kernels each call launches and their device time,
its tensors' strides, and in a graphed replay the kernel's time and the
kernel just before it (``replay_calls``). ``--alone``: the kernels
alone only.

``localize``: K6 and K7 alone (profiler, medians of 5) on the final
states of the rk4/200 and tsit5/48 training batches at 200x200 f32 (all
40,000 rays and their first 33,792, 264 blocks of 128: two an SM) and of
config 5's grouped batch at 1, 4 and 16 starts (32x32 f32 rk4/120), with
digests of their outputs, so that two trees' kernels can be held bitwise
to each other, and the localize library's ptxas lines. Builds only the
libraries those run (adjoint, localize, camera).

``digests``: the flagship render's image (200x200 f32) and K5's colours
on K1's end states of the disk (256x256, f32 and f64) as digests of their
bytes, to hold two trees' outputs bitwise to each other.

``k5``: K5 and the disk render, then K4's work order (``k5_times``,
``order_times``): K5 alone (profiler, medians of 5) on the 1024x1024 f32
disk's end states as the render holds them, as contiguous rows, in the
impact-parameter order, and on batches of its hit rays only and of its
misses only (each replicated to the image's size); a copy over the same
bytes (the card's floor); the wrapper's call in events; the share of hit
rays and of warps that mix hits and misses or the objects' kinds, in the
caller's and the sorted order; K5's ptxas lines and static SASS mix; the
compacted render (``make_compact_renderer``) by default and with
``fast_epilogue``; the digest of K5's colours and, where the tree's
redshift shading is bitwise (its plain version's sums written left to
right), K5 against it. The work order on the rk4/200 and tsit5/48
training batches' ends (40,000 rays), their first 20,000 (a rank of the
sharded W = 2 step), config 5's grouped batches at 1, 4 and 16 starts and
1,048,576 random ends: the device time summed over its kernels and from
its first kernel's start to its last one's end (profiler), the call in
events, the stable ``torch.argsort`` beside it, equality with it, and its
bytes bound. Builds only the libraries these run; ``--libs
compaction,shading,camera`` times K5 alone, ``--libs adjoint,camera`` the
work order alone.

``diagnose``: chip_smoke.py's diagnosis of the tree's kernels: the
``ptxas -v`` lines of every kernel, the static SASS instruction mix of
K2's resumed and K4's f32 Kerr-Schild Tsit5 kernels ("not measured" where
the toolkit has no cuobjdump), and K2 on the disk's packed tail replicated
and cut at a fixed budget (the block sizes are chip_smoke.py's, for this
tree's kernels only).

Prints one JSON line per result; with ``--out`` also writes them to a file.
Uses chip_smoke.py's helpers (of this checkout) on the tree's package.
Needs a CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import os
import statistics
import subprocess
import sys
import threading
import time

from chip_smoke import (INV_N, LIBRARIES, PEAK_BYTES, REPEATS, RTOL_F32,
                        adam_steps, adjoint_work, cam_cotangent, camera_cases,
                        config5_starts, cuda_ms, cuda_tool, demangle,
                        diagnose_k1, diagnose_tail, disk_setup, graph_ms,
                        in_turns, instruction_mix, inverse_case, k1_entry,
                        k1_main_call, k1_takes_own_step, k3_forward_ms,
                        k3_pass, k4_walk, kept_calls, kernel_alone_ms,
                        loc_cotangents, profile_steps, profiled_kernels,
                        ptxas_report, require, sass_report, shade_cases,
                        shade_cotangent, shade_end_states, short_name,
                        state_ct, summed_ms, timed_calls)


# The libraries named by --libs (all where None).
ONLY = None


def libraries() -> list:
    """The libraries of chip_smoke.py's list whose source the tree has (an
    older tree lacks the later ones), those of --libs where it is given."""
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    return [n for n in LIBRARIES
            if os.path.exists(os.path.join(cb.CSRC, f"{n}.cu"))
            and (ONLY is None or n in ONLY)]


def emit(out: list, kind: str, **fields) -> None:
    rec = dict(kind=kind, **fields)
    out.append(rec)
    print(json.dumps(rec), flush=True)


def diagnose(out: list, dev, card: str) -> None:
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    for name in libraries():
        for kern, regs, stack, st, ld in ptxas_report(cb.build_log(name)):
            emit(out, "ptxas", library=name, kernel=kern, registers=regs,
                 stack_bytes=stack, spill_stores=st, spill_loads=ld)
    for lib, kern, counts in sass_report():
        emit(out, "sass", library=lib, kernel=kern, mix=counts)
    for rec in diagnose_tail(dev, block_sizes=()):
        emit(out, rec.pop("kind"), card=card, **rec)


def sass_digests(out: list, dev, card: str) -> None:
    """Each kernel's ptxas line, and its SASS instruction count and the
    digest of its instructions' text (addresses and encodings left out)."""
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    tool = cuda_tool("cuobjdump")
    for name in libraries():
        for kern, regs, stack, st, ld in ptxas_report(cb.build_log(name)):
            emit(out, "ptxas", library=name, kernel=kern, registers=regs,
                 stack_bytes=stack, spill_stores=st, spill_loads=ld)
        if tool is None:
            emit(out, "sass", library=name,
                 digest="not measured (no cuobjdump)")
            continue
        sass = subprocess.run([tool, "-sass", cb._paths(name)[1]],
                              capture_output=True, text=True).stdout
        funcs, cur = {}, None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                cur = m.group(1)
                funcs[cur] = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m and cur is not None:
                funcs[cur].append(" ".join(m.group(1).split()))
        for mangled, kern in zip(list(funcs), demangle(list(funcs))):
            text = "\n".join(funcs[mangled]).encode()
            emit(out, "sass", library=name, kernel=short_name(kern),
                 instructions=len(funcs[mangled]),
                 digest=hashlib.sha256(text).hexdigest()[:16])


def diagnose_k1_times(out: list, dev, card: str) -> None:
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    for kern, regs, stack, st, ld in ptxas_report(cb.build_log("geodesic")):
        emit(out, "ptxas", library="geodesic", kernel=kern, registers=regs,
             stack_bytes=stack, spill_stores=st, spill_loads=ld)
    for lib, kern, counts in sass_report():
        if lib == "geodesic":
            emit(out, "sass", library=lib, kernel=kern, mix=counts)
    for rec in diagnose_k1(dev, card):
        emit(out, rec.pop("kind"), **rec)


def times(out: list, dev, card: str) -> None:
    import torch
    from raytracegr_jl_tpu_torch import compaction as C

    # The disk: the compacted render, K2 per chunk (summed, and the last).
    cfg, metric, scene, canvas, y0, dt0 = disk_setup(dev)
    integ = cfg.integrator
    render = C.make_compact_renderer(metric, scene, cfg)
    render_ms = cuda_ms(lambda: render(canvas))
    runs = []
    for _ in range(REPEATS + 1):
        with timed_calls(C, "chunk_cuda") as pairs:
            C.trace_batch_compacted(metric, scene, y0, dt0, integ)
        torch.cuda.synchronize()
        runs.append([a.elapsed_time(b) for a, b in pairs])
    runs = runs[1:]
    gate = []
    for _ in range(REPEATS + 1):
        with timed_calls(C, "chunk_cuda") as pairs:
            C.trace_batch_compacted(metric, scene, y0, dt0,
                                    integ._replace(event_gate=True))
        gate.append(summed_ms(pairs))
    emit(out, "time", card=card, what="disk 1024x1024 f32",
         k2_ms_all_chunks_gate_on=statistics.median(gate[1:]),
         render_ms=render_ms,
         k2_ms_all_chunks=statistics.median(sum(r) for r in runs),
         k2_ms_last_chunk=statistics.median(r[-1] for r in runs),
         k2_ms_per_chunk=[statistics.median(r[i] for r in runs)
                          for i in range(len(runs[0]))])

    render_times(out, dev, card, (200, 1024))
    train_times(out, dev, card)
    config5_times(out, dev, card)


def render_times(out: list, dev, card: str, sizes) -> None:
    """K1 on example2 (the bench configuration) at each size: the kernel
    alone (profiler; given dt0, and taking its own initial step where it
    can), the call as render_fn makes it, the call given dt0 with its
    launch set up anew, and the render; K11 alone on K1's end states where
    the tree has it."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models import objects
    from raytracegr_jl_tpu_torch.models.scenes import build, example2_spec
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    from raytracegr_jl_tpu_torch.render import initial_dt

    f32 = torch.float32
    bench = rt.IntegratorConfig(method="tsit5", rtol=RTOL_F32, atol=RTOL_F32,
                                max_steps=20_000)
    for n in sizes:
        metric, scene, canvas = build(example2_spec(n, n), f32, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        dt0 = initial_dt(metric, y0, bench)
        fn = rt.render_fn(metric, scene, rt.RenderConfig(integrator=bench))
        rec = dict(
            k1_kernel_ms=kernel_alone_ms(
                k1_entry(metric, scene, bench, y0, dt0), "k1_kernel"),
            k1_main_call_ms=cuda_ms(k1_main_call(metric, scene, y0, dt0,
                                                 bench)),
            k1_ms=cuda_ms(lambda: integrate_rays_cuda(metric, scene, y0,
                                                      dt0, bench)),
            render_ms=cuda_ms(lambda: fn(canvas.pos, canvas.normal)))
        if k1_takes_own_step():
            rec["k1_kernel_own_step_ms"] = kernel_alone_ms(
                k1_entry(metric, scene, bench, y0, None), "k1_kernel")
        if hasattr(objects, "shade_cuda"):
            x = integrate_rays_cuda(metric, scene, y0, None, bench).y[:, :4]
            k11 = lambda: objects.shade_cuda(scene, x)  # noqa: E731
            rec.update(k11_ms=cuda_ms(k11),
                       k11_device_ms=kernel_alone_ms(k11, "k11_kernel"))
        emit(out, "time", card=card, what=f"K1 example2 {n}x{n} f32", **rec)


def train_route(dev, method: str, steps: int):
    """The K3/K4 route of the training step at 200x200 f32 (example2,
    M = 1.05, the bench's configuration ``method/steps``), its launch
    states ``[8, B]`` and its launch arguments."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    from raytracegr_jl_tpu_torch.models.scenes import build, example2_spec
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    f32 = torch.float32
    spec = example2_spec(200, 200)
    integ = rt.default_inverse_cfg(f32, max_steps=steps, method=method,
                                   rk4_dt=100.0 / steps,
                                   stop_rho=0.5).integrator
    xg, ng = rt.flat_pixel_grid(spec, f32, dev)
    M = torch.tensor(1.05, dtype=f32, device=dev)
    a = torch.tensor(0.0, dtype=f32, device=dev)
    metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(M, a),
                            rho_min=max(1e-3, 0.5 * integ.stop_rho))
    _, scene, _ = build(spec, f32, dev)
    seg = adj.segment_length(integ, integ.grad_seg_len)
    route = adj.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                      n_seg=integ.max_steps // seg, cuda=True)
    with torch.no_grad():
        x, u = pixel_rays(metric, xg, ng)
        ys = torch.cat([x, u], -1).t().contiguous()
    return route, ys, adj.launch_args(route, ys)


def train_times(out: list, dev, card: str) -> None:
    """The training steps at 200x200 f32, rk4/200 and tsit5/48: eager and
    graphed in turns, the replay's device ms and kernels, the eager loss's
    bits; the memory they take (``memory``: the allocator's peak in the
    eager steps, in the capture and in the steps in turns, what it holds
    reserved after them, and the card's memory in use, which also counts
    the CUDA context and the local memory CUDA keeps for the
    kernels' stacks); K3 summed and alone, K4, K10 (where the tree has
    it), K6 and K7."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models import camera as cam
    from raytracegr_jl_tpu_torch.models import objects
    from raytracegr_jl_tpu_torch.models.scenes import example2_spec
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    f32 = torch.float32
    spec = example2_spec(200, 200)
    truth = rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    xg, ng = rt.flat_pixel_grid(spec, f32, dev)
    for label, method, steps in (("rk4/200", "rk4", 200),
                                 ("tsit5/48", "tsit5", 48)):
        tcfg = rt.default_inverse_cfg(f32, max_steps=steps, method=method,
                                      rk4_dt=100.0 / steps, stop_rho=0.5)
        render = rt.make_ray_render_for_params(spec, tcfg, 2, f32, dev)
        with torch.no_grad():
            target = render(truth, xg, ng)
        loss_fn = rt.make_ray_loss_fn(spec, tcfg, 2, f32, dev)

        def params():
            return rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32,
                                    dev)

        with torch.no_grad():
            IMAGES[f"train {label}"] = dict(
                render=render(params(), xg, ng)[None].cpu(),
                target=target.cpu())

        def step(keep=None):
            p = params()
            loss = loss_fn(p, xg, ng, target)
            loss.backward()
            if keep is not None:
                keep.append(p)
            return loss

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = cuda_ms(step)
        kept = []
        loss_hex = float(step(kept).detach()).hex()
        mem = {"eager_peak_mib": peak_mib(dev)}
        graphed = graphed_step(lambda q: loss_fn(q, xg, ng, target), params)
        mem["capture_peak_mib"] = peak_mib(dev)
        turns = in_turns({"eager": step, "graphed": graphed})
        mem["in_turns_peak_mib"] = peak_mib(dev)
        free, total = torch.cuda.mem_get_info(dev)
        mem.update(reserved_mib=torch.cuda.memory_reserved(dev) / 2**20,
                   device_used_mib=(total - free) / 2**20)
        prof = profile_steps(graphed)
        route, ys, args = train_route(dev, method, steps)
        metric = route.metric

        k3_runs = [k3_forward_ms(route, ys, args)
                   for _ in range(REPEATS + 1)][1:]
        _, ck, used = k3_runs[0]
        ct = state_ct(ys)
        walk = k4_walk(used)
        k4_ms = cuda_ms(lambda: adj.backward_cuda(route, ck, walk, ct, args))
        k3_kernels = profiled_kernels(lambda: k3_pass(route, ys, args),
                                      ("k3_kernel", "k3_close"))
        loc = {}
        if hasattr(adj, "init_vjp_cuda"):
            pb = torch.zeros((ys.shape[1], 2), dtype=f32, device=dev)
            k10 = lambda: adj.init_vjp_cuda(  # noqa: E731
                route, ck, ct, pb, args)
            loc.update(k10_ms=cuda_ms(k10),
                       k10_device_ms=kernel_alone_ms(k10, "k10_kernel"))
        if hasattr(cam, "pixel_rays_cuda"):
            ct_u = cam_cotangent(xg)
            k8 = lambda: cam.pixel_rays_cuda(metric, xg, ng)  # noqa: E731
            k9 = lambda: cam.pixel_rays_vjp_cuda(  # noqa: E731
                metric, xg, ng, ct_u)
            loc.update(k8_ms=cuda_ms(k8), k9_ms=cuda_ms(k9),
                       k8_device_ms=kernel_alone_ms(k8, "k8_kernel"),
                       k9_device_ms=kernel_alone_ms(k9, "k9_kernel"))
        if hasattr(objects, "shade_cuda"):
            x = ck[route.n_seg][:4].t()
            sc = route.scene._replace(pos=adj.per_ray(route.scene.pos[None],
                                                      x.shape[0]))
            ct_rgb = torch.ones((x.shape[0], 3), dtype=f32, device=dev)
            kw = ({"rec": objects.shade_cuda(sc, x, record=True)[1]}
                  if takes_record(objects.shade_vjp_cuda) else {})
            k11 = lambda: objects.shade_cuda(sc, x)  # noqa: E731
            k12 = lambda: objects.shade_vjp_cuda(  # noqa: E731
                sc, x, ct_rgb, fields=("pos",), **kw)
            loc.update(k11_ms=cuda_ms(k11), k12_ms=cuda_ms(k12),
                       k11_device_ms=kernel_alone_ms(k11, "k11_kernel"),
                       k12_device_ms=kernel_alone_ms(k12, "k12_kernel"))
        if hasattr(adj, "localize_cuda"):
            P = ck[route.n_seg].contiguous()
            ct_y, ct_lam = loc_cotangents(P)
            k6, k7 = loc_calls(route, P, ct_y, ct_lam)
            loc.update(k6_ms=cuda_ms(k6), k7_ms=cuda_ms(k7),
                       k6_device_ms=kernel_alone_ms(k6, "k6_kernel"),
                       k7_device_ms=kernel_alone_ms(k7, "k7_kernel"))
        emit(out, "time", card=card, what=f"train {label} 200x200 f32",
             step_ms=step_ms, eager_step_ms_in_turns=turns["eager"],
             graphed_step_ms=turns["graphed"],
             replay_device_ms=prof["busy_ms"],
             replay_kernels=prof["kernels"],
             replay_k8_k9=(prof["k8"], prof["k9"]),
             replay_k11_k12=(prof["k11"], prof["k12"]), loss_hex=loss_hex,
             grad_digest=grad_digest(kept[0]),
             k3_ms_all_segments=statistics.median(r[0] for r in k3_runs),
             k3_device_ms_per_pass=sum(b - a for _, a, b in k3_kernels)
             / 1e3 / REPEATS, segments=int(used[0]), k4_ms=k4_ms,
             memory=mem, **loc)


def loc_calls(route, P, ct_y, ct_lam):
    """The tree's K6 and K7 on the final state ``P`` as two calls, K7 given
    K6's record where the tree's K6 keeps one (older trees' K7 replays)."""
    import inspect
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    args = adj.localize_args(route, P)
    k6 = lambda: adj.localize_cuda(route, P, args)  # noqa: E731
    if "rec" not in inspect.signature(adj.localize_vjp_cuda).parameters:
        return k6, lambda: adj.localize_vjp_cuda(route, P, ct_y, ct_lam,
                                                 args)
    rec = k6()[2]
    return k6, lambda: adj.localize_vjp_cuda(route, P, ct_y, ct_lam, rec,
                                             args)


# K6 and K7 on a full wave: 264 blocks of 128 threads, two an SM.
LOC_WAVE = 264 * 128
LOC_LIBRARIES = ("adjoint", "localize", "camera")


def localize_times(out: list, dev, card: str) -> None:
    """``localize``: the localize library's ptxas lines; K6 and K7 alone
    (profiler) on the training batches' final states, whole and cut to
    ``LOC_WAVE`` rays, and on config 5's at 1, 4 and 16 starts; the
    digests of their outputs (K6's y and lam, K7's ct_P and pbar)."""
    import torch
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    for kern, regs, stack, st, ld in ptxas_report(cb.build_log("localize")):
        emit(out, "ptxas", library="localize", kernel=kern, registers=regs,
             stack_bytes=stack, spill_stores=st, spill_loads=ld)
    cases = []
    for label, method, steps in (("rk4/200", "rk4", 200),
                                 ("tsit5/48", "tsit5", 48)):
        route, ys, args = train_route(dev, method, steps)
        ck, _ = k3_pass(route, ys, args)
        P = ck[route.n_seg].contiguous()
        cases.append((f"train {label} 200x200 f32", route, P))
        cases.append((f"train {label} 200x200 f32 first {LOC_WAVE} rays",
                      route, P[:, :LOC_WAVE].contiguous()))
    for n in (1, 4, 16):
        _, grouped, y0 = inverse_case(dev, torch.float32, "rk4",
                                      starts=config5_starts(n))
        ck, _ = k3_pass(grouped, y0)
        cases.append((f"config 5 {n} starts rk4/120 32x32 f32", grouped,
                      ck[grouped.n_seg].contiguous()))
    for what, route, P in cases:
        ct_y, ct_lam = loc_cotangents(P)
        k6, k7 = loc_calls(route, P, ct_y, ct_lam)
        y, lam = k6()[:2]
        ct_P, pbar = k7()
        hit = P[adj.P_HIT] > 0
        live = hit & ((ct_y != 0).any(0) | (ct_lam != 0))
        k6_ms = kernel_alone_ms(k6, "k6_kernel")
        k7_ms = kernel_alone_ms(k7, "k7_kernel")
        emit(out, "localize", card=card, what=what, rays=P.shape[1],
             hits=int(hit.sum()), live=int(live.sum()),
             k6_device_ms=k6_ms, k7_device_ms=k7_ms,
             pair_device_ms=None if None in (k6_ms, k7_ms) else k6_ms + k7_ms,
             k6_digest=digest(torch.cat([y, lam[None]])),
             k7_digest=digest(torch.cat([ct_P, pbar])))


# The images behind the steps' losses (``times``): each training
# configuration's render at the step's parameters and its target, and
# config 5's 16 starts' renders and target, written beside ``--out`` as
# ``<out>.images.pt`` for ``compare-images``.
IMAGES = {}
# A pixel flips where a channel moves by more than this between two trees
# (a hit or miss, or a checker edge, crossed), not by rounding.
FLIP = 0.05


def on_edge(a, flip):
    """Of the pixels ``flip`` (a square image's ``[n, n]`` mask), those on
    an edge of image ``a`` (``[n, n, 3]``): a neighbour (of the 8) differs
    from the pixel by more than ``FLIP``, as across a silhouette or a
    checker line, where a ray that moves a little may cross."""
    import torch.nn.functional as F
    n = a.shape[0]
    pad = F.pad(a.permute(2, 0, 1), (1, 1, 1, 1), value=float("nan"))
    edge = False
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            nb = pad[:, dy:dy + n, dx:dx + n].permute(1, 2, 0)
            edge = edge | ((nb - a).abs() > FLIP).any(-1)
    return flip & edge


def compare_images(a_path: str, b_path: str) -> list:
    """``compare-images A B`` (CPU): two trees' ``times`` images. Per
    configuration (and per start of config 5): the pixel-MSE loss of each
    (float64 over the f32 images) and their relative gap, the pixels that
    differ at all and that flip (``FLIP``, in the render or the target),
    those of them on an edge of the image (``on_edge``, in the render and
    the target), and the loss over the pixels that flip in neither, with
    its gap."""
    import torch
    A, B = torch.load(a_path), torch.load(b_path)
    out = []
    for key in A:
        ra, ta = A[key]["render"].double(), A[key]["target"].double()
        rb, tb = B[key]["render"].double(), B[key]["target"].double()
        moved = ((ra - rb).abs() > FLIP) | ((ta - tb).abs() > FLIP)[None]
        flip = moved.any(-1, keepdim=True).expand_as(ra)
        differ = ((ra != rb) | (ta != tb)[None]).any(-1)
        n = int(round(ra[0, ..., 0].numel() ** 0.5))
        sq = lambda t: t.reshape(n, n, 3)  # noqa: E731
        t_flip = ((ta - tb).abs() > FLIP).any(-1).reshape(n, n)
        t_edge = int(on_edge(sq(ta), t_flip).sum())
        for i in range(ra.shape[0]):
            r_flip = ((ra[i] - rb[i]).abs() > FLIP).any(-1).reshape(n, n)
            la = ((ra[i] - ta) ** 2).mean()
            lb = ((rb[i] - tb) ** 2).mean()
            keep = ~flip[i]
            ka = ((ra[i] - ta) ** 2)[keep].mean()
            kb = ((rb[i] - tb) ** 2)[keep].mean()
            rec = dict(kind="images", what=key, start=i,
                       loss_a=float(la), loss_b=float(lb),
                       rel_gap=float((la - lb).abs() / la),
                       abs_gap=float((la - lb).abs()),
                       pixels=int(differ[i].numel()),
                       pixels_differ=int(differ[i].sum()),
                       pixels_flip=int(flip[i].any(-1).sum()),
                       render_flips=int(r_flip.sum()),
                       render_flips_on_edge=int(on_edge(sq(ra[i]),
                                                        r_flip).sum()),
                       target_flips=int(t_flip.sum()),
                       target_flips_on_edge=t_edge,
                       unflipped_rel_gap=float((ka - kb).abs() / ka))
            out.append(rec)
            print(json.dumps(rec), flush=True)
    return out


def peak_mib(dev) -> float:
    """The allocator's peak since the last call (or reset), in MiB; resets
    it."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    torch.cuda.reset_peak_memory_stats(dev)
    return peak



def config5_times(out: list, dev, card: str) -> None:
    """An Adam step of config 5 (32x32 f32) at 1, 4 and 16 starts, eager
    and graphed in turns, with the graphed step's device ms and kernels."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    f32 = torch.float32
    # Config 5: an Adam step (zero, loss and backward or a replay, masks,
    # Adam) of fit at one start and of the vectorized multistart at 4 and
    # 16, eager and graphed in turns.
    spec = rt.lensing_inverse_spec(32, 32)
    cfg = rt.default_inverse_cfg(f32, max_steps=120, rk4_dt=0.5,
                                 soft_temp=0.05, stop_rho=0.5)
    cfg = cfg._replace(soft_freq=2.0, integrator=cfg.integrator._replace(
        lam_max=60.0))
    with torch.no_grad():
        target = rt.make_render_for_params(spec, cfg, 0, f32, dev)(
            rt.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], f32, dev))
    trainable = rt.InverseParams(1.0, 0.0, [0.0, 0.0, 0.0, 1.0], f32, dev)
    for n in (1, 4, 16):
        inits = [rt.InverseParams(0.5 + 0.04 * ((k % 5) - 2) / 2, 0.0,
                                  [0.0, 5.0, 12.0, 0.02 * ((k % 7) - 3)],
                                  f32, dev) for k in range(n)]
        if n == 16:
            render = rt.make_render_for_params(spec, cfg, 0, f32, dev)
            with torch.no_grad():
                IMAGES["config 5 starts"] = dict(
                    render=torch.stack([render(p) for p in inits]).cpu(),
                    target=target.cpu())
        if n == 1:
            loss_fn, make = (rt.make_loss_fn(spec, target, cfg, 0, f32, dev),
                             inits[0].copy)
        else:
            loss_fn = rt.make_multistart_loss_fn(spec, target, cfg, 0, f32,
                                                 dev)

            def make(inits=inits):
                return rt.InverseParams(*(
                    torch.stack([getattr(i, k).detach() for i in inits])
                    for k in ("M", "a", "sphere_pos")), dtype=f32,
                    device=dev)
        with torch.no_grad():
            losses = loss_fn(make()).reshape(-1).tolist()
        q = make()
        loss_fn(q).sum().backward()
        eager, graphed, _ = adam_steps(loss_fn, make, trainable)
        turns = in_turns({"eager": eager, "graphed": graphed})
        prof = profile_steps(graphed)
        emit(out, "time", card=card, what=f"config 5 Adam step {n} starts",
             eager_ms=turns["eager"], graphed_ms=turns["graphed"],
             graphed_device_ms=prof["busy_ms"],
             graphed_kernels=prof["kernels"],
             graphed_k8_k9=(prof["k8"], prof["k9"]),
             graphed_k11_k12=(prof["k11"], prof["k12"]),
             loss_hex=[float(v).hex() for v in losses],
             grad_digest=grad_digest(q))


# K4's diagnosis: the training batch cut to a quarter and a half (every
# fourth and every second ray, so the mix of rays stays) and replicated
# twice and four times; config 5's starts.
K4_SCALES = ("quarter", "half", "1x", "2x", "4x")
K4_STARTS = (1, 4, 16)
# The libraries the k4 mode runs (the training and inversion steps).
K4_LIBRARIES = ("geodesic", "adjoint", "localize", "camera")


def k4_scaled(ck, ends, ct, scale: str):
    """K4's inputs (checkpoints, end segments, cotangent) at ``scale``."""
    if scale == "1x":
        return ck, ends, ct
    if scale in ("quarter", "half"):
        k = 4 if scale == "quarter" else 2
        return (ck[:, :, ::k].contiguous(), ends[::k].contiguous(),
                ct[:, ::k].contiguous())
    k = int(scale[0])
    return ck.repeat(1, 1, k), ends.repeat(k), ct.repeat(1, k)


def k4_times(out: list, dev, card: str) -> None:
    """K4 at the main paths' inputs: its f32 Kerr-Schild RK4 kernels' ptxas
    lines and SASS mix; at rk4/200 and tsit5/48 (200x200 f32) the call in
    events and the kernel alone (profiler), the histogram of end segments,
    the kernel on the batch pre-permuted by end segment (the permutation
    made outside the timed window) and the sort's own time, at rk4/200 the
    batch cut and replicated; grouped at config 5 (rk4/120, 32x32 a start)
    at 1, 4 and 16 starts with its bound, and the ungrouped launch of one
    start."""
    import torch
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    f32 = torch.float32
    for kern, regs, stack, st, ld in ptxas_report(cb.build_log("adjoint")):
        if kern.startswith("k4_kernel<float, true, false"):
            emit(out, "ptxas", library="adjoint", kernel=kern,
                 registers=regs, stack_bytes=stack, spill_stores=st,
                 spill_loads=ld)
    tool = cuda_tool("cuobjdump")
    if tool is None:
        emit(out, "sass", library="adjoint", mix="not measured (no cuobjdump)")
    else:
        sass = subprocess.run([tool, "-sass", cb._paths("adjoint")[1]],
                              capture_output=True, text=True).stdout
        for kern, counts in instruction_mix(
                sass, "k4_kernel<float, true, false").items():
            emit(out, "sass", library="adjoint", kernel=kern, mix=counts)
    def alone(route, ck, ends, ct, args):
        return kernel_alone_ms(
            lambda: adj.backward_cuda(route, ck, ends, ct, args),
            "k4_kernel")

    def inputs(route, ys, args, seed):
        ck, used = k3_pass(route, ys, args)
        return ck, used, used[1:], state_ct(ys, seed)

    for label, method, steps in (("rk4/200", "rk4", 200),
                                 ("tsit5/48", "tsit5", 48)):
        route, ys, args = train_route(dev, method, steps)
        ck, used, ends, ct = inputs(route, ys, args, 0)
        k4 = lambda: adj.backward_cuda(route, ck, ends, ct, args)  # noqa
        sort = lambda: torch.argsort(ends, descending=True,  # noqa: E731
                                     stable=True)
        order = sort()
        rec = dict(
            rays=ends.shape[0], segments=int(used[0]),
            seg_len=route.seg_len,
            ends_histogram=torch.bincount(
                ends, minlength=route.n_seg + 1).tolist(),
            k4_ms=cuda_ms(k4), k4_device_ms=kernel_alone_ms(k4, "k4_kernel"),
            k4_device_ms_prepermuted=alone(
                route, ck[:, :, order].contiguous(), ends[order].contiguous(),
                ct[:, order].contiguous(), args),
            argsort_ms=cuda_ms(sort),
            argsort_device_ms=sum(b - a for _, a, b in profiled_kernels(
                sort, ("",))) / 1e3 / REPEATS)
        if hasattr(adj, "work_order_cuda"):
            count = lambda: adj.work_order_cuda(  # noqa: E731
                ends, route.n_seg)
            require(torch.equal(count(), order), "K4's work order differs "
                    "from the stable sort")
            rec.update(order_ms=cuda_ms(count),
                       order_device_ms=sum(
                           b - a for _, a, b in profiled_kernels(
                               count, ("k4_order",))) / 1e3 / REPEATS)
        if method == "rk4":
            rec["k4_device_ms_by_batch"] = {
                s: alone(route, *k4_scaled(ck, ends, ct, s), args)
                for s in K4_SCALES}
        emit(out, "k4", card=card, what=f"K4 train {label} 200x200 f32",
             **rec)

    for n in K4_STARTS:
        singles, grouped, ys = inverse_case(dev, f32, "rk4",
                                            starts=config5_starts(n))
        args = adj.launch_args(grouped, ys)
        ck, used, ends, ct = inputs(grouped, ys, args, 2)
        k4 = lambda: adj.backward_cuda(grouped, ck, ends, ct, args)  # noqa
        work = adjoint_work(grouped, ys, ct, int(used[0]))
        rec = dict(rays=ends.shape[0], segments=int(used[0]),
                   seg_len=grouped.seg_len,
                   k4_ms=cuda_ms(k4),
                   k4_device_ms=kernel_alone_ms(k4, "k4_kernel"),
                   bound_ms=work["k4_bound"][0], bound_by=work["k4_bound"][1],
                   ray_iterations=work["iters"], accepted=work["accepted"])
        if n == 1:
            route, y1 = singles[0]
            a1 = adj.launch_args(route, y1)
            ck1, _, ends1, ct1 = inputs(route, y1, a1, 2)
            rec["k4_ungrouped_device_ms"] = alone(route, ck1, ends1, ct1, a1)
        emit(out, "k4", card=card, what=f"K4 grouped config 5 {n} starts",
             **rec)


def k4_mode(out: list, dev, card: str) -> None:
    """``k4``: K4's diagnosis, then the training steps and config 5's Adam
    steps as ``times`` gives them (without the disk and K1)."""
    k4_times(out, dev, card)
    train_times(out, dev, card)
    config5_times(out, dev, card)


SHADE_LIBRARIES = ("geodesic", "adjoint", "localize", "camera", "objects")
# The libraries of ``--alone`` (the kernels alone on K1's end states).
ALONE_LIBRARIES = ("geodesic", "camera", "objects")
# --alone: the camera and shade modes time the kernels alone and stop.
ALONE = False


def takes_record(fn) -> bool:
    """Whether a tree's K12 wrapper takes K11's record."""
    import inspect
    return "rec" in inspect.signature(fn).parameters


def floor_times(out: list, dev, card: str) -> None:
    """The floor no kernel's launch beats: a one-element fill, alone
    (profiler) and per launch in a graph of 100 launches."""
    import torch
    one = torch.zeros(1, device=dev)
    fill = lambda: one.zero_()  # noqa: E731
    emit(out, "floor", card=card, what="one-element fill",
         graphed_ms=graph_ms(fill), device_ms=kernel_alone_ms(fill, ""))


def sass_sections(out: list, lib: str, kernels) -> None:
    """A library's ptxas lines and the static SASS mix of the kernels whose
    names start with one of ``kernels``."""
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    for kern, regs, stack, st, ld in ptxas_report(cb.build_log(lib)):
        emit(out, "ptxas", library=lib, kernel=kern, registers=regs,
             stack_bytes=stack, spill_stores=st, spill_loads=ld)
    tool = cuda_tool("cuobjdump")
    if tool is None:
        emit(out, "sass", library=lib, mix="not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", cb._paths(lib)[1]],
                          capture_output=True, text=True).stdout
    for wanted in kernels:
        for kern, counts in instruction_mix(sass, wanted).items():
            emit(out, "sass", library=lib, kernel=kern, mix=counts)


def cam_batches(dev):
    """(label, metric, pos, normal) of K8/K9 at f32: the training batch
    (example2 200x200, chip_smoke's first camera case) and config 5's at
    1, 4 and 16 starts as its steps hold them (M and a one value at one
    start, one per ray beyond)."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    f32 = torch.float32
    out = [camera_cases(dev, f32)[0]]
    xg, ng = rt.flat_pixel_grid(rt.lensing_inverse_spec(INV_N, INV_N), f32,
                                dev)
    B = xg.shape[0]
    for n in K4_STARTS:
        Ms = torch.tensor([M for M, _ in config5_starts(n)], dtype=f32,
                          device=dev)
        M = Ms[0] if n == 1 else Ms.repeat_interleave(B)
        metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(
            M, torch.zeros_like(M)), r_formula="textbook", rho_min=0.25)
        out.append((f"config 5 {n} starts", metric, xg.repeat(n, 1),
                    ng.repeat(n, 1)))
    return out


def camera_times(out: list, dev, card: str) -> None:
    """``camera``: the launch floor; K8 and K9 alone (profiler) and per
    launch in a graph of 100 on the training batch and config 5's at 1, 4
    and 16 starts, K9 also given its cotangent as a view of [8, B] planes
    (its call, with any copy the tree makes), with digests of their
    outputs; the camera library's ptxas lines and the SASS mix of its f32
    Kerr-Schild kernels (K8's is the forward that K9 recomputes); then
    (unless --alone) K9's and K12's calls in the rk4/200 training step
    (``replay_calls``)."""
    import torch
    from raytracegr_jl_tpu_torch.models import camera as cam
    floor_times(out, dev, card)
    for label, metric, pos, normal in cam_batches(dev):
        ct = cam_cotangent(pos)
        # The cotangent as the training path holds it: a view of the
        # planes' gradient (a tree whose K9 reads it contiguous copies it).
        planes = torch.cat([pos, ct], -1).t().contiguous().t()[:, 4:]
        k8 = lambda: cam.pixel_rays_cuda(metric, pos, normal)  # noqa: E731
        k9 = lambda: cam.pixel_rays_vjp_cuda(  # noqa: E731
            metric, pos, normal, ct)
        k9p = lambda: cam.pixel_rays_vjp_cuda(  # noqa: E731
            metric, pos, normal, planes)
        emit(out, "camera", card=card, what=f"K8/K9 {label} f32",
             rays=pos.shape[0],
             k8_device_ms=kernel_alone_ms(k8, "k8_kernel"),
             k8_graphed_ms=graph_ms(k8),
             k9_device_ms=kernel_alone_ms(k9, "k9_kernel"),
             k9_graphed_ms=graph_ms(k9),
             k9_planes_device_ms=kernel_alone_ms(k9p, "k9_kernel"),
             k9_planes_call_graphed_ms=graph_ms(k9p), u=digest(k8()),
             pbar=digest(k9()), pbar_planes=digest(k9p()))
    sass_sections(out, "camera", ("k8_kernel<float, true",
                                  "k9_kernel<float, true"))
    if not ALONE:
        replay_calls(out, dev, card)


def replay_calls(out: list, dev, card: str) -> None:
    """K9's and K12's wrappers in the rk4/200 training step (200x200
    f32): each call as the eager step makes it (its arguments kept), the
    kernels it launches, their device ms and the strides of its tensors;
    and in a graphed replay of the step, the kernel's device ms and the
    kernel that runs just before it."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models import camera as cam
    from raytracegr_jl_tpu_torch.models import objects
    from raytracegr_jl_tpu_torch.models.scenes import example2_spec
    f32 = torch.float32
    spec = example2_spec(200, 200)
    cfg = rt.default_inverse_cfg(f32, max_steps=200, method="rk4",
                                 rk4_dt=0.5, stop_rho=0.5)
    xg, ng = rt.flat_pixel_grid(spec, f32, dev)
    with torch.no_grad():
        target = rt.make_ray_render_for_params(spec, cfg, 2, f32, dev)(
            rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev), xg,
            ng)
    loss_fn = rt.make_ray_loss_fn(spec, cfg, 2, f32, dev)

    def params():
        return rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)

    names = ((cam, "pixel_rays_vjp_cuda", "k9_kernel"),
             (objects, "shade_vjp_cuda", "k12_kernel"))
    with kept_calls(cam, names[0][1]) as k9s, \
            kept_calls(objects, names[1][1]) as k12s:
        loss_fn(params(), xg, ng, target).backward()
    torch.cuda.synchronize()
    evs = profiled_kernels(graphed_step(
        lambda q: loss_fn(q, xg, ng, target), params), ("",), reps=3)
    for (mod, fn, kern), calls in zip(names, (k9s, k12s)):
        args, kw, _ = calls[0]
        mine = profiled_kernels(
            lambda: getattr(mod, fn)(*args, **kw), ("",))  # noqa: B023
        at = [i for i, e in enumerate(evs) if kern in e[0]]
        emit(out, "replay", card=card, what=f"{fn} in the rk4/200 step",
             strides=[list(t.stride()) for t in args
                      if isinstance(t, torch.Tensor)],
             call_kernels=sorted({e[0][:80] for e in mine}),
             call_kernels_per_call=len(mine) / REPEATS,
             call_device_ms=sum(b - a for _, a, b in mine) / 1e3 / REPEATS,
             replay_kernel_ms=(statistics.median(
                 (evs[i][2] - evs[i][1]) / 1e3 for i in at) if at else None),
             replay_seen=len(at),
             replay_before=sorted({evs[i - 1][0][:80] for i in at if i}),
             replay_before_ms=(statistics.median(
                 (evs[i - 1][2] - evs[i - 1][1]) / 1e3 for i in at if i)
                 if any(at) else None))


def shade_config5(dev, n: int):
    """Config 5's shading batch at ``n`` starts (f32, soft at frequency
    2): K1's end states of the lensing scene repeated per start, as
    ``[8, B]`` planes, each start's sphere per ray."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.ops.adjoint import per_ray
    f32 = torch.float32
    scene, y = shade_end_states(dev, rt.lensing_inverse_spec(INV_N, INV_N),
                                f32, rt.IntegratorConfig(
                                    method="rk4", rk4_dt=0.5, max_steps=120,
                                    lam_max=60.0, stop_rho=0.5))
    B = y.shape[0]
    pos = scene.pos.expand(n, -1, -1).clone()
    pos[:, 0, 3] = torch.tensor([z for _, z in config5_starts(n)],
                                dtype=f32, device=dev)
    planes = y.repeat(n, 1).t().contiguous().t()
    return scene._replace(pos=per_ray(pos, B)), planes[:, :4]


def shade_times(out: list, dev, card: str) -> None:
    """``shade``'s kernels alone: the launch floor; on the training batch
    (chip_smoke's "train example2 200x200 float32 hard": K1's end states
    as [8, B] planes, the sphere's pos per ray) K11 (and K11 writing its
    record where the tree has one) and K12 alone (profiler) and per launch
    in a graph of 100, K12 also on misses only (hit_dmin -inf) and with a
    zero cotangent, and a copy over K12's bytes; K11 and K12 on config 5's
    batches at 1, 4 and 16 starts (soft); digests of their outputs; the
    objects library's ptxas lines and the SASS mix of its f32 kernels."""
    import torch
    from raytracegr_jl_tpu_torch.models import objects as O
    floor_times(out, dev, card)
    f32 = torch.float32
    has_rec = takes_record(O.shade_vjp_cuda)
    cases = {c[0]: c for c in shade_cases(dev, f32)}
    _, scene, x, _, _ = cases["train example2 200x200 float32 hard"]
    batches = [("train hard", scene, x, None, 12.0)] + [
        (f"config 5 {n} starts soft", *shade_config5(dev, n), 0.05, 2.0)
        for n in K4_STARTS]
    for label, scene, x, temp, freq in batches:
        B = x.shape[0]
        ct = shade_cotangent(x)

        def k12(hit_dmin=0.01, c=ct, scene=scene, x=x, temp=temp,
                freq=freq):
            kw = dict(hit_dmin=hit_dmin, temp=temp, color_freq=freq,
                      fields=("pos",))
            if has_rec and temp is None:
                kw["rec"] = O.shade_cuda(scene, x, hit_dmin, temp, freq,
                                         record=True)[1]
            return lambda: O.shade_vjp_cuda(scene, x, c, **kw)

        k11 = lambda: O.shade_cuda(scene, x, temp=temp,  # noqa: E731
                                   color_freq=freq)
        variants = {"as chip_smoke": k12()}
        if temp is None:
            variants.update({"misses only": k12(float("-inf")),
                             "zero cotangent": k12(c=torch.zeros_like(ct))})
        ct_x, cts = variants["as chip_smoke"]()
        rec = dict(rays=B, k11_device_ms=kernel_alone_ms(k11, "k11_kernel"),
                   k11_graphed_ms=graph_ms(k11), rgb=digest(k11()),
                   k12_device_ms={k: kernel_alone_ms(v, "k12_kernel")
                                  for k, v in variants.items()},
                   k12_graphed_ms={k: graph_ms(v)
                                   for k, v in variants.items()},
                   ct_x=digest(ct_x), ct_pos=digest(cts["pos"]))
        if has_rec and temp is None:
            k11r = lambda: O.shade_cuda(  # noqa: E731
                scene, x, temp=temp, color_freq=freq, record=True)
            rec.update(k11_record_device_ms=kernel_alone_ms(k11r,
                                                            "k11_kernel"),
                       k11_record_graphed_ms=graph_ms(k11r))
        if temp is None:
            # K12's bytes: x, the cotangent, the sphere's pos per ray read;
            # ct_x and pos's cotangent written: ~16 floats each way.
            src = torch.zeros((B, 16), dtype=f32, device=dev)
            dst = torch.empty_like(src)
            cp = lambda: dst.copy_(src)  # noqa: E731
            rec.update(copy_16_floats_device_ms=kernel_alone_ms(cp, ""),
                       copy_16_floats_graphed_ms=graph_ms(cp))
        emit(out, "shade", card=card, what=f"K11/K12 {label} f32", **rec)
    sass_sections(out, "objects", ("k11_kernel<float", "k12_kernel<float"))


def shade_mode(out: list, dev, card: str) -> None:
    """``shade``: the kernels alone (``shade_times``); then, unless
    --alone, the 200x200 render (``render_times``), the training steps and
    config 5's Adam steps as ``times`` gives them (without the disk and
    the 1024x1024 render)."""
    shade_times(out, dev, card)
    if ALONE:
        return
    render_times(out, dev, card, (200,))
    train_times(out, dev, card)
    config5_times(out, dev, card)


DIGEST_LIBRARIES = ("geodesic", "shading", "objects")


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def grad_digest(p) -> str:
    """The digest of the gradients of the parameters ``p`` (M, a, the
    sphere's position) after one eager loss and backward."""
    import torch
    return digest(torch.cat([q.grad.reshape(-1) for q in p.parameters()]))


def digests(out: list, dev, card: str) -> None:
    """``digests``: the outputs of the forward paths on fixed inputs as
    digests of their bytes, so that two trees' runs can be held bitwise to
    each other: the flagship render at 200x200 f32 (``render_fn``: K1, then
    the tree's shading) and K5 on K1's end states of the disk at 256x256,
    f32 and f64 (K1's end states' digest beside it)."""
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.shading import shade_redshift_cuda
    from raytracegr_jl_tpu_torch.models.scenes import build, example2_spec
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    f32 = torch.float32
    metric, scene, canvas = build(example2_spec(200, 200), f32, dev)
    rgb = rt.render_fn(metric, scene, rt.RenderConfig(
        integrator=rt.IntegratorConfig(rtol=RTOL_F32, atol=RTOL_F32,
                                       max_steps=20_000)))(canvas.pos,
                                                           canvas.normal)
    emit(out, "digest", card=card, what="render example2 200x200 f32",
         rgb=digest(rgb))
    for dtype in (f32, torch.float64):
        metric, scene, canvas = build(rt.accretion_disk_spec(256, 256),
                                      dtype, dev)
        tol = float(torch.finfo(dtype).eps) ** 0.75
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        y = integrate_rays_cuda(metric, scene, y0, None, rt.IntegratorConfig(
            rtol=tol, atol=tol, max_steps=2000, stop_rho=1.0)).y
        emit(out, "digest", card=card,
             what=f"K5 disk 256x256 {str(dtype)[6:]}", y=digest(y),
             rgb=digest(shade_redshift_cuda(metric, scene, y0, y)))


K5_LIBRARIES = ("compaction", "shading", "camera", "adjoint")


def warp_mix(flags, order=None):
    """The share of warps (32 rays in launch order) whose ``flags`` (ints;
    a negative one is not counted) are not all alike."""
    import torch
    f = (flags if order is None else flags[order]).to(torch.int64)
    f = torch.nn.functional.pad(f, (0, -f.numel() % 32),
                                value=-1).reshape(-1, 32)
    big = torch.iinfo(torch.int64).max
    lo = torch.where(f >= 0, f, big).min(1).values
    hi = f.max(1).values
    return float(((hi >= 0) & (lo != hi)).double().mean())


def k5_times(out: list, dev, card: str) -> None:
    """``k5``'s K5 half: see the module's docstring."""
    import torch
    from raytracegr_jl_tpu_torch import compaction as C
    from raytracegr_jl_tpu_torch.models import shading as S
    from raytracegr_jl_tpu_torch.models.objects import distances
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (
        impact_parameter_order, pack_params)
    from raytracegr_jl_tpu_torch.ops.integrate import IntegratorConfig
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    for kern, regs, stack, st, ld in ptxas_report(cb.build_log("shading")):
        emit(out, "ptxas", library="shading", kernel=kern, registers=regs,
             stack_bytes=stack, spill_stores=st, spill_loads=ld)
    tool = cuda_tool("cuobjdump")
    if tool is None:
        emit(out, "sass", library="shading", mix="not measured (no cuobjdump)")
    else:
        sass = subprocess.run([tool, "-sass", cb._paths("shading")[1]],
                              capture_output=True, text=True).stdout
        for kern, counts in instruction_mix(sass, "k5_kernel<float").items():
            emit(out, "sass", library="shading", kernel=kern, mix=counts)
    cfg, metric, scene, canvas, y0, _ = disk_setup(dev)
    res = C.trace_batch_compacted(metric, scene, y0, None, cfg.integrator)
    y = res.y
    rows = y.contiguous()
    B = y.shape[0]
    prm = pack_params(metric, scene, IntegratorConfig(), y.dtype, dev)

    def k5(a0, a):
        return lambda: S.shade_redshift_cuda(metric, scene, a0, a,
                                             cfg.hit_dmin, cfg.beaming,
                                             cfg.exposure, prm)

    with torch.no_grad():
        d = distances(scene, rows[:, :4])
        hit = d.min(-1).values < cfg.hit_dmin
        kind = torch.where(hit, scene.kind[d.argmin(-1)].to(torch.int64), -1)
    order, _ = impact_parameter_order(y0)
    hits = torch.nonzero(hit).flatten()
    misses = torch.nonzero(~hit).flatten()
    rep = lambda idx: idx.repeat(-(-B // idx.numel()))[:B]  # noqa: E731
    cases = {"render": (y0, y), "rows": (y0, rows),
             "sorted": (y0[order], rows[order])}
    if hits.numel():
        cases["hits only"] = (y0[rep(hits)], rows[rep(hits)])
    if misses.numel():
        cases["misses only"] = (y0[rep(misses)], rows[rep(misses)])
    alone = {k: kernel_alone_ms(k5(*v), "k5_kernel") for k, v in
             cases.items()}
    floor = lambda a0, a: lambda: torch.add(a[:, :3], a0[:, :3])  # noqa
    floors = {k: sum(b - a for _, a, b in profiled_kernels(
        floor(*cases[k]), ("",))) / 1e3 / REPEATS for k in ("render", "rows")}
    rgb = k5(y0, y)()
    rec = dict(rays=B, hit_share=float(hit.double().mean()),
               warps_mixing_hits_caller=warp_mix(hit),
               warps_mixing_hits_sorted=warp_mix(hit, order),
               warps_mixing_kinds_caller=warp_mix(kind),
               warps_mixing_kinds_sorted=warp_mix(kind, order),
               k5_device_ms=alone, copy_floor_device_ms=floors,
               k5_call_ms=cuda_ms(k5(y0, y)), rgb=digest(rgb),
               bytes=B * (8 + 8 + 3) * 4)
    if "_contract" in vars(S):  # the plain sums in K5's order
        want = S.shade_redshift(metric, scene, y0, y, metric.params.M,
                                metric.params.a, cfg.hit_dmin, cfg.beaming,
                                cfg.exposure)
        rec["bitwise_vs_plain"] = bool(torch.equal(
            rgb.view(torch.int32), want.view(torch.int32)))
    emit(out, "k5", card=card, what="K5 disk 1024x1024 f32", **rec)
    render = C.make_compact_renderer(metric, scene, cfg)
    fast = C.make_compact_renderer(metric, scene, cfg, fast_epilogue=True)
    img, img_f = render(canvas).rgb, fast(canvas).rgb
    turns = {"default": [], "fast_epilogue": []}
    for r in range(REPEATS):
        for key in (("default", "fast_epilogue") if r % 2 else
                    ("fast_epilogue", "default")):
            fn = render if key == "default" else fast
            turns[key].append(cuda_ms(lambda: fn(canvas), repeats=1))
    emit(out, "k5", card=card, what="disk render 1024x1024 f32",
         render_ms={k: statistics.median(v) for k, v in turns.items()},
         render_ms_all=turns, image=digest(img),
         fast_epilogue_image=digest(img_f),
         images_equal=bool(torch.equal(img, img_f)))


def order_times(out: list, dev, card: str) -> None:
    """``k5``'s work-order half: see the module's docstring."""
    import torch
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    batches = []
    for label, method, steps in (("rk4/200", "rk4", 200),
                                 ("tsit5/48", "tsit5", 48)):
        route, ys, args = train_route(dev, method, steps)
        ends = k3_pass(route, ys, args)[1][1:].contiguous()
        batches.append((f"train {label}", ends, route.n_seg))
        if method == "rk4":
            batches.append(("sharded W = 2 rank 0 rk4/200",
                            ends[:ends.shape[0] // 2].contiguous(),
                            route.n_seg))
            batches.append(("rk4/200 x26", ends.repeat(26), route.n_seg))
    for n in K4_STARTS:
        _, grouped, ys = inverse_case(dev, torch.float32, "rk4",
                                      starts=config5_starts(n))
        ends = k3_pass(grouped, ys, adj.launch_args(grouped, ys))[1][1:]
        batches.append((f"config 5 {n} starts", ends.contiguous(),
                        grouped.n_seg))
    gen = torch.Generator(device=dev).manual_seed(17)
    batches.append(("random 1048576", torch.randint(
        0, 26, (1 << 20,), generator=gen, device=dev, dtype=torch.int32), 25))
    for label, ends, n_seg in batches:
        call = lambda: adj.work_order_cuda(ends, n_seg)  # noqa: E731
        sort = lambda: adj.work_order(ends)  # noqa: E731
        # The kernels of REPEATS calls (the parent tree's order is three):
        # the profiler may miss one, so the device time is the mean over
        # the calls it saw, and the span (first start to last end of a
        # call) only where it saw them all.
        evs = profiled_kernels(call, ("k4_order",))
        per = 3 if any("scatter" in e[0] for e in evs) else 1
        runs = [evs[i:i + per] for i in range(0, len(evs), per)]
        emit(out, "order", card=card, what=f"K4 work order {label}",
             rays=ends.shape[0], bins=n_seg + 1,
             equal_to_stable_sort=bool(torch.equal(call(), sort())),
             kernels_per_call=per, kernels_seen=len(evs),
             device_ms=(sum(b - a for _, a, b in evs) / 1e3
                        / (len(evs) / per) if evs else None),
             span_ms=(statistics.median((r[-1][2] - r[0][1]) / 1e3
                                        for r in runs)
                      if len(evs) == per * REPEATS else None),
             call_ms=cuda_ms(call),
             argsort_device_ms=sum(b - a for _, a, b in profiled_kernels(
                 sort, ("",))) / 1e3 / REPEATS,
             bound_ms=ends.shape[0] * (4 + 8) / PEAK_BYTES * 1e3)


def k5_mode(out: list, dev, card: str) -> None:
    """``k5``: K5 and the disk render, then K4's work order (each where
    ``--libs`` leaves its library: shading, adjoint)."""
    libs = libraries()
    if "shading" in libs:
        k5_times(out, dev, card)
    if "adjoint" in libs:
        order_times(out, dev, card)


def graphed_step(loss_fn, make_params):
    """A replay of ``loss_fn``'s loss and backward captured as one CUDA
    graph over ``make_params()`` (the tree's step_graph.GraphedStep), with
    the gradients zeroed first, as a training step runs it."""
    from raytracegr_jl_tpu_torch.step_graph import GraphedStep
    p = make_params()
    step = GraphedStep(loss_fn, p)

    def replay():
        for q in p.parameters():
            q.grad.zero_()
        return step.replay()

    return replay


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("camera", "compare-images", "diagnose",
                                     "diagnose-k1", "digests", "k4", "k5",
                                     "k4-kernel", "localize", "sass", "shade",
                                     "times"))
    ap.add_argument("images", nargs="*", help="compare-images: A B")
    ap.add_argument("--tree", default=".", help="the checkout to measure")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--libs", default=None,
                    help="sass: only these libraries (comma-separated)")
    ap.add_argument("--alone", action="store_true",
                    help="camera, shade: only the kernels alone")
    ns = ap.parse_args()
    global ONLY, ALONE
    if ns.libs:
        ONLY = set(ns.libs.split(","))
    ALONE = ns.alone
    if ns.mode == "compare-images":
        require(len(ns.images) == 2, "compare-images takes two files")
        compare_images(*ns.images)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(ns.tree)
    sys.path.insert(0, tree)
    import raytracegr_jl_tpu_torch
    require(os.path.dirname(os.path.dirname(
        os.path.abspath(raytracegr_jl_tpu_torch.__file__))) == tree,
        "the package did not load from the tree given")
    from raytracegr_jl_tpu_torch.utils import cuda_build as cb
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        torch.cuda.get_device_name(0))
    out = []
    t0 = time.perf_counter()
    errors = []

    def build_one(name):
        try:
            cb.build(name)
        except Exception as e:  # reported below
            errors.append(f"{name}: {e}")

    names = [n for n in libraries()
             if (n in ALONE_LIBRARIES if ALONE else
                 n in SHADE_LIBRARIES if ns.mode in ("shade", "camera") else
                 n in DIGEST_LIBRARIES if ns.mode == "digests" else
                 n in LOC_LIBRARIES if ns.mode == "localize" else
                 n in K5_LIBRARIES if ns.mode == "k5" else
                 not ns.mode.startswith("k4") or n in K4_LIBRARIES
                 and (ns.mode == "k4" or n == "adjoint"))]
    threads = [threading.Thread(target=build_one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    require(not errors, "build failed: " + "; ".join(errors))
    emit(out, "build", tree=tree, card=card,
         seconds=time.perf_counter() - t0)
    dev = torch.device("cuda", 0)
    {"camera": camera_times, "diagnose": diagnose,
     "diagnose-k1": diagnose_k1_times,
     "k4": k4_mode, "k4-kernel": k4_times, "k5": k5_mode,
     "localize": localize_times,
     "sass": sass_digests,
     "shade": shade_mode, "times": times,
     "digests": digests}[ns.mode](out, dev, card)
    emit(out, "done", tree=tree, mode=ns.mode,
         seconds=time.perf_counter() - t0)
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as f:
            for rec in out:
                f.write(json.dumps(rec) + "\n")
        if IMAGES:
            torch.save(IMAGES, f"{ns.out}.images.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
