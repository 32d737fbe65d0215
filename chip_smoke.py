"""Smoke test of the PyTorch port on one CUDA card: builds the kernels from
raytracegr_jl_tpu_torch/csrc (K1; K3, K4 and, in libraries of their own,
K6 and K7 and the camera's K8 and K9 of the training path, and the
reference shading's K11 and K12 of the render and the training path; K2
of the compacted render; K5, its fused shading; one build per library, in
parallel) and prints each
kernel's registers and spills, checks each against its plain PyTorch
version (K1 also taking its own initial step, K3's one launch against the
per-segment chain, K4 on ragged, one-end and every-end batches and on the
training batches and K4's work-order kernels against the stable sort, the grouped K3 and K4 of the vectorized
multistart against theirs and against one launch per start, K6 and K7 on
K3's final states, and K7 against torch.autograd of the plain epilogue, K8
and K9 on the training batches, shared and grouped, and K9 against
torch.autograd of the plain camera, K11 and K12 hard and soft on K1's end
states, shared, per ray and grouped, and their plain VJPs against
torch.autograd of the plain shading) and
K1 against the committed golden images, drives the forward render and the
training path (one pixel-loss step for two configurations, three Adam
steps) of the
reference's example2, the inversion of BASELINE config 5 (the lensing
scene at 32x32: M and z recovered in 60 Adam steps, the vectorized
multistart against the serial one, a resumed fit against an uninterrupted
one) and the 1024x1024 accretion-disk render (compacted, K2 taking each
ray's initial step, the redshift shading one K5 launch, bitwise the plain
shading) through the kernels, counting launches, eager initial steps
and host syncs, holds refine_minima (K1, K2, K3, K4, grouped K3/K4 on
grazing rays), sort_rays on the differentiable path and grad_mode="scan"
to their plain versions and counts and times their paths, times
them, diagnoses K1 (its time four ways, the step census, scheduler
cycles per warp-iteration), holds the detection gate (event_gate) bitwise to the
ungated disk render, drives data parallelism (parallel/sharding.py: the
training step and the 1024x1024 render over NCCL at world size 1, bitwise
to the unsharded ones, and two gloo ranks on the one card, each a
subprocess of this script, K1, K3 and K4 on half the rays each), holds
the generic-metric row-major route to K1 at f64 and times it, holds the
training path's f64 gradients through K3 and K4 (and the row-major
route's) to the Dual oracle (ops/dual_oracle.py, forward mode by hand),
and diagnoses K2 on the disk's packed tail (SASS instruction mix, the tail's
work replicated and cut, block sizes).

    python3 chip_smoke.py

(``python3 chip_smoke.py --sharding-rank RANK WORLD PORT`` is one rank of
the two-rank phase, started by the script itself.)

Prints one line per phase with its result and seconds, then a JSON line
with each kernel's launches, error, times and bound, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, and when
no CUDA device is present. Imports no jax.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

RTOL_F32 = float(torch.finfo(torch.float32).eps) ** 0.75
MIN_PIXELS_WITHIN_2LSB = 0.995  # kernel vs plain (after bitwise), goldens
REPEATS = 5
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): float32
# outside the tensor cores, and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# K4's (M, a) gradients against torch.autograd of the plain body. f64: the
# two differ only in the order of their sums. f32: the same, but over
# thousands of rays and up to 200 steps of f32 rounding, with cancellation
# between rays of opposite sign.
GRAD_RTOL = {torch.float64: 1e-10, torch.float32: 2e-3}
# The training main path's kernel gradients against the plain path's. The
# kernels equal their plain versions bitwise and the rest is the same
# PyTorch code, so they should agree exactly; the bar allows f32 rounding.
MAIN_GRAD_RTOL = 1e-5
LIBRARIES = ("geodesic", "adjoint", "localize", "compaction", "shading",
             "camera", "objects")
# The accretion disk's step census at 1024x1024, a=0.8, f32, as the JAX
# package recorded it (BASELINE.md:61): a property of the workload.
JAX_DISK_CENSUS = "total 659.2M accepted ray-steps, p50 21, p99 15,451"
# The disk render against scenes/disk_1024.png, which the JAX package
# rendered at f32 on a TPU: at most 1% of the pixels beyond 2 LSB. ROADMAP
# C's bar of 0.5% is printed beside the count but is not met by f32 on
# another chip: the JAX package itself at f32 on a CPU is beyond 2 LSB of
# that image on 0.65% of the sampled rays of tests/test_torch_disk_png.py,
# which holds the port's plain f32 render on the CPU to the same 1%, while
# every bitwise phase here and the f64 comparison with the JAX package
# (tests/test_torch_compaction.py) pass: f32 rounding of two chips moves
# grazing crossings of the thin disk and the shading by a few LSB.
DISK_PNG_BAR_FRAC = 0.01
ROADMAP_C_BAR_FRAC = 0.005
# The disk's main-path configuration (benchmarks/disk_render.py:41-58).
DISK_N = 1024
DISK_MAX_STEPS = 20_000


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str, t0: float, **fields) -> None:
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {parts} seconds={time.perf_counter() - t0:.3f}",
          flush=True)


def frac_within_2lsb(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels whose 8-bit colours differ by at most 2 in every
    channel."""
    from raytracegr_jl_tpu_torch.utils.image import canvas_to_image
    ia = canvas_to_image(a).astype(np.int32)
    ib = canvas_to_image(b).astype(np.int32)
    return float((np.abs(ia - ib).max(-1) <= 2).mean())


def cuda_ms(fn, repeats: int = REPEATS):
    """Median milliseconds of ``fn()`` over ``repeats`` runs after one
    warm-up, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_call(fn):
    """``(fn(), milliseconds of the call between two CUDA events)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def events_ms(fn) -> float:
    """Milliseconds of one ``fn()`` between two CUDA events."""
    return events_call(fn)[1]


# Floating-point arithmetic that the plain versions run, per output element.
_FLOP_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "pow",
             "reciprocal", "abs", "maximum", "minimum", "clamp", "clamp_min",
             "clamp_max", "cos", "exp", "sum", "atan2", "acos", "remainder",
             "sin", "log", "sigmoid"}
# Contractions (einsum's batched products): two operations per term.
_FLOP_PRODUCTS = {"bmm", "mm", "mv", "dot"}


def count_flops(fn) -> int:
    """Floating-point operations of ``fn()``, counted per element over the
    PyTorch operations it runs. Applied to the plain version of a kernel on
    one ray: the kernel follows it operation by operation."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counter(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if not (isinstance(out, torch.Tensor)
                    and out.is_floating_point()):
                return out
            if name in _FLOP_OPS:
                Counter.flops += out.numel()
            elif name in _FLOP_PRODUCTS:
                Counter.flops += 2 * out.numel() * args[0].shape[-1]
            return out

    with Counter():
        fn()
    return Counter.flops


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations over the f32
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def timed_calls(module, name: str):
    """Within the block, each call of ``module.<name>`` is timed between
    two CUDA events; yields the list of (start, end) event pairs. A launch
    count on the function (``fn.launches``, which the function adds to
    through its module's name) carries over to the wrapper and back."""
    orig = getattr(module, name)
    pairs = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    counted = hasattr(orig, "launches")
    if counted:
        timed.launches = orig.launches
    setattr(module, name, timed)
    try:
        yield pairs
    finally:
        setattr(module, name, orig)
        if counted:
            orig.launches = timed.launches


@contextlib.contextmanager
def counted_calls(module, name: str):
    """Within the block, each call of ``module.<name>`` is recorded in the
    list it yields."""
    orig = getattr(module, name)
    calls = []

    def recorded(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def kept_calls(module, name: str):
    """Within the block, each call of ``module.<name>`` keeps its
    ``(args, kwargs, result)`` in the list it yields; the function's
    launch count carries over to the wrapper and back (reset the counts
    before the block: a reset inside it misses the wrapper's)."""
    orig = getattr(module, name)
    calls = []

    def kept(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    kept.launches = orig.launches
    setattr(module, name, kept)
    try:
        yield calls
    finally:
        setattr(module, name, orig)
        orig.launches = kept.launches


def records_kept(calls) -> list:
    """Whether each kept call of K11's wrapper (``shade_cuda``) returned a
    record."""
    return [out[1] is not None for _, _, out in calls]


@contextlib.contextmanager
def sync_count():
    """Counts the host syncs that PyTorch's CUDA sync debug mode reports
    inside the block (a read of a tensor on the card, a blocking copy):
    yields a dict whose ``"n"`` is set when the block ends."""
    import warnings
    out = {"n": 0}
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    out["n"] = sum("synchronizing cuda operation" in str(w.message).lower()
                   for w in caught)


# The runtime calls by which the host puts work on the card, as the
# profiler names them: a kernel launch, a graph launch, a copy or a fill.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemcpyToSymbolAsync", "cudaMemsetAsync")


def profile_steps(fn, reps: int = 3) -> dict:
    """torch.profiler over ``reps`` runs of ``fn()`` (after one): per run,
    the device's busy ms (its kernels, copies and fills summed), its
    kernels, the K3, K4, K10, K6, K7, K8, K9, K11 and K12 kernels among
    them, and
    the host's launch calls (``LAUNCH_CALLS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == DeviceType.CUDA]

    def count(events, names):
        return sum(e.count for e in events
                   if any(n in e.key for n in names)) / reps

    return dict(
        busy_ms=sum(e.self_device_time_total for e in dev) / 1e3 / reps,
        kernels=sum(e.count for e in dev) / reps,
        k3=count(dev, ("k3_kernel",)), k4=count(dev, ("k4_kernel",)),
        k10=count(dev, ("k10_kernel",)),
        k6=count(dev, ("k6_kernel",)), k7=count(dev, ("k7_kernel",)),
        k8=count(dev, ("k8_kernel",)), k9=count(dev, ("k9_kernel",)),
        k11=count(dev, ("k11_kernel",)), k12=count(dev, ("k12_kernel",)),
        host_launches=sum(e.count for e in avg
                          if e.device_type == DeviceType.CPU
                          and e.key in LAUNCH_CALLS) / reps)


@contextlib.contextmanager
def step_launches():
    """The launches of a training step's kernels within the block (K3, K4,
    K10, K6, K7, K8, K9, K11, K12, by their wrappers' counters): yields a
    dict keyed "k3" ... "k12", set when the block ends. A graph's capture launches
    each once (its warm-up passes once each more), and a replay runs what
    was captured, so the graphed phases hold these counts. The profiler's
    counts per replay are printed beside them: in this long process it
    misses some kernels, most often a replay's first ones (K8, and K3
    where no eager kernel precedes it), not in a fresh process
    (``kernel_times.py``)."""
    from raytracegr_jl_tpu_torch.models import camera as cam
    from raytracegr_jl_tpu_torch.models import objects
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    fns = {"k3": adj.forward_segment_cuda, "k4": adj.backward_cuda,
           "k10": adj.init_vjp_cuda, "k6": adj.localize_cuda,
           "k7": adj.localize_vjp_cuda, "k8": cam.pixel_rays_cuda,
           "k9": cam.pixel_rays_vjp_cuda, "k11": objects.shade_cuda,
           "k12": objects.shade_vjp_cuda}
    out = {}
    before = {k: fn.launches for k, fn in fns.items()}
    yield out
    out.update({k: fn.launches - before[k] for k, fn in fns.items()})


def in_turns(fns: dict, reps: int = REPEATS) -> dict:
    """Milliseconds of each ``fns[k]()`` on the host's clock to a
    synchronize, run in turns (the order reversed every other round)
    after one warm-up each: ``{k: median of reps}``."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for r in range(reps):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def no_sync(fn, n: int) -> int:
    """``n`` runs of ``fn()`` under CUDA sync debug mode "error" (a host
    sync raises), then ``n`` more counted under "warn": the syncs seen."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with sync_count() as syncs:
        for _ in range(n):
            fn()
    return syncs["n"]


def summed_ms(pairs) -> float:
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def packs(chunks) -> int:
    """How many times the compacted trace packed its batch."""
    return sum(b["rays"] < a["rays"] for a, b in zip(chunks, chunks[1:]))


def mismatch(a, b):
    """(rays that differ in y, lam, hit or steps; max |d| of y and lam)
    between two TraceResults."""
    differ = ((a.y != b.y).any(1) | (a.lam != b.lam) | (a.hit != b.hit)
              | (a.steps != b.steps))
    err = max(float((a.y - b.y).abs().nan_to_num(0.0).max()),
              float((a.lam - b.lam).abs().nan_to_num(0.0).max()))
    return int(differ.sum()), err


def require_chunks_equal(label: str, kernel, plain) -> float:
    """Fails unless K2's (state, y_fin, lam_fin) equal the plain
    version's bitwise; returns their max |d|."""
    err = 0.0
    for name, a, b in zip(("state", "y_fin", "lam_fin"), kernel, plain):
        err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
        require(torch.equal(a, b), f"{label}: K2 {name} not bitwise equal "
                f"(max |d| {err:.3e})")
    return err


# The diagnosis of K2 on the disk's packed tail (phase 16): a fixed budget
# of iterations, the block sizes compared, and the kernels whose static SASS
# instruction mix is counted (K2 resumed and K4, f32 Kerr-Schild Tsit5).
TAIL_BUDGET = 2000
TAIL_BLOCKS = (32, 64, 128)
SASS_KERNELS = {"compaction": "k2_kernel<float, true, true, false",
                "adjoint": "k4_kernel<float, true, true",
                "geodesic": "k1_kernel<float, true, true, 1"}
# SASS opcode classes (the opcode without its modifiers).
_SASS_CLASSES = (
    ("fp32", {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSET", "FSEL",
              "FCHK", "FRND", "FSWZADD"}),
    ("fp64", {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"}),
    ("mufu", {"MUFU"}),
    ("lds", {"LDS", "LDSM"}),
    ("ldl_stl", {"LDL", "STL"}),
    ("ldc", {"LDC", "ULDC"}),
    ("ldg_stg", {"LDG", "STG"}),
    ("branch", {"BRA", "BRX", "BSSY", "BSYNC", "BREAK", "CALL", "RET",
                "EXIT", "WARPSYNC", "JMP"}),
)


def cuda_tool(name: str):
    """The path of a CUDA toolkit program, or None."""
    path = shutil.which(name)
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", name)
    return path if os.path.isfile(path) else None


def demangle(names):
    """Demangled names (cu++filt, else c++filt, else the names as given)."""
    tool = cuda_tool("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True,
                          text=True)
    out = proc.stdout.splitlines()
    return out if proc.returncode == 0 and len(out) == len(names) else list(
        names)


def short_name(name: str) -> str:
    """A demangled kernel name without its return type, namespace and
    parameter list."""
    for ns in ("(anonymous namespace)::", "<unnamed>::"):
        name = name.replace(ns, "")
    name = name.replace("(bool)1", "true").replace("(bool)0", "false")
    name = re.sub(r"\((?:int|unsigned int)\)(-?\d+)", r"\1", name)
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def ptxas_report(log: str):
    """``[(kernel, registers, stack bytes, spill stores, spill loads)]`` from
    an ``nvcc -Xptxas -v`` log."""
    rows, name, props = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and props == name:
            stack, st, ld = map(int, m.groups())
            rows.append([name, None, stack, st, ld])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name and rows[-1][1] is None:
            rows[-1][1] = int(m.group(1))
    names = demangle([r[0] for r in rows])
    return [(short_name(n), *r[1:]) for n, r in zip(names, rows)]


def instruction_mix(sass: str, wanted: str):
    """Static SASS instruction counts by class of each kernel whose
    demangled name starts with ``wanted``: ``{name: {class: count, ...}}``,
    with the total, the operands read from constant bank 3 (the kernels'
    __constant__ parameters) and the most frequent opcodes."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            funcs[cur].append(m.group(1))
    result = {}
    for mangled, name in zip(list(funcs), demangle(list(funcs))):
        name = short_name(name)
        if not name.startswith(wanted):
            continue
        counts = {c: 0 for c, _ in _SASS_CLASSES}
        counts.update(other=0, const_bank_operands=0, total=0)
        hist = {}
        for ins in funcs[mangled]:
            toks = ins.split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if not toks:
                continue
            op = toks[0].split(".")[0]
            hist[toks[0]] = hist.get(toks[0], 0) + 1
            counts["total"] += 1
            if "c[0x3]" in ins:
                counts["const_bank_operands"] += 1
            for cls, ops in _SASS_CLASSES:
                if op in ops:
                    counts[cls] += 1
                    break
            else:
                counts["other"] += 1
        counts["top_opcodes"] = dict(sorted(hist.items(),
                                            key=lambda kv: -kv[1])[:24])
        result[name] = counts
    return result


def sass_report():
    """``[(library, kernel, counts)]``: the static SASS instruction mix of
    the ``SASS_KERNELS`` (``cuobjdump -sass`` of the built library), or
    "not measured" where the toolkit has no cuobjdump."""
    from raytracegr_jl_tpu_torch.utils import cuda_build
    tool = cuda_tool("cuobjdump")
    rows = []
    for lib, wanted in SASS_KERNELS.items():
        if tool is None:
            rows.append((lib, wanted, "not measured (no cuobjdump)"))
            continue
        sass = subprocess.run([tool, "-sass", cuda_build._paths(lib)[1]],
                              capture_output=True, text=True).stdout
        rows += [(lib, k, c) for k, c in instruction_mix(sass, wanted).items()]
    return rows


# K1's diagnosis (phase 5b): the caps on max_steps whose times give the
# slowest warps' time per iteration, and the H100's schedulers (132 SMs of 4).
K1_CAPS = (8, 16, 32, 64)
SCHEDULERS = 132 * 4


def k1_takes_own_step() -> bool:
    """Whether the loaded package's K1 takes the initial step in its
    prologue (``integrate_rays_cuda(..., dt0=None, ...)``); the diagnosis
    and kernel_times.py also run on older checkouts (``--tree``)."""
    import inspect
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    dt0 = inspect.signature(integrate_rays_cuda).parameters["dt0"]
    return "None" in str(dt0.annotation)


def k1_main_call(metric, scene, y0, dt0, integ):
    """A closure that calls K1 as the loaded package's ``render_fn`` calls
    it on the card: with the launch setup built once where the wrapper
    takes one, and with ``dt0=None`` where K1 takes its own initial
    step."""
    import inspect
    from raytracegr_jl_tpu_torch.ops import geodesic_cm as G
    if "launch" not in inspect.signature(G.integrate_rays_cuda).parameters:
        return lambda: G.integrate_rays_cuda(metric, scene, y0, dt0, integ)
    launch = G.launch_config(metric, scene, integ, y0, "geodesic")
    dt = None if k1_takes_own_step() else dt0
    return lambda: G.integrate_rays_cuda(metric, scene, y0, dt, integ,
                                         launch)


def k3_single_launch() -> bool:
    """Whether the loaded package's K3 runs a whole forward pass in one
    launch (``forward_segment_cuda(route, ck, ...)``) rather than one
    segment per launch."""
    import inspect
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    return "ck" in inspect.signature(adj.forward_segment_cuda).parameters


def k3_builds_start() -> bool:
    """Whether the loaded package's K3 builds each ray's initial state in
    its prologue from the launch states (``forward_segment_cuda(route, ck,
    y0, dt0, args)``); older checkouts (``kernel_times.py --tree``) take
    it packed in ``ck[0]``."""
    import inspect
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    return "y0" in inspect.signature(adj.forward_segment_cuda).parameters


def packed_start(route, y0):
    """The packed initial state ``[34, B]`` of the rays at the launch
    states ``y0 [8, B]``, each at its own first step: ``init_plain`` where
    the loaded package has it, else ``make_step_cm``'s init at
    ``render.initial_dt`` (older checkouts), a grouped route's rays with
    their groups' parameters."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    plain = route._replace(cuda=False)
    if hasattr(adj, "init_plain"):
        return adj.init_plain(plain, y0)
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (make_step_cm,
                                                         scene_event_cm)
    from raytracegr_jl_tpu_torch.render import initial_dt
    metric, scene = adj.route_rows(plain, y0.shape[1])
    with torch.no_grad():
        init, _ = make_step_cm(metric, scene_event_cm(scene), route.cfg)
        return adj.pack_state(init(y0, initial_dt(metric, y0.t(),
                                                  route.cfg)))


def state_ct(y0, seed: int = 0):
    """A random cotangent of the packed state ``[34, B]`` of the rays at
    ``y0 [8, B]``."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    gen = torch.Generator(device=y0.device).manual_seed(seed)
    return torch.randn((adj.N_PLANES, y0.shape[1]), generator=gen,
                       dtype=y0.dtype, device=y0.device)


def k3_forward_ms(route, y0, args):
    """K3's launches of one forward pass from the launch states ``y0 [8,
    B]`` (each ray's own first step), each between CUDA events, the host's
    reads outside them: ``(ms summed, checkpoints, used)`` (``used [1 +
    B]``: n_used, then the rays' end segments). One launch where K3 runs
    the whole pass, else one per segment (older checkouts; ``used`` is
    then n_used alone); where K3 takes its initial state packed (older
    checkouts), that state is built before the timed window."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    ck = torch.empty((route.n_seg + 1, adj.N_PLANES, y0.shape[1]),
                     dtype=y0.dtype, device=y0.device)
    if k3_builds_start():
        used, ms = events_call(lambda: adj.forward_segment_cuda(
            route, ck, y0, None, args))
        return ms, ck, used
    ck[0] = packed_start(route, y0)
    if k3_single_launch():
        used, ms = events_call(lambda: adj.forward_segment_cuda(route, ck,
                                                                args))
        return ms, ck, used
    total, s = 0.0, 0
    while s < route.n_seg and bool(ck[s, adj.P_ACTIVE].any()):
        total += events_ms(lambda: adj.forward_segment_cuda(
            route, ck[s], ck[s + 1], args))
        s += 1
    return total, ck, torch.tensor([s], dtype=torch.int32)


def k4_walk(used):
    """What the loaded package's K4 takes to walk a pass back from K3's
    ``used``: the rays' end segments on the card (``used[1:]``), or the
    host's n_used where K4 takes that (older checkouts, ``kernel_times.py
    --tree``)."""
    import inspect
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    if "ends" in inspect.signature(adj.backward_cuda).parameters:
        return used[1:]
    return int(used[0])


def k3_pass(route, y0, args=None):
    """K3's one launch from the launch states ``y0 [8, B]`` (each ray's
    own first step): (checkpoints, used), read nothing. Older checkouts'
    K3 starts from ``packed_start``."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    ck = torch.empty((route.n_seg + 1, adj.N_PLANES, y0.shape[1]),
                     dtype=y0.dtype, device=y0.device)
    args = args or adj.launch_args(route, y0)
    if k3_builds_start():
        return ck, adj.forward_segment_cuda(route, ck, y0, None, args)
    ck[0] = packed_start(route, y0)
    return ck, adj.forward_segment_cuda(route, ck, args)


def require_k3_equal(label, route, y0):
    """K3's one launch from the launch states ``y0`` against the plain
    per-segment chain from ``init_plain``: bitwise on the initial state
    (K3's prologue), n_used, the end segments and every checkpoint value a
    reader takes (``adj.read_mask``). Returns (max |d|, kernel's
    checkpoints and used, plain checkpoints and used)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    ck_k, used_k = k3_pass(route, y0)
    ck_p, used_p = adj.run_segments(route._replace(cuda=False), y0)
    torch.cuda.synchronize()
    require(bits_equal(ck_k[0], ck_p[0]), f"{label}: K3's initial state "
            "differs from init_plain (max |d| "
            f"{max_err(ck_k[0], ck_p[0]):.3e})")
    n_k, n_p = int(used_k[0]), int(used_p[0])
    require(n_k == n_p, f"{label}: K3 ran {n_k} segments, plain {n_p}")
    ends_k, ends_p = used_k[1:], used_p[1:]
    require(torch.equal(ends_k, ends_p), f"{label}: K3's end segments "
            f"differ on {int((ends_k != ends_p).sum())} rays")
    mask = adj.read_mask(ends_p, route.n_seg)
    a, b = ck_k[mask], ck_p[mask]
    err = float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    require(torch.equal(a.view(bits), b.view(bits)),
            f"{label}: K3 not bitwise equal (max |d| {err:.3e})")
    return err, ck_k, used_k, ck_p, used_p


def k1_entry(metric, scene, integ, y0, dt0, max_steps=None):
    """A closure that launches K1 through its C entry point on inputs and a
    parameter block built beforehand, so that the window holds the launch
    alone; returns the steps output. Not counted. ``dt0`` None where K1
    takes the initial step itself."""
    from raytracegr_jl_tpu_torch.ops import geodesic_cm as G
    prm, (kerr, tsit5, r_mode, code, n_obj, npts) = G.launch_config(
        metric, scene, integ, y0, "geodesic")
    B = y0.shape[0]
    y_in = y0.t().contiguous()
    dt_in = None if dt0 is None else dt0.contiguous()
    y_out, lam = torch.empty_like(y_in), y0.new_empty(B)
    hit = torch.empty(B, dtype=torch.int32, device=y0.device)
    steps = torch.empty_like(hit)
    lib = G._find_lib()
    fn = lib.rtgr_k1_f32 if y0.dtype == torch.float32 else lib.rtgr_k1_f64
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    args = [ptr(y_in), ptr(dt_in), ptr(y_out), ptr(lam), ptr(hit),
            ptr(steps), ptr(prm), B, kerr, tsit5, r_mode, code,
            int(integ.max_steps if max_steps is None else max_steps), n_obj,
            npts, int(integ.bisect_iters),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]

    def run():
        rc = fn(*args)
        require(rc == 0, f"K1 C entry: CUDA error {rc}")
        return steps

    run.buffers = (y_in, dt_in, y_out, lam, hit, prm)  # alive while run is
    return run


def profiled_kernels(fn, names, reps: int = REPEATS):
    """The device kernels of ``reps`` runs of ``fn()`` (after a warm-up)
    whose names contain one of ``names``, from torch.profiler:
    ``[(name, start_us, end_us)]`` in start order; empty where the profiler
    sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA
           and any(n in e.name for n in names)]
    return sorted(evs, key=lambda e: e[1])


def graph_ms(fn, n: int = 100) -> float:
    """Device milliseconds per call of ``fn()``: ``n`` calls captured in
    one CUDA graph, its replay timed with CUDA events (median of
    ``REPEATS``) over ``n``: the kernels back to back, with no host launch
    between them."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay) / n


def kernels_ms(fn, names=("",), reps: int = REPEATS) -> float:
    """Device milliseconds per run of ``fn()``: the durations of its
    kernels whose names contain one of ``names`` (all where ``("",)``),
    summed over ``reps`` runs (profiler) and divided by ``reps``."""
    return sum(b - a for _, a, b in profiled_kernels(fn, names, reps)
               ) / 1e3 / reps


def kernel_alone_ms(fn, name: str, reps: int = REPEATS):
    """Median device time (ms) of the kernels named ``name`` in ``reps``
    runs of ``fn()``, from the profiler; None where it saw none."""
    evs = profiled_kernels(fn, (name,), reps)
    if not evs:
        return None
    return statistics.median((b - a) / 1e3 for _, a, b in evs)


def sm_clock_mhz(fn, seconds: float = 1.5):
    """``(sm clock, max sm clock)`` in MHz, as nvidia-smi reads them while
    ``fn()`` runs back to back on another thread: the median of its
    samples. ``(None, None)`` where nvidia-smi reads none."""
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            fn()
            torch.cuda.synchronize()

    worker = threading.Thread(target=busy)
    worker.start()
    samples = []
    try:
        time.sleep(0.3)
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                 "--format=csv,noheader,nounits", "-i", "0"],
                capture_output=True, text=True, timeout=30).stdout.strip()
            try:
                samples.append(tuple(float(v) for v in out.split(",")[:2]))
            except ValueError:
                pass
            time.sleep(0.1)
    finally:
        stop.set()
        worker.join()
    if not samples:
        return None, None
    return (statistics.median(v[0] for v in samples),
            statistics.median(v[1] for v in samples))


def warp_stats(per_ray: torch.Tensor):
    """``(warp-iterations, useful share)`` of per-ray iteration counts in
    launch order: the sum over warps of 32 of their slowest lane, and the
    share of those warps' lane-iterations that run a ray."""
    s = per_ray.to(torch.int64)
    s = torch.nn.functional.pad(s, (0, -s.numel() % 32)).reshape(-1, 32)
    warp_iters = int(s.max(1).values.sum())
    return warp_iters, float(s.sum()) / (32 * warp_iters)


def mean_order_probe(dev):
    """Which order ``torch.mean`` over a last axis of 8 adds in on this
    card, for a contiguous ``[B, 8]`` operand and for one laid out
    component-major (as the initial step's right-hand sides are): the share
    of rows equal to each candidate (left to right; a tree over lanes
    ((0+1)+(2+3))+((4+5)+(6+7)); four accumulators
    (((0+4)+(1+5))+(2+6))+(3+7)), each divided by 8."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.rand((40_000, 8), generator=gen, device=dev)
    out = {}
    for layout, t in (("contiguous", q), ("component_major",
                                          q.t().contiguous().t())):
        m = torch.mean(t, dim=-1)
        c = [t[:, i] for i in range(8)]
        l2r = c[0]
        for i in range(1, 8):
            l2r = l2r + c[i]
        tree = ((c[0] + c[1]) + (c[2] + c[3])) + ((c[4] + c[5])
                                                  + (c[6] + c[7]))
        acc4 = (((c[0] + c[4]) + (c[1] + c[5])) + (c[2] + c[6])) + (c[3]
                                                                    + c[7])
        out[layout] = {k: float((m == v / 8).double().mean())
                       for k, v in (("left_to_right", l2r), ("lane_tree", tree),
                                    ("four_accumulators", acc4))}
    return out


def k1_work(metric, scene, integ, y0, dt0):
    """The work of K1 on these rays, from the plain step body stepped on
    the card: per-ray iterations (accepted and rejected steps), accepted
    steps, hits, and the plain body's operations per ray-iteration and per
    localization."""
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (localize_events_cm,
                                                         make_step_cm,
                                                         scene_event_cm)
    event_fn = scene_event_cm(scene)
    init, body = make_step_cm(metric, event_fn, integ)
    with torch.no_grad():
        st = init(y0.t().contiguous(), dt0)
        one = lambda t: t[..., :1]  # noqa: E731
        step_flops = count_flops(lambda: body(type(st)(*map(one, st))))
        iters = torch.zeros(y0.shape[0], dtype=torch.int64, device=y0.device)
        it = 0
        while it < integ.max_steps and bool(st.active.any()):
            iters += st.active
            st, _ = body(st)
            it += 1
        loc_flops = count_flops(lambda: localize_events_cm(
            metric, event_fn, integ, one(st.ev_y0), one(st.ev_dt),
            one(st.ev_lo), one(st.ev_hi)))
    return dict(iters=iters, steps=st.steps.to(torch.int64),
                hits=int(st.hit.sum()), step_flops=step_flops,
                loc_flops=loc_flops)


def diagnose_k1(dev, card: str, sizes=(200, 1024)):
    """K1 on example2 f32 (the bench configuration), the diagnosis of where
    its time goes; one record per measurement. At each size: the kernel's
    device time alone (profiler), CUDA events around its C entry point with
    the parameter block built beforehand, around the whole
    ``integrate_rays_cuda`` call, around ``render_fn``, and the eager
    initial step alone; the step census from the plain body on the card
    (warp-iterations in launch order, the useful share of lanes, K1's
    bound) and scheduler cycles per warp-iteration at the SM clock nvidia-smi
    reads under load. At 200x200, K1 with max_steps capped (``K1_CAPS``):
    the slope is the slowest warps' time per iteration. Then the order
    ``torch.mean`` adds in, and a profile of one rk4/200 forward pass of
    the training path (K3's launches and the gaps between them)."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.scenes import build, example2_spec
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    from raytracegr_jl_tpu_torch.render import initial_dt
    takes_none = k1_takes_own_step()
    integ = rt.IntegratorConfig(method="tsit5", rtol=RTOL_F32, atol=RTOL_F32,
                                max_steps=20_000)
    cfg = rt.RenderConfig(integrator=integ)
    recs = []
    for n in sizes:
        metric, scene, canvas = build(example2_spec(n, n), torch.float32, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        dt0 = initial_dt(metric, y0, integ)
        entry = k1_entry(metric, scene, integ, y0, dt0)
        fn = rt.render_fn(metric, scene, cfg)
        rec = dict(kind="k1", rays=n * n, card=card,
                   kernel_alone_ms=kernel_alone_ms(entry, "k1_kernel"),
                   c_entry_ms=cuda_ms(entry),
                   call_ms=cuda_ms(lambda: integrate_rays_cuda(
                       metric, scene, y0, dt0, integ)),
                   main_call_ms=cuda_ms(k1_main_call(metric, scene, y0, dt0,
                                                     integ)),
                   render_ms=cuda_ms(lambda: fn(canvas.pos, canvas.normal)),
                   initial_dt_ms=cuda_ms(lambda: initial_dt(metric, y0,
                                                            integ)))
        if takes_none:
            own = k1_entry(metric, scene, integ, y0, None)
            rec.update(
                kernel_alone_dt0_none_ms=kernel_alone_ms(own, "k1_kernel"),
                c_entry_dt0_none_ms=cuda_ms(own))
        steps = entry().to(torch.int64)
        work = k1_work(metric, scene, integ, y0, dt0)
        rec["census_steps_differ_from_k1"] = int((work["steps"]
                                                  != steps).sum())
        warp_it, useful = warp_stats(work["iters"])
        warp_acc, useful_acc = warp_stats(steps)
        mhz, max_mhz = sm_clock_mhz(entry)
        t_ms = rec["kernel_alone_ms"] or rec["c_entry_ms"]
        slots = (t_ms * 1e-3 * SCHEDULERS * mhz * 1e6 / warp_it
                 if mhz else None)
        B = y0.shape[0]
        flops = (int(work["iters"].sum()) * work["step_flops"]
                 + work["hits"] * work["loc_flops"])
        b_ms, b_by = bound(flops, B * 9 * 4 + B * 11 * 4)
        rec.update(ray_iterations=int(work["iters"].sum()),
                   accepted=int(steps.sum()), hits=work["hits"],
                   steps_p50=int(steps.median()),
                   steps_max=int(steps.max()),
                   steps_mean=float(steps.double().mean()),
                   warp_iterations=warp_it, useful_share=useful,
                   warp_accepted_steps=warp_acc,
                   useful_share_accepted=useful_acc,
                   flops_per_step=work["step_flops"],
                   flops_per_localization=work["loc_flops"],
                   bound_ms=b_ms, bound_by=b_by, sm_clock_mhz=mhz,
                   max_sm_clock_mhz=max_mhz,
                   scheduler_cycles_per_warp_iteration=slots)
        recs.append(rec)
        if n == 200:
            caps = {c: cuda_ms(k1_entry(metric, scene, integ, y0, dt0, c))
                    for c in K1_CAPS}
            xs, ys = list(caps), list(caps.values())
            mx, my = statistics.mean(xs), statistics.mean(ys)
            slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                     / sum((x - mx) ** 2 for x in xs))
            recs.append(dict(kind="k1_caps", rays=n * n, card=card,
                             ms_by_cap=caps, us_per_iteration=slope * 1e3,
                             intercept_ms=my - slope * mx))
    recs.append(dict(kind="mean_order", card=card,
                     shares=mean_order_probe(dev)))
    recs.append(dict(kind="k3_trace", card=card, **k3_trace(dev)))
    return recs


def k3_trace(dev):
    """One rk4/200 forward pass of the training path at 200x200 f32
    (``k3_pass``) under the profiler: K3's device kernels, their
    durations and the gaps between them (us), and the pass's wall time."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.scenes import build, example2_spec
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    f32 = torch.float32
    integ = rt.default_inverse_cfg(f32, max_steps=200, method="rk4",
                                   rk4_dt=0.5, stop_rho=0.5).integrator
    metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(
        torch.tensor(1.05, dtype=f32, device=dev),
        torch.tensor(0.0, dtype=f32, device=dev)), rho_min=0.25)
    _, scene, canvas = build(example2_spec(200, 200), f32, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    seg = adj.segment_length(integ, integ.grad_seg_len)
    route = adj.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                      n_seg=integ.max_steps // seg, cuda=True)
    y0 = y0.t().contiguous()
    out = {}

    def run():
        t0 = time.perf_counter()
        out["n_used"] = int(k3_pass(route, y0)[1][0])
        out.setdefault("wall_ms", []).append((time.perf_counter() - t0) * 1e3)

    evs = profiled_kernels(run, ("k3_kernel", "k3_close"), reps=1)
    return dict(segments=out["n_used"],
                kernels=[e[0].split("(")[0][-40:] for e in evs],
                durations_us=[round(b - a, 3) for _, a, b in evs],
                gaps_us=[round(b[1] - a[2], 3) for a, b in zip(evs, evs[1:])],
                first_to_last_us=(round(evs[-1][2] - evs[0][1], 3)
                                  if evs else None),
                pass_wall_ms=round(out["wall_ms"][-1], 4))


def disk_setup(dev):
    """The disk main path's configuration, rays and initial steps
    (1024x1024 f32): ``(cfg, metric, scene, canvas, y0, dt0)``."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.render import initial_dt
    cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=RTOL_F32, atol=RTOL_F32,
        max_steps=DISK_MAX_STEPS, stop_rho=1.0, sort_rays=True),
        shading="redshift")
    metric, scene, canvas = rt.build(rt.accretion_disk_spec(DISK_N, DISK_N),
                                     torch.float32, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, cfg.integrator)
    return cfg, metric, scene, canvas, y0, dt0


def packed_tail(metric, scene, integ, y0, dt0):
    """The state after the disk main path's second chunk: the sorted batch
    at budget 64, packed as trace_batch_compacted packs it, at budget
    128."""
    from raytracegr_jl_tpu_torch import compaction as C
    from raytracegr_jl_tpu_torch.ops.adjoint import P_ACTIVE
    _, y_cm, dt_s = C.sorted_batch(y0, dt0)
    P1 = C.chunk_cuda(metric, scene, integ, 64, y_cm=y_cm, dt0=dt_s)[0]
    active = P1[P_ACTIVE] > 0
    size = -(-y0.shape[0] // C.PACK_UNIT) * C.PACK_UNIT
    keep = C.pack_slots(active, int(active.sum()), size)
    require(keep is not None, "the first chunk's survivors did not pack")
    return C.chunk_cuda(metric, scene, integ, 128,
                        P=P1.index_select(1, keep))[0]


def k2_at(args, P: torch.Tensor, budget: int, threads: int):
    """K2 resumed on the state ``P`` at ``threads`` per block: its C entry
    point called directly, since ``chunk_cuda`` launches the kernels' one
    block size. The diagnosis's own launches, not counted. ``args`` from
    ``chunk_args``."""
    from raytracegr_jl_tpu_torch import compaction as C
    prm, flags = args
    B = P.shape[1]
    out, y_fin, lam = torch.empty_like(P), P.new_empty((8, B)), P.new_empty(B)
    fn = C._lib().rtgr_k2_f32 if P.dtype == torch.float32 else \
        C._lib().rtgr_k2_f64
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    rc = fn(ptr(P), ptr(None), ptr(None), ptr(out), ptr(y_fin), ptr(lam),
            ptr(prm), B, *flags, int(budget), 0, int(threads),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    require(rc == 0, f"K2 at {threads} threads: CUDA error {rc}")
    return out, y_fin, lam


def diagnose_tail(dev, block_sizes=TAIL_BLOCKS, budget: int = TAIL_BUDGET):
    """K2 on the disk's packed tail state (after the main path's second
    chunk) at a fixed budget of iterations, medians of 3 after a warm-up:
    replicated 1x, 2x and 4x (identical work per ray) and cut to a half and
    a quarter, through ``chunk_cuda``; then at each of ``block_sizes``
    threads per block, each launch's result bitwise equal to the one at
    the largest. Returns one record per timing."""
    from raytracegr_jl_tpu_torch import compaction as C
    from raytracegr_jl_tpu_torch.ops.adjoint import P_ACTIVE
    cfg, metric, scene, _, y0, dt0 = disk_setup(dev)
    integ = cfg.integrator
    tail = packed_tail(metric, scene, integ, y0, dt0)
    n = tail.shape[1]

    def median_ms(fn, reps=3):
        return statistics.median([events_ms(fn) for _ in range(reps + 1)][1:])

    recs = []
    for label, P in (("quarter", tail[:, : n // 4].contiguous()),
                     ("half", tail[:, : n // 2].contiguous()),
                     ("1x", tail), ("2x", torch.cat([tail] * 2, 1)),
                     ("4x", torch.cat([tail] * 4, 1))):
        recs.append(dict(
            kind="tail", copies=label, rays=P.shape[1], budget=budget,
            active=int((P[P_ACTIVE] > 0).sum()), threads=128,
            ms=median_ms(lambda: C.chunk_cuda(metric, scene, integ, budget,
                                              P=P))))
    if block_sizes:
        args = C.chunk_args(metric, scene, integ, tail)
        ref = k2_at(args, tail, budget, max(block_sizes))
        for t in block_sizes:
            got = k2_at(args, tail, budget, t)
            require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                    f"K2 at {t} threads differs from {max(block_sizes)}")
            recs.append(dict(kind="tail_block", copies="1x", rays=n,
                             budget=budget, threads=t,
                             ms=median_ms(lambda: k2_at(args, tail, budget,
                                                        t))))
    return recs


# The inversion slice (BASELINE config 5): the lensing scene at 32x32 f32,
# the JAX package's heavy test's fit (tests/test_inverse.py:69-107). Its
# bars: M within 1% of the truth's 0.5 and |z| below 0.01 after 60 Adam
# steps. The vectorized multistart against the serial one: the same start
# selected, and the loss histories within VEC_SERIAL_RTOL of each other
# (relative to the largest loss): K3 and K4 are bitwise equal grouped and
# ungrouped, but the camera, the losses' means and the (M, a) cotangent
# sums reduce over other batch shapes, so the f32 losses differ by a few
# units in the last place, which 10 Adam steps do not amplify past 1e-4.
INV_N = 32
INV_STEPS = 60
INV_STARTS = ((0.5, 0.0), (0.53, 0.03), (0.47, -0.05), (0.51, 0.1))
VEC_SERIAL_RTOL = 1e-4


def inverse_case(dev, dtype, method: str, starts=INV_STARTS, n: int = INV_N,
                 refine: bool = False):
    """The lensing scene at n x n for each (M, z) start: per start its
    (route, launch states [8, B]) on the card, and the grouped route over
    all starts' rays (start-major, one table row per start) with their
    launch states; with ``refine``, refine_minima on."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    integ = rt.default_inverse_cfg(dtype, max_steps=120, method=method,
                                   rk4_dt=0.5, stop_rho=0.5).integrator
    integ = integ._replace(lam_max=60.0, refine_minima=refine)
    spec = rt.lensing_inverse_spec(n, n)
    _, scene, _ = rt.build(spec, dtype, dev)
    xg, ng = rt.flat_pixel_grid(spec, dtype, dev)
    seg = adj.segment_length(integ, integ.grad_seg_len)
    singles, rows = [], []
    with torch.no_grad():
        for M, z in starts:
            metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(
                torch.tensor(M, dtype=dtype, device=dev),
                torch.tensor(0.0, dtype=dtype, device=dev)),
                r_formula="textbook", rho_min=0.25)
            sc = scene._replace(pos=scene.pos.clone())
            sc.pos[0, 3] = z
            x, u = pixel_rays(metric, xg, ng)
            y0 = torch.cat([x, u], -1)
            singles.append((adj.Route(metric=metric, scene=sc, cfg=integ,
                                      seg_len=seg,
                                      n_seg=integ.max_steps // seg,
                                      cuda=True), y0.t().contiguous()))
            rows.append(adj.flatten_params(metric, sc))
    grouped = singles[0][0]._replace(groups=torch.stack(rows).contiguous())
    return singles, grouped, torch.cat([y for _, y in singles], dim=1)


def config5_starts(n: int):
    """``n`` (M, z) starts of config 5: INV_STARTS' first n up to 4, and
    16 spread over M in [0.48, 0.52] and z in [-0.06, 0.06]."""
    if n <= len(INV_STARTS):
        return INV_STARTS[:n]
    return tuple((0.5 + 0.01 * ((k % 5) - 2), 0.02 * ((k % 7) - 3))
                 for k in range(n))


# K4's work-order cases (tests/test_torch_cuda.py's, whose f64 "every end"
# this run leaves to those tests and to the f64 "K3/K4 vs plain" phases):
# example2 RK4 at n x n, max_steps steps of dt. "ragged": 225 rays, a
# multiple of no block size, at config 5's segments of 15; "one end": every
# ray 15 steps from the end of its span, which none reaches a surface in, so
# all end in segment 2; "every end": spans cut at 1 to max_steps steps and
# every fifth ray inactive from the start, so that the ends cover every
# segment. Then grouped config 5 (32x32 a start) at 1, 4 and 16 starts.
K4_ORDER_CASES = (("ragged", 15, torch.float32, 120, 0.2),
                  ("one end", 16, torch.float32, 100, 0.1),
                  ("every end", 16, torch.float32, 100, 0.1))
K4_ORDER_STARTS = (1, 4, 16)
# Up to this many starts the grouped K4 is held to its plain version too.
K4_PLAIN_STARTS = 4
# K4's work order alone against the stable sort (rays, bins, ends): one ray
# to 1,048,576, a tile's edges (1,023, 1,025), config 5's 16 starts
# (16,384), a rank of the sharded W = 2 step (20,000), the training batch
# (40,000) at rk4/200's 26 and tsit5/48's 7 bins; random ends, every ray at
# one end of 26, and one bin.
WORK_ORDER_SIZES = ((1, 26, "random"), (1_023, 26, "random"),
                    (1_025, 7, "random"), (16_384, 26, "random"),
                    (20_000, 26, "random"), (40_000, 26, "random"),
                    (40_000, 7, "random"), (40_000, 26, "one end"),
                    (40_000, 1, "random"), (1 << 20, 26, "random"))


def k4_order_case(dev, case: str, n: int, dtype, max_steps: int, dt: float):
    """One of K4_ORDER_CASES on the card: (route, launch states [8, B],
    packed start or None). The one-end and every-end batches start from a
    packed state that K3's prologue does not make (near their span's end,
    some inactive): K4 walks the plain chain's checkpoints there."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    integ = rt.default_inverse_cfg(dtype, max_steps=max_steps, method="rk4",
                                   rk4_dt=dt, stop_rho=0.5).integrator
    _, scene, canvas = rt.build(rt.example2_spec(n, n), dtype, dev)
    metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(M=1.05),
                            rho_min=0.25)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    y0 = y0.t().contiguous()
    seg = adj.segment_length(integ, integ.grad_seg_len)
    route = adj.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                      n_seg=max_steps // seg, cuda=True)
    if case == "ragged":
        return route, y0, None
    P = adj.init_plain(route, y0)
    if case == "one end":
        P[adj.P_LAM] = integ.lam_max - 15 * dt
    elif case == "every end":
        k = torch.arange(P.shape[1], device=dev)
        P[adj.P_LAM] = integ.lam_max - (1 + (k * 7) % max_steps).to(
            P.dtype) * dt
        P[adj.P_ACTIVE, ::5] = 0
    return route, y0, P


def k4_vs_plain(label: str, route, y0, P=None, seed: int = 5, plain=None):
    """K3 from the launch states ``y0`` against its plain chain (for a
    packed start ``P``, the plain chain from ``P`` alone: ``chain_plain``),
    then K4 as the wrapper launches it (its work order, then K4 in that
    order) on those checkpoints, bitwise equal to ``k4_plain`` (the walk
    and the initial state's VJP) on the plain chain's. ``plain``:
    (cotangent, k4_plain's output) of these rays, taken from a larger
    batch that holds them (rays are independent), in place of the plain
    version. Returns (the rays' end segments, max |d|, the plain version's
    output, the cotangent)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    if P is not None:
        ck, used = adj.chain_plain(route._replace(cuda=False), P)
        err, ck_p, used_p = 0.0, ck, used
    elif plain is None:
        err, ck, used, ck_p, used_p = require_k3_equal(label, route, y0)
    else:
        (ck, used), err = k3_pass(route, y0), 0.0
    if plain is None:
        ct = state_ct(y0, seed)
        want = adj.k4_plain(route._replace(cuda=False), ck_p, used_p[1:], ct)
    else:
        ct, want = plain
    ends = used[1:]
    c, p = adj.backward_cuda(route, ck, ends, ct)
    torch.cuda.synchronize()
    err = max(err, max_err(c, want[0]), max_err(p, want[1]))
    require(bits_equal(c, want[0]) and bits_equal(p, want[1]),
            f"{label}: K4 not bitwise equal to the plain version (max |d| "
            f"{err:.3e})")
    return ends, err, want, ct


def k4_order_slice(dev, card: str) -> float:
    """K4 and its work order (the order's kernel against the stable sort)
    against the plain versions on K4_ORDER_CASES and grouped config 5 at
    K4_ORDER_STARTS starts (each start's rays also against its own
    ungrouped launch; above K4_PLAIN_STARTS starts against those launches
    only), and the work order alone at WORK_ORDER_SIZES. Returns the
    largest |d| (0: bitwise)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    t0 = time.perf_counter()
    err, lines = 0.0, []
    for case, n, dtype, max_steps, dt in K4_ORDER_CASES:
        label = f"{case} example2 {n}x{n} {str(dtype)[6:]} rk4/{max_steps}"
        route, y0, P = k4_order_case(dev, case, n, dtype, max_steps, dt)
        ends, e, _, _ = k4_vs_plain(label, route, y0, P)
        err = max(err, e)
        require(torch.equal(adj.work_order_cuda(ends, route.n_seg),
                            adj.work_order(ends)),
                f"{label}: K4's work order differs from the stable sort")
        hist = torch.bincount(ends, minlength=route.n_seg + 1)
        require(bool((hist > 0).all()) if case == "every end" else
                int(hist[2]) == y0.shape[1] if case == "one end" else
                y0.shape[1] % 32 != 0, f"{label}: ends {hist.tolist()}")
        lines.append(f"{label}:{hist.tolist()}")
    # The 4 starts' plain version holds the 1 start's rays too: its batch
    # is their first 1,024 rays. 16 starts: against each start's own
    # launch only, which the plain version holds at 1 and 4 starts.
    starts = INV_STARTS + config5_starts(16)[:12]
    plain = None
    for n in sorted(K4_ORDER_STARTS, reverse=True):
        label = f"grouped config 5 {n} starts"
        singles, grouped, y0 = inverse_case(dev, torch.float32, "rk4",
                                            starts=starts[:n])
        if n > K4_PLAIN_STARTS:
            ck, used = k3_pass(grouped, y0)
            ends, e, ct = used[1:], 0.0, state_ct(y0, 5)
            c, p = adj.backward_cuda(grouped, ck, ends, ct)
        else:
            if plain is not None:  # the first y0.shape[1] rays of 4 starts
                ct4, (c4, p4) = plain
                r = y0.shape[1]
                plain = (ct4[:, :r].contiguous(), (c4[:, :r], p4[:r]))
            ends, e, (c, p), ct = k4_vs_plain(label, grouped, y0,
                                              plain=plain)
            plain = plain or (ct, (c, p))
        err = max(err, e)
        require(torch.equal(adj.work_order_cuda(ends, grouped.n_seg),
                            adj.work_order(ends)),
                f"{label}: K4's work order differs from the stable sort")
        B = singles[0][1].shape[1]
        for s, (route, y) in enumerate(singles):
            rays = slice(s * B, (s + 1) * B)
            ck_s, used_s = k3_pass(route, y)
            c_s, p_s = adj.backward_cuda(route, ck_s, used_s[1:],
                                         ct[:, rays].contiguous())
            torch.cuda.synchronize()
            require(bits_equal(c_s, c[:, rays]) and bits_equal(p_s, p[rays]),
                    f"{label}: start {s} differs from its own launch")
        lines.append(f"{label}:{int(ends.max())}")
    # The work order alone at WORK_ORDER_SIZES, and its time at 40,000 and
    # 1,048,576 rays (profiler, the kernel alone) beside the stable sort's.
    gen = torch.Generator(device=dev).manual_seed(17)
    order_ms = {}
    for n_rays, bins, kind in WORK_ORDER_SIZES:
        ends = torch.randint(0, bins, (n_rays,), generator=gen, device=dev,
                             dtype=torch.int32)
        if kind == "one end":
            ends.fill_(bins // 2)
        call = lambda: adj.work_order_cuda(ends, bins - 1)  # noqa: E731
        require(torch.equal(call(), adj.work_order(ends)),
                f"K4's work order differs from the stable sort at {n_rays} "
                f"rays, {bins} bins, {kind} ends")
        if kind == "random" and n_rays in (40_000, 1 << 20) and bins == 26:
            order_ms[n_rays] = (
                f"{kernels_ms(call, ('k4_order',)):.5f}/"
                f"{kernels_ms(lambda: adj.work_order(ends)):.5f}")
    phase("K4 and its work order vs plain", t0,
          card=repr(card), cases=lines, max_abs_err=err,
          work_order_sizes_bitwise=len(WORK_ORDER_SIZES),
          work_order_alone_ms_over_sort_ms=order_ms)
    return err


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    bits = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(bits), b.view(bits))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


def adjoint_work(route, y0, ct, n_used: int) -> dict:
    """This run's work of K3 and K4 from the launch states ``y0 [8, B]``
    over ``n_used`` segments: K3's prologue (each ray's initial state,
    ``init_plain``: k1 = rhs(y0), and for Tsit5 Hairer's first step, one
    more rhs) and each ray's iterations while active, at the plain
    version's count for one ray (the first group's, on a grouped route);
    K4 also each accepted step's reverse step at step_vjp's count (for
    RK4 less its three forward right-hand sides, whose values K4 keeps
    from the replay); K10 the initial state's VJP (one rhs_vjp per ray);
    and their bounds (``bound``: K3 reads y0 and writes the initial state
    and the state of each segment, K4 reads the checkpoints and the
    cotangent and writes the initial state's cotangent and the (M, a)
    cotangents, K10 reads y0, that cotangent's y, k1 and ev_y0 planes and
    the (M, a) cotangents and writes ct_y0 and the (M, a) cotangents)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (make_step_cm,
                                                         scene_event_cm)
    plain = route._replace(cuda=False)
    R = y0.shape[1]
    with torch.no_grad():
        P0 = packed_start(route, y0)
        metric, scene = adj.route_rows(plain, R)
        _, body = make_step_cm(metric, scene_event_cm(scene), route.cfg)
        first = (plain._replace(groups=route.groups[:1])
                 if route.groups is not None else plain)
        m1, s1 = adj.route_rows(first, 1)
        _, body1 = make_step_cm(m1, scene_event_cm(s1), route.cfg)
        st = adj.unpack_state(P0)
        one = lambda t: t[..., :1]  # noqa: E731
        step_flops = count_flops(lambda: body1(type(st)(*map(one, st))))
        init_flops = count_flops(lambda: packed_start(first, one(y0)))
        p = adj.adj_params(m1, P0.dtype, P0.device)
        tsit5 = route.cfg.method == "tsit5"
        vjp_flops = count_flops(lambda: adj.step_vjp(
            p, tsit5, one(st.y), one(st.k1), one(st.dt),
            one(ct[adj.P_Y:adj.P_Y + 8]), one(ct[adj.P_K1:adj.P_K1 + 8])))
        if not tsit5:  # K4 keeps the replay's stages: no forward rhs
            vjp_flops -= 3 * count_flops(lambda: adj.geodesic_cm(
                p.metric, one(st.y)))
        init_vjp_flops = count_flops(lambda: adj.rhs_vjp(
            p, one(st.y), one(ct[adj.P_K1:adj.P_K1 + 8])))
        iters = accepted = 0
        for _ in range(n_used * route.seg_len):
            iters += int(st.active.sum())
            st, rec = body(st)
            accepted += int(rec.do.sum())
    size = y0.element_size()
    table = route.groups.numel() * size if route.groups is not None else 0
    return dict(
        iters=iters, accepted=accepted, step_flops=step_flops,
        vjp_flops=vjp_flops, init_flops=init_flops,
        init_vjp_flops=init_vjp_flops,
        k3_bound=bound(R * init_flops + iters * step_flops,
                       8 * R * size + (2 * n_used + 1) * adj.N_PLANES * R
                       * size + table),
        k4_bound=bound(iters * step_flops + accepted * vjp_flops,
                       (n_used + 2) * adj.N_PLANES * R * size
                       + R * 2 * size + table),
        k10_bound=bound(R * init_vjp_flops,
                        (8 + 24 + 2 + 8 + 2) * R * size + table))


# The initial state's VJP (init_vjp, K4's epilogue's plain version)
# against torch autograd of make_step_cm's init, f64: the two round apart
# only in the order of their sums.
INIT_GRAD_RTOL = 1e-12


def init_autograd_gap(route, y0, seed: int = 6) -> float:
    """``init_vjp`` against torch autograd of ``make_step_cm``'s init at
    the launch states ``y0 [8, B]`` on one random cotangent of every
    plane, with M and a per ray on a grouped route: the largest relative
    gap of y0's cotangent (against its largest entry) and of the (M, a)
    cotangents (per ray against their largest; a shared value's sum
    against the sum of the per-ray magnitudes). Requires ``init_plain`` to
    equal the autograd forward bit for bit."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (initial_dt,
                                                         make_step_cm,
                                                         scene_event_cm)
    from raytracegr_jl_tpu_torch.ops.metrics import KerrSchildParams
    plain = route._replace(cuda=False)
    metric, scene = adj.route_rows(plain, y0.shape[1])
    as_t = lambda v: torch.as_tensor(  # noqa: E731
        v, dtype=y0.dtype, device=y0.device).detach().clone()
    M, a = as_t(metric.params.M).requires_grad_(), \
        as_t(metric.params.a).requires_grad_()
    ct = state_ct(y0, seed)
    yt = y0.clone().requires_grad_()
    m = metric._replace(params=KerrSchildParams(M, a))
    with torch.no_grad():
        dt0 = initial_dt(metric, y0.t(), route.cfg)
    init, _ = make_step_cm(m, scene_event_cm(scene), route.cfg)
    P = adj.pack_state(init(yt, dt0))
    want = torch.autograd.grad((P * ct).sum(), (yt, M, a))
    got_y, pbar = adj.init_vjp(plain, y0, ct, torch.zeros(
        (y0.shape[1], 2), dtype=y0.dtype, device=y0.device))
    require(bits_equal(adj.init_plain(plain, y0), P.detach()),
            "init_plain differs from make_step_cm's init")
    gaps = [float((got_y - want[0]).abs().max() / want[0].abs().max())]
    for k in range(2):
        got, ref = pbar[:, k], want[1 + k]
        if ref.dim() == 0:
            gaps.append(float((got.sum() - ref).abs()
                              / got.abs().sum().clamp_min(1e-300)))
        else:
            gaps.append(float((got - ref).abs().max()
                              / ref.abs().max().clamp_min(1e-300)))
    return max(gaps)


FIT_NAMES = ("M", "a", "sphere_pos")
# Replays (and graphed Adam steps) after the first under sync debug mode.
GRAPH_REPLAYS = 5


def same_fit(a, b) -> bool:
    """Two FitResults bit for bit: the loss and parameter histories, the
    final parameters, Adam's state."""
    return (bits_equal(a.loss_history, b.loss_history)
            and a.opt_state["step"] == b.opt_state["step"]
            and all(bits_equal(a.params_history[n], b.params_history[n])
                    and bits_equal(getattr(a.final_params, n).detach(),
                                   getattr(b.final_params, n).detach())
                    and all(bits_equal(a.opt_state[k][n], b.opt_state[k][n])
                            for k in ("exp_avg", "exp_avg_sq"))
                    for n in FIT_NAMES))


def adam_steps(loss_fn, make_params, trainable=None, lr: float = 5e-3):
    """One Adam step of ``fit``'s loop on ``loss_fn``, eager and graphed,
    each over its own parameters from ``make_params()``: zero the
    gradients, the loss and its backward pass (or a replay), the masks,
    Adam's step. Returns ``(eager, graphed, peak bytes while the graph
    was built)``."""
    from raytracegr_jl_tpu_torch.step_graph import GraphedStep
    pe, pg = make_params(), make_params()
    oe = torch.optim.Adam(pe.parameters(), lr=lr)
    og = torch.optim.Adam(pg.parameters(), lr=lr)

    def masked(p):
        if trainable is not None:
            with torch.no_grad():
                for n in FIT_NAMES:
                    getattr(p, n).grad.mul_(getattr(trainable, n))

    def eager():
        oe.zero_grad(set_to_none=False)
        loss_fn(pe).sum().backward()
        masked(pe)
        oe.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step = GraphedStep(loss_fn, pg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base

    def graphed():
        og.zero_grad(set_to_none=False)
        step.replay()
        masked(pg)
        og.step()

    return eager, graphed, peak


def eager_peak(fn) -> int:
    """Peak bytes allocated above the current while ``fn()`` runs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def require_grouped_equal(label: str, dev, dtype, method: str,
                          refine: bool = False):
    """Grouped K3 (with k3_close) and K4 against their grouped plain
    versions on the same CUDA tensors, and against one ungrouped launch
    per start, ray by ray; all bitwise. Returns (max |d|, segments,
    hits)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    singles, grouped, y0 = inverse_case(dev, dtype, method, refine=refine)
    B = singles[0][1].shape[1]

    err, ck_k, used_k, ck_p, used_p = require_k3_equal(
        f"{label} grouped", grouped, y0)
    n_k = int(used_k[0])
    ct = state_ct(y0, 1)
    c_k, p_k = adj.backward_cuda(grouped, ck_k, used_k[1:], ct)
    c_p, p_p = adj.k4_plain(grouped._replace(cuda=False), ck_p, used_p[1:],
                            ct)
    torch.cuda.synchronize()
    err = max(err, max_err(c_k, c_p), max_err(p_k, p_p))
    require(bits_equal(c_k, c_p) and bits_equal(p_k, p_p),
            f"{label}: grouped K4 not bitwise equal to the grouped plain "
            f"version (max |d| {err:.3e})")
    fin = ck_k[grouped.n_seg]
    for s, (route, y) in enumerate(singles):
        rays = slice(s * B, (s + 1) * B)
        ck, used = k3_pass(route, y)
        c, p = adj.backward_cuda(route, ck, used[1:], ct[:, rays])
        torch.cuda.synchronize()
        require(int(used[0]) <= n_k
                and bits_equal(ck[0], ck_k[0][:, rays])
                and bits_equal(ck[route.n_seg], fin[:, rays])
                and bits_equal(c, c_k[:, rays]) and bits_equal(p, p_k[rays]),
                f"{label}: start {s}: the grouped launch differs from its "
                "own ungrouped launch")
    hits = int(fin[adj.P_HIT].sum())
    require(hits > 0, f"{label}: no ray hit the sphere")
    if dtype == torch.float64:
        gap = init_autograd_gap(grouped, y0)
        require(gap <= INIT_GRAD_RTOL, f"{label}: the grouped initial "
                f"state's VJP differs from autograd by {gap:.3e}")
    return err, n_k, hits


def inverse_slice(dev, card: str, reset_counts) -> list:
    """The inversion slice: grouped K3 and K4 against their grouped plain
    versions and against ungrouped launches (f32 and f64), config 5's
    recovery through fit (K3 and K4 on the card), the vectorized
    multistart (the main path of this slice: one grouped K3 and K4 launch
    per Adam step, counted) against the serial one, step times at N = 1,
    4 and 16, a resumed fit against an uninterrupted one, the grouped
    kernels' times, their plain versions' and their bounds, and the
    lensing scene's fixed scene code against SC_ANY. Returns the grouped
    K3 and K4 entries of the kernels line."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models import camera as cam
    from raytracegr_jl_tpu_torch.models import objects
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import SC_ANY
    from raytracegr_jl_tpu_torch.step_graph import WARMUP_PASSES
    from raytracegr_jl_tpu_torch.utils import checkpoint
    f32 = torch.float32
    CAPTURED = WARMUP_PASSES + 1  # each kernel's launches as a graph is built

    # 1. Grouped against plain, and against one launch per start.
    grouped_err = 0.0
    for dtype, method in ((f32, "rk4"), (torch.float64, "rk4"),
                          (f32, "tsit5")):
        t0 = time.perf_counter()
        label = f"lensing {INV_N}x{INV_N} {str(dtype)[6:]} {method}"
        err, n_used, hits = require_grouped_equal(label, dev, dtype, method)
        grouped_err = max(grouped_err, err)
        phase(f"grouped K3/K4 vs plain and vs ungrouped {label}", t0,
              starts=len(INV_STARTS), segments=n_used, hits=hits,
              max_abs_err=err)

    # 2. Config 5's recovery through K3 and K4.
    t0 = time.perf_counter()
    spec = rt.lensing_inverse_spec(INV_N, INV_N)
    cfg = rt.default_inverse_cfg(f32, max_steps=120, rk4_dt=0.5,
                                 soft_temp=0.05, stop_rho=0.5)._replace(
        soft_freq=2.0)
    cfg = cfg._replace(integrator=cfg.integrator._replace(lam_max=60.0))
    truth = rt.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], f32, dev)
    with torch.no_grad():
        target = rt.make_render_for_params(spec, cfg, 0, f32, dev)(truth)
    trainable = rt.InverseParams(1.0, 0.0, [0.0, 0.0, 0.0, 1.0], f32, dev)
    kw = dict(sphere_index=0, trainable=trainable, dtype=f32, device=dev)
    init = rt.InverseParams(0.53, 0.0, [0.0, 5.0, 12.0, 0.03], f32, dev)
    reset_counts()
    torch.cuda.synchronize()
    tw = time.perf_counter()
    res = rt.fit(spec, target, init, cfg, steps=INV_STEPS,
                 learning_rate=5e-3, graph=False, **kw)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - tw) * 1e3 / INV_STEPS
    k3n, k4n = adj.forward_segment_cuda.launches, adj.backward_cuda.launches
    k6n, k7n = adj.localize_cuda.launches, adj.localize_vjp_cuda.launches
    k8n, k9n = cam.pixel_rays_cuda.launches, cam.pixel_rays_vjp_cuda.launches
    k11n, k12n = objects.shade_cuda.launches, objects.shade_vjp_cuda.launches
    m = float(res.params.M.detach())
    z = float(res.params.sphere_pos.detach()[3])
    hist = res.loss_history.tolist()
    phase("config 5 recovery lensing 32x32 f32 60 Adam steps", t0,
          card=repr(card), M=f"{m:.7f}", z=f"{z:.7f}",
          M_rel_err=f"{abs(m - 0.5) / 0.5:.3e}",
          best_loss=f"{float(res.loss):.6e}", first_loss=f"{hist[0]:.6e}",
          last_loss=f"{hist[-1]:.6e}",
          losses=[f"{v:.4e}" for v in hist[::6]],
          ms_per_step=f"{fit_ms:.3f}", k3_launches=k3n, k4_launches=k4n,
          k6_launches=k6n, k7_launches=k7n, k8_launches=k8n,
          k9_launches=k9n, k11_launches=k11n, k12_launches=k12n)
    require(k3n == k4n == k6n == k7n == k8n == k9n == k11n == k12n
            == INV_STEPS, f"config 5: {k3n} K3, {k4n} K4, {k6n} K6, {k7n} "
            f"K7, {k8n} K8, {k9n} K9, {k11n} K11 and {k12n} K12 launches in "
            f"{INV_STEPS} steps")
    require(abs(m - 0.5) / 0.5 < 0.01 and abs(z) < 0.01,
            f"config 5 not recovered: M {m}, z {z}")
    require(float(res.params.a.detach()) == 0.0, "config 5: the spin moved")

    # 3. The vectorized multistart (this slice's main path, counted) against
    #    the serial one, and step times at N = 1, 4 and 16.
    t0 = time.perf_counter()

    def inits(n):
        return [rt.InverseParams(0.5 + 0.04 * ((k % 5) - 2) / 2, 0.0,
                                 [0.0, 5.0, 12.0, 0.02 * ((k % 7) - 3)],
                                 f32, dev) for k in range(n)]

    def timed_fit(n, vectorized, steps, graph=False):
        starts = inits(n)
        reset_counts()
        torch.cuda.synchronize()
        tw = time.perf_counter()
        r = rt.fit_multistart(spec, target, starts, cfg,
                              vectorized=vectorized, steps=steps,
                              learning_rate=5e-3, graph=graph, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - tw) * 1e3 / steps
        return r, ms, (adj.forward_segment_cuda.launches,
                       adj.backward_cuda.launches, adj.localize_cuda.launches,
                       adj.localize_vjp_cuda.launches,
                       cam.pixel_rays_cuda.launches,
                       cam.pixel_rays_vjp_cuda.launches,
                       objects.shade_cuda.launches,
                       objects.shade_vjp_cuda.launches), starts

    vec, _, main_counts, starts = timed_fit(4, True, 10)
    ser, _, ser_counts, _ = timed_fit(4, False, 10)

    def picked(r):
        first = r.params_history["sphere_pos"][0]
        return [k for k, s in enumerate(starts)
                if torch.equal(s.sphere_pos.detach(), first)
                and torch.equal(s.M.detach(), r.params_history["M"][0])]

    scale = float(ser.loss_history.abs().max())
    rel = float((vec.loss_history - ser.loss_history).abs().max()) / scale
    require(main_counts == (10,) * 8, f"vectorized fit of 4 starts "
            f"launched K3, K4, K6, K7, K8, K9, K11 and K12 {main_counts} "
            "times in 10 steps")
    require(picked(vec) == picked(ser) and len(picked(vec)) == 1,
            f"vectorized picked start {picked(vec)}, serial {picked(ser)}")
    require(rel <= VEC_SERIAL_RTOL, f"vectorized and serial loss histories "
            f"differ by {rel:.3e} (bar {VEC_SERIAL_RTOL})")
    step_ms, per_step = {}, {}
    for n, vectorized in ((1, True), (4, True), (16, True), (4, False)):
        timed_fit(n, vectorized, 2)  # warm-up
        runs = [timed_fit(n, vectorized, 5) for _ in range(3)]
        step_ms[(n, vectorized)] = statistics.median(r[1] for r in runs)
        per_step[(n, vectorized)] = [c / 5 for c in runs[-1][2]]
    for n in (1, 4, 16):
        require(per_step[(n, True)] == [1.0] * 8, f"vectorized N={n}: "
                f"{per_step[(n, True)]} K3/K4/K6/K7/K8/K9/K11/K12 launches "
                "per step")
    phase("main path vectorized multistart lensing 32x32 f32", t0,
          card=repr(card), starts=4, steps=10,
          k3_launches=main_counts[0], k4_launches=main_counts[1],
          k6_launches=main_counts[2], k7_launches=main_counts[3],
          k8_launches=main_counts[4], k9_launches=main_counts[5],
          k11_launches=main_counts[6], k12_launches=main_counts[7],
          serial_k3_launches=ser_counts[0], picked=picked(vec),
          picked_serial=picked(ser), loss_hist_rel_diff=f"{rel:.3e}",
          bar=VEC_SERIAL_RTOL,
          ms_per_step={f"{'vec' if v else 'serial'}{n}": f"{ms:.3f}"
                       for (n, v), ms in step_ms.items()},
          rays_per_s={f"{'vec' if v else 'serial'}{n}":
                      f"{n * INV_N * INV_N / ms * 1e3:.1f}"
                      for (n, v), ms in step_ms.items()},
          launches_per_step={f"N{n}": per_step[(n, True)]
                             for n in (1, 4, 16)})

    # Where a vectorized step's time goes (4 starts): the device's busy
    #    time from the profiler, read against the unprofiled step time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        timed_fit(4, True, 2)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    host_launches = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CPU
                        and e.key in LAUNCH_CALLS) / 2
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    vec4_ms = step_ms[(4, True)]
    phase("profile vectorized step lensing 32x32 f32 4 starts", t0,
          card=repr(card), step_ms=f"{vec4_ms:.3f}",
          device_busy_ms_per_step=f"{busy_ms:.3f}",
          device_idle_share=f"{max(0.0, 1 - busy_ms / vec4_ms):.4f}",
          device_kernels_per_step=f"{sum(e.count for e in kernels) / 2:.0f}",
          host_launches_per_step=f"{host_launches:.0f}",
          top=[f"{e.key[:40]}:{e.self_device_time_total / 2e3:.3f}ms"
               f"x{e.count // 2}" for e in top])
    require(busy_ms > 0, "the profiler saw no device time")

    # 3b. Config 5 with one CUDA graph per step: the 60-step fit and the
    #     vectorized multistart at 4 and 16 starts, graphed against eager,
    #     bitwise; an Adam step eager and graphed in turns, the graphed
    #     step's device time, kernels and host launch calls (profiler), no
    #     host sync in graphed steps 2..n, peak memory.
    t0 = time.perf_counter()
    same = {"fit60": same_fit(rt.fit(spec, target, init, cfg,
                                     steps=INV_STEPS, learning_rate=5e-3,
                                     graph=True, **kw), res),
            "vec4": same_fit(timed_fit(4, True, 10, graph=True)[0], vec),
            "vec16": same_fit(timed_fit(16, True, 5, graph=True)[0],
                              timed_fit(16, True, 5)[0])}

    def stacked(n):
        return lambda: rt.InverseParams(*(
            torch.stack([getattr(i, k).detach() for i in inits(n)])
            for k in FIT_NAMES), dtype=f32, device=dev)

    steps = {"fit": (rt.make_loss_fn(spec, target, cfg, 0, f32, dev),
                     init.copy)}
    for n in (4, 16):
        steps[f"vec{n}"] = (rt.make_multistart_loss_fn(spec, target, cfg, 0,
                                                       f32, dev), stacked(n))
    graphed_cells = {}
    for name, (loss_fn, make_params) in steps.items():
        with step_launches() as cap_n:
            eager, graphed, peak_g = adam_steps(loss_fn, make_params,
                                                trainable)
        peak_e = eager_peak(eager)
        syncs = no_sync(graphed, GRAPH_REPLAYS)
        ms = in_turns({"eager": eager, "graphed": graphed})
        prof = profile_steps(graphed)
        graphed_cells[name] = dict(
            eager_ms=f"{ms['eager']:.3f}", graphed_ms=f"{ms['graphed']:.3f}",
            speedup=f"{ms['eager'] / ms['graphed']:.3f}",
            device_ms=f"{prof['busy_ms']:.4f}",
            idle_share=f"{max(0.0, 1 - prof['busy_ms'] / ms['graphed']):.4f}",
            kernels=f"{prof['kernels']:.0f}", k3=prof["k3"], k4=prof["k4"],
            k10=prof["k10"], k6=prof["k6"], k7=prof["k7"], k8=prof["k8"],
            k9=prof["k9"], k11=prof["k11"], k12=prof["k12"],
            captured=cap_n,
            host_launches=f"{prof['host_launches']:.0f}", syncs=syncs,
            eager_peak_mib=f"{peak_e / 2**20:.1f}",
            graphed_capture_peak_mib=f"{peak_g / 2**20:.1f}")
    phase("graphed config 5 lensing 32x32 f32", t0, card=repr(card),
          bitwise=same, **graphed_cells)
    require(all(same.values()), f"config 5: a graphed fit differs from the "
            f"eager one: {same}")
    for name, c in graphed_cells.items():
        require(c["syncs"] == 0
                and set(c["captured"].values()) == {CAPTURED},
                f"config 5 {name}: {c['syncs']} host syncs; launches in the "
                f"capture and its warm-ups {c['captured']}, not {CAPTURED} "
                "of each kernel")

    # 4. A fit checkpointed after 3 steps, restored and run 3 more, against
    #    6 uninterrupted steps, with a 6-step cosine schedule.
    t0 = time.perf_counter()
    sched = rt.cosine_decay_schedule(5e-3, 6, alpha=0.1)
    full = rt.fit(spec, target, init, cfg, steps=6, learning_rate=sched, **kw)
    part = rt.fit(spec, target, init, cfg, steps=3, learning_rate=sched, **kw)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_fit.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"params": part.final_params, "opt_state": part.opt_state}
    back = checkpoint.restore(checkpoint.save(path, state), state)
    rest = rt.fit(spec, target, back["params"], cfg, steps=3,
                  learning_rate=sched, opt_state=back["opt_state"], **kw)
    same = torch.equal(rest.loss_history, full.loss_history[3:]) and all(
        torch.equal(getattr(rest.final_params, k), getattr(full.final_params,
                                                           k))
        for k in ("M", "a", "sphere_pos"))
    phase("checkpoint resume on the card lensing 32x32 f32", t0,
          bitwise_equal=same, device=str(back["params"].M.device),
          M_full=f"{float(full.final_params.M.detach()):.9f}",
          M_resumed=f"{float(rest.final_params.M.detach()):.9f}")
    require(same and back["params"].M.device.type == "cuda",
            "the resumed fit differs from the uninterrupted one")

    # 5. The grouped kernels' times at N = 4 (rk4/120, as the fit runs
    #    them) beside one ungrouped launch per start, their plain versions,
    #    SC_ANY against the fixed scene code, and their bounds.
    t0 = time.perf_counter()
    singles, grouped, y0 = inverse_case(dev, f32, "rk4")
    args = adj.launch_args(grouped, y0)
    prm, flags = args
    any_args = (prm, flags[:3] + (SC_ANY,) + flags[4:])
    ct = state_ct(y0, 2)

    def k3_ms(route, P, a):
        runs = [k3_forward_ms(route, P, a) for _ in range(REPEATS + 1)][1:]
        return statistics.median(r[0] for r in runs), runs[0][1], runs[0][2]

    def k4_ms(route, ck, ends, c, a):
        return statistics.median(
            events_ms(lambda: adj.backward_cuda(route, ck, ends, c, a))
            for _ in range(REPEATS))

    g3, ck, used = k3_ms(grouped, y0, args)
    n_used = int(used[0])
    g4 = k4_ms(grouped, ck, used[1:], ct, args)
    g3_any = k3_ms(grouped, y0, any_args)[0]
    g4_any = k4_ms(grouped, ck, used[1:], ct, any_args)
    B = singles[0][1].shape[1]
    u3 = u4 = u3_any = u4_any = 0.0
    for s, (route, y) in enumerate(singles):
        a = adj.launch_args(route, y)
        a_any = (a[0], a[1][:3] + (SC_ANY,) + a[1][4:])
        t3, ck_s, used_s = k3_ms(route, y, a)
        u3 += t3
        u3_any += k3_ms(route, y, a_any)[0]
        c = ct[:, s * B:(s + 1) * B].contiguous()
        u4 += k4_ms(route, ck_s, used_s[1:], c, a)
        u4_any += k4_ms(route, ck_s, used_s[1:], c, a_any)
    plain = grouped._replace(cuda=False)
    _, k3_plain_ms = events_call(lambda: adj.run_segments(plain, y0))
    k4_plain_ms = events_ms(lambda: adj.k4_plain(plain, ck, used[1:], ct))
    work = adjoint_work(grouped, y0, ct, n_used)
    k3_bound, k4_bound = work["k3_bound"], work["k4_bound"]
    R = y0.shape[1]
    iters, accepted = work["iters"], work["accepted"]
    step_flops, vjp_flops = work["step_flops"], work["vjp_flops"]
    phase("time grouped K3/K4 lensing 32x32 f32 rk4/120 4 starts", t0,
          card=repr(card), rays=R, segments=n_used,
          k3_grouped_ms=f"{g3:.4f}", k3_ungrouped_4_launches_ms=f"{u3:.4f}",
          k4_grouped_ms=f"{g4:.4f}", k4_ungrouped_4_launches_ms=f"{u4:.4f}",
          k3_grouped_sc_any_ms=f"{g3_any:.4f}",
          k4_grouped_sc_any_ms=f"{g4_any:.4f}",
          k3_ungrouped_sc_any_ms=f"{u3_any:.4f}",
          k4_ungrouped_sc_any_ms=f"{u4_any:.4f}",
          scene_code=flags[3], k3_plain_ms=f"{k3_plain_ms:.4f}",
          k4_plain_ms=f"{k4_plain_ms:.4f}", ray_iterations=iters,
          accepted=accepted, flops_per_step=step_flops,
          flops_per_step_vjp=vjp_flops,
          k3_bound_ms=f"{k3_bound[0]:.6f}", k3_bound_by=k3_bound[1],
          k4_bound_ms=f"{k4_bound[0]:.6f}", k4_bound_by=k4_bound[1])
    entry = dict(route="cuda", source="raytracegr_jl_tpu_torch/csrc/adjoint.cu",
                 max_abs_err=grouped_err, library_ms=None)
    return [dict(name="K3 grouped forward_segment_cuda (route.groups)",
                 replaces="raytracegr_jl_tpu/ops/pallas_adjoint.py:131",
                 launches=main_counts[0], ms=g3, plain_ms=k3_plain_ms,
                 bound_ms=k3_bound[0], bound_by=k3_bound[1], **entry),
            dict(name="K4 grouped backward_cuda (route.groups)",
                 replaces="raytracegr_jl_tpu/ops/pallas_adjoint.py:203",
                 launches=main_counts[1], ms=g4, plain_ms=k4_plain_ms,
                 bound_ms=k4_bound[0], bound_by=k4_bound[1], **entry)]


def disk_slice(dev, card: str, reset_counts) -> list:
    """The accretion-disk slice: K2 against its plain version (also taking
    its own initial step), the compacted chain against K1 sorted and
    unsorted at 1024x1024, the main path (make_compact_renderer: K2, then
    one K5 launch, no eager shading) once, counted, its image against
    scenes/disk_1024.png and fast_epilogue's image, K5 against the plain
    shading bitwise (the disk's end states, a moving sphere, Minkowski; f32
    and f64), times (the render with the eager initial step and with K2's
    own, the plain shading and K5), a profile and K2's and K5's bounds.
    Returns K2's and K5's entries of the kernels line."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch import compaction as C
    from raytracegr_jl_tpu_torch import render as R
    from raytracegr_jl_tpu_torch.models.shading import (shade_redshift,
                                                        shade_redshift_cuda)
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (
        impact_parameter_order, integrate_rays_cuda, localize_events_cm,
        make_step_cm, pack_params, scene_event_cm)
    from raytracegr_jl_tpu_torch.render import _shade, initial_dt

    f32 = torch.float32

    def disk(n, dtype):
        metric, scene, canvas = rt.build(rt.accretion_disk_spec(n, n), dtype,
                                         dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        return metric, scene, canvas, y0

    # 10. K2 against its plain version, bitwise on every plane: the first
    #     chunk (state built in the kernel), one resumed chunk, and whole
    #     compacted traces (first_chunk 16 as the JAX package's test; 21
    #     packs the 64x64 batch twice, 4096 to 2048 to 1024 rays, before
    #     packing stalls; a 32x32 batch is one pack unit).
    def compare_k2(label, n, dtype, tol, first_chunks, min_packs):
        t0 = time.perf_counter()
        metric, scene, _, y0 = disk(n, dtype)
        integ = rt.IntegratorConfig(rtol=tol, atol=tol, max_steps=400,
                                    stop_rho=1.0)
        dt0 = initial_dt(metric, y0, integ)
        y_cm = y0.t().contiguous()
        first = (C.chunk_cuda(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0),
                 C.chunk_plain(metric, scene, integ, 16, y_cm=y_cm, dt0=dt0))
        resumed = (C.chunk_cuda(metric, scene, integ, 32, P=first[0][0]),
                   C.chunk_plain(metric, scene, integ, 32, P=first[1][0]))
        torch.cuda.synchronize()
        err = max(require_chunks_equal(f"{label} first chunk", *first),
                  require_chunks_equal(f"{label} resumed", *resumed))
        runs, most = [], 0
        for fc in first_chunks:
            ck, cp = [], []
            rk = C.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                         first_chunk=fc, chunks=ck)
            rp = C.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                         first_chunk=fc, backend="torch",
                                         chunks=cp)
            n_bad, d = mismatch(rk, rp)
            err = max(err, d)
            require(n_bad == 0 and ck == cp, f"{label} first_chunk={fc}: "
                    f"{n_bad} rays differ (max |d| {d:.3e}), chunks {ck} "
                    f"vs plain {cp}")
            runs.append(f"fc{fc}:chunks={len(ck)},packs={packs(ck)}")
            most = max(most, packs(ck))
        require(most >= min_packs, f"{label}: at most {most} pack(s)")
        phase(f"K2 vs plain {label}", t0, k2_max_abs_err=err,
              hits=int(first[1][0][adj.P_HIT].sum()), traces=runs)
        return err

    k2_err = max(
        compare_k2("disk 64x64 f32", 64, f32, RTOL_F32, (16, 21), 2),
        compare_k2("disk 32x32 f64", 32, torch.float64, 1e-8, (16,), 0))

    # 11. The main path's shape: 1024x1024, a=0.8, f32, Tsit5 at eps^(3/4),
    #     20000 steps, capture-stop 1, sorted, redshift shading
    #     (benchmarks/disk_render.py:41-58). The compacted chain (K2)
    #     against one K1 launch sorted, and K1 sorted against K1 unsorted.
    t0 = time.perf_counter()
    cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=RTOL_F32, atol=RTOL_F32,
        max_steps=DISK_MAX_STEPS, stop_rho=1.0, sort_rays=True),
        shading="redshift")
    integ = cfg.integrator
    n = DISK_N
    metric, scene, canvas, y0 = disk(n, f32)
    dt0 = initial_dt(metric, y0, integ)
    chunks = []
    comp = C.trace_batch_compacted(metric, scene, y0, dt0, integ,
                                   chunks=chunks)
    srt = integrate_rays_cuda(metric, scene, y0, dt0, integ)
    uns = integrate_rays_cuda(metric, scene, y0, dt0,
                              integ._replace(sort_rays=False))
    torch.cuda.synchronize()
    bad_cs, err_cs = mismatch(comp, srt)
    bad_su, err_su = mismatch(srt, uns)
    img_c = _shade(metric, scene, y0, comp.y, cfg)
    img_s = _shade(metric, scene, y0, srt.y, cfg)
    phase("disk 1024x1024 f32 compacted vs K1", t0,
          rays_differ_compacted_vs_sorted=bad_cs, max_abs_d_cs=err_cs,
          rays_differ_sorted_vs_unsorted=bad_su, max_abs_d_su=err_su,
          images_equal=bool(torch.equal(img_c, img_s)), chunks=len(chunks),
          packs=packs(chunks),
          schedule=[(c["rays"], c["budget"], c["active"]) for c in chunks])
    require(bad_cs == 0, f"compacted vs K1 sorted: {bad_cs} rays differ")
    require(bad_su == 0, f"K1 sorted vs unsorted: {bad_su} rays differ")
    require(torch.equal(img_c, img_s), "compacted and single-launch images "
            "differ")

    # 11b. K2 against its plain version on the main path's own first two
    #      chunks: the sorted 1024x1024 batch at the first budget (state
    #      built in the kernel), then that batch packed as
    #      trace_batch_compacted packs it, at the second budget. The long
    #      last chunk is held to K1 above: the plain loop cannot run it.
    t0 = time.perf_counter()
    require(len(chunks) >= 2, f"the main path ran {len(chunks)} chunk(s)")
    _, y_cm, dt_s = C.sorted_batch(y0, dt0)
    args = C.chunk_args(metric, scene, integ, y0)
    b1, b2 = chunks[0]["budget"], chunks[1]["budget"]
    ms = []

    def both(budget, **state):
        k, k_ms = events_call(lambda: C.chunk_cuda(
            metric, scene, integ, budget, args=args, **state))
        p, p_ms = events_call(lambda: C.chunk_plain(
            metric, scene, integ, budget, **state))
        ms.append(f"{k_ms:.4f}/{p_ms:.1f}")
        return k, p

    first = both(b1, y_cm=y_cm, dt0=dt_s)
    err_main = require_chunks_equal("main path chunk 1", *first)
    # K2 taking each ray's initial step itself (dt0=None, the main path's
    # first chunk since K2 has its own step) against initial_dt then the
    # plain chunk, every ray and plane.
    own_first = C.chunk_cuda(metric, scene, integ, b1, y_cm=y_cm, dt0=None,
                             args=args)
    err_main = max(err_main, require_chunks_equal(
        "main path chunk 1, K2's own initial step", own_first, first[1]))
    P1 = first[0][0]
    active = P1[adj.P_ACTIVE] > 0
    keep = C.pack_slots(active, int(active.sum()),
                        -(-y0.shape[0] // C.PACK_UNIT) * C.PACK_UNIT)
    require(keep is not None and len(keep) == chunks[1]["rays"],
            "the main path's second batch is not the packed first")
    second = both(b2, P=P1.index_select(1, keep))
    err_main = max(err_main, require_chunks_equal("main path chunk 2",
                                                  *second))
    own_trace = C.trace_batch_compacted(metric, scene, y0, None, integ)
    bad_own, err_own = mismatch(own_trace, comp)
    require(bad_own == 0, f"the compacted trace with K2's own initial step "
            f"differs on {bad_own} rays (max |d| {err_own:.3e})")
    phase("K2 vs plain disk 1024x1024 f32 main-path chunks 1 and 2", t0,
          k2_max_abs_err=err_main, rays=(y0.shape[0], len(keep)),
          own_initial_step_first_chunk_bitwise=True,
          own_initial_step_trace_rays_differ=bad_own,
          budgets=(b1, b2), active_after=(int(active.sum()),
                                          int((second[0][0][adj.P_ACTIVE]
                                               > 0).sum())),
          card=repr(card), k2_ms_over_plain_ms=ms)

    t0 = time.perf_counter()
    stats = rt.trace_stats(comp, cfg=integ)
    total_steps = int(comp.steps.sum(dtype=torch.int64))
    # How the work falls into warps of 32 in each launch order: the share
    # of executed lane-steps that are useful, and the warps that hold a ray
    # of more than 64 steps (the rays the first chunk leaves active).
    steps = comp.steps.to(torch.int64)
    order, _ = impact_parameter_order(y0)
    slow_sorted = steps[order][steps[order] > 64]

    def warps(s):
        s = torch.nn.functional.pad(s, (0, -s.numel() % 32)).reshape(-1, 32)
        return (f"{float(s.sum() / (32 * s.max(1).values.sum())):.4f}",
                int((s > 64).any(1).sum()))

    phase("disk census", t0, total_accepted_ray_steps=total_steps,
          steps_p50=stats["steps_p50"], steps_p90=stats["steps_p90"],
          steps_p99=stats["steps_p99"], steps_max=stats["steps_max"],
          hit_frac=stats["hit_frac"], killed_frac=stats["killed_frac"],
          device=repr(stats["device"]), jax_census=repr(JAX_DISK_CENSUS),
          warp_efficiency_and_slow_warps_camera_order=warps(steps),
          sorted=warps(steps[order]), packed_slow_rays=warps(slow_sorted))

    # 12. The main path once, counted: make_compact_renderer on CUDA
    #     tensors at 1024x1024 (benchmarks/disk_render.py's pallas_compact):
    #     K2, then the redshift shading as one K5 launch, no eager shading.
    t0 = time.perf_counter()
    render = C.make_compact_renderer(metric, scene, cfg)
    with counted_calls(C, "initial_dt") as eager_init, \
            counted_calls(R, "shade_redshift") as eager_shade:
        reset_counts()
        rgb = render(canvas).rgb
        torch.cuda.synchronize()
        k2_launches = C.chunk_cuda.launches
        k5_launches = shade_redshift_cuda.launches
    require(k2_launches >= 1, "the disk main path did not launch K2")
    require(not eager_init, "the disk main path ran the eager initial step")
    require(k5_launches == 1 and not eager_shade, f"the disk main path "
            f"launched K5 {k5_launches} times and shaded eagerly "
            f"{len(eager_shade)} times")
    require(tuple(rgb.shape) == (n, n, 3) and bool(torch.isfinite(rgb).all())
            and float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0,
            "bad disk main-path output")
    left, right = float(rgb[: n // 2].mean()), float(rgb[n // 2:].mean())
    require(torch.equal(rgb.reshape(-1, 3), img_c),
            "the main path's image differs from the compacted trace's")
    img = rt.canvas_to_image(rgb).astype(np.int32)
    gold = np.round(rt.load_png("scenes/disk_1024.png") * 255).astype(
        np.int32)
    bad = np.abs(img - gold).max(-1) > 2  # [nj, ni], as the image
    steps_img = comp.steps.reshape(n, n).t().cpu().numpy()
    hit_img = comp.hit.reshape(n, n).t().cpu().numpy()
    phase("main path disk 1024x1024 f32 compacted redshift", t0,
          k2_launches=k2_launches, k5_launches=k5_launches,
          eager_shadings=len(eager_shade),
          k1_launches=integrate_rays_cuda.launches,
          eager_initial_steps=len(eager_init),
          approaching_half_mean=f"{left:.6f}",
          receding_half_mean=f"{right:.6f}",
          pixels_beyond_2lsb_vs_disk_1024_png=int(bad.sum()), of=n * n,
          bar=int(DISK_PNG_BAR_FRAC * n * n),
          roadmap_c_bar=int(ROADMAP_C_BAR_FRAC * n * n),
          of_them_steps_over_64=int((bad & (steps_img > 64)).sum()),
          of_them_steps_over_1000=int((bad & (steps_img > 1000)).sum()),
          of_them_missed=int((bad & ~hit_img).sum()),
          rays_steps_over_64=int((steps_img > 64).sum()))
    require(left > 1.2 * right, "the approaching half is not brighter")
    require(bad.sum() <= DISK_PNG_BAR_FRAC * n * n, f"{int(bad.sum())} "
            "pixels beyond 2 LSB of scenes/disk_1024.png")

    # 12b. fast_epilogue's image equals the default's bitwise (the option
    #      changes nothing on the port). K5 against the plain shading
    #      (shade_redshift, its sums left to right) on the same CUDA
    #      tensors, every bit: the 1024x1024 disk's end states at f32 and
    #      f64 (the Keplerian branch), example2 with its sphere moving (a
    #      stored vel: the sphere and plane branch) and example1
    #      (Minkowski), each at 256x256, f32 and f64.
    t0 = time.perf_counter()
    fast = C.make_compact_renderer(metric, scene, cfg, fast_epilogue=True)
    require(bits_equal(fast(canvas).rgb, rgb),
            "fast_epilogue's image differs from the default's")
    checks = []

    def k5_bitwise(label, metric_, scene_, y0_, y_):
        want = shade_redshift(metric_, scene_, y0_, y_, metric_.params.M,
                              metric_.params.a, cfg.hit_dmin, cfg.beaming,
                              cfg.exposure)
        got = shade_redshift_cuda(metric_, scene_, y0_, y_, cfg.hit_dmin,
                                  cfg.beaming, cfg.exposure)
        torch.cuda.synchronize()
        lit = int((want.abs().sum(1) > 0).sum())
        checks.append(f"{label}:lit={lit}/{want.shape[0]}")
        require(bits_equal(got, want) and lit > 0, f"K5 on {label} not "
                f"bitwise equal to shade_redshift (max |d| "
                f"{max_err(got, want):.3e}, {lit} rays lit)")

    k5_bitwise("disk 1024x1024 f32", metric, scene, y0, comp.y)
    require(bits_equal(img_c, shade_redshift(
        metric, scene, y0, comp.y, metric.params.M, metric.params.a,
        cfg.hit_dmin, cfg.beaming, cfg.exposure)),
        "the main path's colours differ from the plain shading's")
    metric64, scene64, _, y64 = disk(n, torch.float64)
    k5_bitwise("disk 1024x1024 f64", metric64, scene64, y64,
               C.trace_batch_compacted(metric64, scene64, y64, None,
                                       integ).y)
    for dtype in (f32, torch.float64):
        tol = RTOL_F32 if dtype == f32 else 1e-8
        k1_cfg = rt.IntegratorConfig(rtol=tol, atol=tol, max_steps=4000,
                                     sort_rays=True)
        for label, spec in (("example2 moving sphere",
                             rt.example2_spec(256, 256)),
                            ("example1 Minkowski",
                             rt.example1_spec(256, 256))):
            m_, s_, c_ = rt.build(spec, dtype, dev)
            vel = s_.vel.clone()
            vel[2] = torch.tensor([1.0, 0.0, 0.3, 0.2], dtype=dtype)
            s_ = s_._replace(vel=vel)
            a0 = torch.cat([c_.pos, c_.normal], -1).reshape(-1, 8)
            k5_bitwise(f"{label} 256x256 {str(dtype)[6:]}", m_, s_, a0,
                       integrate_rays_cuda(m_, s_, a0, None, k1_cfg).y)
    phase("K5 vs plain shading and fast_epilogue", t0, k5_bitwise=checks,
          fast_epilogue_image_bitwise=True)

    # 13. Times, each the median of 5 after a warm-up: the compacted render,
    #     the single-launch render sorted and unsorted, K2 summed over the
    #     chunks of one trace (CUDA events per launch), the eager initial
    #     step, the plain redshift shading and K5 alone (its call, and in a
    #     graph of 100 launches); and K2's plain version at 64x64 (its whole
    #     compacted trace, summed over chunks, once).
    t0 = time.perf_counter()
    fn_sorted = rt.render_fn(metric, scene, cfg._replace(backend="cuda"))
    fn_unsorted = rt.render_fn(metric, scene, cfg._replace(
        backend="cuda", integrator=integ._replace(sort_rays=False)))
    times = {
        "compacted_render_ms": cuda_ms(lambda: render(canvas)),
        "sorted_render_ms": cuda_ms(lambda: fn_sorted(canvas.pos,
                                                      canvas.normal)),
        "unsorted_render_ms": cuda_ms(lambda: fn_unsorted(canvas.pos,
                                                          canvas.normal)),
        "k1_sorted_ms": cuda_ms(lambda: integrate_rays_cuda(
            metric, scene, y0, dt0, integ)),
        "init_dt_ms": cuda_ms(lambda: initial_dt(metric, y0, integ)),
        "plain_shading_ms": cuda_ms(lambda: shade_redshift(
            metric, scene, y0, comp.y, metric.params.M, metric.params.a,
            cfg.hit_dmin, cfg.beaming, cfg.exposure)),
    }
    prm5 = pack_params(metric, scene, rt.IntegratorConfig(), f32, dev)

    def k5_call():
        return shade_redshift_cuda(metric, scene, y0, comp.y, cfg.hit_dmin,
                                   cfg.beaming, cfg.exposure, prm5)

    times["k5_ms"] = cuda_ms(k5_call)
    times["k5_graph_ms"] = graph_ms(k5_call)

    # The render before K2 took its own initial step (the eager
    # initial_dt, then the chunks) and after, in turns after a warm-up.
    def render_eager_step():
        y = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        res = C.trace_batch_compacted(metric, scene, y,
                                      initial_dt(metric, y, integ), integ)
        return _shade(metric, scene, y, res.y, cfg)

    turns = {"eager": [], "own": []}
    render_eager_step()
    for rep in range(REPEATS):
        for key in (("eager", "own") if rep % 2 else ("own", "eager")):
            turns[key].append(events_ms(
                render_eager_step if key == "eager"
                else lambda: render(canvas)))
    times["render_eager_initial_step_ms"] = statistics.median(turns["eager"])
    times["render_own_initial_step_ms"] = statistics.median(turns["own"])
    k2_runs = []
    for _ in range(REPEATS + 1):
        with timed_calls(C, "chunk_cuda") as pairs:
            C.trace_batch_compacted(metric, scene, y0, dt0, integ)
        k2_runs.append(summed_ms(pairs))
    times["k2_ms_all_chunks"] = statistics.median(k2_runs[1:])
    metric64, scene64, _, y64 = disk(64, f32)
    integ64 = integ._replace(max_steps=400)
    dt64 = initial_dt(metric64, y64, integ64)
    k2_64, plain_64 = [], []
    # K2 after a warm-up; its plain version (host-bound plain torch, ~15 s)
    # once.
    for name, backend, out, runs in (("chunk_cuda", "cuda", k2_64, 2),
                                     ("chunk_plain", "torch", plain_64, 1)):
        for _ in range(runs):
            with timed_calls(C, name) as pairs:
                C.trace_batch_compacted(metric64, scene64, y64, dt64,
                                        integ64, backend=backend)
            out.append(summed_ms(pairs))
    times["k2_ms_64x64"], times["plain_ms_64x64"] = k2_64[-1], plain_64[-1]
    rates = {f"{k}_rays_per_s": f"{n * n / times[f'{k}_render_ms'] * 1e3:.1f}"
             for k in ("compacted", "sorted", "unsorted")}
    phase("time disk 1024x1024 f32", t0, card=repr(card),
          **{k: f"{v:.4f}" for k, v in times.items()}, **rates)

    # 13b. The detection gate (event_gate): the compacted 1024x1024 trace
    #      and render with the gate on, bitwise against the ungated ones on
    #      every ray, and K2's time summed over the chunks of each (medians
    #      of 5, in turns).
    t0 = time.perf_counter()
    g_integ = integ._replace(event_gate=True)
    g_chunks = []
    comp_g = C.trace_batch_compacted(metric, scene, y0, dt0, g_integ,
                                     chunks=g_chunks)
    bad_g, err_g = mismatch(comp_g, comp)
    rgb_g = C.make_compact_renderer(metric, scene, cfg._replace(
        integrator=g_integ))(canvas).rgb
    torch.cuda.synchronize()
    img_equal = bool(torch.equal(rgb_g.reshape(-1, 3), img_c))
    gate_ms = {True: [], False: []}
    for rep in range(REPEATS):  # after the warm-up above, in turns
        for g in ((True, False) if rep % 2 else (False, True)):
            with timed_calls(C, "chunk_cuda") as pairs:
                C.trace_batch_compacted(metric, scene, y0, dt0,
                                        integ._replace(event_gate=g))
            gate_ms[g].append(summed_ms(pairs))
    on_ms, off_ms = (statistics.median(gate_ms[g]) for g in (True, False))
    phase("disk 1024x1024 f32 gate on vs off", t0, card=repr(card),
          rays_differ=bad_g, max_abs_d=err_g, images_equal=img_equal,
          chunks_equal=g_chunks == chunks,
          k2_ms_all_chunks_gate_on=f"{on_ms:.4f}",
          k2_ms_all_chunks_gate_off=f"{off_ms:.4f}")
    require(bad_g == 0 and img_equal and g_chunks == chunks,
            f"gate on vs off: {bad_g} rays differ (max |d| {err_g:.3e})")

    # 14. One profiled compacted render: the device's busy time (the sum of
    #     its kernels) against the unprofiled render time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        render(canvas)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    render_ms = times["compacted_render_ms"]
    phase("profile disk compacted render 1024x1024 f32", t0, card=repr(card),
          render_ms=f"{render_ms:.4f}", device_busy_ms=f"{busy_ms:.3f}",
          device_idle_share=f"{max(0.0, 1 - busy_ms / render_ms):.4f}",
          device_kernels=sum(e.count for e in kernels),
          top=[f"{e.key[:40]}:{e.self_device_time_total / 1e3:.3f}ms"
               f"x{e.count}" for e in top])
    require(busy_ms > 0, "the profiler saw no device time")

    # 15. K2's bound on the main path's work: every ray-iteration of every
    #     chunk (counted by stepping the batch one iteration per launch) at
    #     the plain step body's operations on one ray, plus one localization
    #     per hit ray per chunk; bytes: each chunk's state in and out and
    #     its 9 result planes (the first chunk reads y0 and dt0).
    t0 = time.perf_counter()
    with torch.no_grad():
        init, body = make_step_cm(metric, scene_event_cm(scene), integ)
        st = init(y0[:1].t().contiguous(), dt0[:1])
        step_flops = count_flops(lambda: body(st))
        loc_flops = count_flops(lambda: localize_events_cm(
            metric, scene_event_cm(scene), integ, st.ev_y0, st.ev_dt,
            st.ev_lo, st.ev_hi))
        args = C.chunk_args(metric, scene, integ, y0)
        P = C.chunk_cuda(metric, scene, integ, 0, y_cm=y0.t().contiguous(),
                         dt0=dt0, args=args)[0]
        iters, it = 0, 0
        while it < integ.max_steps:
            act = P[adj.P_ACTIVE] > 0
            n_act = int(act.sum())
            if n_act == 0:
                break
            iters += n_act
            if n_act <= P.shape[1] // 2:
                P = P[:, act]
            P = C.chunk_cuda(metric, scene, integ, 1, P=P, args=args)[0]
            it += 1
    B = y0.shape[0]
    # Per chunk: its input planes (y0 and dt0 for the first, the state
    # after), the state out, y_fin and lam_fin; 4 bytes each in f32.
    nbytes = sum(((9 if i == 0 else adj.N_PLANES) + adj.N_PLANES + 9)
                 * c["rays"] * 4 for i, c in enumerate(chunks))
    loc_hits = sum(c["hits"] for c in chunks)
    k2_bound = bound(iters * step_flops + loc_hits * loc_flops, nbytes)
    phase("K2 bound disk 1024x1024 f32", t0, ray_iterations=iters,
          accepted=total_steps, iterations_stepped=it,
          localizations=loc_hits, flops_per_step=step_flops,
          flops_per_localization=loc_flops, bytes=nbytes,
          bound_ms=f"{k2_bound[0]:.6f}", bound_by=k2_bound[1],
          rays=B)
    # 15b. K5's bound on this image: what this run's rays need read (a
    #      miss's position, a hit's whole end and launch states) and rgb
    #      written (f32), or the plain shading's operations on one ray,
    #      times the rays.
    t0 = time.perf_counter()
    with torch.no_grad():
        k5_ray_flops = count_flops(lambda: shade_redshift(
            metric, scene, y0[:1], comp.y[:1], metric.params.M,
            metric.params.a, cfg.hit_dmin, cfg.beaming, cfg.exposure))
        lit = int((torch.min(rt.distances(scene, comp.y[:, :4]), dim=-1)
                   .values < cfg.hit_dmin).sum())
    k5_bytes = (lit * 16 + (B - lit) * 4 + B * 3) * 4
    k5_bound = bound(k5_ray_flops * B, k5_bytes)
    phase("K5 bound disk 1024x1024 f32", t0, card=repr(card),
          flops_per_ray=k5_ray_flops, hit_rays=lit, bytes=k5_bytes,
          bound_ms=f"{k5_bound[0]:.6f}", bound_by=k5_bound[1],
          k5_ms=f"{times['k5_ms']:.4f}",
          k5_graph_ms=f"{times['k5_graph_ms']:.4f}",
          plain_shading_ms=f"{times['plain_shading_ms']:.4f}")
    return [{
        "name": "K2 chunk_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/compaction.cu",
        "replaces": "raytracegr_jl_tpu/compaction.py:103",
        "launches": k2_launches,
        "max_abs_err": max(k2_err, err_main),
        "ms": times["k2_ms_all_chunks"],
        "plain_ms": times["plain_ms_64x64"],
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "library_ms": None}, {
        "name": "K5 shade_redshift_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/shading.cu",
        "replaces": "port-only: the JAX package's jitted shading epilogue, "
                    "raytracegr_jl_tpu/compaction.py:353",
        "launches": k5_launches,
        "max_abs_err": 0.0,
        "ms": times["k5_ms"],
        "plain_ms": times["plain_shading_ms"],
        "bound_ms": k5_bound[0],
        "bound_by": k5_bound[1],
        "library_ms": None}]


# The refine_minima phase's grazing rays: example1's camera aimed just
# inside the radius-0.5 sphere's silhouette (tests/test_event_detection.py's
# construction, the band where the reference's sampled detection misses true
# hits), every one a hit by the closed-form oracle.
GRAZE_N = 4096


def grazing_rays(metric, dtype, dev, n: int = GRAZE_N, seed: int = 7):
    """``[n, 8]`` launch states of rays that graze example1's small sphere
    (closest approach uniform in (0.487, 0.4999) of its 0.5 radius)."""
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0.0, 2.0 * np.pi, n)
    t = np.tan(np.arcsin(rng.uniform(0.487, 0.4999, n) / 2.0))
    normal = np.stack([np.zeros(n), t * np.cos(ang), np.ones(n),
                       t * np.sin(ang)], axis=1)
    pos = np.tile([0.0, 0.0, -2.0, 0.0], (n, 1))
    x, u = pixel_rays(metric, torch.tensor(pos, dtype=dtype, device=dev),
                      torch.tensor(normal, dtype=dtype, device=dev))
    return torch.cat([x, u], -1)


def small_sphere_hits(res) -> int:
    """Rays that end on example1's radius-0.5 sphere (not the sky)."""
    return int((res.hit & (res.y[:, 1:4].norm(dim=1) < 1.0)).sum())


def options_slice(dev, card: str, reset_counts) -> dict:
    """The options ported last: refine_minima through K1, K2, K3 (and
    k3_close), K4 and the grouped K3/K4, each bitwise against its plain
    version on grazing rays, the hits it adds, its main path (example1's
    golden render) counted, and the refine kernels' times beside the
    default ones; sort_rays on the differentiable kernel route (gradients
    bitwise, its main path counted, K3 and K4 sorted and unsorted) and
    grad_mode="scan" against the kernel route's gradients. Returns the
    times for the record."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch import compaction as C
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    from raytracegr_jl_tpu_torch.models.scenes import (build, example1_spec,
                                                       example2_spec)
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (
        impact_parameter_order, integrate_rays_cm, integrate_rays_cuda)
    from raytracegr_jl_tpu_torch.render import initial_dt

    f32, f64 = torch.float32, torch.float64
    out = {}

    # 17. refine_minima on grazing rays, f64 and f32: K1 (given dt0 and
    #     taking its own), K2 (a first chunk and a resumed one), K3 with
    #     k3_close and K4 (RK4 at a step of 2, Tsit5), each bitwise against
    #     its plain version; the grouped K3 and K4 on the lensing scene.
    for dtype in (f64, f32):
        t0 = time.perf_counter()
        metric, scene, _ = build(example1_spec(2, 2), dtype, dev)
        y0 = grazing_rays(metric, dtype, dev)
        tol = rt.default_tol(dtype)
        integ = rt.IntegratorConfig(rtol=tol, atol=tol, max_steps=4000,
                                    refine_minima=True)
        dt0 = initial_dt(metric, y0, integ)
        k = integrate_rays_cuda(metric, scene, y0, dt0, integ)
        own = integrate_rays_cuda(metric, scene, y0, None, integ)
        p = integrate_rays_cm(metric, scene, y0, dt0, integ)
        bad, err = mismatch(k, p)
        bad_own, err_own = mismatch(own, p)
        require(bad == 0 and bad_own == 0, f"refine K1 {dtype}: {bad} rays "
                f"differ given dt0, {bad_own} taking its own (max |d| "
                f"{max(err, err_own):.3e})")
        base = integrate_rays_cuda(metric, scene, y0, dt0,
                                   integ._replace(refine_minima=False))
        y_cm = y0.t().contiguous()
        first = (C.chunk_cuda(metric, scene, integ, 3, y_cm=y_cm, dt0=dt0),
                 C.chunk_plain(metric, scene, integ, 3, y_cm=y_cm, dt0=dt0))
        err = max(err, require_chunks_equal(f"refine K2 {dtype} chunk 1",
                                            *first))
        err = max(err, require_chunks_equal(
            f"refine K2 {dtype} chunk 2",
            C.chunk_cuda(metric, scene, integ, 64, P=first[0][0]),
            C.chunk_plain(metric, scene, integ, 64, P=first[1][0])))
        for method, steps in (("rk4", 8), ("tsit5", 32)):
            ci = integ._replace(method=method, rk4_dt=2.0, max_steps=steps)
            route = adj.Route(metric=metric, scene=scene, cfg=ci, seg_len=4,
                              n_seg=steps // 4, cuda=True)
            e3, ck_k, used_k, ck_p, used_p = require_k3_equal(
                f"refine K3 {dtype} {method}", route, y_cm)
            ct = state_ct(y_cm, 2)
            c_k, p_k = adj.backward_cuda(route, ck_k, used_k[1:], ct)
            c_p, p_p = adj.k4_plain(route, ck_p, used_p[1:], ct)
            torch.cuda.synchronize()
            e4 = max(max_err(c_k, c_p), max_err(p_k, p_p))
            require(bits_equal(c_k, c_p) and bits_equal(p_k, p_p),
                    f"refine K4 {dtype} {method}: not bitwise equal (max |d| "
                    f"{e4:.3e})")
            err = max(err, e3, e4)
        g_err, g_seg, g_hits = require_grouped_equal(
            f"refine grouped {dtype}", dev, dtype, "rk4", refine=True)
        err = max(err, g_err)
        out[f"refine_err_{str(dtype)[6:]}"] = err
        phase(f"refine_minima grazing rays {str(dtype)[6:]}", t0,
              rays=y0.shape[0], small_sphere_hits_refined=small_sphere_hits(k),
              small_sphere_hits_default=small_sphere_hits(base),
              k1_k2_k3_k4_bitwise=True, grouped_k3_k4_bitwise=True,
              grouped_segments=g_seg, grouped_hits=g_hits, max_abs_err=err)

    # 18. refine_minima's main path, counted: example1 at the golden's
    #     200x200, f64, through render_fn on the card (one K1 launch), and
    #     the rays that refinement turns into hits against scenes/sphere.png
    #     (the reference's sampled detection misses true silhouette hits).
    t0 = time.perf_counter()
    tol64 = rt.default_tol(f64)
    ref_integ = rt.IntegratorConfig(rtol=tol64, atol=tol64, max_steps=20_000)
    metric, scene, canvas = build(example1_spec(200, 200), f64, dev)
    fn = rt.render_fn(metric, scene, rt.RenderConfig(
        integrator=ref_integ._replace(refine_minima=True)))
    fn(canvas.pos, canvas.normal)
    torch.cuda.synchronize()
    reset_counts()
    rgb = fn(canvas.pos, canvas.normal)
    torch.cuda.synchronize()
    k1_refine_launches = integrate_rays_cuda.launches
    require(k1_refine_launches == 1, f"the refine main path launched K1 "
            f"{k1_refine_launches} times")
    rgb0 = rt.render_fn(metric, scene, rt.RenderConfig(integrator=ref_integ))(
        canvas.pos, canvas.normal)
    gold = np.round(rt.load_png("scenes/sphere.png") * 255).astype(np.int32)
    n_bad = [int((np.abs(rt.canvas_to_image(c).astype(np.int32) - gold)
                  .max(-1) > 2).sum()) for c in (rgb0, rgb)]
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    hits = [small_sphere_hits(integrate_rays_cuda(metric, scene, y0, None,
                                                  ref_integ._replace(
                                                      refine_minima=r)))
            for r in (False, True)]
    phase("main path refine_minima example1 200x200 f64", t0,
          k1_launches=k1_refine_launches, small_sphere_hits_default=hits[0],
          small_sphere_hits_refined=hits[1],
          refinement_adds_hits=hits[1] - hits[0],
          pixels_beyond_2lsb_vs_sphere_png_default=n_bad[0],
          pixels_beyond_2lsb_vs_sphere_png_refined=n_bad[1])
    require(hits[1] >= hits[0] and bool(torch.isfinite(rgb).all()),
            "refinement lost hits or rendered non-finite colours")

    # 19. The refine kernels' times beside the default ones (medians of 5,
    #     in turns): K1 on example2 200x200 f32 (SC_REFINE against the
    #     fixed SC_SPS9), K3 and K4 in the rk4/200 training step's shape,
    #     K2 summed over the 1024x1024 disk's chunks.
    t0 = time.perf_counter()
    bench = rt.IntegratorConfig(method="tsit5", rtol=RTOL_F32, atol=RTOL_F32,
                                max_steps=20_000)
    metric, scene, canvas = build(example2_spec(200, 200), f32, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, bench)
    k1_ms = {}
    for r in (False, True):
        c = bench._replace(refine_minima=r)
        k1_ms[r] = cuda_ms(lambda: integrate_rays_cuda(metric, scene, y0,
                                                       dt0, c))
    tcfg = rt.default_inverse_cfg(f32, max_steps=200, method="rk4",
                                  rk4_dt=0.5, stop_rho=0.5)
    spec = example2_spec(200, 200)
    xg, ng = rt.flat_pixel_grid(spec, f32, dev)
    M = torch.tensor(1.05, dtype=f32, device=dev)
    tmetric = rt.make_metric("kerr_schild", rt.KerrSchildParams(
        M, torch.tensor(0.0, dtype=f32, device=dev)), rho_min=0.25)
    _, tscene, _ = build(spec, f32, dev)
    with torch.no_grad():
        x, u = pixel_rays(tmetric, xg, ng)
        ty0 = torch.cat([x, u], -1)
    gen = torch.Generator(device=dev).manual_seed(0)

    def k3_k4_ms(integ, order=None):
        """K3's pass and K4's launch (medians of 5) from the training
        step's launch states, in ``order`` where given."""
        seg = adj.segment_length(integ, integ.grad_seg_len)
        route = adj.Route(metric=tmetric, scene=tscene, cfg=integ,
                          seg_len=seg, n_seg=integ.max_steps // seg,
                          cuda=True)
        yy = (ty0 if order is None else ty0[order]).t().contiguous()
        args = adj.launch_args(route, yy)
        runs = [k3_forward_ms(route, yy, args) for _ in range(REPEATS + 1)]
        _, ck, used = runs[0]
        ct = torch.randn((adj.N_PLANES, yy.shape[1]), generator=gen,
                         dtype=f32, device=dev)
        k4 = [events_ms(lambda: adj.backward_cuda(route, ck, used[1:], ct,
                                                  args))
              for _ in range(REPEATS + 1)]
        return (statistics.median(r[0] for r in runs[1:]),
                statistics.median(k4[1:]), int(used[0]))

    k34 = {r: k3_k4_ms(tcfg.integrator._replace(refine_minima=r))
           for r in (False, True)}
    dcfg, dmetric, dscene, _, dy0, ddt0 = disk_setup(dev)
    k2_ms = {False: [], True: []}
    for rep in range(REPEATS + 1):
        for r in ((False, True) if rep % 2 else (True, False)):
            with timed_calls(C, "chunk_cuda") as pairs:
                C.trace_batch_compacted(dmetric, dscene, dy0, ddt0,
                                        dcfg.integrator._replace(
                                            refine_minima=r))
            k2_ms[r].append(summed_ms(pairs))
    k2_med = {r: statistics.median(v[1:]) for r, v in k2_ms.items()}
    out.update(k1_ms=k1_ms, k3_k4=k34, k2_ms=k2_med)
    phase("time refine_minima kernels f32", t0, card=repr(card),
          k1_200_default_ms=f"{k1_ms[False]:.4f}",
          k1_200_refine_ms=f"{k1_ms[True]:.4f}",
          k3_rk4_200_default_ms=f"{k34[False][0]:.4f}",
          k3_rk4_200_refine_ms=f"{k34[True][0]:.4f}",
          k4_rk4_200_default_ms=f"{k34[False][1]:.4f}",
          k4_rk4_200_refine_ms=f"{k34[True][1]:.4f}",
          segments=(k34[False][2], k34[True][2]),
          k2_disk_1024_default_ms=f"{k2_med[False]:.4f}",
          k2_disk_1024_refine_ms=f"{k2_med[True]:.4f}")

    # 20. sort_rays on the differentiable kernel route at 200x200 rk4/200
    #     f32: its main path counted (one pixel-loss step: one K3 and one
    #     K4 launch), the loss and gradients bitwise those unsorted, and K3
    #     and K4 timed on the sorted and the unsorted batch.
    t0 = time.perf_counter()
    truth = rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    with torch.no_grad():
        target = rt.make_ray_render_for_params(spec, tcfg, 2, f32, dev)(
            truth, xg, ng)

    def loss_grads(cfg):
        p = rt.InverseParams(1.05, 0.02, [0.0, 4.0, 0.1, 0.0], f32, dev)
        loss = rt.make_ray_loss_fn(spec, cfg, 2, f32, dev)(p, xg, ng, target)
        loss.backward()
        return torch.cat([loss.detach()[None], p.M.grad[None],
                          p.a.grad[None], p.sphere_pos.grad])

    sorted_cfg = tcfg._replace(integrator=tcfg.integrator._replace(
        sort_rays=True))
    loss_grads(sorted_cfg)
    torch.cuda.synchronize()
    reset_counts()
    g_sorted = loss_grads(sorted_cfg)
    torch.cuda.synchronize()
    sort_launches = (adj.forward_segment_cuda.launches,
                     adj.backward_cuda.launches)
    g_plain = loss_grads(tcfg)
    require(sort_launches == (1, 1), f"the sorted training step launched K3 "
            f"and K4 {sort_launches} times")
    require(bits_equal(g_sorted, g_plain), "sort_rays: the loss or gradients "
            f"differ (max |d| {max_err(g_sorted, g_plain):.3e})")
    order, _ = impact_parameter_order(ty0)
    k34_sorted = k3_k4_ms(tcfg.integrator, order)
    out.update(k3_k4_sorted=k34_sorted)
    phase("main path sort_rays train step rk4/200 200x200 f32", t0,
          card=repr(card), k3_launches=sort_launches[0],
          k4_launches=sort_launches[1], grads_bitwise=True,
          k3_unsorted_ms=f"{k34[False][0]:.4f}",
          k3_sorted_ms=f"{k34_sorted[0]:.4f}",
          k4_unsorted_ms=f"{k34[False][1]:.4f}",
          k4_sorted_ms=f"{k34_sorted[1]:.4f}")

    # 21. grad_mode="scan" (autograd through every rematerialized step of
    #     the plain body) against the kernel route's gradients, 16x16 f64
    #     rk4/40.
    t0 = time.perf_counter()
    sspec = example2_spec(16, 16)
    sxg, sng = rt.flat_pixel_grid(sspec, f64, dev)
    scfg = rt.default_inverse_cfg(f64, max_steps=40, method="rk4",
                                  rk4_dt=2.5, stop_rho=0.5, soft_temp=0.05)
    with torch.no_grad():
        starget = rt.make_ray_render_for_params(sspec, scfg, 2, f64, dev)(
            rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f64, dev),
            sxg, sng)
    grads = {}
    for mode in ("scan", "ckpt_cuda"):
        c = scfg._replace(integrator=scfg.integrator._replace(grad_mode=mode))
        p = rt.InverseParams(1.05, 0.02, [0.0, 4.0, 0.1, 0.0], f64, dev)
        rt.make_ray_loss_fn(sspec, c, 2, f64, dev)(p, sxg, sng,
                                                   starget).backward()
        grads[mode] = torch.cat([p.M.grad[None], p.a.grad[None],
                                 p.sphere_pos.grad])
    rel = float((grads["scan"] - grads["ckpt_cuda"]).abs().max()
                / grads["ckpt_cuda"].abs().max())
    phase("grad_mode scan vs ckpt_cuda 16x16 f64 rk4/40", t0,
          grads_scan=[f"{v:.12e}" for v in grads["scan"].tolist()],
          grads_ckpt_cuda=[f"{v:.12e}" for v in grads["ckpt_cuda"].tolist()],
          max_rel_diff=f"{rel:.3e}", rtol=GRAD_RTOL[f64])
    require(rel <= GRAD_RTOL[f64], f"scan vs ckpt_cuda: {rel:.3e}")
    return out


SHARD_W = 2
SHARD_TIMEOUT = 300
# The sharded training step against the unsharded one at W = 2 (JAX's f32
# bar, tests/test_sharding.py:86-101): the sums run in another order.
SHARD_LOSS_RTOL = 1e-5
SHARD_M_RTOL = 1e-3
# The row-major route against K1 at f64 (tests/test_pallas.py's bar
# between the JAX package's two routes), and the share of pixels that may
# exceed it (ROADMAP C's pixel bar); hit flips only on horizon rays
# (final Kerr-Schild radius below 1.04 r+, tests/test_torch_integrate.py).
ROWMAJOR_ATOL = 1e-9
ROWMAJOR_PIXEL_FRAC = 0.005
HORIZON_BAND = 1.04


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_setup(dev, n: int = 200):
    """The training main path's inputs at n x n f32: (spec, cfg, xg, ng,
    target, params factory, loss function)."""
    import raytracegr_jl_tpu_torch as rt
    f32 = torch.float32
    spec = rt.example2_spec(n, n)
    cfg = rt.default_inverse_cfg(f32, max_steps=200, method="rk4",
                                 rk4_dt=0.5, stop_rho=0.5)
    xg, ng = rt.flat_pixel_grid(spec, f32, dev)
    with torch.no_grad():
        target = rt.make_ray_render_for_params(spec, cfg, 2, f32, dev)(
            rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev),
            xg, ng)

    def params():
        return rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)

    return xg, ng, target, params, rt.make_ray_loss_fn(spec, cfg, 2, f32,
                                                       dev)


def flat_grads(loss, M, a, sphere_pos) -> torch.Tensor:
    """A training step's loss and (M, a, sphere_pos) gradients, flat."""
    return torch.cat([loss.detach().reshape(1), M.reshape(1), a.reshape(1),
                      sphere_pos.reshape(-1)])


def flagship_render(dev, n: int = 1024):
    """render_fn of example2 n x n f32 in the bench configuration, and its
    canvas."""
    import raytracegr_jl_tpu_torch as rt
    metric, scene, canvas = rt.build(rt.example2_spec(n, n), torch.float32,
                                     dev)
    fn = rt.render_fn(metric, scene, rt.RenderConfig(
        integrator=rt.IntegratorConfig(method="tsit5", rtol=RTOL_F32,
                                       atol=RTOL_F32, max_steps=20_000)))
    return fn, canvas


def kernel_counts():
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    return {name: (fn.launches, fn.rays) for name, fn in (
        ("k1", integrate_rays_cuda), ("k3", adj.forward_segment_cuda),
        ("k4", adj.backward_cuda))}


def reset_rays(launches: bool = False):
    """Sets the ray counts of K1, K3 and K4 to 0, and with ``launches``
    their launch counts too."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    for fn in (integrate_rays_cuda, adj.forward_segment_cuda,
               adj.backward_cuda):
        fn.rays = 0
        if launches:
            fn.launches = 0


def sharding_rank(rank: int, world: int, port: int) -> int:
    """One rank of phase 23 (a subprocess): a gloo group whose ranks share
    card 0. Renders its rows of the 1024x1024 flagship through K1, runs the
    sharded 200x200 training step through K3 and K4 with the counts set to
    0 just before, the unsharded step for the gap, and times the sharded
    step; prints ``RESULT {json}``."""
    from raytracegr_jl_tpu_torch.parallel import sharding as S
    dev = torch.device("cuda", 0)
    require(S.init_distributed(f"localhost:{port}", world, rank,
                               local_rank=0, backend="gloo"),
            "init_distributed: not a multi-process run")
    mesh = S.make_mesh()
    require(S.mesh_device(mesh) == dev, f"rank {rank} on {S.mesh_device(mesh)}")
    out = {"rank": rank}
    try:
        fn, canvas = flagship_render(dev)
        single = fn(canvas.pos, canvas.normal)
        pos, normal = S.shard_pixels(mesh, canvas.pos, canvas.normal)
        shard = S.sharded_render(fn, mesh)
        shard(pos, normal)  # the launch setup, once
        torch.cuda.synchronize()
        reset_rays(launches=True)
        rgb = shard(pos, normal)
        torch.cuda.synchronize()
        out["render"] = kernel_counts()["k1"]
        mine = S.shard_rows(single, rank, world)
        full = S.crop_rows(canvas.pos.shape[0], S.gather_rows(mesh, rgb))[0]
        out["render_rows_bitwise"] = bool(torch.equal(rgb, mine))
        out["render_gathered_bitwise"] = bool(torch.equal(full, single))

        xg, ng, target, params, loss_fn = train_setup(dev)
        step = S.sharded_value_and_grad(loss_fn, mesh)
        batch = S.shard_pixels(mesh, xg, ng, target)
        step(params(), *batch)
        torch.cuda.synchronize()
        reset_rays(launches=True)
        loss, g = step(params(), *batch)
        torch.cuda.synchronize()
        counts = kernel_counts()
        out["train"] = [counts["k3"], counts["k4"]]
        out["rows"] = batch[0].shape[0]
        vec = flat_grads(loss, g.M, g.a, g.sphere_pos)
        out["loss_grads"] = [float(v).hex() for v in vec.tolist()]
        p = params()
        ref_loss = loss_fn(p, xg, ng, target)
        ref_loss.backward()
        ref = flat_grads(ref_loss, p.M.grad, p.a.grad, p.sphere_pos.grad)
        out["unsharded"] = [float(v) for v in ref.tolist()]
        times = []
        for _ in range(REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params(), *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = statistics.median(times[1:])
    finally:
        torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def sharding_slice(dev, card: str, reset_counts) -> dict:
    """Data parallelism (parallel/sharding.py). 22: NCCL at world size 1 in
    this process: the training main path (200x200 f32, rk4/200) through
    sharded_value_and_grad bitwise equal to the unsharded loss and
    gradients, and the 1024x1024 flagship through sharded_render and
    gather_rows bitwise equal to render_fn's. 23: two gloo ranks on this
    card (NCCL takes one rank per card), each a subprocess: each renders
    its half of the rows through K1, bitwise, and runs K3 and K4 on its
    20,000 rays of the step; both ranks' loss and gradients bitwise equal,
    within the f32 bar of the unsharded step. Returns the times."""
    from raytracegr_jl_tpu_torch.parallel import sharding as S

    # 22. NCCL, world size 1.
    t0 = time.perf_counter()
    port = free_port()
    require(not S.init_distributed(f"localhost:{port}", 1, 0, local_rank=0),
            "init_distributed reported several processes")
    require(torch.distributed.get_backend() == "nccl", "not NCCL")
    try:
        mesh = S.make_mesh()
        xg, ng, target, params, loss_fn = train_setup(dev)
        p = params()
        ref_loss = loss_fn(p, xg, ng, target)
        ref_loss.backward()
        ref = flat_grads(ref_loss, p.M.grad, p.a.grad, p.sphere_pos.grad)
        step = S.sharded_value_and_grad(loss_fn, mesh)
        batch = S.shard_pixels(mesh, xg, ng, target)
        torch.cuda.synchronize()
        reset_counts()
        reset_rays()
        loss, g = step(params(), *batch)
        torch.cuda.synchronize()
        train_counts = kernel_counts()
        got = flat_grads(loss, g.M, g.a, g.sphere_pos)
        require(train_counts["k3"] == (1, 40_000)
                and train_counts["k4"] == (1, 40_000),
                f"the sharded step at W = 1 ran K3/K4 {train_counts}")
        require(torch.equal(got, ref), "sharded step at W = 1 differs from "
                f"the unsharded one (max |d| {max_err(got, ref):.3e})")
        step_ms = []
        for _ in range(REPEATS + 1):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(params(), *batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        one_rank_ms = statistics.median(step_ms[1:])
        fn, canvas = flagship_render(dev)
        single = fn(canvas.pos, canvas.normal)
        pos, normal = S.shard_pixels(mesh, canvas.pos, canvas.normal)
        torch.cuda.synchronize()
        reset_counts()
        reset_rays()
        rgb = S.crop_rows(canvas.pos.shape[0], S.gather_rows(
            mesh, S.sharded_render(fn, mesh)(pos, normal)))[0]
        torch.cuda.synchronize()
        render_counts = kernel_counts()["k1"]
        require(render_counts == (1, 1024 * 1024),
                f"the sharded render at W = 1 ran K1 {render_counts}")
        require(torch.equal(rgb, single), "sharded render at W = 1 differs")
    finally:
        torch.distributed.destroy_process_group()
    phase("main path sharded NCCL world size 1", t0, card=repr(card),
          k3_launches_rays=train_counts["k3"],
          k4_launches_rays=train_counts["k4"],
          k1_launches_rays=render_counts, step_bitwise=True,
          render_1024_bitwise=True, step_ms=f"{one_rank_ms:.4f}",
          loss=f"{float(loss):.9e}")

    # 23. Two gloo ranks on one card.
    t0 = time.perf_counter()
    port = free_port()
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharding-rank",
         str(r), str(SHARD_W), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for r in range(SHARD_W)]
    results, errs = [], []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SHARD_TIMEOUT)
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            if p.returncode != 0 or not lines:
                errs.append(f"rank exit {p.returncode}: {err[-3000:]}")
            else:
                results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(not errs, "sharding ranks failed: " + " | ".join(errs))
    half = 1024 * 1024 // SHARD_W
    rows = 200 * 200 // SHARD_W
    for r in results:
        require(r["render"] == [1, half], f"rank {r['rank']} ran K1 "
                f"{r['render']}, not once on {half} rays")
        require(r["train"] == [[1, rows], [1, rows]], f"rank {r['rank']} ran "
                f"K3/K4 {r['train']}, not once each on {rows} rays")
        require(r["render_rows_bitwise"] and r["render_gathered_bitwise"],
                f"rank {r['rank']}: its rows of the render differ")
    a, b = results
    require(a["loss_grads"] == b["loss_grads"],
            "the two ranks' loss and gradients differ")
    got = [float.fromhex(v) for v in a["loss_grads"]]
    ref = a["unsharded"]
    loss_gap = abs(got[0] - ref[0]) / abs(ref[0])
    m_gap = abs(got[1] - ref[1]) / abs(ref[1])
    grad_gap = max(abs(x - y) for x, y in zip(got[1:], ref[1:])) / max(
        abs(y) for y in ref[1:])
    phase("main path sharded gloo 2 ranks on one card", t0, card=repr(card),
          k1_launches_rays_per_rank=[r["render"] for r in results],
          k3_k4_launches_rays_per_rank=[r["train"] for r in results],
          ranks_bitwise=True, render_rows_bitwise=True,
          loss=f"{got[0]:.9e}", loss_unsharded=f"{ref[0]:.9e}",
          loss_rel_gap=f"{loss_gap:.3e}", grad_M_rel_gap=f"{m_gap:.3e}",
          grads_max_rel_gap=f"{grad_gap:.3e}",
          step_ms_1_rank_nccl=f"{one_rank_ms:.4f}",
          step_ms_2_ranks_gloo=[f"{r['step_ms']:.4f}" for r in results])
    require(loss_gap <= SHARD_LOSS_RTOL and m_gap <= SHARD_M_RTOL,
            f"the sharded step at W = 2 is {loss_gap:.3e} / {m_gap:.3e} from "
            "the unsharded one")
    return {"one_rank_ms": one_rank_ms,
            "two_rank_ms": [r["step_ms"] for r in results]}


def rowmajor_slice(dev, card: str) -> dict:
    """24. The generic-metric row-major route (backend="rowmajor") on the
    card: example2 64x64 f64 at rtol = atol = 1e-9 against K1 on the same
    rays (rgb within ROWMAJOR_ATOL but on at most ROWMAJOR_PIXEL_FRAC of
    the pixels, hit flips on horizon rays only), and the route's times
    and host reads per render at 64x64 f64 and 200x200 f32."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.ops import integrate
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    from raytracegr_jl_tpu_torch.ops.metrics import kerr_schild_radius
    from raytracegr_jl_tpu_torch.render import _shade, trace_batch

    def reads():
        return (integrate.integrate_rays.host_reads
                + integrate._locate_event.host_reads)

    t0 = time.perf_counter()
    f64 = torch.float64
    spec = rt.example2_spec(64, 64)
    metric, scene, canvas = rt.build(spec, f64, dev)
    integ = rt.IntegratorConfig(rtol=1e-9, atol=1e-9, max_steps=20_000)
    cfg = rt.RenderConfig(integrator=integ, backend="rowmajor")
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    r0 = reads()
    res, ms64 = events_call(lambda: trace_batch(metric, scene, y0, cfg))
    reads64 = reads() - r0
    rgb = _shade(metric, scene, y0, res.y, cfg)
    k1 = integrate_rays_cuda(metric, scene, y0, None, integ)
    rgb_k1 = _shade(metric, scene, y0, k1.y, cfg)
    diff = (rgb - rgb_k1).abs().amax(-1)
    beyond = int((diff > ROWMAJOR_ATOL).sum())
    M, a = spec.metric_params.M, spec.metric_params.a
    r_plus = M + (M * M - a * a) ** 0.5

    def radius(y):
        x = y[:, 1:4]
        return kerr_schild_radius((x * x).sum(1), x[:, 2], a,
                                  r_formula=spec.r_formula)

    horizon = ((radius(res.y) < HORIZON_BAND * r_plus)
               | (radius(k1.y) < HORIZON_BAND * r_plus))
    flips = res.hit != k1.hit
    flips_off = int((flips & ~horizon).sum())
    phase("rowmajor vs K1 example2 64x64 f64", t0, card=repr(card),
          rays=y0.shape[0], iterations=res.n_iters,
          hit_flips=int(flips.sum()), hit_flips_off_horizon=flips_off,
          pixels_beyond_1e_9=beyond, max_abs_diff=f"{float(diff.max()):.3e}",
          steps_equal_share=f"{float((res.steps == k1.steps).double().mean()):.6f}",
          render_ms=f"{ms64:.1f}", host_reads=reads64)
    require(bool(torch.isfinite(rgb).all()), "row-major: non-finite colours")
    require(flips_off == 0, f"row-major: {flips_off} hit flips off the "
            "horizon against K1")
    require(beyond <= ROWMAJOR_PIXEL_FRAC * y0.shape[0],
            f"row-major: {beyond} pixels beyond {ROWMAJOR_ATOL} of K1's")

    t0 = time.perf_counter()
    metric, scene, canvas = rt.build(rt.example2_spec(200, 200),
                                     torch.float32, dev)
    fn = rt.render_fn(metric, scene, rt.RenderConfig(
        integrator=rt.IntegratorConfig(rtol=RTOL_F32, atol=RTOL_F32,
                                       max_steps=20_000),
        backend="rowmajor"))
    # One render, timed and counted: the route is host-bound plain torch
    # (~80-110 ms an iteration), not a main path.
    r0 = reads()
    ms200 = events_ms(lambda: fn(canvas.pos, canvas.normal))
    reads200 = reads() - r0
    phase("time rowmajor render 200x200 f32", t0, card=repr(card),
          render_ms=f"{ms200:.1f}", host_reads=reads200,
          render_ms_64x64_f64=f"{ms64:.1f}")
    return {"ms64": ms64, "ms200": ms200}


# The Dual oracle's configuration (the JAX package's
# tests/test_dual_oracle.py): example2, f64, RK4 with 20 steps of 0.25,
# M0 = 1.05, a = 0, sphere 2. Its bars: the primal on every pixel within
# ORACLE_PRIMAL_ATOL, the loss gradients and projections within a relative
# ORACLE_GRAD_RTOL (ROADMAP C's bar for gradients); at least 3 sphere hits
# and real signal in both tangents, as in the JAX tests.
ORACLE_N_STEPS = 20
ORACLE_RK4_DT = 0.25
ORACLE_M0 = 1.05
ORACLE_SPHERE = 2
ORACLE_PRIMAL_ATOL = 1e-12
ORACLE_GRAD_RTOL = 1e-9
ORACLE_SEED = 9
# Host syncs per oracle render: the scene's four fields, read once.
ORACLE_SCENE_READS = 4


def dual_oracle_case(dev, card: str, reset_counts, n: int,
                     backend: str | None) -> dict:
    """The Dual oracle (ops/dual_oracle.py: forward mode by hand, sharing
    no derivative code with the port) against one differentiable route of
    the training path at example2 n x n f64: the route's primal, the loss
    gradients for M (target at M = 1) and for the sphere's z (target 0.9
    times the render) through make_ray_loss_fn, and both gradients of a
    seeded projection sum(w * rgb), against the oracle's mean(2 (rgb -
    target) drgb) and sum(w * drgb). The route is driven with the launch
    counts set to 0 just before and read just after."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.dual_oracle import \
        render_dual_sensitivity

    t0 = time.perf_counter()
    f64 = torch.float64
    label = backend or "K3/K4"
    spec = rt.example2_spec(n, n)
    cfg = rt.default_inverse_cfg(f64, max_steps=ORACLE_N_STEPS, method="rk4",
                                 rk4_dt=ORACLE_RK4_DT)
    if backend is not None:
        cfg = cfg._replace(backend=backend)
    _, scene0, _ = rt.build(spec, f64, dev)
    xg, ng = rt.flat_pixel_grid(spec, f64, dev)
    kw = dict(r_formula=spec.r_formula, rho_min=1e-3,
              rk4_dt=ORACLE_RK4_DT, n_steps=ORACLE_N_STEPS,
              interp_points=cfg.integrator.interp_points,
              bisect_iters=cfg.integrator.bisect_iters)
    oracle_ms = {}
    tangents = {}
    with sync_count() as syncs:
        for name, wrt in (("M", "M"), ("z", ("pos", ORACLE_SPHERE, 3))):
            torch.cuda.synchronize()
            ta = time.perf_counter()
            rgb_o, tangents[name] = render_dual_sensitivity(
                scene0, xg, ng, ORACLE_M0, 0.0, wrt=wrt, **kw)
            torch.cuda.synchronize()
            oracle_ms[name] = 1e3 * (time.perf_counter() - ta)
    require(rgb_o.device == dev, "the oracle left the card")

    render = rt.make_ray_render_for_params(spec, cfg, ORACLE_SPHERE, f64, dev)
    loss = rt.make_ray_loss_fn(spec, cfg, ORACLE_SPHERE, f64, dev)

    def params(M):
        return rt.InverseParams(M, 0.0, scene0.pos[ORACLE_SPHERE], f64, dev)

    with torch.no_grad():
        target_M = render(params(1.0), xg, ng)
    w = torch.from_numpy(np.random.default_rng(ORACLE_SEED).uniform(
        -1.0, 1.0, (xg.shape[0], 3))).to(dev)
    route_ms = []
    reset_counts()
    ta = time.perf_counter()
    p = params(ORACLE_M0)
    rgb = render(p, xg, ng)
    (rgb * w).sum().backward()
    torch.cuda.synchronize()
    route_ms.append(1e3 * (time.perf_counter() - ta))
    rgb = rgb.detach()
    targets = {"M": target_M, "z": 0.9 * rgb}
    got = {"proj_M": float(p.M.grad), "proj_z": float(p.sphere_pos.grad[3])}
    for name in ("M", "z"):
        ta = time.perf_counter()
        p = params(ORACLE_M0)
        loss(p, xg, ng, targets[name]).backward()
        torch.cuda.synchronize()
        route_ms.append(1e3 * (time.perf_counter() - ta))
        got[f"loss_{name}"] = float(p.M.grad if name == "M"
                                    else p.sphere_pos.grad[3])
    k3, k4 = adj.forward_segment_cuda.launches, adj.backward_cuda.launches
    k6, k7 = adj.localize_cuda.launches, adj.localize_vjp_cuda.launches

    dM, dz = tangents["M"], tangents["z"]
    want = {"loss_M": float(torch.mean(2.0 * (rgb_o - targets["M"]) * dM)),
            "loss_z": float(torch.mean(2.0 * (rgb_o - targets["z"]) * dz)),
            "proj_M": float((w * dM).sum()), "proj_z": float((w * dz).sum())}
    rel = {k: abs(got[k] - v) / abs(v) if v else float("inf")
           for k, v in want.items()}
    primal = float((rgb - rgb_o).abs().max())
    hits = int(((rgb_o[:, 2] - 1.0).abs() < 0.01).sum())
    max_dM, max_dz = float(dM.abs().max()), float(dz.abs().max())
    phase(f"dual oracle vs {label} example2 {n}x{n} f64 rk4/20", t0,
          card=repr(card), rays=xg.shape[0], k3_launches=k3,
          k4_launches=k4, k6_launches=k6, k7_launches=k7, sphere_hits=hits,
          max_abs_drgb_dM=f"{max_dM:.6e}", max_abs_drgb_dz=f"{max_dz:.6e}",
          primal_max_abs_diff=f"{primal:.3e}",
          **{f"rel_{k}": f"{v:.3e}" for k, v in rel.items()},
          **{f"oracle_{k}": f"{v:.17e}" for k, v in want.items()},
          oracle_ms_dM=f"{oracle_ms['M']:.1f}",
          oracle_ms_dz=f"{oracle_ms['z']:.1f}", oracle_host_syncs=syncs["n"],
          route_ms=[f"{v:.1f}" for v in route_ms])
    if backend is None:
        require(k3 > 0 and k4 > 0 and k6 > 0 and k7 > 0,
                f"oracle {n}x{n}: the route launched K3 {k3}, K4 {k4}, K6 "
                f"{k6} and K7 {k7} times")
    require(hits >= 3 and max_dM > 0.1 and max_dz > 1.0,
            f"oracle {n}x{n}: the check is empty ({hits} sphere hits, max "
            f"|drgb/dM| {max_dM:.3e}, max |drgb/dz| {max_dz:.3e})")
    require(syncs["n"] <= 2 * ORACLE_SCENE_READS,
            f"oracle {n}x{n}: {syncs['n']} host syncs in two renders")
    require(primal <= ORACLE_PRIMAL_ATOL,
            f"oracle {n}x{n} {label}: primal differs by {primal:.3e}")
    bad = {k: v for k, v in rel.items() if not v <= ORACLE_GRAD_RTOL}
    require(not bad, f"oracle {n}x{n} {label}: relative gaps {bad} above "
            f"{ORACLE_GRAD_RTOL}")
    return {"rel": rel, "primal": primal, "oracle_ms": oracle_ms,
            "route_ms": route_ms, "k3": k3, "k4": k4}


def dual_oracle_slice(dev, card: str, reset_counts) -> dict:
    """25. The Dual oracle against the training path's kernels: K3 and K4
    (the default route on the card) at 8x8 and 16x16, and the row-major
    route at 8x8."""
    return {(n, backend): dual_oracle_case(dev, card, reset_counts, n,
                                           backend)
            for n, backend in ((8, None), (16, None), (8, "rowmajor"))}


def graph_train_slice(dev, card: str, cfgs: dict, targets: dict, spec, xg,
                      ng, fit_target) -> dict:
    """The training step as one CUDA graph (step_graph.py) against the
    eager step, at 200x200 f32 for each training configuration: the loss
    and gradients bitwise (also after the parameters change in place), no
    host sync in replays 2..n, the step's time eager and graphed in turns,
    the replay's device time, kernels, K3 and K4 launches and host launch
    calls (profiler), peak memory; then fit's default configuration for 3
    Adam steps, graphed against eager, bitwise, and one Adam step of it
    measured as the training steps are (the eager one profiled once).
    Returns each configuration's numbers."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.step_graph import WARMUP_PASSES, GraphedStep
    f32 = torch.float32
    CAPTURED = WARMUP_PASSES + 1  # each kernel's launches as a graph is built
    out = {}
    for label, cfg in cfgs.items():
        t0 = time.perf_counter()
        loss_fn = rt.make_ray_loss_fn(spec, cfg, 2, f32, dev)
        target = targets[label]

        def params(M=1.05):
            return rt.InverseParams(M, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)

        def grads(p):
            return torch.cat([p.M.grad[None], p.a.grad[None],
                              p.sphere_pos.grad])

        def eager(p):
            for q in p.parameters():
                q.grad = None
            loss = loss_fn(p, xg, ng, target)
            loss.backward()
            return loss.detach()

        pe = params()
        peak_e = eager_peak(lambda: eager(pe))
        loss_e = eager(pe)
        pg = params()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with step_launches() as cap_n:
            step = GraphedStep(lambda p: loss_fn(p, xg, ng, target), pg)
        torch.cuda.synchronize()
        peak_g = torch.cuda.max_memory_allocated() - base
        held_g = torch.cuda.memory_allocated() - base

        def replay():
            for q in pg.parameters():
                q.grad.zero_()
            return step.replay()

        same = bits_equal(replay(), loss_e) and bits_equal(grads(pg),
                                                           grads(pe))
        syncs = no_sync(replay, GRAPH_REPLAYS)
        same = same and bits_equal(step.loss, loss_e) and bits_equal(
            grads(pg), grads(pe))
        # The leaves are read in place: a new M reaches the replay.
        with torch.no_grad():
            pg.M.fill_(1.06)
        pe2 = params(1.06)
        loss_e2 = eager(pe2)
        moved = (bits_equal(replay(), loss_e2)
                 and bits_equal(grads(pg), grads(pe2))
                 and not bits_equal(loss_e2, loss_e))
        ms = in_turns({"eager": lambda: eager(pe), "graphed": replay})
        prof = profile_steps(replay)
        out[label] = dict(ms=ms, prof=prof, peak_e=peak_e, peak_g=peak_g)
        phase(f"graphed train step {label} 200x200 f32", t0, card=repr(card),
              bitwise=same, new_params_bitwise=moved,
              loss=f"{float(loss_e):.9e}",
              host_syncs_in_replays=syncs,
              eager_step_ms=f"{ms['eager']:.4f}",
              graphed_step_ms=f"{ms['graphed']:.4f}",
              speedup=f"{ms['eager'] / ms['graphed']:.3f}",
              graphed_rays_per_s=f"{xg.shape[0] / ms['graphed'] * 1e3:.1f}",
              replay_device_ms=f"{prof['busy_ms']:.4f}",
              replay_idle_share=f"{max(0.0, 1 - prof['busy_ms'] / ms['graphed']):.4f}",
              replay_device_kernels=f"{prof['kernels']:.0f}",
              k3_per_replay=prof["k3"], k4_per_replay=prof["k4"],
              k10_per_replay=prof["k10"],
              k6_per_replay=prof["k6"], k7_per_replay=prof["k7"],
              k8_per_replay=prof["k8"], k9_per_replay=prof["k9"],
              k11_per_replay=prof["k11"], k12_per_replay=prof["k12"],
              launches_in_warmups_and_capture=cap_n,
              replay_host_launches=f"{prof['host_launches']:.0f}",
              eager_peak_mib=f"{peak_e / 2**20:.1f}",
              graphed_capture_peak_mib=f"{peak_g / 2**20:.1f}",
              graphed_held_mib=f"{held_g / 2**20:.1f}")
        require(same and moved, f"{label}: the graphed step differs from "
                "the eager one")
        require(syncs == 0, f"{label}: {syncs} host syncs in replays")
        require(set(cap_n.values()) == {CAPTURED},
                f"{label}: the capture and its warm-ups launched {cap_n}, "
                f"not {CAPTURED} of each kernel")

    t0 = time.perf_counter()
    fit_cfg = rt.default_inverse_cfg(f32, soft_temp=0.05, stop_rho=0.5)
    init = rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    res = {g: rt.fit(spec, fit_target, init, fit_cfg, steps=3, dtype=f32,
                     device=dev, graph=g) for g in (False, True)}
    same = same_fit(res[True], res[False])
    # One Adam step of that fit, eager and graphed.
    loss_fn = rt.make_loss_fn(spec, fit_target, fit_cfg, 2, f32, dev)
    with step_launches() as cap_n:
        eager, graphed, peak_g = adam_steps(loss_fn, init.copy, lr=3e-2)
    peak_e = eager_peak(eager)
    syncs = no_sync(graphed, GRAPH_REPLAYS)
    ms = in_turns({"eager": eager, "graphed": graphed})
    prof, prof_e = profile_steps(graphed), profile_steps(eager, reps=1)
    phase("graphed fit 3 Adam steps 200x200 f32", t0, card=repr(card),
          bitwise=same,
          losses=[f"{v:.9e}" for v in res[True].loss_history.tolist()],
          M=f"{float(res[True].final_params.M.detach()):.9f}",
          host_syncs_in_graphed_steps=syncs,
          eager_step_ms=f"{ms['eager']:.4f}",
          graphed_step_ms=f"{ms['graphed']:.4f}",
          speedup=f"{ms['eager'] / ms['graphed']:.3f}",
          eager_device_ms=f"{prof_e['busy_ms']:.4f}",
          eager_idle_share=f"{max(0.0, 1 - prof_e['busy_ms'] / ms['eager']):.4f}",
          eager_host_launches=f"{prof_e['host_launches']:.0f}",
          graphed_device_ms=f"{prof['busy_ms']:.4f}",
          graphed_idle_share=f"{max(0.0, 1 - prof['busy_ms'] / ms['graphed']):.4f}",
          graphed_host_launches=f"{prof['host_launches']:.0f}",
          graphed_device_kernels=f"{prof['kernels']:.0f}",
          k3_per_step=prof["k3"], k4_per_step=prof["k4"],
          k10_per_step=prof["k10"],
          k6_per_step=prof["k6"], k7_per_step=prof["k7"],
          k8_per_step=prof["k8"], k9_per_step=prof["k9"],
          k11_per_step=prof["k11"], k12_per_step=prof["k12"],
          launches_in_warmups_and_capture=cap_n,
          eager_peak_mib=f"{peak_e / 2**20:.1f}",
          graphed_capture_peak_mib=f"{peak_g / 2**20:.1f}")
    require(same, "the graphed fit differs from the eager one")
    require(syncs == 0 and set(cap_n.values()) == {CAPTURED},
            f"fit: {syncs} host syncs; launches in the capture and its "
            f"warm-ups {cap_n}, not {CAPTURED} of each kernel")
    return out


# K6 and K7 (the localization epilogue and its VJP) against their plain
# versions, bitwise, and K7 against torch.autograd of the plain epilogue.
LOC_GRAD_RTOL = 1e-12
# K6's bisection counts held to the plain bisection besides the default 40,
# with the record K7 reads at each, on these cases' final states.
LOC_BISECT = (0, 1, 39)
LOC_BISECT_CASES = ("example2 200x200 f32 rk4/200",
                    "example2 200x200 f64 tsit5/48")
LOC_CASES = (  # (label, spec, dtype, method, max_steps, refine)
    ("example2 200x200 f32 rk4/200", "example2", torch.float32, "rk4", 200,
     False),
    ("example2 200x200 f32 tsit5/48", "example2", torch.float32, "tsit5",
     48, False),
    ("example2 200x200 f64 rk4/200", "example2", torch.float64, "rk4", 200,
     False),
    ("example2 200x200 f64 tsit5/48", "example2", torch.float64, "tsit5",
     48, False),
    ("example1 200x200 f32 rk4/200", "example1", torch.float32, "rk4", 200,
     False),
    ("example1 200x200 f64 tsit5/48", "example1", torch.float64, "tsit5",
     48, False),
    ("example2 200x200 f32 rk4/200 refine_minima", "example2",
     torch.float32, "rk4", 200, True))


def final_state(dev, spec_name: str, dtype, method: str, max_steps: int,
                refine: bool = False, n: int = 200):
    """The training path's final packed state at n x n through K3: (route
    on the card, P [34, B])."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    integ = rt.default_inverse_cfg(dtype, max_steps=max_steps, method=method,
                                   rk4_dt=100.0 / max_steps,
                                   stop_rho=0.5).integrator
    integ = integ._replace(refine_minima=refine)
    spec = (rt.example2_spec if spec_name == "example2"
            else rt.example1_spec)(n, n)
    metric, scene, _ = rt.build(spec, dtype, dev)
    if spec_name == "example2":
        metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(
            torch.tensor(1.05, dtype=dtype, device=dev),
            torch.tensor(0.0, dtype=dtype, device=dev)), rho_min=0.25)
    xg, ng = rt.flat_pixel_grid(spec, dtype, dev)
    seg = adj.segment_length(integ, integ.grad_seg_len)
    route = adj.Route(metric=metric, scene=scene, cfg=integ, seg_len=seg,
                      n_seg=integ.max_steps // seg, cuda=True)
    with torch.no_grad():
        x, u = pixel_rays(metric, xg, ng)
        y0 = torch.cat([x, u], -1)
        ck, _ = adj.run_segments(route, y0.t().contiguous())
    return route, ck[route.n_seg].contiguous()


def loc_cotangents(P: torch.Tensor, seed: int = 3):
    """Seeded cotangents of (y, lam), every seventh ray's all zero."""
    gen = torch.Generator(device=P.device).manual_seed(seed)
    B = P.shape[1]
    ct_y = torch.randn((8, B), generator=gen, dtype=P.dtype, device=P.device)
    ct_lam = torch.randn(B, generator=gen, dtype=P.dtype, device=P.device)
    ct_y[:, ::7] = 0
    ct_lam[::7] = 0
    return ct_y, ct_lam


def require_loc_equal(label: str, route, P) -> float:
    """K6 against localize_plain (its results, and its record on the hit
    rays: K6 writes no other) and K7, given K6's record, against
    localize_vjp given the plain record and against localize_vjp's replay,
    on the same CUDA tensors, bit for bit; returns the largest |difference|
    (0)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    plain = route._replace(cuda=False)
    y_k, lam_k, rec_k = adj.localize_cuda(route, P)
    y_p, lam_p, rec_p = adj.localize_plain(plain, P)
    ct_y, ct_lam = loc_cotangents(P)
    c_k, p_k = adj.localize_vjp_cuda(route, P, ct_y, ct_lam, rec_k)
    c_p, p_p = adj.localize_vjp(plain, P, ct_y, ct_lam, rec_p)
    c_r, p_r = adj.localize_vjp(plain, P, ct_y, ct_lam)
    torch.cuda.synchronize()
    hit = P[adj.P_HIT] > 0
    rec_k, rec_p = rec_k[:, hit], rec_p[:, hit]
    err = max(max_err(y_k, y_p), max_err(lam_k, lam_p),
              max_err(rec_k, rec_p), max_err(c_k, c_p), max_err(p_k, p_p),
              max_err(c_k, c_r), max_err(p_k, p_r))
    require(bits_equal(y_k, y_p) and bits_equal(lam_k, lam_p)
            and bits_equal(rec_k, rec_p),
            f"{label}: K6 not bitwise equal to its plain version "
            f"(max |d| {err:.3e})")
    require(bits_equal(c_k, c_p) and bits_equal(p_k, p_p)
            and bits_equal(c_k, c_r) and bits_equal(p_k, p_r),
            f"{label}: K7 not bitwise equal to localize_vjp "
            f"(max |d| {err:.3e})")
    return err


def localize_autograd(route, P, ct_y, ct_lam):
    """torch.autograd of the plain epilogue (the dead-ray cutoff, then
    localize_events_cm and the selection) on an ungrouped route, with M, a
    and the objects' fields as leaves: (ct of P [34, B], of pvec [P])."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (OBJ_FIELDS,
                                                         localize_events_cm,
                                                         scene_event_cm)
    from raytracegr_jl_tpu_torch.ops.metrics import KerrSchildParams
    P = P.clone().requires_grad_()
    pv = adj.flatten_params(route.metric, route.scene).detach()
    pv.requires_grad_()
    metric = route.metric._replace(params=KerrSchildParams(M=pv[0],
                                                           a=pv[1]))
    sc = route.scene
    rows = pv[2:].reshape(sc.n_objects, 8)
    scene = sc._replace(pos=torch.cat([sc.pos[:, :1], rows[:, :3]], 1),
                        **{f: rows[:, 3 + k]
                           for k, f in enumerate(OBJ_FIELDS[3:])})
    st = adj.unpack_state(P)
    cfg = route.cfg
    dead = ~st.hit & ~st.active & (st.lam < cfg.lam_max - 1e-6)
    y = torch.where(dead, st.y.detach(), st.y)
    th, ys = localize_events_cm(metric, scene_event_cm(scene), cfg, st.ev_y0,
                                st.ev_dt, st.ev_lo, st.ev_hi)
    y = torch.where(st.hit, ys, y)
    lam = torch.where(st.hit, st.ev_lam + th * st.ev_dt, st.lam)
    return torch.autograd.grad((y * ct_y).sum() + (lam * ct_lam).sum(),
                               (P, pv))


def loc_autograd_gap(route, P) -> float:
    """K7 against torch.autograd of the plain epilogue: the largest
    relative gap of the y and ev_y0 planes' cotangents (each against the
    largest of its reference) and of each parameter's (against the sum of
    its per-ray cotangents' magnitudes, the scale of the sum's rounding)."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    ct_y, ct_lam = loc_cotangents(P)
    rec = adj.localize_cuda(route, P)[2]
    c_k, p_k = adj.localize_vjp_cuda(route, P, ct_y, ct_lam, rec)
    g_P, g_p = localize_autograd(route, P, ct_y, ct_lam)
    gap = 0.0
    for lo in (adj.P_Y, adj.P_EV_Y0):
        ref = g_P[lo:lo + 8]
        gap = max(gap, max_err(c_k[lo:lo + 8], ref)
                  / max(float(ref.abs().max()), 1e-300))
    scale = p_k.abs().sum(1).clamp_min(1e-300)
    gap = max(gap, float(((p_k.sum(1) - g_p).abs() / scale).max()))
    return gap


def localize_slice(dev, card: str) -> dict:
    """K6 and K7 against their plain versions on the card, bitwise, on the
    final states of the training configurations at 200x200 (f32 and f64,
    rk4/200 and tsit5/48; example1's flat space; refine_minima; other
    bisection counts, LOC_BISECT) and of config 5's grouped
    batch at 4 starts (f32, rk4 and tsit5, and refine_minima); K7 against
    torch.autograd of the plain epilogue at f64; then each kernel's time,
    its plain version's and its bound on the main path's final state
    (rk4/200 f32), and the pair's. Returns the numbers for the kernels'
    JSON line."""
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.utils import cuda_build
    t0 = time.perf_counter()
    err, gaps, hits = 0.0, {}, {}
    for label, spec_name, dtype, method, steps, refine in LOC_CASES:
        route, P = final_state(dev, spec_name, dtype, method, steps, refine)
        hits[label] = int((P[adj.P_HIT] > 0).sum())
        err = max(err, require_loc_equal(label, route, P))
        if dtype == torch.float64:
            gaps[label] = loc_autograd_gap(route, P)
        if label in LOC_BISECT_CASES:
            for iters in LOC_BISECT:
                err = max(err, require_loc_equal(
                    f"{label} bisect_iters {iters}", route._replace(
                        cfg=route.cfg._replace(bisect_iters=iters)), P))
    for method, refine in (("rk4", False), ("tsit5", False), ("rk4", True)):
        _, grouped, y0 = inverse_case(dev, torch.float32, method,
                                      refine=refine)
        ck, _ = k3_pass(grouped, y0)
        P = ck[grouped.n_seg].contiguous()
        label = (f"config 5 grouped 4 starts f32 {method}"
                 + (" refine_minima" if refine else ""))
        hits[label] = int((P[adj.P_HIT] > 0).sum())
        err = max(err, require_loc_equal(label, grouped, P))
    gap = max(gaps.values())
    phase("K6/K7 vs plain and autograd", t0, cases=len(hits),
          hits=hits, max_abs_err=err,
          k7_vs_autograd_max_rel_gap=f"{gap:.3e}",
          per_case={k: f"{v:.3e}" for k, v in gaps.items()},
          rtol=LOC_GRAD_RTOL)
    require(all(v > 0 for v in hits.values()), "a case had no hit ray")
    require(gap <= LOC_GRAD_RTOL, f"K7 differs from autograd of the plain "
            f"epilogue by {gap:.3e}")

    # Times and bounds on the main path's final state. Work of this run:
    # K6 localizes each hit ray (the plain epilogue's count for one ray);
    # K7 walks back each hit ray with a non-zero cotangent (localize_vjp's
    # count for one ray given the record: no replay). Bytes: K6 reads 22
    # planes and writes 9, and the record's R (57 Tsit5, 49 RK4) for each
    # hit ray; K7 reads 14 planes and 9 of cotangents, and the record for
    # each live ray, and writes 34 planes and 2 + 8 N rows.
    t0 = time.perf_counter()
    out = {}
    regs = {k: f"{r} registers, {st}/{ld} B spilled"
            for k, r, _, st, ld in ptxas_report(cuda_build.build_log(
                "localize")) if k.startswith(("k6_kernel<float, true",
                                              "k7_kernel<float, true"))}
    for label, method, steps in (("rk4/200", "rk4", 200),
                                 ("tsit5/48", "tsit5", 48)):
        route, P = final_state(dev, "example2", torch.float32, method, steps)
        plain = route._replace(cuda=False)
        ct_y, ct_lam = loc_cotangents(P)
        args = adj.localize_args(route, P)
        rec = adj.localize_cuda(route, P, args)[2]
        rec_p = adj.localize_plain(plain, P)[2]
        k6 = lambda: adj.localize_cuda(route, P, args)  # noqa: E731
        k7 = lambda: adj.localize_vjp_cuda(  # noqa: E731
            route, P, ct_y, ct_lam, rec, args)
        k6_ms, k7_ms = cuda_ms(k6), cuda_ms(k7)
        k6_dev = kernel_alone_ms(k6, "k6_kernel")
        k7_dev = kernel_alone_ms(k7, "k7_kernel")
        k6_plain_ms = cuda_ms(lambda: adj.localize_plain(plain, P))
        k7_plain_ms = cuda_ms(lambda: adj.localize_vjp(plain, P, ct_y,
                                                       ct_lam, rec_p))
        hit = P[adj.P_HIT] > 0
        live = hit & ((ct_y != 0).any(0) | (ct_lam != 0))
        j = int(torch.nonzero(live)[0])
        one = lambda t: t[..., j:j + 1].contiguous()  # noqa: E731
        with torch.no_grad():
            f6 = count_flops(lambda: adj.localize_plain(plain, one(P)))
            f7 = count_flops(lambda: adj.localize_vjp(
                plain, one(P), one(ct_y), one(ct_lam), one(rec_p)))
        B, n_par = P.shape[1], 2 + 8 * route.scene.n_objects
        R = rec.shape[0]
        n_hit, n_live = int(hit.sum()), int(live.sum())
        b6 = bound(n_hit * f6, (B * (22 + 9) + n_hit * R) * 4)
        b7 = bound(n_live * f7,
                   (B * (14 + 9 + adj.N_PLANES + n_par) + n_live * R) * 4)
        pair_dev = (None if None in (k6_dev, k7_dev) else k6_dev + k7_dev)
        out[label] = dict(k6_ms=k6_ms, k7_ms=k7_ms, k6_plain_ms=k6_plain_ms,
                          k7_plain_ms=k7_plain_ms, k6_bound=b6, k7_bound=b7)
        phase(f"time K6/K7 {label} 200x200 f32", t0, card=repr(card),
              hits=n_hit, live=n_live, record_planes=R,
              k6_ms=f"{k6_ms:.4f}", k6_device_ms=k6_dev,
              k7_device_ms=k7_dev, pair_device_ms=pair_dev,
              k6_plain_ms=f"{k6_plain_ms:.4f}", k7_ms=f"{k7_ms:.4f}",
              k7_plain_ms=f"{k7_plain_ms:.4f}",
              flops_per_localization=f6, flops_per_vjp=f7,
              k6_bound_ms=f"{b6[0]:.6f}", k6_bound_by=b6[1],
              k7_bound_ms=f"{b7[0]:.6f}", k7_bound_by=b7[1],
              pair_bound_ms=f"{b6[0] + b7[0]:.6f}", registers=regs)
    out["err"] = err
    return out


# K8 and K9 (the camera and its VJP) against their plain versions,
# bitwise, and K9 against torch.autograd of the plain forward at f64: each
# ray's (M, a) cotangents against the larger of the two
# (tests/test_torch_camera.py's measure).
CAM_GRAD_RTOL = 1e-12
CAM_STARTS = 4


def camera_cases(dev, dtype):
    """(label, metric, pos, normal) of K8/K9's check at ``dtype``: the
    training path's example2 (M 1.05, rho_min 0.25; at f64 also spinning,
    a = 0.6) and example1 (Minkowski) at 200x200, and config 5's grouped
    batch at 4 starts (32x32 each, textbook, M and a per ray; at f64 also
    spins 0 to 0.3 per start)."""
    import raytracegr_jl_tpu_torch as rt
    name = str(dtype)[6:]
    full = lambda v: torch.tensor(v, dtype=dtype, device=dev)  # noqa: E731
    xg, ng = rt.flat_pixel_grid(rt.example2_spec(200, 200), dtype, dev)
    spins = (0.0, 0.6) if dtype == torch.float64 else (0.0,)
    cases = [(f"example2 200x200 {name} a={a}", rt.make_metric(
        "kerr_schild", rt.KerrSchildParams(full(1.05), full(a)),
        rho_min=0.25), xg, ng) for a in spins]
    xg, ng = rt.flat_pixel_grid(rt.example1_spec(200, 200), dtype, dev)
    cases.append((f"example1 200x200 {name}", rt.make_metric("minkowski"),
                  xg, ng))
    xg, ng = rt.flat_pixel_grid(rt.lensing_inverse_spec(INV_N, INV_N),
                                dtype, dev)
    B = xg.shape[0]
    Ms = full([M for M, _ in config5_starts(CAM_STARTS)])
    for top in spins[:1] + ((0.3,) if dtype == torch.float64 else ()):
        a = full([top * k / (CAM_STARTS - 1) for k in range(CAM_STARTS)])
        cases.append((f"config 5 grouped {CAM_STARTS} starts {name} spins "
                      f"0-{top}", rt.make_metric(
                          "kerr_schild", rt.KerrSchildParams(
                              Ms.repeat_interleave(B),
                              a.repeat_interleave(B)),
                          r_formula="textbook", rho_min=0.25),
                      xg.repeat(CAM_STARTS, 1), ng.repeat(CAM_STARTS, 1)))
    return cases


def cam_cotangent(pos: torch.Tensor, seed: int = 4) -> torch.Tensor:
    """A seeded cotangent of u, every ninth ray's zero."""
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    ct = torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                     device=pos.device)
    ct[::9] = 0
    return ct


def cam_autograd_gap(metric, pos, normal, ct) -> float:
    """K9 against torch.autograd of pixel_rays_plain with M and a a leaf
    per ray: the largest gap of a ray's (M, a) cotangents over the larger
    of the two."""
    from raytracegr_jl_tpu_torch.models import camera as cam
    B = pos.shape[0]
    leaf = lambda v: torch.as_tensor(  # noqa: E731
        v, dtype=pos.dtype, device=pos.device).expand(B).clone(
    ).requires_grad_()
    M, a = leaf(metric.params.M), leaf(metric.params.a)
    u = cam.pixel_rays_plain(metric._replace(params=metric.params._replace(
        M=M, a=a)), pos, normal)
    loss = (u * ct).sum()
    want = (torch.stack(torch.autograd.grad(loss, (M, a)))
            if loss.requires_grad else torch.zeros((2, B), dtype=pos.dtype,
                                                   device=pos.device))
    got = cam.pixel_rays_vjp_cuda(metric, pos, normal, ct)
    scale = want.abs().amax(0)
    gap = ((got - want).abs() / scale).nan_to_num(0.0, posinf=float("inf"))
    require(bool(torch.isfinite(want).all()), "autograd of the camera is "
            "not finite")
    return float(gap.max())


def camera_slice(dev, card: str) -> dict:
    """K8 and K9 against their plain versions on the card, bitwise, at f32
    and f64 (``camera_cases``), K9 against torch.autograd at f64; then
    each kernel's time alone (100 launches replayed in one graph, and
    the profiler) and in events, its plain version's, and its bound on
    the training path's pixel batch (example2 200x200 f32). Returns the
    numbers for the kernels' JSON line."""
    from raytracegr_jl_tpu_torch.models import camera as cam
    t0 = time.perf_counter()
    err, gaps, n_cases = 0.0, {}, 0
    for dtype in (torch.float32, torch.float64):
        for label, metric, pos, normal in camera_cases(dev, dtype):
            n_cases += 1
            ct = cam_cotangent(pos)
            # The training path's cotangent of u: a view of the gradient of
            # its [8, B] planes, which K9 reads through its strides.
            ct_planes = torch.cat([pos, ct], -1).t().contiguous().t()[:, 4:]
            u_k = cam.pixel_rays_cuda(metric, pos, normal)
            u_p = cam.pixel_rays_plain(metric, pos, normal)
            p_k = cam.pixel_rays_vjp_cuda(metric, pos, normal, ct)
            p_s = cam.pixel_rays_vjp_cuda(metric, pos, normal, ct_planes)
            p_p = cam.pixel_rays_vjp(metric, pos, normal, ct)
            torch.cuda.synchronize()
            e = max(max_err(u_k, u_p), max_err(p_k, p_p))
            err = max(err, e)
            require(bool(torch.isfinite(u_k).all()), f"{label}: u not finite")
            require(bits_equal(u_k, u_p), f"{label}: K8 not bitwise equal to "
                    f"pixel_rays_plain (max |d| {e:.3e})")
            require(bits_equal(p_k, p_p) and bits_equal(p_s, p_p),
                    f"{label}: K9 (its cotangent contiguous or a view of the "
                    f"planes) not bitwise equal to pixel_rays_vjp (max |d| "
                    f"{e:.3e})")
            if dtype == torch.float64:
                gaps[label] = cam_autograd_gap(metric, pos, normal, ct)
    gap = max(gaps.values())
    phase("K8/K9 vs plain and autograd", t0, cases=n_cases,
          max_abs_err=err, k9_vs_autograd_max_rel_gap=f"{gap:.3e}",
          per_case={k: f"{v:.3e}" for k, v in gaps.items()},
          rtol=CAM_GRAD_RTOL)
    require(gap <= CAM_GRAD_RTOL, f"K9 differs from autograd of the plain "
            f"camera by {gap:.3e}")

    # Times and bounds on the training path's pixel batch: in events (the
    # wrapper's call), 100 launches in one graph (the kernel back to back)
    # and from the profiler (None where it misses them). Work of this
    # run: the plain version's operations on one ray, times the rays;
    # bytes: K8 reads pos and normal and writes u, K9 reads pos, normal and
    # the cotangent and writes (M_bar, a_bar), per ray.
    t0 = time.perf_counter()
    label, metric, pos, normal = camera_cases(dev, torch.float32)[0]
    # As the training path hands K9 its cotangent: a view of the planes'
    # gradient.
    ct = torch.cat([pos, cam_cotangent(pos)], -1).t().contiguous().t()[:, 4:]
    k8 = lambda: cam.pixel_rays_cuda(metric, pos, normal)  # noqa: E731
    k9 = lambda: cam.pixel_rays_vjp_cuda(  # noqa: E731
        metric, pos, normal, ct)
    k8_ms, k9_ms = cuda_ms(k8), cuda_ms(k9)
    k8_graph, k9_graph = graph_ms(k8), graph_ms(k9)
    k8_dev, k9_dev = (kernel_alone_ms(k8, "k8_kernel"),
                      kernel_alone_ms(k9, "k9_kernel"))
    k8_plain_ms = cuda_ms(lambda: cam.pixel_rays_plain(metric, pos, normal))
    k9_plain_ms = cuda_ms(lambda: cam.pixel_rays_vjp(metric, pos, normal,
                                                     ct))
    with torch.no_grad():
        f8 = count_flops(lambda: cam.pixel_rays_plain(metric, pos[:1],
                                                      normal[:1]))
        f9 = count_flops(lambda: cam.pixel_rays_vjp(metric, pos[:1],
                                                    normal[:1], ct[:1]))
    B, w = pos.shape[0], pos.element_size()
    b8 = bound(B * f8, B * (4 + 4 + 4) * w)
    b9 = bound(B * f9, B * (4 + 4 + 4 + 2) * w)
    phase(f"time K8/K9 {label}", t0, card=repr(card), rays=B,
          k8_ms=f"{k8_ms:.4f}", k8_graphed_ms=f"{k8_graph:.5f}",
          k8_device_ms=k8_dev, k8_plain_ms=f"{k8_plain_ms:.4f}",
          k9_ms=f"{k9_ms:.4f}", k9_graphed_ms=f"{k9_graph:.5f}",
          k9_device_ms=k9_dev, k9_plain_ms=f"{k9_plain_ms:.4f}",
          flops_per_ray_k8=f8, flops_per_ray_k9=f9,
          k8_bound_ms=f"{b8[0]:.6f}", k8_bound_by=b8[1],
          k9_bound_ms=f"{b9[0]:.6f}", k9_bound_by=b9[1])
    return dict(err=err, k8_ms=k8_ms, k9_ms=k9_ms, k8_plain_ms=k8_plain_ms,
                k9_plain_ms=k9_plain_ms, k8_bound=b8, k9_bound=b9)


# K11 and K12 (the reference shading and its VJP) against their plain
# versions, bitwise, and the plain VJPs against torch.autograd of the plain
# forward at f64: each output's largest gap over its largest magnitude, on
# the rays where autograd's is finite (it forms 0 x inf at the poles and on
# the axis, where the VJPs give no cotangent; tests/test_torch_shade_vjp.py's
# measure).
SHADE_GRAD_RTOL = 1e-12
SHADE_STARTS = 4
SHADE_TEMP = 0.05


def shade_end_states(dev, spec, dtype, integ):
    """K1's end states ``[B, 8]`` of a spec's canvas, and its scene."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import integrate_rays_cuda
    metric, scene, canvas = rt.build(spec, dtype, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    return scene, integrate_rays_cuda(metric, scene, y0, None, integ).y


def shade_cases(dev, dtype):
    """(label, scene, x, temp, freq) of K11/K12's check at ``dtype``:
    example2 at 200x200 (K1's end states, f32 Tsit5 at eps^(3/4)) as the
    flagship render holds them (shared fields, x in K1's [B, 8] rows) and
    as the training path does (pos per ray, x in the [8, B] planes), hard
    and soft; config 5's lensing scene at 4 starts of 32x32 (each start's
    sphere per ray, soft at frequency 2); the accretion disk at 64x64
    (every field per ray, each ray's r_in, r_out and half its own), hard
    and soft."""
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.ops.adjoint import per_ray
    name = str(dtype)[6:]
    tol = float(torch.finfo(dtype).eps) ** 0.75
    integ = rt.IntegratorConfig(rtol=tol, atol=tol, max_steps=20_000)
    scene, y = shade_end_states(dev, rt.example2_spec(200, 200), dtype,
                                integ)
    B = y.shape[0]
    planes = y.t().contiguous().t()
    train = scene._replace(pos=per_ray(scene.pos[None], B))
    cases = []
    for temp, freq, mode in ((None, 12.0, "hard"),
                             (SHADE_TEMP, 12.0, "soft")):
        cases += [(f"render example2 200x200 {name} {mode}", scene,
                   y[:, :4], temp, freq),
                  (f"train example2 200x200 {name} {mode}", train,
                   planes[:, :4], temp, freq)]
    scene, y = shade_end_states(dev, rt.lensing_inverse_spec(INV_N, INV_N),
                                dtype, rt.IntegratorConfig(
                                    method="rk4", rk4_dt=0.5, max_steps=120,
                                    lam_max=60.0, stop_rho=0.5))
    B = y.shape[0]
    z = torch.tensor([0.02 * (k - 1.5) for k in range(SHADE_STARTS)],
                     dtype=dtype, device=dev)
    pos = scene.pos.expand(SHADE_STARTS, -1, -1).clone()
    pos[:, 0, 3] = z
    planes = y.repeat(SHADE_STARTS, 1).t().contiguous().t()
    cases.append((f"config 5 grouped {SHADE_STARTS} starts {name} soft",
                  scene._replace(pos=per_ray(pos, B)), planes[:, :4],
                  SHADE_TEMP, 2.0))
    scene, y = shade_end_states(dev, rt.accretion_disk_spec(64, 64), dtype,
                                rt.IntegratorConfig(rtol=tol, atol=tol,
                                                    max_steps=400,
                                                    stop_rho=1.0))
    B = y.shape[0]
    ramp = 1 + 1e-3 * torch.arange(B, dtype=dtype, device=dev)[:, None] / B
    disk = scene._replace(**{
        f: (getattr(scene, f)[None] * (ramp[..., None] if f == "pos"
                                        else ramp)).contiguous()
        for f in ("pos", "radius", "time", "r_in", "r_out", "half")})
    for temp, mode in ((None, "hard"), (SHADE_TEMP, "soft")):
        cases.append((f"disk 64x64 {name} {mode}", disk, y[:, :4], temp,
                      12.0))
    return cases


def shade_cotangent(x: torch.Tensor, seed: int = 5) -> torch.Tensor:
    """A seeded cotangent of the colour, every ninth ray's zero."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    ct = torch.randn((x.shape[0], 3), generator=gen, dtype=x.dtype,
                     device=x.device)
    ct[::9] = 0
    return ct


def shade_plain(scene, x, temp, freq):
    from raytracegr_jl_tpu_torch.models import objects as O
    if temp is None:
        return O.shade(scene, x)
    return O.shade_soft(scene, x, temp=temp, color_freq=freq)


def shade_plain_vjp(scene, x, ct, temp, freq, rec=None):
    from raytracegr_jl_tpu_torch.models import objects as O
    if temp is None:
        return O.shade_vjp(scene, x, ct, rec=rec)
    return O.shade_soft_vjp(scene, x, ct, temp=temp, color_freq=freq)


def shade_keeping_record(scene, x, temp, freq):
    """K11 keeping its record where the shading is hard (as the training
    path runs it): ``(rgb, rec)``, rec None where soft (no record)."""
    from raytracegr_jl_tpu_torch.models import objects as O
    return O.shade_cuda(scene, x, color_freq=freq, temp=temp,
                        record=temp is None)


def shade_autograd_gap(scene, x, ct, temp, freq, got) -> tuple:
    """The plain VJP's outputs ``got`` against torch.autograd of the plain
    forward, x and every field a leaf per ray: the largest gap of an output
    over its largest magnitude, on the rays where autograd's cotangents
    are all finite; and the count of the other rays."""
    from raytracegr_jl_tpu_torch.models.objects import (FIELD_DIMS,
                                                        SHADE_FIELDS)
    B = x.shape[0]
    xl = x.detach().clone().requires_grad_()
    leaves = {}
    for f in SHADE_FIELDS:
        v = getattr(scene, f).detach()
        if v.dim() == FIELD_DIMS.get(f, 1):
            v = v.expand((B,) + tuple(v.shape))
        leaves[f] = v.contiguous().requires_grad_()
    out = shade_plain(scene._replace(**leaves), xl, temp, freq)
    want = torch.autograd.grad((out * ct).sum(), [xl, *leaves.values()],
                               allow_unused=True)
    ct_x, cts = got
    pairs = [(ct_x, want[0])] + [(cts[f], w) for f, w in
                                 zip(SHADE_FIELDS, want[1:])]
    pairs = [(g, torch.zeros_like(g) if w is None else w) for g, w in pairs]
    finite = torch.ones(B, dtype=torch.bool, device=x.device)
    for _, w in pairs:
        finite &= torch.isfinite(w.reshape(B, -1)).all(-1)
    gap = 0.0
    for g, w in pairs:
        g, w = g.reshape(B, -1)[finite], w.reshape(B, -1)[finite]
        scale = float(w.abs().max()) if w.numel() else 0.0
        if scale > 0:
            gap = max(gap, float((g - w).abs().max()) / scale)
    return gap, int((~finite).sum())


def shade_slice(dev, card: str) -> dict:
    """K11 and K12 against their plain versions on the card, bitwise, at
    f32 and f64 (``shade_cases``), the plain VJPs against torch.autograd
    at f64; then each kernel's time alone (100 launches replayed in one
    graph, and the profiler) and in events, its plain version's, and its
    bound, on the flagship render's, the training path's and config 5's
    batches at f32. Returns the numbers for the kernels' JSON line."""
    from raytracegr_jl_tpu_torch.models import objects as O
    t0 = time.perf_counter()
    err, gaps, skipped, n_cases = 0.0, {}, {}, 0
    for dtype in (torch.float32, torch.float64):
        for label, scene, x, temp, freq in shade_cases(dev, dtype):
            n_cases += 1
            ct = shade_cotangent(x)
            rgb_k, none = O.shade_cuda(scene, x, temp=temp,
                                       color_freq=freq)
            require(none is None, f"{label}: K11 kept a record unasked")
            rgb_r, rec = shade_keeping_record(scene, x, temp, freq)
            rgb_p = shade_plain(scene, x, temp, freq)
            got_k = O.shade_vjp_cuda(scene, x, ct, temp=temp,
                                     color_freq=freq, rec=rec)
            got_p = shade_plain_vjp(scene, x, ct, temp, freq)
            got_r = shade_plain_vjp(scene, x, ct, temp, freq, rec)
            torch.cuda.synchronize()
            outs = [(got_k[0], got_p[0]), (got_r[0], got_p[0])] + [
                pair for f in O.SHADE_FIELDS
                for pair in ((got_k[1][f], got_p[1][f]),
                             (got_r[1][f], got_p[1][f]))]
            e = max([max_err(rgb_k, rgb_p)]
                    + [max_err(a, b) for a, b in outs])
            err = max(err, e)
            require(bool(torch.isfinite(rgb_k).all()),
                    f"{label}: rgb not finite")
            require(bits_equal(rgb_k, rgb_p) and bits_equal(rgb_r, rgb_p),
                    f"{label}: K11 not bitwise equal to the plain shading "
                    f"(max |d| {e:.3e})")
            require(rec is None or torch.equal(rec, O.shade_record(scene, x)),
                    f"{label}: K11's record differs from shade_record")
            require(all(bits_equal(a, b) for a, b in outs),
                    f"{label}: K12, or the plain VJP given the record, not "
                    f"bitwise equal to the plain VJP (max |d| {e:.3e})")
            if dtype == torch.float64:
                gaps[label], skipped[label] = shade_autograd_gap(
                    scene, x, ct, temp, freq, got_p)
    gap = max(gaps.values())
    phase("K11/K12 vs plain and autograd", t0, cases=n_cases,
          max_abs_err=err, k12_vs_autograd_max_rel_gap=f"{gap:.3e}",
          per_case={k: f"{v:.3e}" for k, v in gaps.items()},
          rays_autograd_not_finite=skipped, rtol=SHADE_GRAD_RTOL)
    require(gap <= SHADE_GRAD_RTOL, f"the plain shading VJPs differ from "
            f"autograd by {gap:.3e}")

    # K11's record is a tensor of its own call: K11 keeping it and K12
    # reading it on two streams at once, each stream with its own end
    # positions (the training batch and the same rays reversed), equal
    # the same launches run alone. (The f32 cases serve the times below.)
    t0 = time.perf_counter()
    cases = {c[0]: c for c in shade_cases(dev, torch.float32)}
    _, scene, x, _, _ = cases["train example2 200x200 float32 hard"]
    ct = shade_cotangent(x)

    def shade_pair(xs):
        rgb, rec = O.shade_cuda(scene, xs, record=True)
        return (rgb, rec, O.shade_vjp_cuda(scene, xs, ct, fields=("pos",),
                                           rec=rec)[0])

    inputs = (x, x.flip(0))
    want = [shade_pair(xs) for xs in inputs]
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    got = ([], [])
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        for j, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[j].append(shade_pair(inputs[j]))
    torch.cuda.synchronize()
    apart = all(torch.equal(a, b) for j in (0, 1) for run in got[j]
                for a, b in zip(run, want[j]))
    phase("K11/K12 records on two streams", t0, runs=6,
          records_differ=not torch.equal(want[0][1], want[1][1]),
          equal_to_alone=apart)
    require(apart, "K11/K12 on two streams differ from their launches alone")

    # Times and bounds at f32: in events (the wrapper's call), 100
    # launches in one graph and from the profiler (None where it misses
    # them). Work: the plain version's operations on one ray, times the
    # rays; bytes: x and the fields read once (a shared field once, a
    # per-ray one per ray), rgb (K11) or the cotangent, ct_x and the
    # fields' cotangents the path asks for (K12) written.
    out = {}
    for key, label, wanted in (
            ("render", "render example2 200x200 float32 hard", ()),
            ("train", "train example2 200x200 float32 hard", ("pos",)),
            ("config5", f"config 5 grouped {SHADE_STARTS} starts float32 "
             "soft", ("pos",))):
        t0 = time.perf_counter()
        _, scene, x, temp, freq = cases[label]
        ct = shade_cotangent(x)
        # The training path's K11 keeps its record (hard), the render's
        # none; K12 reads it.
        kept = key != "render" and temp is None
        srec = shade_keeping_record(scene, x, temp, freq)[1]
        k11 = lambda: O.shade_cuda(  # noqa: E731
            scene, x, temp=temp, color_freq=freq, record=kept)
        k12 = lambda: O.shade_vjp_cuda(  # noqa: E731
            scene, x, ct, temp=temp, color_freq=freq, fields=wanted, rec=srec)
        rec = dict(k11_ms=cuda_ms(k11), k12_ms=cuda_ms(k12),
                   k11_graphed_ms=graph_ms(k11), k12_graphed_ms=graph_ms(k12),
                   k11_device_ms=kernel_alone_ms(k11, "k11_kernel"),
                   k12_device_ms=kernel_alone_ms(k12, "k12_kernel"),
                   k11_plain_ms=cuda_ms(lambda: shade_plain(scene, x, temp,
                                                            freq)),
                   k12_plain_ms=cuda_ms(lambda: shade_plain_vjp(
                       scene, x, ct, temp, freq, srec)))
        with torch.no_grad():
            one = scene._replace(**{
                f: getattr(scene, f)[:1] for f in O.SHADE_FIELDS
                if getattr(scene, f).dim() > O.FIELD_DIMS.get(f, 1)})
            f11 = count_flops(lambda: shade_plain(one, x[:1], temp, freq))
            f12 = count_flops(lambda: shade_plain_vjp(
                one, x[:1], ct[:1], temp, freq,
                None if srec is None else srec[:1]))
        B, w, n = x.shape[0], x.element_size(), scene.kind.shape[0]
        fields = sum(getattr(scene, f).numel() for f in O.SHADE_FIELDS)
        outs = sum(B * n * (4 if f == "pos" else 1) for f in wanted)
        # The record: a byte a ray, written by K11 and read by K12. Given
        # it, K12 reads of the fields only the pos row of the object a ray
        # hit, where its cotangent is not zero: one row per such ray where
        # pos is per ray, each object's row once where it is shared.
        rec_bytes, k12_fields = 0, fields
        if srec is not None:
            rec_bytes = B
            live = (srec >= 0) & (ct != 0).any(-1)
            per_ray_pos = scene.pos.dim() > O.FIELD_DIMS.get("pos", 1)
            k12_fields = 4 * (int(live.sum()) if per_ray_pos else
                              int(torch.unique(srec[live]).numel()))
        rec["k11_bound"] = bound(B * f11, (B * (4 + 3) + fields) * w
                                 + (rec_bytes if kept else 0))
        rec["k12_bound"] = bound(B * f12, (B * (4 + 3 + 4) + k12_fields
                                           + outs) * w + rec_bytes)
        out[key] = rec
        phase(f"time K11/K12 {label}", t0, card=repr(card), rays=B,
              k11_ms=f"{rec['k11_ms']:.4f}",
              k11_graphed_ms=f"{rec['k11_graphed_ms']:.5f}",
              k11_device_ms=rec["k11_device_ms"],
              k11_plain_ms=f"{rec['k11_plain_ms']:.4f}",
              k12_ms=f"{rec['k12_ms']:.4f}",
              k12_graphed_ms=f"{rec['k12_graphed_ms']:.5f}",
              k12_device_ms=rec["k12_device_ms"],
              k12_plain_ms=f"{rec['k12_plain_ms']:.4f}",
              flops_per_ray_k11=f11, flops_per_ray_k12=f12,
              k11_bound_ms=f"{rec['k11_bound'][0]:.6f}",
              k11_bound_by=rec["k11_bound"][1],
              k12_bound_ms=f"{rec['k12_bound'][0]:.6f}",
              k12_bound_by=rec["k12_bound"][1])
    out["err"] = err
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.camera import pixel_rays
    from raytracegr_jl_tpu_torch.models.scenes import (build, example1_spec,
                                                       example2_spec)
    from raytracegr_jl_tpu_torch.ops import adjoint as adj
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (integrate_rays_cm,
                                                         integrate_rays_cuda,
                                                         localize_events_cm,
                                                         make_step_cm,
                                                         scene_event_cm)
    from raytracegr_jl_tpu_torch.render import initial_dt
    from raytracegr_jl_tpu_torch.utils import cuda_build

    from raytracegr_jl_tpu_torch import compaction
    from raytracegr_jl_tpu_torch.models import camera, objects
    from raytracegr_jl_tpu_torch.models.shading import shade_redshift_cuda

    counted = (integrate_rays_cuda, adj.forward_segment_cuda,
               adj.backward_cuda, compaction.chunk_cuda, shade_redshift_cuda,
               adj.localize_cuda, adj.localize_vjp_cuda, adj.work_order_cuda,
               camera.pixel_rays_cuda, camera.pixel_rays_vjp_cuda,
               adj.init_vjp_cuda, objects.shade_cuda,
               objects.shade_vjp_cuda)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. Device and build.
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else kind
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    tb = time.perf_counter()
    errors = []

    def build_one(name):
        try:
            cuda_build.build(name)
        except Exception as e:  # reported below, and the script fails
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=build_one, args=(name,))
                for name in LIBRARIES]
    for b in threads:
        b.start()
    for b in threads:
        b.join()
    require(not errors, "build failed: " + "; ".join(errors))
    build_s = time.perf_counter() - tb
    for name in LIBRARIES:
        cuda_build.load(name)
        for kern, regs, stack, st, ld in ptxas_report(
                cuda_build.build_log(name)):
            print(f"  ptxas {name}: {kern} registers={regs} "
                  f"stack={stack} spill_stores={st} spill_loads={ld}",
                  flush=True)
    phase("device+build", t0, card=repr(card), build_s=f"{build_s:.1f}")

    bench_cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=RTOL_F32, atol=RTOL_F32, max_steps=20_000))

    def rays(spec, dtype):
        metric, scene, canvas = build(spec, dtype, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        return metric, scene, y0

    def compare(label, spec, dtype, integ):
        """K1 against its plain version on the same (y0, dt0) on the card,
        and K1 taking each ray's initial step in its prologue
        (``dt0=None``) against the same plain run on the plain
        ``initial_dt``. Both round operation by operation alike (the kernel
        is built with --fmad=false), so hit, steps, y and lam must agree
        bitwise on every ray; the pixel bar is a second check. Returns max
        |dy|, |dlam|."""
        t0 = time.perf_counter()
        metric, scene, y0 = rays(spec, dtype)
        dt0 = initial_dt(metric, y0, integ)
        ker = integrate_rays_cuda(metric, scene, y0, dt0, integ)
        own = integrate_rays_cuda(metric, scene, y0, None, integ)
        torch.cuda.synchronize()
        plain = integrate_rays_cm(metric, scene, y0, dt0, integ)
        bad_own, err_own = mismatch(own, plain)
        hit_eq = (ker.hit == plain.hit)
        st_eq = (ker.steps == plain.steps)
        max_dy = float((ker.y - plain.y).abs().max())
        max_dlam = float((ker.lam - plain.lam).abs().max())
        rgb_k = rt.shade(scene, ker.y[:, :4]).reshape(spec.ni, spec.nj, 3)
        rgb_p = rt.shade(scene, plain.y[:, :4]).reshape(spec.ni, spec.nj, 3)
        within = frac_within_2lsb(rgb_k, rgb_p)
        phase(f"kernel-vs-plain {label}", t0,
              hit_agree=f"{float(hit_eq.double().mean()):.6f}",
              step_agree=f"{float(st_eq.double().mean()):.6f}",
              max_abs_dy=f"{max_dy:.3e}", max_abs_dlam=f"{max_dlam:.3e}",
              pixels_within_2lsb=f"{within:.6f}",
              hits=int(plain.hit.sum()),
              mean_steps=f"{float(plain.steps.double().mean()):.2f}",
              plain_iters=plain.n_iters, own_step_rays_differ=bad_own,
              own_step_max_abs_d=f"{err_own:.3e}")
        require(bool(hit_eq.all()), f"{label}: hit differs on "
                f"{int((~hit_eq).sum())} rays")
        require(bool(st_eq.all()), f"{label}: steps differ on "
                f"{int((~st_eq).sum())} rays")
        require(torch.equal(ker.y, plain.y) and torch.equal(ker.lam, plain.lam),
                f"{label}: y or lam not bitwise equal (max |dy| {max_dy:.3e}, "
                f"max |dlam| {max_dlam:.3e})")
        require(within >= MIN_PIXELS_WITHIN_2LSB,
                f"{label}: only {within:.4%} of pixels within 2 LSB")
        require(bad_own == 0, f"{label}: K1 with its own initial step "
                f"differs on {bad_own} rays (max |d| {err_own:.3e})")
        return max(max_dy, max_dlam, err_own)

    # 2. Kernel against plain version on the card. The disk scene is the
    #    only one that sends a disk object through K1; max_steps 400 bounds
    #    its horizon rays, which would run to any cap.
    compare("example2 64x64 f32", example2_spec(64, 64), torch.float32,
            bench_cfg.integrator)
    compare("example1 64x64 f64 rk4", example1_spec(64, 64), torch.float64,
            rt.IntegratorConfig(method="rk4", rtol=1e-12, atol=1e-12))
    compare("example2 32x32 f64", example2_spec(32, 32), torch.float64,
            rt.IntegratorConfig(method="tsit5", rtol=rt.default_tol(
                torch.float64), atol=rt.default_tol(torch.float64),
                max_steps=20_000))
    disk_cfg = rt.IntegratorConfig(method="tsit5", rtol=RTOL_F32,
                                   atol=RTOL_F32, max_steps=400, stop_rho=1.0)
    compare("accretion disk 64x64 f32", rt.accretion_disk_spec(64, 64),
            torch.float32, disk_cfg)
    compare("accretion disk 32x32 f64", rt.accretion_disk_spec(32, 32),
            torch.float64, disk_cfg._replace(rtol=1e-8, atol=1e-8))

    # 3. Goldens through the "cuda" backend.
    golden_cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=1e-10, atol=1e-10, max_steps=4000),
        backend="cuda")
    tol64 = rt.default_tol(torch.float64)
    ref_cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=tol64, atol=tol64, max_steps=20_000),
        backend="cuda")
    for name, spec, cfg in [
            ("golden64_e1", example1_spec(64, 64), golden_cfg),
            ("golden64_e2", example2_spec(64, 64), golden_cfg),
            ("sphere2", example2_spec(200, 200), ref_cfg),
            ("sphere", example1_spec(200, 200), ref_cfg)]:
        compare(f"{name} f64", spec, torch.float64, cfg.integrator)
        t0 = time.perf_counter()
        canvas = rt.render_spec(spec, torch.float64, cfg, device=dev)
        img = rt.canvas_to_image(canvas.rgb).astype(np.int32)
        gold = np.round(rt.load_png(f"scenes/{name}.png") * 255).astype(
            np.int32)
        require(img.shape == gold.shape, f"{name}: shape {img.shape}")
        n_bad = int((np.abs(img - gold).max(-1) > 2).sum())
        phase(f"golden {name}", t0, differing_pixels=n_bad,
              of=img.shape[0] * img.shape[1])
        require(n_bad <= 0.005 * img.shape[0] * img.shape[1],
                f"{name}: {n_bad} pixels differ by more than 2 LSB")

    # 4. The main path once, counted: example2 at the reference's 200x200,
    #    the bench configuration, through render_fn on CUDA tensors.
    t0 = time.perf_counter()
    metric, scene, canvas = build(example2_spec(200, 200), torch.float32, dev)
    fn = rt.render_fn(metric, scene, bench_cfg)
    fn(canvas.pos, canvas.normal)  # builds the launch setup once
    torch.cuda.synchronize()
    reset_counts()
    with counted_calls(rt.render, "initial_dt") as eager_init, \
            kept_calls(objects, "shade_cuda") as k11_calls, \
            sync_count() as syncs:
        rgb = fn(canvas.pos, canvas.normal)
        launches = integrate_rays_cuda.launches
        k11_render = objects.shade_cuda.launches
    torch.cuda.synchronize()
    require(records_kept(k11_calls) == [False], "the render's K11 kept "
            "a record")
    require(launches == 1, f"the main path launched K1 {launches} times")
    require(k11_render == 1, f"the main path launched K11 {k11_render} "
            "times")
    require(not eager_init, "the main path ran the eager initial step")
    require(syncs["n"] == 0, f"the main path synced the host {syncs['n']} "
            "times")
    require(tuple(rgb.shape) == (200, 200, 3)
            and bool(torch.isfinite(rgb).all()), "bad main-path output")
    plain_fn = rt.render_fn(metric, scene,
                            bench_cfg._replace(backend="torch"))
    rgb_plain = plain_fn(canvas.pos, canvas.normal)
    within = frac_within_2lsb(rgb, rgb_plain)
    phase("main path example2 200x200 f32", t0, k1_launches=launches,
          k11_launches=k11_render, eager_initial_steps=len(eager_init), host_syncs=syncs["n"],
          pixels_within_2lsb_of_plain=f"{within:.6f}")
    require(within >= MIN_PIXELS_WITHIN_2LSB, "main path disagrees with plain")
    main_err = max(
        compare("example2 200x200 f32 (the main path's shape)",
                example2_spec(200, 200), torch.float32, bench_cfg.integrator),
        compare("example2 1024x1024 f32", example2_spec(1024, 1024),
                torch.float32, bench_cfg.integrator))

    # 5. Times (bench configuration: f32, tsit5, eps^(3/4), 20000 steps).
    timings = {}
    for n in (200, 1024):
        t0 = time.perf_counter()
        metric, scene, canvas = build(example2_spec(n, n), torch.float32, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        dt0 = initial_dt(metric, y0, bench_cfg.integrator)
        fn = rt.render_fn(metric, scene, bench_cfg)
        main_ms = cuda_ms(k1_main_call(metric, scene, y0, dt0,
                                       bench_cfg.integrator))
        k_ms = cuda_ms(lambda: integrate_rays_cuda(
            metric, scene, y0, dt0, bench_cfg.integrator))
        r_ms = cuda_ms(lambda: fn(canvas.pos, canvas.normal))
        i_ms = cuda_ms(lambda: initial_dt(metric, y0, bench_cfg.integrator))
        timings[n] = (main_ms, r_ms)
        phase(f"time {n}x{n} f32", t0, card=repr(card),
              k1_main_path_ms=f"{main_ms:.4f}",
              k1_rays_per_s=f"{n * n / main_ms * 1e3:.1f}",
              k1_given_dt0_setup_per_call_ms=f"{k_ms:.4f}",
              eager_initial_dt_ms=f"{i_ms:.4f}", render_ms=f"{r_ms:.4f}",
              render_rays_per_s=f"{n * n / r_ms * 1e3:.1f}")
    t0 = time.perf_counter()
    metric, scene, canvas = build(example2_spec(200, 200), torch.float32, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, bench_cfg.integrator)
    plain_ms = cuda_ms(lambda: integrate_rays_cm(
        metric, scene, y0, dt0, bench_cfg.integrator))
    phase("time 200x200 f32 plain", t0, card=repr(card),
          plain_ms=f"{plain_ms:.4f}",
          plain_rays_per_s=f"{200 * 200 / plain_ms * 1e3:.1f}")

    t0 = time.perf_counter()
    # K1's bound: its accepted and rejected steps on this run's rays, each
    # at the operation count of the plain step body on one ray, plus one
    # localization per hit; bytes: y0 and dt0 in, y, lam, hit, steps out.
    integ = bench_cfg.integrator
    event_fn = scene_event_cm(scene)
    init, body = make_step_cm(metric, event_fn, integ)
    with torch.no_grad():
        st = init(y0.t().contiguous(), dt0)
        one = lambda t: t[..., :1]  # noqa: E731
        k1_step_flops = count_flops(lambda: body(type(st)(*map(one, st))))
        k1_iters, it = 0, 0
        while it < integ.max_steps and bool(st.active.any()):
            k1_iters += int(st.active.sum())
            st, _ = body(st)
            it += 1
        hits = int(st.hit.sum())
        k1_loc_flops = count_flops(lambda: localize_events_cm(
            metric, event_fn, integ, one(st.ev_y0), one(st.ev_dt),
            one(st.ev_lo), one(st.ev_hi)))
    B = y0.shape[0]
    k1_bound = bound(k1_iters * k1_step_flops + hits * k1_loc_flops,
                     B * 9 * 4 + B * 11 * 4)
    phase("K1 bound 200x200 f32", t0, ray_iterations=k1_iters, hits=hits,
          flops_per_step=k1_step_flops, flops_per_localization=k1_loc_flops,
          bound_ms=f"{k1_bound[0]:.6f}", bound_by=k1_bound[1])

    # 5b. K1's diagnosis at 200x200 and 1024x1024 (diagnose_k1): its time
    #     four ways, the step census and bound, scheduler cycles per
    #     warp-iteration, the capped runs; torch.mean's order; one rk4/200
    #     forward pass of the training path under the profiler.
    t0 = time.perf_counter()
    for rec in diagnose_k1(dev, card):
        phase(f"diagnose K1 {rec.pop('kind')}", t0, **rec)

    # 6. K3 and K4 against their plain versions on the same inputs, and
    #    K4's (M, a) gradients against torch.autograd of the plain body.
    def train_cfg(dtype, method, max_steps):
        """The bench's training configurations (rk4/200, tsit5/48)."""
        return rt.default_inverse_cfg(dtype, max_steps=max_steps,
                                      method=method,
                                      rk4_dt=100.0 / max_steps, stop_rho=0.5)

    def ckpt_setup(n, dtype, integ, M=1.05, a=0.0, grad=False):
        """example2 n x n: (metric, scene, y0 [B, 8], dt0, route, the
        launch states [8, B])."""
        Mt = torch.tensor(M, dtype=dtype, device=dev, requires_grad=grad)
        at = torch.tensor(a, dtype=dtype, device=dev, requires_grad=grad)
        metric = rt.make_metric("kerr_schild", rt.KerrSchildParams(Mt, at),
                                rho_min=max(1e-3, 0.5 * integ.stop_rho))
        _, scene, canvas = build(example2_spec(n, n), dtype, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        with torch.no_grad():
            dt0 = initial_dt(metric, y0, integ)
        seg = adj.segment_length(integ, integ.grad_seg_len)
        route = adj.Route(
            metric=rt.make_metric("kerr_schild", rt.KerrSchildParams(
                Mt.detach(), at.detach()), rho_min=metric.rho_min),
            scene=scene, cfg=integ, seg_len=seg,
            n_seg=integ.max_steps // seg, cuda=True)
        return metric, scene, y0, dt0, route, y0.t().contiguous()

    def diff_ct(ys, seed=0):
        """A random cotangent of the packed state of the rays at ``ys``
        on the planes that carry one."""
        ct = state_ct(ys, seed)
        keep = torch.zeros((adj.N_PLANES, 1), dtype=ys.dtype, device=dev)
        for lo in (adj.P_Y, adj.P_K1, adj.P_EV_Y0):
            keep[lo:lo + 8] = 1
        return ct * keep

    def compare_adjoint(label, n, dtype, method, max_steps):
        t0 = time.perf_counter()
        integ = train_cfg(dtype, method, max_steps).integrator
        metric, scene, y0, dt0, route, ys = ckpt_setup(n, dtype, integ)
        k3_err, ck_k, used_k, ck_p, used_p = require_k3_equal(label, route,
                                                              ys)
        n_k = int(used_k[0])
        # K3 given the first steps (the caller's dt0, initial_dt's) and
        # taking its own: the same checkpoints.
        ck_d, used_d = adj.run_segments(route, ys, dt0)
        mask = adj.read_mask(used_k[1:], route.n_seg)
        require(torch.equal(used_d, used_k)
                and bits_equal(ck_d[mask], ck_k[mask]),
                f"{label}: K3 given dt0 differs from K3 taking its own")
        # A span of one step: every ray stops in segment 0, n_used is 1.
        short = route._replace(cfg=integ._replace(lam_max=1e-3))
        err_stop, ck_s, used_s, ck_sp, used_sp = require_k3_equal(
            f"{label} one-step span", short, ys)
        n_stop = int(used_s[0])
        require(n_stop == 1, f"{label}: the one-step span ran {n_stop} "
                "segments")
        k3_err = max(k3_err, err_stop)
        with sync_count() as syncs:
            adj.run_segments(route, ys)
        require(syncs["n"] == 0, f"{label}: the forward pass synced the host "
                f"{syncs['n']} times")
        ct = diff_ct(ys)
        k4_err = 0.0
        for what, rt_, cks in (
                ("", route, (ck_k, used_k, ck_p, used_p)),
                (" one-step span", short, (ck_s, used_s, ck_sp, used_sp))):
            ck_a, used_a, ck_b, used_b = cks
            c_k, p_k = adj.backward_cuda(rt_, ck_a, used_a[1:], ct)
            c_p, p_p = adj.k4_plain(rt_, ck_b, used_b[1:], ct)
            torch.cuda.synchronize()
            k4_err = max(k4_err, float((c_k - c_p).abs().max()),
                         float((p_k - p_p).abs().max()))
            require(torch.equal(c_k, c_p) and torch.equal(p_k, p_p),
                    f"{label}{what}: K4 not bitwise equal (max |d| "
                    f"{k4_err:.3e})")
        init_gap = (init_autograd_gap(route, ys)
                    if dtype == torch.float64 else None)
        require(init_gap is None or init_gap <= INIT_GRAD_RTOL,
                f"{label}: the initial state's VJP differs from autograd "
                f"by {init_gap}")

        def grads(fn):
            metric, scene, y0, _, _, _ = ckpt_setup(n, dtype, integ,
                                                    grad=True)
            res = fn(metric, scene, y0, None, integ,
                     seg_len=integ.grad_seg_len)
            loss = (res.y[:, :4] ** 2).sum() * 1e-3
            M, a = metric.params.M, metric.params.a
            return [float(g) for g in torch.autograd.grad(loss, (M, a))]

        launches = (adj.forward_segment_cuda.launches,
                    adj.backward_cuda.launches)
        g_k = grads(adj.integrate_rays_ckpt_cuda)
        require(adj.forward_segment_cuda.launches > launches[0]
                and adj.backward_cuda.launches > launches[1],
                f"{label}: the kernel path did not launch K3 and K4")
        g_o = grads(adj.integrate_rays_autograd)
        rel = max(abs(k - o) / abs(o) for k, o in zip(g_k, g_o))
        phase(f"K3/K4 vs plain {label}", t0, segments=n_k,
              forward_host_syncs=syncs["n"],
              hits=int(ck_k[route.n_seg, adj.P_HIT].sum()),
              k3_max_abs_err=k3_err, k4_max_abs_err=k4_err,
              init_vjp_vs_autograd_max_rel_gap=(
                  "not run (f32)" if init_gap is None else f"{init_gap:.3e}"),
              grad_M_kernel=f"{g_k[0]:.9e}", grad_M_autograd=f"{g_o[0]:.9e}",
              grad_a_kernel=f"{g_k[1]:.9e}", grad_a_autograd=f"{g_o[1]:.9e}",
              grad_max_rel_err=f"{rel:.3e}", rtol=GRAD_RTOL[dtype])
        require(all(np.isfinite(g_k)) and rel <= GRAD_RTOL[dtype],
                f"{label}: K4 gradients {g_k} vs autograd {g_o}")
        return max(k3_err, k4_err)

    adj_err = 0.0
    for n, dtype in ((64, torch.float32), (32, torch.float64)):
        for method, steps in (("rk4", 200), ("tsit5", 48)):
            adj_err = max(adj_err, compare_adjoint(
                f"example2 {n}x{n} {str(dtype)[6:]} {method}/{steps}", n,
                dtype, method, steps))

    # 6a. K4 and its work order, bitwise to the plain
    #     version, on ragged, one-end and every-end batches (f32, f64) and
    #     grouped config 5 at 1, 4 and 16 starts.
    adj_err = max(adj_err, k4_order_slice(dev, card))

    # 6b. K6 and K7 against their plain versions and K7 against autograd;
    #     their times and bounds.
    loc = localize_slice(dev, card)

    # 6c. K8 and K9 (the camera) against their plain versions and K9
    #     against autograd; their times and bounds.
    cam = camera_slice(dev, card)

    # 6d. K11 and K12 (the shading) against their plain versions and the
    #     plain VJPs against autograd; their times and bounds.
    shd = shade_slice(dev, card)

    # 7. The training main path, counted: one pixel-loss step (loss and
    #    backward) of make_ray_loss_fn at 200x200 f32 for each bench
    #    configuration, then three Adam steps of inverse.fit; each against
    #    the same on the plain path (backend "torch" on the card).
    spec = example2_spec(200, 200)
    f32 = torch.float32
    truth = rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    xg, ng = rt.flat_pixel_grid(spec, f32, dev)

    def plain_cfg(cfg):
        return cfg._replace(backend="torch")

    loss_fns = {}

    def loss_and_grads(cfg, target):
        """One training step's loss and (M, a, sphere_pos) gradients; the
        loss function is built once per configuration, as a trainer would."""
        if cfg not in loss_fns:
            loss_fns[cfg] = rt.make_ray_loss_fn(spec, cfg, 2, f32, dev)
        p = rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
        loss = loss_fns[cfg](p, xg, ng, target)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), torch.cat(
            [p.M.grad[None], p.a.grad[None], p.sphere_pos.grad])

    step_launches, plain_step_ms = {}, {}
    main_cfgs = {"rk4/200": train_cfg(f32, "rk4", 200),
                 "tsit5/48": train_cfg(f32, "tsit5", 48)}
    targets = {}
    for label, cfg in main_cfgs.items():
        t0 = time.perf_counter()
        with torch.no_grad():
            targets[label] = rt.make_ray_render_for_params(
                spec, cfg, 2, f32, dev)(truth, xg, ng)
        reset_counts()
        # The initial state runs in K3's prologue and its VJP in K4's
        # epilogue: neither the eager init nor the eager first step.
        with counted_calls(adj, "init_plain") as eager_start, \
                counted_calls(adj, "make_step_cm") as eager_body, \
                counted_calls(adj, "initial_dt") as eager_dt, \
                counted_calls(rt.render, "initial_dt") as render_dt, \
                kept_calls(objects, "shade_cuda") as k11_calls:
            loss, g = loss_and_grads(cfg, targets[label])
        eager = eager_start + eager_body + eager_dt + render_dt
        # K11 keeps its record for K12.
        require(records_kept(k11_calls) == [True], f"{label}: K11 kept "
                f"records {records_kept(k11_calls)}")
        counts = [fn.launches for fn in counted]
        step_launches[label] = counts
        out = {}
        plain_step_ms[label] = events_ms(lambda: out.update(
            r=loss_and_grads(plain_cfg(cfg), targets[label])))
        loss_p, g_p = out["r"]
        rel = float((g - g_p).abs().max() / g_p.abs().max())
        phase(f"main path train step {label} 200x200 f32", t0,
              k1_launches=counts[0], k3_launches=counts[1],
              k4_launches=counts[2], k6_launches=counts[5],
              k7_launches=counts[6], k4_order_launches=counts[7],
              k8_launches=counts[8], k9_launches=counts[9],
              k10_launches=counts[10], k11_launches=counts[11],
              k12_launches=counts[12],
              eager_initial_state_calls=len(eager),
              loss=f"{loss:.9e}",
              loss_plain=f"{loss_p:.9e}",
              grads=[f"{v:.6e}" for v in g.tolist()],
              grad_max_rel_diff_vs_plain=f"{rel:.3e}")
        require(all(counts[i] == 1 for i in (1, 2, 5, 6, 7, 8, 9, 10, 11,
                                             12)),
                f"{label}: the training step launched K3 {counts[1]}, K4 "
                f"{counts[2]}, K6 {counts[5]}, K7 {counts[6]}, K4's work "
                f"order {counts[7]}, K8 {counts[8]}, K9 {counts[9]}, K10 "
                f"{counts[10]}, K11 {counts[11]} and K12 {counts[12]} "
                "times, not once each")
        require(not eager, f"{label}: the training step ran the eager "
                f"initial state ({eager})")
        require(np.isfinite(loss) and bool(torch.isfinite(g).all()),
                f"{label}: non-finite loss or gradients")
        require(rel <= MAIN_GRAD_RTOL and abs(loss - loss_p)
                <= MAIN_GRAD_RTOL * abs(loss_p),
                f"{label}: kernel gradients differ from the plain path's")

    t0 = time.perf_counter()
    fit_cfg = rt.default_inverse_cfg(f32, soft_temp=0.05, stop_rho=0.5)
    with torch.no_grad():
        target_img = rt.make_render_for_params(spec, fit_cfg, 2, f32, dev)(
            truth)
    init = rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32, dev)
    reset_counts()
    res = rt.fit(spec, target_img, init, fit_cfg, steps=3, dtype=f32,
                 device=dev, graph=False)
    torch.cuda.synchronize()
    fit_counts = [fn.launches for fn in counted]
    res_p = rt.fit(spec, target_img, init, plain_cfg(fit_cfg), steps=3,
                   dtype=f32, device=dev)
    fin = [float(getattr(res.final_params, k).detach().abs().max())
           for k in ("M", "a", "sphere_pos")]
    fit_diff = max(float((getattr(res.final_params, k)
                          - getattr(res_p.final_params, k)).detach()
                         .abs().max()) for k in ("M", "a", "sphere_pos"))
    phase("main path fit 3 Adam steps 200x200 f32", t0,
          k3_launches=fit_counts[1], k4_launches=fit_counts[2],
          k6_launches=fit_counts[5], k7_launches=fit_counts[6],
          k8_launches=fit_counts[8], k9_launches=fit_counts[9],
          k10_launches=fit_counts[10], k11_launches=fit_counts[11],
          k12_launches=fit_counts[12],
          losses=[f"{v:.6e}" for v in res.loss_history.tolist()],
          M=f"{float(res.final_params.M.detach()):.9f}",
          max_param_diff_vs_plain=f"{fit_diff:.3e}")
    require(all(fit_counts[i] == 3 for i in (1, 2, 5, 6, 8, 9, 10, 11, 12)),
            "fit did not launch K3, K4, K6, K7, K8, K9, K10, K11 and K12 "
            "once in each step")
    require(bool(torch.isfinite(res.loss_history).all())
            and all(np.isfinite(fin)), "fit: non-finite loss or parameters")
    require(fit_diff <= MAIN_GRAD_RTOL * max(fin),
            "fit: kernel path differs from the plain path")

    # 8. Times of the training path at 200x200 f32, the bounds of K3 and
    #    K4 from this run's work, and K4 on this batch bitwise to the plain
    #    version.
    train_times = {}
    for label, cfg in main_cfgs.items():
        t0 = time.perf_counter()
        step_ms = cuda_ms(lambda: loss_and_grads(cfg, targets[label]))
        integ = cfg.integrator
        metric, scene, _, _, route, _ = ckpt_setup(200, f32, integ)
        with torch.no_grad():
            x, u = pixel_rays(metric, xg, ng)
            y0 = torch.cat([x, u], -1)
        ys = y0.t().contiguous()
        args = adj.launch_args(route, ys)

        k3_runs = [k3_forward_ms(route, ys, args)
                   for _ in range(REPEATS + 1)][1:]
        k3_ms = statistics.median(r[0] for r in k3_runs)
        _, ck, used = k3_runs[0]
        n_used = int(used[0])
        k3_device_ms = sum(b - a for _, a, b in profiled_kernels(
            lambda: adj.run_segments(route, ys),
            ("k3_kernel", "k3_close"))) / 1e3 / REPEATS
        ct = diff_ct(ys)
        k4_ms = statistics.median(
            events_ms(lambda: adj.backward_cuda(route, ck, used[1:], ct,
                                                args))
            for _ in range(REPEATS))
        # K4's work order: the counting sort's kernels against the stable
        # sort (the plain version, and the one PyTorch call that computes
        # the same order); bound: the ends read and the order written.
        ends = used[1:]
        order = adj.work_order_cuda(ends, route.n_seg)
        require(torch.equal(order, adj.work_order(ends)),
                f"{label}: K4's work order differs from the stable sort")
        order_ms = cuda_ms(lambda: adj.work_order_cuda(ends, route.n_seg))
        order_sort_ms = cuda_ms(lambda: adj.work_order(ends))
        order_bound = bound(0, ends.numel() * (4 + 8))
        (ck_p, used_p), k3_plain_ms = events_call(
            lambda: adj.run_segments(route._replace(cuda=False), ys))
        mask = adj.read_mask(used_p[1:], route.n_seg)
        require(torch.equal(used, used_p) and torch.equal(
            ck[mask].view(torch.int32), ck_p[mask].view(torch.int32)),
            f"{label}: K3 at 200x200 differs from the plain chain")
        # K4 as the training step launches it (its work order, then K4 in
        # that order) against the plain version on this batch, bitwise.
        want, k4_plain_ms = events_call(lambda: adj.k4_plain(
            route._replace(cuda=False), ck, used[1:], ct))
        before = adj.work_order_cuda.launches
        c4, p4 = adj.backward_cuda(route, ck, used[1:], ct, args)
        work_order_cuda_launches = adj.work_order_cuda.launches - before
        torch.cuda.synchronize()
        k4_err = max(max_err(c4, want[0]), max_err(p4, want[1]))
        require(work_order_cuda_launches == 1 and bits_equal(c4, want[0])
                and bits_equal(p4, want[1]),
                f"{label}: K4 at 200x200 not bitwise equal to the plain "
                f"version (max |d| {k4_err:.3e}; work order launched "
                f"{work_order_cuda_launches} times)")
        # K10 alone on this batch (the cotangent of the initial state as
        # it comes from K4: here ct's planes) against its plain version.
        pb = torch.randn((ys.shape[1], 2), generator=torch.Generator(
            device=dev).manual_seed(1), dtype=f32, device=dev)
        want10, k10_plain_ms = events_call(lambda: adj.init_vjp(
            route._replace(cuda=False), ys, ct, pb))
        got10 = adj.init_vjp_cuda(route, ck, ct, pb.clone(), args)
        torch.cuda.synchronize()
        k10_err = max(max_err(got10[0], want10[0]),
                      max_err(got10[1], want10[1]))
        require(bits_equal(got10[0], want10[0])
                and bits_equal(got10[1], want10[1]),
                f"{label}: K10 at 200x200 not bitwise equal to init_vjp "
                f"(max |d| {k10_err:.3e})")
        pt = pb.clone()  # K10 adds into it in place
        k10_ms = statistics.median(
            events_ms(lambda: adj.init_vjp_cuda(route, ck, ct, pt, args))
            for _ in range(REPEATS))
        work = adjoint_work(route, ys, ct, n_used)
        k3_bound, k4_bound = work["k3_bound"], work["k4_bound"]
        k10_bound = work["k10_bound"]
        iters, accepted = work["iters"], work["accepted"]
        step_flops, vjp_flops = work["step_flops"], work["vjp_flops"]
        B = y0.shape[0]
        train_times[label] = dict(
            step_ms=step_ms, k3_ms=k3_ms,
            k4_ms=k4_ms, k3_plain_ms=k3_plain_ms, k4_plain_ms=k4_plain_ms,
            k3_bound=k3_bound, k4_bound=k4_bound, order_ms=order_ms,
            order_sort_ms=order_sort_ms, order_bound=order_bound,
            k10_ms=k10_ms, k10_plain_ms=k10_plain_ms, k10_bound=k10_bound,
            k10_err=k10_err)
        phase(f"time train step {label} 200x200 f32", t0, card=repr(card),
              step_ms=f"{step_ms:.4f}",
              fwd_bwd_rays_per_s=f"{B / step_ms * 1e3:.1f}",
              plain_step_ms=f"{plain_step_ms[label]:.4f}",
              k3_ms_all_segments=f"{k3_ms:.4f}",
              k3_device_ms_per_pass=f"{k3_device_ms:.4f}",
              k4_ms=f"{k4_ms:.4f}", k4_max_abs_err_vs_plain=k4_err,
              k4_order_ms=f"{order_ms:.4f}",
              k4_order_sort_ms=f"{order_sort_ms:.4f}",
              k4_order_bound_ms=f"{order_bound[0]:.6f}",
              k3_plain_ms=f"{k3_plain_ms:.4f}",
              k4_plain_ms=f"{k4_plain_ms:.4f}", segments=n_used,
              k3_launches_per_step=step_launches[label][1],
              k4_launches_per_step=step_launches[label][2],
              ray_iterations=iters, accepted=accepted,
              flops_per_step=step_flops, flops_per_step_vjp=vjp_flops,
              k3_bound_ms=f"{k3_bound[0]:.6f}", k3_bound_by=k3_bound[1],
              k4_bound_ms=f"{k4_bound[0]:.6f}", k4_bound_by=k4_bound[1],
              k10_ms=f"{k10_ms:.4f}", k10_plain_ms=f"{k10_plain_ms:.4f}",
              k10_max_abs_err_vs_plain=k10_err,
              flops_per_ray_init=work["init_flops"],
              flops_per_ray_init_vjp=work["init_vjp_flops"],
              k10_bound_ms=f"{k10_bound[0]:.6f}", k10_bound_by=k10_bound[1])

    # 9. Where a training step's time goes: torch.profiler over three
    #    rk4/200 steps; the device's busy time is the sum of its kernels.
    #    The profiler slows the host's thousands of small launches many
    #    times over, so the idle share is read against the unprofiled
    #    step time of phase 8.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    cfg, target = main_cfgs["rk4/200"], targets["rk4/200"]
    loss_and_grads(cfg, target)
    tw = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(3):
            loss_and_grads(cfg, target)
    wall_ms = (time.perf_counter() - tw) * 1e3 / 3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    n_kernels = sum(e.count for e in kernels) / 3
    host_launches = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CPU
                        and e.key in LAUNCH_CALLS) / 3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    step_ms = train_times["rk4/200"]["step_ms"]
    phase("profile train step rk4/200 200x200 f32", t0, card=repr(card),
          profiled_wall_ms_per_step=f"{wall_ms:.3f}",
          step_ms=f"{step_ms:.4f}",
          device_busy_ms_per_step=f"{busy_ms:.3f}",
          device_idle_share=f"{max(0.0, 1 - busy_ms / step_ms):.4f}",
          device_kernels_per_step=f"{n_kernels:.0f}",
          host_launches_per_step=f"{host_launches:.0f}",
          top=[f"{e.key[:40]}:{e.self_device_time_total / 3e3:.3f}ms"
               f"x{e.count // 3}" for e in top])
    require(busy_ms > 0, "the profiler saw no device time")

    # 9a. The training step as one CUDA graph against the eager step, and
    #     fit's default configuration graphed against eager.
    graph_train_slice(dev, card, main_cfgs, targets, spec, xg, ng,
                      target_img)

    # 9b. The inversion slice (config 5; grouped K3 and K4).
    inverse_entries = inverse_slice(dev, card, reset_counts)

    # 10-15. The accretion-disk slice (K2, K5).
    disk_entries = disk_slice(dev, card, reset_counts)

    # 17-21. The options ported last: refine_minima, sort_rays on the
    #        differentiable path, grad_mode="scan".
    options_slice(dev, card, reset_counts)

    # 22-23. Data parallelism: NCCL at world size 1, two gloo ranks on one
    #        card. 24. The row-major route.
    sharding_slice(dev, card, reset_counts)
    rowmajor_slice(dev, card)

    # 25. The Dual oracle against K3 and K4's gradients (and the row-major
    #     route's): a differentiation that shares no code with the port.
    dual_oracle_slice(dev, card, reset_counts)

    # 16. K2 on the disk's packed tail: the SASS instruction mix of K2's and
    #     K4's f32 Kerr-Schild Tsit5 kernels, the tail's state replicated
    #     1x, 2x, 4x and cut to a half and a quarter, and each block size
    #     (bitwise equal to 128 threads), at a fixed budget of iterations.
    t0 = time.perf_counter()
    for lib, kern, counts in sass_report():
        print(f"  sass {lib}: {kern} {json.dumps(counts)}", flush=True)
    diag = diagnose_tail(dev)
    tail = {r["copies"]: r["ms"] for r in diag if r["kind"] == "tail"}
    blocks = {r["threads"]: r["ms"] for r in diag
              if r["kind"] == "tail_block"}
    phase("diagnose K2 packed tail", t0, card=repr(card),
          rays=diag[2]["rays"], active=diag[2]["active"], budget=TAIL_BUDGET,
          ms_by_copies={k: f"{v:.4f}" for k, v in tail.items()},
          ms_1x_by_block={k: f"{v:.4f}" for k, v in blocks.items()},
          ratio_2x=f"{tail['2x'] / tail['1x']:.3f}",
          ratio_half=f"{tail['half'] / tail['1x']:.3f}")

    main = train_times["rk4/200"]
    print(json.dumps({"kernels": [{
        "name": "K1 integrate_rays_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/geodesic.cu",
        "replaces": "raytracegr_jl_tpu/ops/pallas_geodesic.py:1231",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": timings[200][0],
        "plain_ms": plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None}, {
        "name": "K3 forward_segment_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/adjoint.cu",
        "replaces": "raytracegr_jl_tpu/ops/pallas_adjoint.py:131",
        "launches": step_launches["rk4/200"][1],
        "max_abs_err": adj_err,
        "ms": main["k3_ms"],
        "plain_ms": main["k3_plain_ms"],
        "bound_ms": main["k3_bound"][0],
        "bound_by": main["k3_bound"][1],
        "library_ms": None}, {
        "name": "K4 backward_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/adjoint.cu",
        "replaces": "raytracegr_jl_tpu/ops/pallas_adjoint.py:203",
        "launches": step_launches["rk4/200"][2],
        "max_abs_err": adj_err,
        "ms": main["k4_ms"],
        "plain_ms": main["k4_plain_ms"],
        "bound_ms": main["k4_bound"][0],
        "bound_by": main["k4_bound"][1],
        "library_ms": None}, {
        "name": "K4 work order work_order_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/adjoint.cu",
        "replaces": "none: port-only, the order K4 walks its rays in "
                    "(raytracegr_jl_tpu/ops/pallas_adjoint.py:203 walks "
                    "them in pixel order)",
        "launches": step_launches["rk4/200"][7],
        "max_abs_err": 0.0,
        "ms": main["order_ms"],
        "plain_ms": main["order_sort_ms"],
        "bound_ms": main["order_bound"][0],
        "bound_by": main["order_bound"][1],
        "library_ms": main["order_sort_ms"]}, {
        "name": "K10 init_vjp_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/adjoint.cu",
        "replaces": "none: XLA's AD of the jitted step's initial state "
                    "(make_step_cm's init, k1 = rhs(y0)), fused around the "
                    "pallas_calls (raytracegr_jl_tpu/ops/"
                    "pallas_adjoint.py:351)",
        "launches": step_launches["rk4/200"][10],
        "max_abs_err": max(adj_err, main["k10_err"]),
        "ms": main["k10_ms"],
        "plain_ms": main["k10_plain_ms"],
        "bound_ms": main["k10_bound"][0],
        "bound_by": main["k10_bound"][1],
        "library_ms": None}, {
        "name": "K6 localize_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/localize.cu",
        "replaces": "none: XLA's fusion of localize_events_cm after K3 "
                    "(raytracegr_jl_tpu/ops/pallas_adjoint.py:380)",
        "launches": step_launches["rk4/200"][5],
        "max_abs_err": loc["err"],
        "ms": loc["rk4/200"]["k6_ms"],
        "plain_ms": loc["rk4/200"]["k6_plain_ms"],
        "bound_ms": loc["rk4/200"]["k6_bound"][0],
        "bound_by": loc["rk4/200"]["k6_bound"][1],
        "library_ms": None}, {
        "name": "K7 localize_vjp_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/localize.cu",
        "replaces": "none: XLA's AD of localize_events_cm after K3 "
                    "(raytracegr_jl_tpu/ops/pallas_adjoint.py:380)",
        "launches": step_launches["rk4/200"][6],
        "max_abs_err": loc["err"],
        "ms": loc["rk4/200"]["k7_ms"],
        "plain_ms": loc["rk4/200"]["k7_plain_ms"],
        "bound_ms": loc["rk4/200"]["k7_bound"][0],
        "bound_by": loc["rk4/200"]["k7_bound"][1],
        "library_ms": None}, {
        "name": "K8 pixel_rays_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/camera.cu",
        "replaces": "none: XLA's fusion of the camera's pixel_rays "
                    "(raytracegr_jl_tpu/models/camera.py:43)",
        "launches": step_launches["rk4/200"][8],
        "max_abs_err": cam["err"],
        "ms": cam["k8_ms"],
        "plain_ms": cam["k8_plain_ms"],
        "bound_ms": cam["k8_bound"][0],
        "bound_by": cam["k8_bound"][1],
        "library_ms": None}, {
        "name": "K9 pixel_rays_vjp_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/camera.cu",
        "replaces": "none: XLA's AD of the camera's pixel_rays "
                    "(raytracegr_jl_tpu/models/camera.py:43)",
        "launches": step_launches["rk4/200"][9],
        "max_abs_err": cam["err"],
        "ms": cam["k9_ms"],
        "plain_ms": cam["k9_plain_ms"],
        "bound_ms": cam["k9_bound"][0],
        "bound_by": cam["k9_bound"][1],
        "library_ms": None}, {
        "name": "K11 shade_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/objects.cu",
        "replaces": "none: XLA's fusion of the shading around the "
                    "pallas_calls (raytracegr_jl_tpu/models/objects.py:300 "
                    "shade_lanes, :376 shade_soft)",
        "launches": step_launches["rk4/200"][11],
        "max_abs_err": shd["err"],
        "ms": shd["train"]["k11_ms"],
        "plain_ms": shd["train"]["k11_plain_ms"],
        "bound_ms": shd["train"]["k11_bound"][0],
        "bound_by": shd["train"]["k11_bound"][1],
        "library_ms": None}, {
        "name": "K12 shade_vjp_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/objects.cu",
        "replaces": "none: XLA's AD of the shading in the jitted step "
                    "(raytracegr_jl_tpu/models/objects.py:300 shade_lanes, "
                    ":376 shade_soft)",
        "launches": step_launches["rk4/200"][12],
        "max_abs_err": shd["err"],
        "ms": shd["train"]["k12_ms"],
        "plain_ms": shd["train"]["k12_plain_ms"],
        "bound_ms": shd["train"]["k12_bound"][0],
        "bound_by": shd["train"]["k12_bound"][1],
        "library_ms": None}] + disk_entries + inverse_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharding-rank"]:
        sys.exit(sharding_rank(*(int(v) for v in sys.argv[2:5])))
    sys.exit(main())
