"""Mid-flight compaction: the forward integration in chunks of iterations,
with the still-active rays packed into a smaller batch between chunks
(counterpart of raytracegr_jl_tpu/compaction.py).

On a strongly step-divergent scene (the accretion disk: p50 ~21 steps, a
photon-ring band of a few percent of the rays at ~15k) a single launch
keeps every warp that holds one slow ray alive to the end. Here each chunk
is one launch of K2 (csrc/compaction.cu), the resumable form of K1: the
34-plane loop state of ops/adjoint.py streams in and out, so a ray's
evolution is bit for bit the same whether it runs in one launch or in many,
and hit rays are localized from their event record after every chunk
(idempotent). Between chunks the host loop reads one number, the active
count; the result scatter and the packing stay on the device.

The schedule is the JAX package's: the first chunk runs ``first_chunk``
iterations; the batch is packed only when the active rays fit in at most
half of it (in units of ``PACK_UNIT`` rays), and then the budget doubles,
up to ``MAX_BUDGET``; when packing stalls, the rest of ``max_steps`` runs
in one launch. Rays are sorted by impact parameter first, so that a packed
batch keeps similar rays together, and put back in the caller's order at
the end. Results equal the single launch's (``integrate_rays_cuda``, or
``integrate_rays_cm`` on the CPU) bitwise.

On the card the first chunk takes each ray's initial step itself (K2's
prologue, as K1's; bit for bit the plain ``initial_dt``), so the render
runs no eager initial step, and the redshift shading is one K5 launch
(csrc/shading.cu, bitwise the plain shading, as ``render_fn`` shades), the
counterpart of the JAX package's jitted shading epilogue.

Not ported: the JAX launcher cache and ``interpret`` (nothing is compiled
per shape here, and a CUDA kernel has no interpreter) and the TPU row
rounding.
"""

from __future__ import annotations

import ctypes

import torch

from .models.camera import Canvas
from .models.objects import Scene
from .ops.adjoint import (N_PLANES, P_ACTIVE, P_HIT, P_STEPS, pack_state,
                          unpack_state)
from .ops.geodesic_cm import (MAX_THREADS, _check_options,
                              impact_parameter_order, launch_config,
                              localized, make_step_cm, run_body,
                              scene_event_cm)
from .ops.integrate import IntegratorConfig, TraceResult
from .ops.metrics import Metric
from .render import (BACKENDS, RenderConfig, _check, _shade, initial_dt,
                     resolve_backend)

# The packing unit and the budget cap of the JAX schedule: packed batches
# are whole TPU tiles (TILE_S * LANES rays), which keeps the sequence of
# chunks the JAX package's. K2 itself takes a batch of any size.
PACK_UNIT = 1024
MAX_BUDGET = 4096


def _one_source(P, y_cm, dt0, own_step: bool = False):
    """Exactly one of ``P`` and ``(y_cm, dt0)``; with ``own_step`` (K2,
    which can take the initial step) ``dt0`` may be None beside ``y_cm``."""
    if (P is None) == (y_cm is None) or (P is not None and dt0 is not None) \
            or (y_cm is not None and dt0 is None and not own_step):
        raise ValueError("give either the packed state P or (y_cm, dt0)")


def chunk_plain(metric: Metric, scene: Scene, cfg: IntegratorConfig,
                budget: int, P: torch.Tensor | None = None,
                y_cm: torch.Tensor | None = None,
                dt0: torch.Tensor | None = None):
    """Plain version of K2: at most ``budget`` iterations of the
    ``make_step_cm`` body from the packed state ``P [34, B]``, or from the
    initial rays ``y_cm [8, B]``, ``dt0 [B]``; then every hit ray localized
    from its record. Returns ``(P_out [34, B], y_fin [8, B], lam_fin [B])``
    (``y_fin``, ``lam_fin``: localized for hit rays, the state's for the
    others)."""
    _one_source(P, y_cm, dt0)
    event_fn = scene_event_cm(scene)
    init, body = make_step_cm(metric, event_fn, cfg)
    st = init(y_cm, dt0) if P is None else unpack_state(P)
    st, _ = run_body(body, st, budget)
    y, lam = localized(metric, event_fn, cfg, st)
    return pack_state(st), y, lam


def chunk_args(metric: Metric, scene: Scene, cfg: IntegratorConfig,
               like: torch.Tensor):
    """K2's parameter block on ``like``'s device and its int flags
    (``launch_config``'s, then ``bisect_iters``), built once per trace
    (building them syncs with the host)."""
    prm, flags = launch_config(metric, scene, cfg, like, "compaction")
    return prm, flags + (int(cfg.bisect_iters),)


def _lib():
    from .utils import cuda_build
    return cuda_build.load("compaction")


def chunk_cuda(metric: Metric, scene: Scene, cfg: IntegratorConfig,
               budget: int, P: torch.Tensor | None = None,
               y_cm: torch.Tensor | None = None,
               dt0: torch.Tensor | None = None, args=None):
    """K2: the contract of ``chunk_plain``, one launch on the card; ``args``
    from ``chunk_args`` (built here if not given). From ``y_cm`` with
    ``dt0=None`` the kernel takes each ray's initial step itself, bit for
    bit ``render.initial_dt``'s. Raises for CPU tensors, a failed build or
    launch, and what the kernel does not take. Adds one to
    ``chunk_cuda.launches`` per launch."""
    _one_source(P, y_cm, dt0, own_step=True)
    src = P if P is not None else y_cm
    if src.device.type != "cuda" or (dt0 is not None
                                     and dt0.device != src.device):
        raise ValueError(f"K2 needs CUDA tensors, got {src.device}")
    if src.dtype not in (torch.float32, torch.float64) or (
            dt0 is not None and dt0.dtype != src.dtype):
        raise TypeError(f"unsupported dtype {src.dtype}")
    rows = N_PLANES if P is not None else 8
    if src.dim() != 2 or src.shape[0] != rows or (
            dt0 is not None and dt0.shape != src.shape[1:]):
        raise ValueError(f"bad shapes {tuple(src.shape)}"
                         + ("" if dt0 is None else f", {tuple(dt0.shape)}"))
    if budget < 0:
        raise ValueError(f"budget must be >= 0, got {budget}")
    prm, flags = args if args is not None else chunk_args(metric, scene, cfg,
                                                          src)
    B = src.shape[1]
    dev, dtype = src.device, src.dtype
    src = src.contiguous()
    dt_in = None if dt0 is None else dt0.contiguous()
    P_out = torch.empty((N_PLANES, B), dtype=dtype, device=dev)
    y_fin = torch.empty((8, B), dtype=dtype, device=dev)
    lam_fin = torch.empty(B, dtype=dtype, device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    fn = _lib().rtgr_k2_f32 if dtype == torch.float32 else _lib().rtgr_k2_f64
    with torch.cuda.device(dev):
        rc = fn(ptr(src if P is not None else None),
                ptr(src if P is None else None), ptr(dt_in), ptr(P_out),
                ptr(y_fin), ptr(lam_fin), ptr(prm), B, *flags, int(budget),
                int(P is None), MAX_THREADS,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {rc}")
    chunk_cuda.launches += 1
    return P_out, y_fin, lam_fin


chunk_cuda.launches = 0


def sorted_batch(y0: torch.Tensor, dt0: torch.Tensor | None):
    """The first chunk's input: ``(inv_order, y_cm [8, B], dt0 [B] or
    None)``, the rays sorted by impact parameter, and the permutation that
    puts results back in the caller's order."""
    order, inv_order = impact_parameter_order(y0)
    return (inv_order, y0[order].t().contiguous(),
            None if dt0 is None else dt0[order].contiguous())


def pack_slots(active: torch.Tensor, n_act: int, size: int):
    """The next chunk's batch as positions in the current one, or None
    where packing stalls (the ``n_act`` active rays need more than half of
    the batch's ``size``, in units of ``PACK_UNIT``). Active rays come
    first, in their (impact-parameter) order; the rest of the batch is
    finished rays, which stay frozen."""
    need = max(1, -(-n_act // PACK_UNIT)) * PACK_UNIT
    if need > size // 2:
        return None
    return torch.argsort((~active).to(torch.int32), stable=True)[:need]


def trace_batch_compacted(metric: Metric, scene: Scene, y0: torch.Tensor,
                          dt0: torch.Tensor | None, cfg: IntegratorConfig, *,
                          first_chunk: int = 64, backend: str | None = None,
                          chunks: list | None = None) -> TraceResult:
    """Forward integration with mid-flight compaction (see the module
    docstring). ``y0 [B, 8]``, ``dt0 [B]``: the contract of
    ``integrate_rays_cuda``, whose results this equals bitwise;
    ``n_iters`` is the number of iterations run over all chunks. With
    ``dt0=None`` K2's first chunk takes each ray's initial step (the
    torch backend runs ``initial_dt`` over ``y0`` first); the result is
    bitwise that of ``dt0=initial_dt(metric, y0, cfg)``.

    ``backend``: ``"cuda"`` (K2), ``"torch"`` (``chunk_plain``) or None,
    which picks by ``y0``'s device. Where ``chunks`` is a list, one record
    per chunk is appended to it: the batch size, the budget, and the
    active and hit rays of the batch after the chunk."""
    if backend is None:
        backend = "cuda" if y0.device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend!r}")
    if first_chunk < 1:
        raise ValueError(f"first_chunk must be >= 1, got {first_chunk}")
    _check_options(cfg)
    if dt0 is None and backend == "torch":
        dt0 = initial_dt(metric, y0, cfg)
    B = y0.shape[0]
    inv_order, y_cm, dt_s = sorted_batch(y0, dt0)
    if backend == "cuda":
        args = chunk_args(metric, scene, cfg, y0)

        def run(budget, **state):
            return chunk_cuda(metric, scene, cfg, budget, args=args, **state)
    else:
        def run(budget, **state):
            return chunk_plain(metric, scene, cfg, budget, **state)

    # Results in sorted order, on the device. Each chunk writes every slot
    # of its batch once (a packed batch's slots are distinct): finished
    # rays are final, active ones are overwritten by a later chunk.
    y_out = torch.empty((8, B), dtype=y0.dtype, device=y0.device)
    lam_out = torch.empty(B, dtype=y0.dtype, device=y0.device)
    hit_out = torch.empty(B, dtype=torch.bool, device=y0.device)
    steps_out = torch.empty(B, dtype=torch.int32, device=y0.device)
    slots = torch.arange(B, device=y0.device)
    size = -(-B // PACK_UNIT) * PACK_UNIT  # the batch in the JAX schedule
    it_total, budget, P = 0, int(first_chunk), None
    while True:
        budget = min(budget, cfg.max_steps - it_total)
        if P is None:
            P, y_fin, lam_fin = run(budget, y_cm=y_cm, dt0=dt_s)
        else:
            P, y_fin, lam_fin = run(budget, P=P)
        it_total += budget
        y_out.index_copy_(1, slots, y_fin)
        lam_out.index_copy_(0, slots, lam_fin)
        hit_out.index_copy_(0, slots, P[P_HIT] > 0)
        # The packed step count is a float, exact far beyond max_steps.
        steps_out.index_copy_(0, slots, P[P_STEPS].to(torch.int32))
        active = P[P_ACTIVE] > 0
        n_act = int(active.sum())  # the one host sync per chunk
        if chunks is not None:
            chunks.append(dict(rays=P.shape[1], budget=budget, active=n_act,
                               hits=int((P[P_HIT] > 0).sum())))
        if n_act == 0 or it_total >= cfg.max_steps:
            break
        keep = pack_slots(active, n_act, size)
        if keep is not None:
            P, slots, size = P.index_select(1, keep), slots[keep], len(keep)
            budget = min(budget * 2, MAX_BUDGET)
        else:
            # Packing stalled: the survivors are a homogeneous band (the
            # photon ring), so further chunks would buy only syncs and
            # launches. Run the rest in one launch.
            budget = cfg.max_steps - it_total
    return TraceResult(y=y_out[:, inv_order].t(), lam=lam_out[inv_order],
                       hit=hit_out[inv_order], steps=steps_out[inv_order],
                       n_iters=it_total)


def make_compact_renderer(metric: Metric, scene: Scene, cfg: RenderConfig, *,
                          first_chunk: int = 64, fast_epilogue: bool = False):
    """A reusable ``canvas -> canvas with rgb`` compacted render: the initial
    step, ``trace_batch_compacted`` and the shading of ``cfg``
    (``render._shade``), so the image equals ``render_fn``'s bitwise. K2
    runs where ``cfg.backend`` resolves to ``"cuda"`` (CUDA tensors unless
    ``backend="torch"``), and its first chunk takes the initial step; the
    plain version elsewhere, after an eager ``initial_dt``. On the CUDA
    backend the redshift shading is one K5 launch, its parameter block
    built once per device and dtype and kept (where M and a are floats).

    ``fast_epilogue`` (the JAX option that fuses the epilogue) changes
    nothing here: the port's first chunk already takes its own initial
    step and the shading on the card is already one kernel, so both values
    give the same image."""
    _check(cfg)
    integ = cfg.integrator
    params = metric.params
    keep = not any(isinstance(v, torch.Tensor) for v in (params.M, params.a))
    blocks = {} if keep else None

    def render(canvas: Canvas) -> Canvas:
        ni, nj = canvas.shape
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        backend = resolve_backend(cfg, y0)
        dt0 = None if backend == "cuda" else initial_dt(metric, y0, integ)
        res = trace_batch_compacted(metric, scene, y0, dt0, integ,
                                    first_chunk=first_chunk, backend=backend)
        rgb = _shade(metric, scene, y0, res.y, cfg, blocks)
        return canvas._replace(rgb=rgb.reshape(ni, nj, 3))

    return render


def render_compacted(metric: Metric, scene: Scene, canvas: Canvas,
                     cfg: RenderConfig, *, first_chunk: int = 64,
                     fast_epilogue: bool = False) -> Canvas:
    """One-shot ``make_compact_renderer``."""
    return make_compact_renderer(metric, scene, cfg, first_chunk=first_chunk,
                                 fast_epilogue=fast_epilogue)(canvas)
