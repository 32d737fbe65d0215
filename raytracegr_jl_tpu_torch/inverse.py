"""Inverse rendering: fit M, a and a sphere's pose to an observed image by
gradient descent with Adam (counterpart of raytracegr_jl_tpu/inverse.py).

The forward model is the differentiable pipeline of grad.py with soft
shading. The loss is piecewise smooth with a finite basin, so ``fit``
returns the best iterate, and ``fit_multistart`` restarts from several
initializations, all of them in one ray batch by default.

On a CUDA card with the kernel route (K3 and K4) each step replays one
CUDA graph of the loss and its backward pass (step_graph.py, the
counterpart of the JAX package's jitted step), and Adam steps eagerly
beside it, so that a fit equals the eager loop bit for bit. The eager loop
(``_adam_loop`` without a graph) is what the plain route
(``backend="torch"``), ``grad_mode="scan"`` and CPU tensors run.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from .grad import (InverseParams, default_inverse_cfg, make_loss_fn,
                   make_multistart_loss_fn)
from .models.scenes import SceneSpec
from .render import RenderConfig, resolve_backend
from .step_graph import GraphedStep

PARAM_NAMES = ("M", "a", "sphere_pos")


class FitResult(NamedTuple):
    params: InverseParams  # best parameters found
    loss: torch.Tensor  # loss of the best iterate
    loss_history: torch.Tensor  # [steps]
    params_history: dict  # name -> [steps, ...], each step's parameters
    final_params: InverseParams  # last iterate (resume from here)
    opt_state: dict  # Adam's state at the last iterate (resume from here)


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``step -> learning rate``: optax's ``cosine_decay_schedule`` in closed
    form, ``init_value * ((1 - alpha) * 0.5 * (1 + cos(pi * t / T)) +
    alpha)`` with ``t = min(step, T)``; the first update takes step 0.
    (``torch.optim.lr_scheduler.CosineAnnealingLR`` updates recursively
    and rounds apart from it.)"""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(step: int) -> float:
        t = min(float(step), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def graphed(cfg: RenderConfig, params: InverseParams) -> bool:
    """Whether a fit of ``params`` under ``cfg`` replays a CUDA graph of its
    step: parameters on a CUDA card and the kernel route (K3 and K4). The
    plain route (``backend="torch"``), ``grad_mode="scan"`` and CPU
    tensors step eagerly."""
    return (resolve_backend(cfg, params.M) == "cuda"
            and cfg.integrator.grad_mode in ("auto", "ckpt_cuda"))


def _adam_loop(params: InverseParams, loss_fn, steps: int, learning_rate,
               trainable, opt_state, graph: bool = False):
    """``steps`` Adam updates of ``params`` (in place) on ``loss_fn(params)
    .sum()``: ``(losses [steps, ...], {name: [steps, ...]}, opt_state)``,
    each step's loss and parameters before its update. ``learning_rate``:
    a float or ``step -> lr``, evaluated at the count of updates already
    made (0 for the first, the resumed count after ``opt_state``).

    Each step: zero the gradients, the loss and its backward pass, the
    masks, the loss and the parameters copied into device buffers, the
    learning rate, Adam's eager step; nothing is read back to the host.
    With ``graph`` the loss and its backward pass are captured once
    (``GraphedStep``, before the first update) and replayed in each step.
    The values equal the eager loop's bit for bit (the same kernels on the
    same values; Adam outside the graph, since the capturable Adam rounds
    its bias corrections apart)."""
    schedule = learning_rate if callable(learning_rate) else None
    step0 = 0 if opt_state is None else int(opt_state["step"])
    lr = schedule(step0) if schedule else learning_rate
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    if opt_state is not None:  # one start's state serves every start
        for n in PARAM_NAMES:
            p = getattr(params, n)
            opt.state[p] = {
                "step": torch.tensor(float(step0), dtype=torch.float32),
                **{k: opt_state[k][n].detach().expand_as(p).clone()
                   for k in ("exp_avg", "exp_avg_sq")}}
    masks = None
    if trainable is not None:
        masks = {n: torch.as_tensor(getattr(trainable, n),
                                    dtype=params.M.dtype,
                                    device=params.M.device).detach()
                 for n in PARAM_NAMES}
    step = GraphedStep(loss_fn, params) if graph else None
    history = {n: getattr(params, n).detach().new_empty(
        (steps,) + tuple(getattr(params, n).shape)) for n in PARAM_NAMES}
    losses = None
    for k in range(steps):
        opt.zero_grad(set_to_none=False)
        if step is not None:
            loss = step.replay()
        else:
            loss = loss_fn(params)
            loss.sum().backward()
        with torch.no_grad():
            for n in PARAM_NAMES:
                p = getattr(params, n)
                if p.grad is None:  # not in the graph (e.g. M in flat space)
                    p.grad = torch.zeros_like(p)
                if masks is not None:
                    p.grad.mul_(masks[n])
            if losses is None:
                losses = loss.new_empty((steps,) + tuple(loss.shape))
            losses[k].copy_(loss)
            for n in PARAM_NAMES:
                history[n][k].copy_(getattr(params, n))
        if schedule:
            for group in opt.param_groups:
                group["lr"] = schedule(step0 + k)
        opt.step()
    state = {"step": step0 + steps,
             "exp_avg": {n: opt.state[getattr(params, n)]["exp_avg"].clone()
                         for n in PARAM_NAMES},
             "exp_avg_sq": {n: opt.state[getattr(params, n)]["exp_avg_sq"]
                            .clone() for n in PARAM_NAMES}}
    return losses, history, state


def fit(spec: SceneSpec, target_rgb: torch.Tensor, init: InverseParams,
        cfg: RenderConfig | None = None, *, steps: int = 100,
        learning_rate=3e-2, sphere_index: int = 2, trainable=None,
        opt_state: dict | None = None, dtype=torch.float32,
        device=None, graph: bool | None = None) -> FitResult:
    """Fit ``init`` (left unchanged) toward the target with
    ``torch.optim.Adam`` (the defaults of optax's adam).

    ``learning_rate`` is a float or a schedule ``step -> lr`` (optax's
    contract: the first update takes step 0; ``cosine_decay_schedule``).
    ``opt_state`` resumes a fit: save ``(res.final_params, res.opt_state)``
    with utils/checkpoint.save and continue with ``fit(..., init=params,
    opt_state=opt_state)``; given the same full-length schedule, the
    continuation equals an uninterrupted fit of the combined length bit
    for bit (the schedule resumes at the saved step count).

    ``trainable`` optionally masks the gradients: an object with 0/1 ``M``,
    ``a`` and ``sphere_pos`` (an ``InverseParams`` or a namedtuple), e.g.
    to freeze the spin of a non-spinning scene. Returns the best-loss
    iterate, which the rough landscape makes more useful than the last.

    ``graph``: None replays a CUDA graph of the loss and its backward pass
    in each step where ``graphed`` says so (a card and the kernel route),
    False steps eagerly, True replays a graph (and raises where it cannot
    be captured). Graphed or not, the result is the same bit for bit."""
    if cfg is None:
        cfg = default_inverse_cfg(dtype, soft_temp=0.05, stop_rho=0.5)
    device = init.M.device if device is None else device
    loss_fn = make_loss_fn(spec, target_rgb, cfg, sphere_index, dtype,
                           device)
    params = init.copy()
    losses, history, state = _adam_loop(params, loss_fn, steps,
                                        learning_rate, trainable, opt_state,
                                        graphed(cfg, params) if graph is None
                                        else graph)
    best = int(torch.argmin(losses))
    best_params = InverseParams(*(history[n][best] for n in PARAM_NAMES),
                                dtype=dtype, device=params.M.device)
    return FitResult(params=best_params, loss=losses[best],
                     loss_history=losses, params_history=history,
                     final_params=params.copy(), opt_state=state)


def _fit_stacked(spec: SceneSpec, target_rgb: torch.Tensor,
                 inits: Sequence[InverseParams], cfg: RenderConfig | None,
                 *, steps: int = 100, learning_rate=3e-2,
                 sphere_index: int = 2, trainable=None,
                 opt_state: dict | None = None, dtype=torch.float32,
                 device=None, graph: bool | None = None) -> FitResult:
    """The vectorized multistart: one Adam over the inits stacked along a
    leading start axis, on the sum of the starts' losses, whose gradients
    are independent (so each start follows its own ``fit``), rendered as
    one grouped batch per step (``make_multistart_loss_fn``). Returns the
    run of least best loss, the first on ties, its ``opt_state`` that of
    its own start."""
    if cfg is None:
        cfg = default_inverse_cfg(dtype, soft_temp=0.05, stop_rho=0.5)
    device = inits[0].M.device if device is None else device
    loss_fn = make_multistart_loss_fn(spec, target_rgb, cfg, sphere_index,
                                      dtype, device)
    params = InverseParams(*(torch.stack([getattr(i, n).detach()
                                          for i in inits])
                             for n in PARAM_NAMES), dtype=dtype,
                           device=device)
    losses, history, state = _adam_loop(params, loss_fn, steps,
                                        learning_rate, trainable, opt_state,
                                        graphed(cfg, params) if graph is None
                                        else graph)
    best_step = torch.argmin(losses, dim=0)  # per start, the first minimum
    best_loss = losses.gather(0, best_step[None])[0]
    run = int(torch.argmin(best_loss))  # first minimum, as the serial loop
    step = int(best_step[run])
    hist = {n: v[:, run] for n, v in history.items()}
    pick = lambda t: t[run]  # noqa: E731
    return FitResult(
        params=InverseParams(*(hist[n][step] for n in PARAM_NAMES),
                             dtype=dtype, device=device),
        loss=losses[step, run], loss_history=losses[:, run],
        params_history=hist,
        final_params=InverseParams(*(pick(getattr(params, n)).detach()
                                     for n in PARAM_NAMES), dtype=dtype,
                                   device=device),
        opt_state={"step": state["step"],
                   "exp_avg": {n: pick(v) for n, v in
                               state["exp_avg"].items()},
                   "exp_avg_sq": {n: pick(v) for n, v in
                                  state["exp_avg_sq"].items()}})


def fit_multistart(spec: SceneSpec, target_rgb: torch.Tensor,
                   inits: Sequence[InverseParams],
                   cfg: RenderConfig | None = None, *,
                   vectorized: bool = True, **kw) -> FitResult:
    """Fit from each initialization (keywords ``kw`` as for ``fit``) and
    keep the run of least loss, the first on ties.

    ``vectorized=True`` runs all starts at once: one Adam over the stacked
    parameters, each step one render of all starts' rays (one K3 and one
    K4 launch on the card, whatever the number of starts), the counterpart
    of the JAX package's vmapped fit. Its results equal the serial fits'
    up to the order of floating-point sums. ``vectorized=False`` runs
    ``fit`` from each initialization in turn."""
    inits = list(inits)
    if not inits:
        raise ValueError("fit_multistart needs at least one init")
    if vectorized:
        return _fit_stacked(spec, target_rgb, inits, cfg, **kw)
    best = None
    for init in inits:
        r = fit(spec, target_rgb, init, cfg, **kw)
        if best is None or float(r.loss) < float(best.loss):
            best = r
    return best
