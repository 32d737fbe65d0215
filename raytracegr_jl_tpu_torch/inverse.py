"""Inverse rendering: fit M, a and a sphere's pose to an observed image by
gradient descent with Adam (counterpart of raytracegr_jl_tpu/inverse.py).

The forward model is the differentiable pipeline of grad.py with soft
shading. The loss is piecewise smooth with a finite basin, so ``fit``
returns the best iterate, and ``fit_multistart`` restarts from several
initializations.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .grad import InverseParams, default_inverse_cfg, make_loss_fn
from .models.scenes import SceneSpec
from .render import RenderConfig

PARAM_NAMES = ("M", "a", "sphere_pos")


class FitResult(NamedTuple):
    params: InverseParams  # best parameters found
    loss: torch.Tensor  # loss of the best iterate
    loss_history: torch.Tensor  # [steps]
    params_history: dict  # name -> [steps, ...], each step's parameters
    final_params: InverseParams  # last iterate


def fit(spec: SceneSpec, target_rgb: torch.Tensor, init: InverseParams,
        cfg: RenderConfig | None = None, *, steps: int = 100,
        learning_rate: float = 3e-2, sphere_index: int = 2,
        trainable=None, dtype=torch.float32, device=None) -> FitResult:
    """Fit ``init`` (left unchanged) toward the target with
    ``torch.optim.Adam`` (the defaults of optax's adam).

    ``trainable`` optionally masks the gradients: an object with 0/1 ``M``,
    ``a`` and ``sphere_pos`` (an ``InverseParams`` or a namedtuple), e.g.
    to freeze the spin of a non-spinning scene. Returns the best-loss
    iterate, which the rough landscape makes more useful than the last."""
    if cfg is None:
        cfg = default_inverse_cfg(dtype, soft_temp=0.05, stop_rho=0.5)
    device = init.M.device if device is None else device
    loss_fn = make_loss_fn(spec, target_rgb, cfg, sphere_index, dtype,
                           device)
    params = init.copy()
    opt = torch.optim.Adam(params.parameters(), lr=learning_rate)
    masks = None
    if trainable is not None:
        masks = {n: torch.as_tensor(getattr(trainable, n), dtype=dtype,
                                    device=params.M.device).detach()
                 for n in PARAM_NAMES}
    history = {n: [] for n in PARAM_NAMES}
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        loss = loss_fn(params)
        loss.backward()
        if masks is not None:
            with torch.no_grad():
                for n in PARAM_NAMES:
                    getattr(params, n).grad.mul_(masks[n])
        for n in PARAM_NAMES:
            history[n].append(getattr(params, n).detach().clone())
        losses.append(loss.detach())
        opt.step()
    loss_history = torch.stack(losses)
    history = {n: torch.stack(v) for n, v in history.items()}
    best = int(torch.argmin(loss_history))
    best_params = InverseParams(*(history[n][best] for n in PARAM_NAMES),
                                dtype=dtype, device=params.M.device)
    return FitResult(params=best_params, loss=loss_history[best],
                     loss_history=loss_history, params_history=history,
                     final_params=params.copy())


def fit_multistart(spec: SceneSpec, target_rgb: torch.Tensor,
                   inits: Sequence[InverseParams],
                   cfg: RenderConfig | None = None, **kw) -> FitResult:
    """Run ``fit`` (keywords ``kw``) from each initialization in turn and
    keep the best, the first on ties: the JAX package's serial variant
    (its vmapped one is not ported)."""
    inits = list(inits)
    if not inits:
        raise ValueError("fit_multistart needs at least one init")
    best = None
    for init in inits:
        r = fit(spec, target_rgb, init, cfg, **kw)
        if best is None or float(r.loss) < float(best.loss):
            best = r
    return best
