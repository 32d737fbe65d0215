"""Checkpoint and resume of a fit (counterpart of
raytracegr_jl_tpu/utils/checkpoint.py, which uses orbax): the state, e.g.
``{"params": res.final_params, "opt_state": res.opt_state, "step": n}``,
goes to one file through ``torch.save`` and comes back through
``torch.load(weights_only=True)``, so that a preempted fit continues bit
for bit (``inverse.fit(..., opt_state=...)``).

The state is a tree of dicts, lists, tuples, tensors, numbers and
``InverseParams``; a parameter module is stored as its three tensors and
rebuilt by ``restore`` from the structure of ``like``.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..grad import InverseParams
from .device import resolve_device

_PARAMS = ("M", "a", "sphere_pos")


def _plain(state: Any) -> Any:
    """The state with each ``InverseParams`` as a dict of detached tensors
    and tuples as lists: what the weights-only loader takes."""
    if isinstance(state, InverseParams):
        return {n: getattr(state, n).detach() for n in _PARAMS}
    if isinstance(state, dict):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_plain(v) for v in state]
    if isinstance(state, torch.Tensor):
        return state.detach()
    return state


def save(path: str, state: Any) -> str:
    """Save ``state`` to ``path`` (overwrites); returns the absolute path."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp"
    torch.save(_plain(state), tmp)
    os.replace(tmp, path)
    return path


def _first_tensor(like: Any):
    if isinstance(like, InverseParams):
        return like.M
    if isinstance(like, torch.Tensor):
        return like
    items = like.values() if isinstance(like, dict) else (
        like if isinstance(like, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _rebuild(like: Any, saved: Any, device) -> Any:
    if isinstance(like, InverseParams):
        return InverseParams(*(saved[n] for n in _PARAMS),
                             dtype=like.M.dtype, device=device)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], saved[k], device) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(a, b, device) for a, b in zip(like, saved))
    if isinstance(saved, torch.Tensor):
        return saved.to(device)
    return saved


def restore(path: str, like: Any) -> Any:
    """Load a checkpoint with the structure of ``like``, its tensors on
    ``like``'s device (that of its first tensor), else on the CUDA card."""
    t = _first_tensor(like)
    device = t.device if t is not None else resolve_device(None)
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return _rebuild(like, saved, device)
