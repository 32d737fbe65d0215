"""State carried across from the JAX package: functions that turn its
objects, handed over as numpy arrays or python scalars, into the port's,
so that both packages compute from the same inputs. Imports no jax: the
caller converts each JAX array with ``np.asarray``."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..grad import InverseParams
from ..models.camera import Canvas
from ..models.objects import Scene, kind_tensor
from ..ops.integrate import IntegratorConfig
from ..ops.metrics import KerrSchildParams


def tensor(a, dtype=None, device=None) -> torch.Tensor:
    """Array -> tensor (a copy), keeping its dtype unless one is given."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def scene_from_numpy(fields: Mapping[str, np.ndarray], dtype=None,
                     device=None) -> Scene:
    """A ``Scene`` from the JAX ``Scene``'s fields, ``{name: array}``."""
    return Scene(**{
        f: (kind_tensor(np.asarray(fields[f]).tolist(), device)
            if f == "kind" else tensor(fields[f], dtype, device))
        for f in Scene._fields})


def ks_params_from_numpy(M, a) -> KerrSchildParams:
    """``KerrSchildParams`` from the JAX parameters (scalars or 0-d arrays)."""
    return KerrSchildParams(M=float(np.asarray(M)), a=float(np.asarray(a)))


def canvas_from_numpy(pos: np.ndarray, normal: np.ndarray, dtype=None,
                      device=None) -> Canvas:
    """A ``Canvas`` from the JAX canvas's ``pos`` and ``normal``."""
    p = tensor(pos, dtype, device)
    return Canvas(pos=p, normal=tensor(normal, dtype, device),
                  rgb=torch.zeros(p.shape[:-1] + (3,), dtype=p.dtype,
                                  device=device))


def integrator_config_from_fields(fields: Mapping) -> IntegratorConfig:
    """``IntegratorConfig`` from the JAX config's ``_asdict()``; fields the
    port does not know are refused."""
    unknown = set(fields) - set(IntegratorConfig._fields)
    if unknown:
        raise ValueError(f"unknown IntegratorConfig fields: {sorted(unknown)}")
    return IntegratorConfig(**{k: (v.item() if isinstance(v, np.generic)
                                   else v) for k, v in fields.items()})


def inverse_params_from_numpy(M, a, sphere_pos, dtype=None,
                              device=None) -> InverseParams:
    """The port's ``InverseParams`` module from the JAX ``InverseParams``'s
    fields (numpy arrays or scalars); the dtype is the arrays' unless one
    is given."""
    pos = np.asarray(sphere_pos)
    return InverseParams(np.asarray(M), np.asarray(a), pos,
                         dtype=dtype or torch.from_numpy(pos).dtype,
                         device=device)
