"""A render's summary as one JSON-able record (counterpart of
raytracegr_jl_tpu/utils/stats.py): ray counts, the hit / escaped / killed
classification, the step-count distribution (what a warp's divergence costs
follows from it), the throughput and the device."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.integrate import IntegratorConfig, TraceResult


def trace_stats(res: TraceResult, wall_s: float | None = None,
                cfg: IntegratorConfig | None = None) -> dict[str, Any]:
    """Summarize a TraceResult into a flat JSON-able dict, with the JAX
    package's signature and keys.

    ``hit``: ended on a surface crossing; ``escaped``: spanned the affine
    range (shaded as a miss), judged against ``cfg.lam_max`` or, without
    ``cfg``, 100; ``killed``: stopped mid-flight (capture radius,
    error-control failure or the step budget). ``wall_s`` (seconds, when
    positive) adds itself and ``rays_per_s``; ``cfg`` adds ``method`` and
    ``max_steps``. ``device`` is the card's name for a result on a CUDA
    device, else ``"cpu"``."""
    dev = res.steps.device
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    steps = res.steps.cpu().numpy()
    hit = res.hit.cpu().numpy()
    lam = res.lam.cpu().numpy()
    n = int(steps.size)
    lam_max = float(cfg.lam_max) if cfg is not None else 100.0
    escaped = (~hit) & (lam >= lam_max - 1e-5)
    killed = (~hit) & ~escaped
    p = np.percentile(steps, [50, 90, 99]) if n else [0, 0, 0]
    out: dict[str, Any] = {
        "rays": n,
        "hit_frac": round(float(hit.mean()), 6) if n else 0.0,
        "escaped_frac": round(float(escaped.mean()), 6) if n else 0.0,
        "killed_frac": round(float(killed.mean()), 6) if n else 0.0,
        "steps_mean": round(float(steps.mean()), 2) if n else 0.0,
        "steps_p50": int(p[0]),
        "steps_p90": int(p[1]),
        "steps_p99": int(p[2]),
        "steps_max": int(steps.max()) if n else 0,
        "loop_iters": int(res.n_iters),
        "device": device,
    }
    if wall_s is not None and wall_s > 0:
        out["wall_s"] = round(float(wall_s), 4)
        out["rays_per_s"] = round(n / wall_s, 1)
    if cfg is not None:
        out["method"] = cfg.method
        out["max_steps"] = int(cfg.max_steps)
    return out
