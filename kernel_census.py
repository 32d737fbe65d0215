"""Which module of a training step issues its device kernels: one step (the
loss and its backward pass) of the port's training path, its PyTorch
operations that launch a kernel counted by the module that issues them,
forward and backward.

    python3 kernel_census.py [--tree DIR] [--n N] [--out FILE]

The step runs on the CPU, through the plain route, at N x N (8 by default:
the counts do not depend on the width). An operation launches a kernel
unless it is a view or only allocates. A forward operation belongs to the
module whose call it runs in; a backward one to the module whose forward
created the autograd node it runs for (by the node's sequence number).
Modules: the camera (``models.camera._Camera``: K8 and K9 on the card;
in a tree without them, ``grad.pixel_rays`` under autograd), the initial
step (``render.initial_dt``, which the differentiable path no longer
calls: a tree's count there is 0), the segments
(``ops.adjoint._Checkpointed``: K3 and K4 on the card, and from the tree
that has ``init_plain`` also the initial state, K3's prologue and K4's
epilogue on the card), the localization (``ops.adjoint._Localized``: K6
and K7 on the card; in a tree without them, ``localize_events_cm`` under
autograd), the shading (``models.objects._Shaded``: K11 and K12 on the
card; in a tree without them, ``shade`` and ``shade_soft`` under
autograd) and the rest (the
loss, the selections of ``flatten_params`` and ``ray_params``, the
camera's parameters per ray; in an older tree also the initial state,
``make_step_cm``'s init, and its autograd). The operations of a
module that the card runs as kernels are not counted; its kernels are
named instead. Launch setup that only the card runs (``pack_params``) is
not seen here.

Configurations: the training steps of ``chip_smoke.py`` (example2,
rk4/200 and tsit5/48, the hard shading) and config 5's soft shading (the
lensing scene, rk4/120). Prints one JSON line per configuration; with
``--out`` also writes them to a file. ``--tree`` measures another checkout
(an older one unpacked with ``git archive``). Imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

# Operations that launch no kernel: they allocate, or read a value.
NO_KERNEL = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_local_scalar_dense", "lift_fresh",
             "set_", "is_nonzero", "item"}


def census(step, labels: dict) -> dict:
    """``{module: {"forward": n, "backward": n}}`` of one call of
    ``step()``, with ``labels`` ``{label: [(owner, name), ...]}``: each
    ``owner.name`` is wrapped so that what it runs counts under its
    label."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    stack, owner_of = [], {}
    counts = collections.defaultdict(lambda: {"forward": 0, "backward": 0})

    def note(out):
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.grad_fn is not None:
                owner_of.setdefault(t.grad_fn._sequence_nr(),
                                    stack[-1] if stack else "rest")

    class Nodes(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            note(out)
            return out

    class Kernels(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if not func.is_view and name not in NO_KERNEL:
                node = torch._C._current_autograd_node()
                if node is None:
                    counts[stack[-1] if stack else "rest"]["forward"] += 1
                else:
                    counts[owner_of.get(node._sequence_nr(),
                                        "rest")]["backward"] += 1
            return func(*args, **(kwargs or {}))

    def wrap(label, fn):
        def wrapped(*args, **kwargs):
            stack.append(label)
            try:
                out = fn(*args, **kwargs)
                note(out)
                return out
            finally:
                stack.pop()
        return wrapped

    saved = []
    for label, sites in labels.items():
        for owner, name in sites:
            saved.append((owner, name, getattr(owner, name)))
            setattr(owner, name, wrap(label, getattr(owner, name)))
    try:
        with Nodes(), Kernels():
            step()
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return {k: dict(v) for k, v in sorted(counts.items())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="the checkout to measure")
    ap.add_argument("--n", type=int, default=8, help="pixels per side")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ns = ap.parse_args()
    tree = os.path.abspath(ns.tree)
    sys.path.insert(0, tree)
    import torch
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch import grad, render
    from raytracegr_jl_tpu_torch.models import camera, objects
    from raytracegr_jl_tpu_torch.ops import adjoint
    if os.path.dirname(os.path.dirname(os.path.abspath(rt.__file__))) != tree:
        raise RuntimeError("the package did not load from the tree given")

    labels = {"initial_dt": [(render, "initial_dt")],
              "shading": [(render, "shade"), (render, "shade_soft")],
              "segments": [(adjoint._Checkpointed, "apply")]}
    # The modules that the card runs as kernels, and those kernels.
    on_card = {"segments": "K3, k3_close, K4"}
    if hasattr(adjoint, "init_plain"):
        on_card["segments"] = ("K3 (with the initial state), k3_close, K4 "
                               "(with its VJP)")
    if hasattr(camera, "_Camera"):
        labels["camera"] = [(camera._Camera, "apply")]
        on_card["camera"] = "K8, K9"
    else:
        labels["camera"] = [(grad, "pixel_rays")]
    if hasattr(objects, "_Shaded"):
        labels["shading"] = [(objects._Shaded, "apply")]
        on_card["shading"] = "K11, K12"
    if hasattr(adjoint, "_Localized"):
        labels["localization"] = [(adjoint._Localized, "apply")]
        on_card["localization"] = "K6, K7"
    else:
        labels["localization"] = [(adjoint, "localize_events_cm")]
    f32, n = torch.float32, ns.n
    out = []
    cases = {"rk4/200": ("example2", "rk4", 200), "tsit5/48":
             ("example2", "tsit5", 48), "config 5": ("lensing", "rk4", 120)}
    for label, (scene_name, method, steps) in cases.items():
        if scene_name == "example2":
            spec = rt.example2_spec(n, n)
            cfg = rt.default_inverse_cfg(f32, max_steps=steps, method=method,
                                         rk4_dt=100.0 / steps, stop_rho=0.5)
            truth = rt.InverseParams(1.0, 0.0, [0.0, 4.0, 0.0, 0.0], f32,
                                     "cpu")
            start = rt.InverseParams(1.05, 0.0, [0.0, 4.0, 0.0, 0.0], f32,
                                     "cpu")
            index = 2
        else:
            spec = rt.lensing_inverse_spec(n, n)
            cfg = rt.default_inverse_cfg(f32, max_steps=steps, rk4_dt=0.5,
                                         soft_temp=0.05, stop_rho=0.5)
            cfg = cfg._replace(soft_freq=2.0, integrator=cfg.integrator.
                               _replace(lam_max=60.0))
            truth = rt.InverseParams(0.5, 0.0, [0.0, 5.0, 12.0, 0.0], f32,
                                     "cpu")
            start = rt.InverseParams(0.53, 0.0, [0.0, 5.0, 12.0, 0.03], f32,
                                     "cpu")
            index = 0
        xg, ng = rt.flat_pixel_grid(spec, f32, "cpu")
        with torch.no_grad():
            target = rt.make_ray_render_for_params(spec, cfg, index, f32,
                                                   "cpu")(truth, xg, ng)
        loss_fn = rt.make_ray_loss_fn(spec, cfg, index, f32, "cpu")
        counts = census(lambda: loss_fn(start, xg, ng, target).backward(),
                        labels)
        kernels = {k: (on_card[k] if k in on_card else v["forward"]
                       + v["backward"]) for k, v in counts.items()}
        rec = dict(kind="census", tree=tree, config=label, pixels=n * n,
                   modules=counts, kernels_on_the_card=kernels,
                   total_outside_kernels=sum(v for v in kernels.values()
                                             if isinstance(v, int)))
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(ns.out)), exist_ok=True)
        with open(ns.out, "w") as f:
            for rec in out:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
