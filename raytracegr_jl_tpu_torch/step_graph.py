"""The training step as one device program: the loss and its backward pass
captured once in a CUDA graph and replayed, the counterpart of the JAX
package's ``jax.jit(step)`` (raytracegr_jl_tpu/inverse.py).

Eagerly, a 200x200 training step issues thousands of small kernels from the
host (the camera, the soft shading and autograd around K3, K4, K6 and K7),
and the card waits for the host most of the time. Captured, the whole step
is one launch. This needs a step that reads
nothing back to the host and whose shapes do not depend on the data, which
the kernel route of ops/adjoint.py provides (K3 and K4 keep the segment
counts on the card), and parameter blocks that a replay refreshes from the
live parameters (``pack_params``).

``GraphedStep(loss_fn, params)`` runs ``loss_fn(params)`` and its backward
pass a few times on a side stream (the kernels build, autograd and the
caching allocator settle), then captures one such pass with
``torch.cuda.graph``, reading the parameter leaves in place and adding
their gradients into their ``.grad`` tensors. ``replay()`` reruns the
captured pass on the leaves' current values and returns the static loss;
the gradients are then in ``.grad``, added to what was there (zero them
before, as an eager step does). A failed capture raises: there is no eager
fallback. CPU tensors raise too: a graph is a CUDA device program.

The launch counters of the kernel wrappers (``forward_segment_cuda.
launches``, ``backward_cuda.launches``, ``localize_cuda.launches``,
``localize_vjp_cuda.launches``) count the warm-up passes and the capture,
not the replays, which issue no launch from Python; a replay's kernels are
seen by a profiler.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from .ops import adjoint

# Eager passes before the capture: the first builds the kernels and the
# parameter blocks, the second runs as the captured one will.
WARMUP_PASSES = 2


def _params_fence(dtype: torch.dtype, stream: torch.cuda.Stream) -> None:
    """The adjoint and localize libraries' fences on ``stream`` (csrc
    params_fence): a replay, whose K3, K4, K6 and K7 launches take their
    library's constant parameter copy, is ordered after each library's
    last eager launch on another stream, and the next one after it."""
    for lib in (adjoint._lib(), adjoint._loc_lib()):
        fn = (lib.rtgr_fence_f32 if dtype == torch.float32
              else lib.rtgr_fence_f64)
        rc = fn(ctypes.c_void_p(stream.cuda_stream))
        if rc != 0:
            raise RuntimeError(f"the parameter-block fence failed: CUDA "
                               f"error {rc}")


class GraphedStep:
    """``loss_fn(params)`` and ``loss.sum().backward()`` as one CUDA graph
    over the parameters of ``params`` (an ``nn.Module``, such as
    ``InverseParams``, all on one CUDA device). Building it runs the pass
    ``WARMUP_PASSES`` times and captures it once; the leaves' gradients
    are zeroed after that (allocated as zeros where they were None), and
    the leaves keep these ``.grad`` tensors: each replay adds into them.
    Raises ``ValueError`` for leaves that are not on a CUDA device, and
    ``RuntimeError`` where the capture fails."""

    def __init__(self, loss_fn, params: nn.Module):
        leaves = list(params.parameters())
        devices = {p.device for p in leaves}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError("a CUDA graph of the step needs its parameters "
                             "on one CUDA device, got "
                             f"{sorted(map(str, devices))}")
        self.device = next(iter(devices))
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)

        def zero_grads():
            for p in leaves:
                p.grad.zero_()

        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_PASSES):
                loss_fn(params).sum().backward()
                zero_grads()
        caller.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                loss = loss_fn(params)
                loss.sum().backward()
        except Exception as e:
            raise RuntimeError("capturing the training step in a CUDA graph "
                               f"failed: {e}") from e
        self.dtype = leaves[0].dtype
        self.loss = loss.detach()
        zero_grads()

    def replay(self) -> torch.Tensor:
        """One captured pass on the leaves' current values, on the current
        stream: the static loss (overwritten by the next replay); the
        gradients added into the leaves' ``.grad``. Reads nothing back to
        the host."""
        stream = torch.cuda.current_stream(self.device)
        _params_fence(self.dtype, stream)
        self.graph.replay()
        _params_fence(self.dtype, stream)
        return self.loss
