"""Data parallelism over cards with torch.distributed (counterpart of
raytracegr_jl_tpu/parallel/sharding.py): the pixel batch split over the
ranks of a 1-D device mesh, one process per card.

Rays are independent, so the forward render of a rank's rows needs no
communication (``sharded_render``: each rank runs K1 on its B/W rays),
and a training step needs one all-reduce of the loss and the (M, a, pose)
gradients (``sharded_value_and_grad``: each rank runs K3 and K4 on its
rows, then one SUM over a packed vector). Where JAX places global arrays
over a mesh and inserts the collectives itself, here every rank holds
only its rows of the batch (``shard_pixels``, ``global_pixels``) and the
collectives are explicit; ``gather_rows`` assembles the rows of every
rank where a caller needs the whole batch. JAX's ``ray_sharding`` and
``replicated`` (shardings of global arrays) have no counterpart: a
rank's tensors are its own, and parameters are replicated by being built
alike on every rank.

Each process owns one card: ``init_distributed`` selects it
(``torch.cuda.set_device``) before anything is built, so that every
factory's default device (``torch.device("cuda")``, the current one) and
the kernels' launch setup follow it. The kernels keep one copy of their
parameter block per process (csrc/geodesic_common.cuh), so a rank must
never launch on another rank's card; the sharded entry points check
the current device against the mesh's.

A run over N cards: ``torchrun --nproc-per-node=N script.py``, where the
script calls ``init_distributed()`` first (README.md has an example).
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device

RAY_AXIS = "rays"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_rank: int | None = None, device=None,
                     backend: str | None = None) -> bool:
    """Join a multi-process run: ``torch.distributed.init_process_group``,
    guarded so that a single process (or a group already up) is left as it
    is. Returns True when more than one process takes part.

    The group comes from the arguments (``coordinator_address``
    ``"host:port"`` of rank 0's store, ``num_processes``, ``process_id``)
    or, without them, from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    with neither it returns False and initialises nothing. ``device``:
    None for this process's card, ``cuda:local_rank`` (``local_rank``
    from the argument, else ``LOCAL_RANK``, else the rank; a card named
    with its index is that card), made the current device before anything
    else; ``"cpu"`` for a run on the CPU.
    ``backend``: ``"nccl"`` for a card and ``"gloo"`` for the CPU unless
    given. A failure to initialise raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        if (coordinator_address is None or num_processes is None
                or process_id is None):
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together")
        rank, world = process_id, num_processes
        init_method = f"tcp://{coordinator_address}"
    if device is not None and torch.device(device).type == "cpu":
        backend = backend or "gloo"
    else:
        card = resolve_device(device)  # raises where there is no card
        if local_rank is None:
            local_rank = (card.index if card.index is not None
                          else int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(local_rank)
        backend = backend or "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return world > 1


def make_mesh(device=None) -> DeviceMesh:
    """The 1-D mesh over every rank of the group ``init_distributed`` set
    up, its axis named ``RAY_AXIS``, on the card (``device=None``) or the
    CPU (``device="cpu"``). The rank, the world size and this rank's
    device come from it (``mesh_device``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed (or init_process_group) first")
    kind = "cpu" if device is not None and torch.device(
        device).type == "cpu" else resolve_device(device).type
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(RAY_AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_device(mesh: DeviceMesh, *tensors: torch.Tensor) -> None:
    """A sharded entry point runs on this rank's device only."""
    dev = mesh_device(mesh)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"rank {mesh.get_rank()} runs on {dev}, got a "
                             f"tensor on {t.device}")


def pad_rows(mesh: DeviceMesh, n: int) -> int:
    """Rows of padding that make ``n`` divisible by the mesh's size."""
    return (-n) % mesh.size()


def shard_rows(a, rank: int, world_size: int):
    """Rank ``rank``'s rows of ``a`` (tensor or numpy array) padded to a
    multiple of ``world_size`` by repeating its last row (not zeros: a zero
    state sits on the metric's singularity): rows ``[rank R, (rank + 1)
    R)`` with R = padded rows / world_size. Padded rays trace like real
    ones; ``crop_rows`` drops them from the gathered result."""
    n = a.shape[0]
    rows = (n + (-n) % world_size) // world_size
    idx = np.minimum(np.arange(rank * rows, (rank + 1) * rows), n - 1)
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return a[idx]


def shard_pixels(mesh: DeviceMesh, *tensors: torch.Tensor
                 ) -> tuple[torch.Tensor, ...]:
    """This rank's rows (``shard_rows``) of pixel tensors ``[n, ...]``, on
    the rank's device."""
    dev = mesh_device(mesh)
    return tuple(shard_rows(t, mesh.get_rank(), mesh.size()).to(dev)
                 for t in tensors)


def global_pixels(mesh: DeviceMesh, *arrays) -> tuple[torch.Tensor, ...]:
    """``shard_pixels`` from numpy arrays that every rank passes whole:
    only this rank's rows are copied to its device."""
    dev = mesh_device(mesh)
    return tuple(torch.from_numpy(np.ascontiguousarray(shard_rows(
        np.asarray(a), mesh.get_rank(), mesh.size()))).to(dev)
        for a in arrays)


def crop_rows(n: int, *tensors):
    """Undo the padding: the first ``n`` rows."""
    return tuple(t[:n] for t in tensors)


def gather_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, in rank order (the padded batch), on
    every rank: one all-gather. NCCL gathers on the card; gloo gathers
    only host tensors, so under gloo the rows go through the host and
    come back to ``x``'s device."""
    group = mesh.get_group()
    host = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    part = (x.cpu() if host else x).contiguous()
    parts = [torch.empty_like(part) for _ in range(mesh.size())]
    dist.all_gather(parts, part, group=group)
    out = torch.cat(parts)
    return out.to(x.device) if host else out


def sharded_render(render: Callable, mesh: DeviceMesh) -> Callable:
    """``(pos_local, normal_local) -> rgb_local``: ``render`` (e.g.
    ``render_fn``'s closure) on this rank's rows. Rays are independent, so
    no collective runs; on the card each rank launches K1 on its own rays.
    ``gather_rows`` and ``crop_rows`` assemble the image."""
    def fn(pos: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
        _check_device(mesh, pos, normal)
        return render(pos, normal)

    return fn


def sharded_value_and_grad(loss_fn: Callable, mesh: DeviceMesh,
                           n_batch_args: int = 3) -> Callable:
    """``(params, *local_batch) -> (loss, grads)``: ``loss_fn(params,
    *local_batch)`` (e.g. ``make_ray_loss_fn``'s) and its gradients on this
    rank's rows, then one all-reduce (SUM) of the loss, the gradients and
    the row count, packed into one float64 vector, divided by the world
    size W. ``params`` is an ``nn.Module`` (``InverseParams``) built alike
    on every rank; ``grads`` has a field per parameter (``g.M``, ``g.a``,
    ``g.sphere_pos``), in the parameters' dtypes. As after
    ``DistributedDataParallel``'s backward, each parameter's ``.grad``
    holds the reduced gradient afterwards (whatever it held before is
    dropped), so an optimizer can step; the local gradients come from
    ``loss.backward()``, which every differentiable route takes (the
    row-major scan's reentrant checkpoint takes no other).

    The result is the mean over the padded global batch, as JAX's, on
    every rank, provided that ``loss_fn`` is a mean over rows (which is
    not checked) and that every rank holds the same number of rows (which
    is: the step raises on every rank otherwise). With W = 1 it equals
    ``loss_fn`` and autograd bit for bit; with W > 1 the sums run in
    another order than one rank's. The vector lives on the group's
    device: the card under NCCL, the host under gloo."""
    def step(params: torch.nn.Module, *batch: torch.Tensor):
        if len(batch) != n_batch_args:
            raise ValueError(f"expected {n_batch_args} batch arguments, got "
                             f"{len(batch)}")
        _check_device(mesh, *batch)
        rows = batch[0].shape[0]
        if any(b.shape[0] != rows for b in batch):
            raise ValueError("the batch arguments differ in rows")
        names, leaves = zip(*((n, p) for n, p in params.named_parameters()
                              if p.requires_grad))
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, *batch)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
        group = mesh.get_group()
        on = ("cpu" if dist.get_backend(group) == "gloo"
              else mesh_device(mesh))
        f64 = torch.float64
        vec = torch.cat([loss.detach().reshape(1).to(f64)]
                        + [g.reshape(-1).to(f64) for g in grads]
                        + [torch.tensor([rows, rows * rows], dtype=f64,
                                        device=loss.device)]).to(on)
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
        W = mesh.size()
        s1, s2 = float(vec[-2]), float(vec[-1])
        if s2 * W != s1 * s1:  # the row counts' variance times W^2
            raise ValueError(f"the ranks hold different numbers of rows "
                             f"(this rank {rows}, {s1:.0f} in all)")
        vec = (vec[:-2] / W).to(loss.device)
        out, k = [], 1
        for p, g in zip(leaves, grads):
            p.grad = vec[k:k + g.numel()].reshape(g.shape).to(g.dtype)
            out.append(p.grad)
            k += g.numel()
        Grads = NamedTuple("Grads", [(n, torch.Tensor) for n in names])
        return vec[0].to(loss.dtype), Grads(*out)

    return step
