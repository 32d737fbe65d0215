"""Scene objects as struct-of-arrays tensors (counterpart of
raytracegr_jl_tpu/models/objects.py).

Same semantics, reference quirks included: the sphere distance is the
quadratic form ``sign(radius) * (|x - c|^2 - radius^2)`` (negative radius =
inside-out sky sphere), the sphere colour a 12x12 lat/long checker, the
plane a time-plane in constant green, a miss is red and a hit colour is
dimmed by ``(index + 1) / N``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from ..ops.metrics import D
from ..utils.device import resolve_device

KIND_SPHERE = 0
KIND_PLANE = 1
KIND_DISK = 2


class Sphere(NamedTuple):
    pos: Sequence[float]  # center x^a, length 4
    vel: Sequence[float]  # 4-velocity, length 4 (unused by distance/colour)
    radius: float  # negative => inside-out sky sphere


class Plane(NamedTuple):
    time: float


class Disk(NamedTuple):
    pos: Sequence[float]  # center x^a, length 4
    r_in: float
    r_out: float
    half: float = 0.02


class Scene(NamedTuple):
    """Struct-of-arrays over N objects, in the user's object order (which
    sets the shading dim factor and breaks distance ties). In a grouped
    batch (several parameter sets in one ray batch) a field may carry a
    leading ray axis, one row per ray: ``pos [R, N, 4]``, ``radius [R, N]``;
    the distances, events and shading broadcast over it."""

    kind: torch.Tensor  # [N] int32
    pos: torch.Tensor  # [N, 4]
    vel: torch.Tensor  # [N, 4]
    radius: torch.Tensor  # [N]
    time: torch.Tensor  # [N]
    r_in: torch.Tensor  # [N]
    r_out: torch.Tensor  # [N]
    half: torch.Tensor  # [N]

    @property
    def n_objects(self) -> int:
        return self.kind.shape[0]


def make_scene(objects: Sequence[Sphere | Plane | Disk],
               dtype=torch.float64, device=None) -> Scene:
    """Pack a heterogeneous object list into a Scene on ``device`` (the
    CUDA card unless another is named)."""
    device = resolve_device(device)
    kind, pos, vel, radius, time = [], [], [], [], []
    r_in, r_out, half = [], [], []
    for obj in objects:
        if isinstance(obj, Sphere):
            kind.append(KIND_SPHERE)
            pos.append(list(obj.pos))
            vel.append(list(obj.vel))
            radius.append(obj.radius)
            time.append(0.0)
            r_in.append(0.0), r_out.append(1.0), half.append(1.0)
        elif isinstance(obj, Plane):
            kind.append(KIND_PLANE)
            pos.append([0.0] * D)
            vel.append([0.0] * D)
            radius.append(1.0)
            time.append(obj.time)
            r_in.append(0.0), r_out.append(1.0), half.append(1.0)
        elif isinstance(obj, Disk):
            kind.append(KIND_DISK)
            pos.append(list(obj.pos))
            vel.append([1.0, 0.0, 0.0, 0.0])
            radius.append(1.0)
            time.append(0.0)
            r_in.append(obj.r_in), r_out.append(obj.r_out)
            half.append(obj.half)
        else:
            raise TypeError(f"unknown object type: {type(obj)!r}")

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    return Scene(kind=kind_tensor(kind, device), pos=t(pos), vel=t(vel),
                 radius=t(radius), time=t(time), r_in=t(r_in),
                 r_out=t(r_out), half=t(half))


def kind_tensor(kinds: Sequence[int], device=None) -> torch.Tensor:
    """The ``[N]`` int32 kind tensor of a scene, carrying its kinds as host
    ints (``host_kinds``), so that ``object_kinds`` never reads them back
    from the card."""
    t = torch.tensor(list(kinds), dtype=torch.int32, device=device)
    t.host_kinds = tuple(int(k) for k in kinds)
    return t


def object_kinds(scene: Scene) -> tuple:
    """The scene's object kinds as host ints, without a read from the card:
    the copy that ``kind_tensor`` keeps on the tensor, else the values of a
    CPU tensor. A kind tensor on the card made otherwise is read once (a
    host sync) and the copy kept on it."""
    kinds = getattr(scene.kind, "host_kinds", None)
    if kinds is not None:
        return kinds
    kinds = tuple(int(k) for k in scene.kind.tolist())
    if scene.kind.device.type != "cpu":
        scene.kind.host_kinds = kinds
    return kinds


# ---------------------------------------------------------------------------
# Per-kind signed distances: zero on the surface, positive outside. ``t, x,
# y, z`` broadcast together; ``get(field, comp=None)`` returns the object's
# parameter. Each kind also has a forward derivative (value, tangent) for
# the Newton polish of event localization; where two branches of a min or
# max tie, each takes half the tangent, as JAX's min/max derivatives do.
# ---------------------------------------------------------------------------

def _sphere_distance(t, x, y, z, get):
    dx = x - get("pos", 1)
    dy = y - get("pos", 2)
    dz = z - get("pos", 3)
    r = get("radius")
    return torch.sign(r) * (dx * dx + dy * dy + dz * dz - r * r)


def _sphere_jvp(t, x, y, z, dt, dx_, dy_, dz_, get):
    dx = x - get("pos", 1)
    dy = y - get("pos", 2)
    dz = z - get("pos", 3)
    r = get("radius")
    sgn = torch.sign(r)
    val = sgn * (dx * dx + dy * dy + dz * dz - r * r)
    tan = sgn * (2 * (dx * dx_ + dy * dy_ + dz * dz_))
    return val, tan


def _plane_distance(t, x, y, z, get):
    return t - get("time")


def _plane_jvp(t, x, y, z, dt, dx_, dy_, dz_, get):
    return t - get("time"), dt


def _disk_distance(t, x, y, z, get):
    dx = x - get("pos", 1)
    dy = y - get("pos", 2)
    dz = z - get("pos", 3)
    rho2 = dx * dx + dy * dy
    return torch.maximum(torch.abs(dz) - get("half"),
                         torch.maximum(rho2 - get("r_out") ** 2,
                                       get("r_in") ** 2 - rho2))


def balanced_max(a, da, b, db):
    """(max(a, b), its tangent), half to each side on a tie."""
    m = torch.maximum(a, b)
    wa = torch.where(a == m, torch.where(b == m, 0.5, 1.0), 0.0)
    wb = torch.where(b == m, torch.where(a == m, 0.5, 1.0), 0.0)
    return m, da * wa + db * wb


def balanced_min(a, da, b, db):
    """(min(a, b), its tangent), half to each side on a tie."""
    m = torch.minimum(a, b)
    wa = torch.where(a == m, torch.where(b == m, 0.5, 1.0), 0.0)
    wb = torch.where(b == m, torch.where(a == m, 0.5, 1.0), 0.0)
    return m, da * wa + db * wb


def _disk_jvp(t, x, y, z, dt, dx_, dy_, dz_, get):
    dx = x - get("pos", 1)
    dy = y - get("pos", 2)
    dz = z - get("pos", 3)
    rho2 = dx * dx + dy * dy
    drho2 = 2 * (dx * dx_ + dy * dy_)
    slab = torch.abs(dz) - get("half")
    dslab = torch.where(dz >= 0, dz_, -dz_)
    ring, dring = balanced_max(rho2 - get("r_out") ** 2, drho2,
                               get("r_in") ** 2 - rho2, -drho2)
    return balanced_max(slab, dslab, ring, dring)


KIND_DISTANCE = {
    KIND_SPHERE: _sphere_distance,
    KIND_PLANE: _plane_distance,
    KIND_DISK: _disk_distance,
}

KIND_DISTANCE_JVP = {
    KIND_SPHERE: _sphere_jvp,
    KIND_PLANE: _plane_jvp,
    KIND_DISK: _disk_jvp,
}


def register_kind(kind_id: int, distance_fn, distance_jvp=None) -> None:
    """Register a new object kind's signed distance (and optionally its
    forward derivative; ``torch.func.jvp`` of ``distance_fn`` otherwise).
    The plain integrator picks it up; the CUDA kernel knows only the three
    built-in kinds and raises for others."""
    KIND_DISTANCE[kind_id] = distance_fn
    if distance_jvp is None:
        def distance_jvp(t, x, y, z, dt, dx_, dy_, dz_, get):
            return torch.func.jvp(
                lambda *c: distance_fn(*c, get), (t, x, y, z),
                (dt, dx_, dy_, dz_))
    KIND_DISTANCE_JVP[kind_id] = distance_jvp


def distances(scene: Scene, x: torch.Tensor) -> torch.Tensor:
    """Signed distance of point(s) to every object: ``[..., 4] -> [..., N]``."""
    t = x[..., None, 0]
    xs, ys, zs = x[..., None, 1], x[..., None, 2], x[..., None, 3]

    def get(field, comp=None):
        arr = getattr(scene, field)
        return arr[..., comp] if comp is not None else arr

    d = None
    for kid in sorted(KIND_DISTANCE):
        dk = KIND_DISTANCE[kid](t, xs, ys, zs, get)
        d = dk if d is None else torch.where(scene.kind == kid, dk, d)
    return d


def min_distance(scene: Scene, s: torch.Tensor) -> torch.Tensor:
    """Min over objects of the distance to the ray position (``[..., 8]``)."""
    return torch.min(distances(scene, s[..., :D]), dim=-1).values


def colors(scene: Scene, x: torch.Tensor, smooth: bool = False,
           freq: float = 12.0) -> torch.Tensor:
    """RGB colour of every object at point(s) x: ``[..., 4] -> [..., N, 3]``:
    the reference's hard checker (floored modulo as ``jnp.mod``), or with
    ``smooth`` the same-period wave ``(1 - cos(2 pi t)) / 2`` for inverse
    rendering. ``freq`` scales the sphere checker (reference 12)."""
    rel = x[..., None, 1:] - scene.pos[..., 1:]
    xx, yy, zz = rel[..., 0], rel[..., 1], rel[..., 2]
    r = torch.sqrt(xx * xx + yy * yy + zz * zz)
    safe_r = torch.where(r == 0, torch.ones_like(r), r)
    theta = torch.arccos(torch.clamp(zz / safe_r, -1.0, 1.0))
    phi = torch.arctan2(yy, xx)

    def wave(v):
        if smooth:
            return 0.5 - 0.5 * torch.cos(2 * math.pi * v)
        return torch.remainder(v, 1.0)

    sphere_rgb = torch.stack([wave(freq * theta / math.pi),
                              wave(freq * phi / math.pi),
                              torch.ones_like(r)], dim=-1)
    plane_rgb = torch.stack([torch.zeros_like(r), torch.full_like(r, 0.5),
                             torch.zeros_like(r)], dim=-1)
    rho_cyl = torch.sqrt(xx * xx + yy * yy)
    disk_rgb = torch.stack([wave(rho_cyl), wave(6 * phi / math.pi),
                            torch.full_like(r, 0.9)], dim=-1)
    kind = scene.kind[:, None]
    return torch.where(kind == KIND_SPHERE, sphere_rgb,
                       torch.where(kind == KIND_PLANE, plane_rgb, disk_rgb))


def _miss_colour(like: torch.Tensor) -> torch.Tensor:
    """Red, ``[3]``, made on ``like``'s device (no copy from the host, which
    would sync it with the card)."""
    return (torch.arange(3, device=like.device) == 0).to(like.dtype)


def shade(scene: Scene, x: torch.Tensor, hit_dmin: float = 0.01) -> torch.Tensor:
    """Final ray position(s) ``[..., 4]`` -> RGB ``[..., 3]``: the object with
    the smallest distance strictly below ``hit_dmin`` (earliest index on
    ties), dimmed by ``(index + 1) / N``; red on a miss."""
    d = distances(scene, x)
    n = scene.n_objects
    hit_any = torch.min(d, dim=-1).values < hit_dmin
    omin = torch.argmin(d, dim=-1)
    col = colors(scene, x)
    col = torch.gather(col, -2, omin[..., None, None].expand(
        omin.shape + (1, 3))).squeeze(-2)
    dim = (omin.to(col.dtype) + 1) / n
    col = col * dim[..., None]
    return torch.where(hit_any[..., None], col, _miss_colour(col))


def shade_soft(scene: Scene, x: torch.Tensor, hit_dmin: float = 0.01,
               temp: float = 0.05, smooth_colors: bool = True,
               color_freq: float = 12.0) -> torch.Tensor:
    """Differentiable shading, a smooth relaxation of ``shade``: object
    selection by a softmin over distances (softmax of -d/temp), the hit
    decision by sigmoid((hit_dmin - softmin d)/temp). Recovers ``shade``
    as temp -> 0."""
    d = distances(scene, x)
    n = scene.n_objects
    w = torch.softmax(-d / temp, dim=-1)
    dim = (torch.arange(n, dtype=d.dtype, device=d.device) + 1) / n
    col = colors(scene, x, smooth=smooth_colors,
                 freq=color_freq) * dim[:, None]
    obj_col = torch.einsum("...n,...nc->...c", w, col)
    softmin_d = -temp * torch.logsumexp(-d / temp, dim=-1)
    p_hit = torch.sigmoid((hit_dmin - softmin_d) / temp)
    miss = _miss_colour(col)
    return p_hit[..., None] * obj_col + (1 - p_hit[..., None]) * miss
