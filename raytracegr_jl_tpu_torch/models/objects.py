"""Scene objects as struct-of-arrays tensors (counterpart of
raytracegr_jl_tpu/models/objects.py).

Same semantics, reference quirks included: the sphere distance is the
quadratic form ``sign(radius) * (|x - c|^2 - radius^2)`` (negative radius =
inside-out sky sphere), the sphere colour a 12x12 lat/long checker, the
plane a time-plane in constant green, a miss is red and a hit colour is
dimmed by ``(index + 1) / N``.

The reference shading (``shade``, and ``shade_soft`` for inverse
rendering) is one function with a hand-written reverse (``_Shaded``,
``shade_reference``): on CUDA tensors two kernels, K11 (``shade_cuda``)
and its VJP K12 (``shade_vjp_cuda``), csrc/objects.cu, one thread per
ray; on CPU tensors the plain forward and its plain reverse
(``shade_vjp``, ``shade_soft_vjp``). They replace the XLA fusion that the
JAX package makes of its shading (``shade_lanes``, ``shade_soft``) and of
the shading's AD inside its jitted step. Autograd of the plain forward
stays available (the render's row-major backend takes it).
"""

from __future__ import annotations

import ctypes
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


# The dimensions of a field shared by all rays (one more with a leading ray
# axis); the other fields are ``[N]``.
FIELD_DIMS = {"pos": 2, "vel": 2}


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


def _sum_lr(terms):
    """The terms' sum, left to right from the first (K11/K12's order: on
    the card ``torch.sum`` and ``torch.einsum`` add in orders of their
    own)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def _lse_shift(z: torch.Tensor) -> torch.Tensor:
    """logsumexp's shift over the last axis: the left-to-right maximum
    (``torch.maximum``, NaN first), 0 where it is infinite, detached (the
    softmax and the logsumexp do not depend on it)."""
    m = z[..., 0]
    for j in range(1, z.shape[-1]):
        m = torch.maximum(m, z[..., j])
    return torch.where(m.abs() == math.inf, torch.zeros_like(m), m).detach()


def shade_soft(scene: Scene, x: torch.Tensor, hit_dmin: float = 0.01,
               temp: float = 0.05, smooth_colors: bool = True,
               color_freq: float = 12.0) -> torch.Tensor:
    """Differentiable shading, a smooth relaxation of ``shade``: object
    selection by a softmin over distances (softmax of -d/temp), the hit
    decision by sigmoid((hit_dmin - softmin d)/temp). Recovers ``shade``
    as temp -> 0. The softmax, its weighted colour and the logsumexp are
    written out over the objects, each sum left to right (K11's order)."""
    _, col, obj_col, p_hit = _soft_parts(scene, x, hit_dmin, temp,
                                         smooth_colors, color_freq)
    miss = _miss_colour(col)
    return p_hit[..., None] * obj_col + (1 - p_hit[..., None]) * miss


def _soft_parts(scene: Scene, x: torch.Tensor, hit_dmin: float, temp: float,
                smooth_colors: bool, color_freq: float):
    """``shade_soft`` up to its blend with red: the softmax weights
    ``w [..., N]``, the dimmed colours ``col [..., N, 3]``, their weighted
    sum ``[..., 3]`` and the hit probability ``[...]``."""
    d = distances(scene, x)
    n = scene.n_objects
    z = -d / temp
    m = _lse_shift(z)
    e = torch.exp(z - m[..., None])
    s = _sum_lr([e[..., j] for j in range(n)])
    w = e / s[..., None]
    dim = (torch.arange(n, dtype=d.dtype, device=d.device) + 1) / n
    col = colors(scene, x, smooth=smooth_colors,
                 freq=color_freq) * dim[:, None]
    obj_col = _sum_lr([w[..., j, None] * col[..., j, :] for j in range(n)])
    softmin_d = -temp * (torch.log(s) + m)
    return w, col, obj_col, torch.sigmoid((hit_dmin - softmin_d) / temp)


# ---------------------------------------------------------------------------
# The shading's hand-written reverse (K12's plain versions): per ray, the
# cotangents of the end position x and of each object's fields for a
# cotangent of the colour. Written per object, in K12's order of operations
# (csrc/objects.cu); accumulations start from zero. Where autograd of the
# plain forward forms 0 x inf, these give no cotangent: theta's at the
# poles (|z / r| >= 1, where arccos' derivative is infinite), phi's on the
# axis (x = y = 0), r's at the centre (r = 0).
# ---------------------------------------------------------------------------

# The float fields the shading reads, in K11's and K12's argument order.
SHADE_FIELDS = ("pos", "radius", "time", "r_in", "r_out", "half")
_TWO_PI = 2 * math.pi


def _object_get(scene: Scene, j: int):
    """Object j's fields as ``get(field, comp=None)``: a value, or one per
    ray of a field with a leading ray axis."""
    def get(field, comp=None):
        v = getattr(scene, field)
        return v[..., j, comp] if comp is not None else v[..., j]
    return get


def _wave_vjp(g, v, smooth: bool):
    """The cotangent of a colour channel's argument v: ``torch.remainder``
    passes it on; the smooth wave 0.5 - 0.5 cos(2 pi v) scales it by
    0.5 sin(2 pi v) 2 pi."""
    if not smooth:
        return g
    return g * (0.5 * torch.sin(_TWO_PI * v)) * _TWO_PI


def _colour_vjp(kind: int, xx, yy, zz, g, smooth: bool, freq: float):
    """The cotangents of the offsets (xx, yy, zz) for the cotangent ``g``
    (three channels) of an object's colour (``colors``) of this kind."""
    if kind == KIND_PLANE:
        zero = torch.zeros_like(xx)
        return zero, zero, zero
    phi = torch.arctan2(yy, xx)
    rho2 = xx * xx + yy * yy
    if kind == KIND_SPHERE:
        r = torch.sqrt(xx * xx + yy * yy + zz * zz)
        nz = r != 0
        safe_r = torch.where(nz, r, torch.ones_like(r))
        u = zz / safe_r
        uc = torch.clamp(u, -1.0, 1.0)
        theta = torch.arccos(uc)
        vb0 = _wave_vjp(g[0], freq * theta / math.pi, smooth)
        vb1 = _wave_vjp(g[1], freq * phi / math.pi, smooth)
        thetab = vb0 * freq / math.pi
        phib = vb1 * freq / math.pi
        ub = torch.where((u > -1) & (u < 1),
                         -(thetab / torch.sqrt(1 - uc * uc)), 0.0)
        zzb = ub / safe_r
        srb = -(ub * u) / safe_r
        qb = torch.where(nz, srb * 0.5 / safe_r, 0.0)
        tp = torch.where(rho2 != 0, phib / rho2, 0.0)
        return (qb * xx * 2 - tp * yy, qb * yy * 2 + tp * xx,
                zzb + qb * zz * 2)
    rho = torch.sqrt(rho2)
    vb0 = _wave_vjp(g[0], rho, smooth)
    vb1 = _wave_vjp(g[1], 6 * phi / math.pi, smooth)
    phib = vb1 * 6 / math.pi
    safe_rho = torch.where(rho != 0, rho, torch.ones_like(rho))
    r2b = torch.where(rho != 0, vb0 * 0.5 / safe_rho, 0.0)
    tp = torch.where(rho2 != 0, phib / rho2, 0.0)
    return (r2b * xx * 2 - tp * yy, r2b * yy * 2 + tp * xx,
            torch.zeros_like(xx))


def _max_split(a, b, g):
    """``torch.maximum(a, b)``'s cotangents for ``g``: all to the larger,
    half to each on a tie (torch's rule)."""
    half = g * 0.5
    return (torch.where(a == b, half, torch.where(a < b, 0.0, g)),
            torch.where(a == b, half, torch.where(a > b, 0.0, g)))


def _distance_vjp(kind: int, x, get, db):
    """The cotangents of an object's signed distance (``KIND_DISTANCE``)
    for ``db``: ``(tb, (dxb, dyb, dzb), {field: cotangent})``, dx.. the
    offsets from its centre, the fields those that take one."""
    if kind == KIND_PLANE:
        return db, None, {"time": -db}
    dx = x[..., 1] - get("pos", 1)
    dy = x[..., 2] - get("pos", 2)
    dz = x[..., 3] - get("pos", 3)
    if kind == KIND_SPHERE:
        r = get("radius")
        qb = db * torch.sign(r)
        return None, (qb * dx * 2, qb * dy * 2, qb * dz * 2), {
            "radius": -(qb * r * 2)}
    if kind != KIND_DISK:
        raise NotImplementedError(f"object kind {kind}: the shading's VJP "
                                  "knows the built-in kinds only")
    ro, ri, hf = get("r_out"), get("r_in"), get("half")
    rho2 = dx * dx + dy * dy
    a = rho2 - ro * ro
    b = ri * ri - rho2
    slab = torch.abs(dz) - hf
    slabb, ringb = _max_split(slab, torch.maximum(a, b), db)
    ab, bb = _max_split(a, b, ringb)
    rho2b = ab - bb
    return None, (rho2b * dx * 2, rho2b * dy * 2, slabb * torch.sign(dz)), {
        "half": -slabb, "r_out": -(ab * ro * 2), "r_in": bb * ri * 2}


def _vjp_out(x, xb, posb, fields, n: int, live):
    """``(ct_x [B, 4], {field: [B, N(, 4)]})`` from the per-object parts
    (``posb[j]``: the cotangents of object j's pos[1:3]; ``fields[j]``:
    its other fields'), zero where ``live`` is false."""
    zero = torch.zeros_like(x[..., 0])
    keep = lambda v: torch.where(live, v, zero)  # noqa: E731
    ct_x = torch.stack([keep(v) for v in xb], dim=-1)
    pos = torch.stack([torch.stack([zero] + [keep(v) for v in posb[j]],
                                   dim=-1) for j in range(n)], dim=-2)
    out = {"pos": pos}
    for f in SHADE_FIELDS[1:]:
        out[f] = torch.stack([keep(fields[j][f]) if f in fields[j] else zero
                              for j in range(n)], dim=-1)
    return ct_x, out


def shade_record(scene: Scene, x: torch.Tensor,
                 hit_dmin: float = 0.01) -> torch.Tensor:
    """K11's record of ``shade`` (K11 writes it where the shading will be
    differentiated): each ray's object, -1 for a miss, ``int8 [B]``: the
    nearest object (``torch.argmin``: the earliest index) where its
    distance is below ``hit_dmin``."""
    d = distances(scene, x)
    hit = torch.min(d, dim=-1).values < hit_dmin
    return torch.where(hit, torch.argmin(d, dim=-1), -1).to(torch.int8)


def shade_vjp(scene: Scene, x: torch.Tensor, ct: torch.Tensor,
              hit_dmin: float = 0.01, rec: torch.Tensor | None = None):
    """K12's plain version for ``shade``: the cotangents of ``x [B, 4]``
    and of the fields (per ray, ``{field: [B, N, 4] or [B, N]}``) for the
    colour's cotangent ``ct [B, 3]``. Only the chosen object's colour
    carries one, through theta, phi and the disk's rho; a miss ray, or one
    whose cotangent is zero, gets exact zeros. Given ``rec`` (the
    forward's ``shade_record``) the objects come from it and no distance
    is evaluated, bit for bit the same result."""
    kinds = object_kinds(scene)
    n = len(kinds)
    if rec is None:
        rec = shade_record(scene, x, hit_dmin)
    omin = rec.to(torch.int64)
    live = (omin >= 0) & (ct != 0).any(-1)
    dim = (omin.to(x.dtype) + 1) / n
    g = [ct[..., c] * dim for c in range(3)]
    zero = torch.zeros_like(x[..., 0])
    xb = [zero] * 4
    posb = []
    for j, kind in enumerate(kinds):
        get = _object_get(scene, j)
        rel = [x[..., c] - get("pos", c) for c in (1, 2, 3)]
        cb = _colour_vjp(kind, *rel, g, False, 12.0)
        sel = omin == j
        xb = [xb[0]] + [torch.where(sel, cb[c], xb[1 + c]) for c in range(3)]
        posb.append([torch.where(sel, -cb[c], zero) for c in range(3)])
    return _vjp_out(x, xb, posb, [{}] * n, n, live)


def shade_soft_vjp(scene: Scene, x: torch.Tensor, ct: torch.Tensor,
                   hit_dmin: float = 0.01, temp: float = 0.05,
                   color_freq: float = 12.0):
    """K12's plain version for ``shade_soft`` (smooth colours): as
    ``shade_vjp``, the gradient flowing through every object's distance
    and colour, the softmax, the logsumexp and the sigmoid. A ray whose
    cotangent is zero gets exact zeros."""
    kinds = object_kinds(scene)
    n = len(kinds)
    gets = [_object_get(scene, j) for j in range(n)]
    rels = [[x[..., c] - gets[j]("pos", c) for c in (1, 2, 3)]
            for j in range(n)]
    w, cw, obj, p = _soft_parts(scene, x, hit_dmin, temp, True, color_freq)
    w = [w[..., j] for j in range(n)]
    cw = [[cw[..., j, c] for c in range(3)] for j in range(n)]
    obj = [obj[..., c] for c in range(3)]
    dim = (torch.arange(n, dtype=x.dtype, device=x.device) + 1) / n
    # The reverse of the blend with red, the sigmoid, the softmin distance,
    # the weighted colour and the softmax.
    pb = (ct[..., 0] * obj[0] + ct[..., 1] * obj[1] + ct[..., 2] * obj[2]
          - ct[..., 0])
    objb = [ct[..., c] * p for c in range(3)]
    hb = pb * (p * (1 - p))
    lseb = -(hb / temp) * -temp
    wb = [objb[0] * cw[j][0] + objb[1] * cw[j][1] + objb[2] * cw[j][2]
          for j in range(n)]
    gsum = lseb - _sum_lr([w[j] * wb[j] for j in range(n)])
    xb = [torch.zeros_like(x[..., 0])] * 4
    posb, fields = [], []
    for j, kind in enumerate(kinds):
        db = -(w[j] * (wb[j] + gsum) / temp)
        tb, distb, fb = _distance_vjp(kind, x, gets[j], db)
        colb = [objb[c] * w[j] * dim[j] for c in range(3)]
        cb = _colour_vjp(kind, *rels[j], colb, True, color_freq)
        rel = [cb[c] if distb is None else distb[c] + cb[c] for c in range(3)]
        if tb is not None:
            xb[0] = xb[0] + tb
        xb = [xb[0]] + [xb[1 + c] + rel[c] for c in range(3)]
        posb.append([-v for v in rel])
        fields.append(fb)
    return _vjp_out(x, xb, posb, fields, n, (ct != 0).any(-1))


# ---------------------------------------------------------------------------
# K11 and K12 (csrc/objects.cu): the reference shading and its VJP on the
# card, one thread per ray, and the route between them and their plain
# versions (``_Shaded``).
# ---------------------------------------------------------------------------

MAX_SHADE_OBJECTS = 16  # csrc/geodesic_common.cuh MAX_OBJ


def shade_args(scene: Scene, x: torch.Tensor):
    """K11's and K12's inputs: ``x [B, 4]`` as the caller holds it (the
    kernels read it through its two strides: K1's ``[B, 8]`` rows, or the
    transposed ``[8, B]`` planes of the training path), each field of
    ``SHADE_FIELDS`` contiguous with a mask of those that hold one row per
    ray (bit k for field k; the kernels read a shared field with a ray
    stride of 0, so a captured graph reads the live fields), the object
    count and the kinds, 4 bits an object."""
    if x.device.type != "cuda":
        raise ValueError(f"K11 and K12 need CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 4:
        raise ValueError(f"bad end positions {tuple(x.shape)}")
    B = x.shape[0]
    kinds = object_kinds(scene)
    n = len(kinds)
    if not 1 <= n <= MAX_SHADE_OBJECTS or any(
            k not in (KIND_SPHERE, KIND_PLANE, KIND_DISK) for k in kinds):
        raise NotImplementedError(f"K11 and K12 take 1 to "
                                  f"{MAX_SHADE_OBJECTS} built-in objects, "
                                  f"got kinds {kinds}")
    fields, per_ray = [], 0
    for bit, f in enumerate(SHADE_FIELDS):
        v = getattr(scene, f).detach()
        shared = (n, 4) if f == "pos" else (n,)
        if tuple(v.shape) == (B,) + shared and v.dim() > len(shared):
            per_ray |= 1 << bit
        elif tuple(v.shape) != shared:
            raise ValueError(f"scene field {f} {tuple(v.shape)}: neither "
                             f"{shared} nor one row per ray of {B}")
        if v.dtype != x.dtype or v.device != x.device:
            raise ValueError(f"scene field {f} is {v.dtype} on {v.device}, "
                             f"the rays {x.dtype} on {x.device}")
        fields.append(v.contiguous())
    packed = sum(k << (4 * j) for j, k in enumerate(kinds))
    return x.detach(), fields, per_ray, n, packed


def _launch(kernel: str, args, tensors, hit_dmin: float, temp,
            color_freq: float) -> bool:
    """Launches ``rtgr_<kernel>_f32/f64`` on ``args`` (``shade_args``'s)
    with the extra pointers ``tensors`` (K11's rgb and record; K12's
    cotangent, record and outputs; None for a record not kept or a field's
    cotangent not wanted) on the current stream; raises if the launch
    fails. False for an empty batch."""
    x, fields, per_ray, n_obj, kinds = args
    B = x.shape[0]
    if B == 0:
        return False
    from ..utils import cuda_build
    lib = cuda_build.load("objects")
    fn = getattr(lib, f"rtgr_{kernel}_f32" if x.dtype == torch.float32
                 else f"rtgr_{kernel}_f64")
    ptrs = [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in (x, *fields, *tensors)]
    with torch.cuda.device(x.device):
        rc = fn(*ptrs, B, x.stride(0), x.stride(1), per_ray, n_obj,
                int(temp is not None), kinds, hit_dmin,
                0.0 if temp is None else temp, color_freq,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{kernel.upper()} launch failed: CUDA error {rc}")
    return True


def shade_cuda(scene: Scene, x: torch.Tensor, hit_dmin: float = 0.01,
               temp: float | None = None, color_freq: float = 12.0,
               record: bool = False):
    """K11: ``shade`` (``temp`` None) or ``shade_soft`` (smooth colours at
    ``color_freq``) of ``x [B, 4]`` in one launch on the card, one thread
    per ray (csrc/objects.cu k11_kernel), bitwise: ``(rgb [B, 3], rec)``,
    rec bitwise ``shade_record`` (which K12 reads) with ``record`` (hard
    only), else None. Reads nothing back. Adds one to
    ``shade_cuda.launches`` per launch."""
    if record and temp is not None:
        raise ValueError("the soft shading keeps no record")
    args = shade_args(scene, x)
    rgb = torch.empty((x.shape[0], 3), dtype=x.dtype, device=x.device)
    rec = (torch.empty(x.shape[0], dtype=torch.int8, device=x.device)
           if record else None)
    if _launch("k11", args, (rgb, rec), hit_dmin, temp,
               12.0 if temp is None else color_freq):
        shade_cuda.launches += 1
    return rgb, rec


shade_cuda.launches = 0


def shade_vjp_cuda(scene: Scene, x: torch.Tensor, ct: torch.Tensor,
                   hit_dmin: float = 0.01, temp: float | None = None,
                   color_freq: float = 12.0, fields=SHADE_FIELDS,
                   rec: torch.Tensor | None = None):
    """K12: ``shade_vjp`` (``temp`` None; given K11's record ``rec``,
    which it must be: it evaluates no distance) or ``shade_soft_vjp``
    (no record) in one launch on the card, one thread per ray
    (csrc/objects.cu k12_kernel), bitwise: ``(ct_x [B, 4], {field:
    per-ray cotangent})`` for the ``fields`` asked for, every entry written
    by the kernel. Adds one to ``shade_vjp_cuda.launches`` per launch."""
    args = shade_args(scene, x)
    B, n = x.shape[0], args[3]
    if tuple(ct.shape) != (B, 3):
        raise ValueError(f"bad cotangent {tuple(ct.shape)} for {B} rays")
    if temp is None and (rec is None or rec.dtype != torch.int8
                         or tuple(rec.shape) != (B,)
                         or rec.device != x.device):
        raise ValueError("K12's hard shading reads K11's record: int8 "
                         f"[{B}] on {x.device}, got "
                         f"{None if rec is None else (rec.dtype, rec.shape)}")
    if temp is not None and rec is not None:
        raise ValueError("the soft shading keeps no record")
    ct = ct.to(x.dtype).contiguous()
    new = lambda *s: torch.empty((B, n) + s, dtype=x.dtype,  # noqa: E731
                                 device=x.device)
    outs = {f: new(4) if f == "pos" else new() for f in fields}
    ct_x = torch.empty((B, 4), dtype=x.dtype, device=x.device)
    if _launch("k12", args, (ct, rec, ct_x, *(outs.get(f)
                                              for f in SHADE_FIELDS)),
               hit_dmin, temp, 12.0 if temp is None else color_freq):
        shade_vjp_cuda.launches += 1
    return ct_x, outs


shade_vjp_cuda.launches = 0


def _field_cotangent(per_ray: torch.Tensor, v: torch.Tensor,
                     field: str) -> torch.Tensor:
    """A field's cotangent from its per-ray ones: a per-ray field's as they
    are (``ops.adjoint.per_ray`` sums them per group upstream), a shared
    field's summed in float64, as ``per_ray`` sums one group."""
    if v.dim() > FIELD_DIMS.get(field, 1):
        return per_ray
    from ..ops.adjoint import group_sums
    return group_sums(per_ray, 1).reshape(v.shape)


class _Shaded(torch.autograd.Function):
    """``(x, pos, radius, time, r_in, r_out, half, scene, hit_dmin, temp,
    color_freq, keep) -> rgb``: K11 (CUDA tensors) or ``shade`` /
    ``shade_soft`` forward, K12 or ``shade_vjp`` / ``shade_soft_vjp``
    backward; x and the fields take the cotangents, each field's per ray
    where it holds one row per ray. With ``keep`` (the hard shading will
    be differentiated) the forward keeps its record for the backward
    (K11's or ``shade_record``)."""

    @staticmethod
    def forward(ctx, x, pos, radius, time, r_in, r_out, half, scene,
                hit_dmin, temp, color_freq, keep):
        fields = (pos, radius, time, r_in, r_out, half)
        scene = scene._replace(**dict(zip(SHADE_FIELDS, fields)))
        ctx.scene, ctx.opts = scene, (hit_dmin, temp, color_freq)
        ctx.save_for_backward(x, *fields)
        ctx.rec = None
        if x.is_cuda:
            rgb, ctx.rec = shade_cuda(scene, x, hit_dmin, temp, color_freq,
                                      keep)
            return rgb
        if keep:
            ctx.rec = shade_record(scene, x, hit_dmin)
        if temp is None:
            return shade(scene, x, hit_dmin)
        return shade_soft(scene, x, hit_dmin, temp, color_freq=color_freq)

    @staticmethod
    def backward(ctx, ct):
        x, *fields = ctx.saved_tensors
        scene = ctx.scene._replace(**dict(zip(SHADE_FIELDS, fields)))
        hit_dmin, temp, color_freq = ctx.opts
        wanted = [f for f, need in zip(SHADE_FIELDS,
                                       ctx.needs_input_grad[1:7]) if need]
        if x.is_cuda:
            ct_x, cts = shade_vjp_cuda(scene, x, ct, hit_dmin, temp,
                                       color_freq, wanted, ctx.rec)
        elif temp is None:
            ct_x, cts = shade_vjp(scene, x, ct, hit_dmin, ctx.rec)
        else:
            ct_x, cts = shade_soft_vjp(scene, x, ct, hit_dmin, temp,
                                       color_freq)
        grads = [_field_cotangent(cts[f], v, f) if f in wanted else None
                 for f, v in zip(SHADE_FIELDS, fields)]
        return (ct_x if ctx.needs_input_grad[0] else None, *grads, None,
                None, None, None, None)


def shade_reference(scene: Scene, x: torch.Tensor, hit_dmin: float = 0.01,
                    temp: float | None = None,
                    color_freq: float = 12.0) -> torch.Tensor:
    """The reference shading of end positions ``x [B, 4]``, ``rgb [B, 3]``:
    ``shade``, or ``shade_soft`` (smooth colours at ``color_freq``) where
    ``temp`` is set, through ``_Shaded``: K11 and K12 on CUDA tensors, the
    plain forward and VJP on CPU tensors. Gradients reach x and the scene's
    fields (per ray where a field holds one row per ray, else summed in
    float64). Where one will be taken the hard forward keeps its record
    for the VJP; a forward render keeps none."""
    fields = [getattr(scene, f) for f in SHADE_FIELDS]
    keep = temp is None and torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *fields))
    return _Shaded.apply(x, *fields, scene, hit_dmin, temp, color_freq,
                         keep)
