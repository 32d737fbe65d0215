"""Camera / canvas construction (counterpart of raytracegr_jl_tpu/models/camera.py).

Pixel offsets ``(i + 1/2)/ni - 1/2`` tilt both position and normal (curved
screen); each ray's 4-velocity is the metric-normalised null vector
``(t_hat + n_hat) / sqrt(2)`` with ``t = g^-1 (1, 0, 0, 0)`` (past-pointing).

For a ``Metric`` value the normalization is one function with a
hand-written reverse (``_Camera``), per ray in M and a, the pixel batch
being data: on CUDA tensors two kernels, K8 (``pixel_rays_cuda``) and its
VJP K9 (``pixel_rays_vjp_cuda``), csrc/camera.cu, one thread per ray; on
CPU tensors their plain versions ``pixel_rays_plain`` and
``pixel_rays_vjp``. They replace the XLA fusion that the JAX package makes
of its camera and of the camera's AD. A metric function takes the plain
forward under autograd; both share its arithmetic from g on
(``null_normals``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..ops.adjoint import group_sums
from ..ops.geodesic_cm import kernel_r_mode
from ..ops.geometry import clamp_det, det3, det_min, inv4_column0
from ..ops.metrics import R_AS_WRITTEN, KerrSchildParams, Metric
from ..utils.device import resolve_device

_SQRT2 = math.sqrt(2.0)


class Canvas(NamedTuple):
    """Pixel grid: ``pos``/``normal`` are [ni, nj, 4], ``rgb`` [ni, nj, 3]."""

    pos: torch.Tensor
    normal: torch.Tensor
    rgb: torch.Tensor

    @property
    def shape(self):
        return self.pos.shape[:-1]


def quad(u, g, v):
    """``u^a g_ab v^b`` of entry lists (``u[a]``, ``g[a][b]``), the inner
    sums over b, each left to right (csrc/camera_common.cuh quad: on the
    card ``torch.einsum`` is a batched GEMM that adds in an order of its
    own)."""
    acc = None
    for a in range(4):
        gv = g[a][0] * v[0] + g[a][1] * v[1] + g[a][2] * v[2] + g[a][3] * v[3]
        acc = u[a] * gv if acc is None else acc + u[a] * gv
    return acc


def null_normals(g: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """The camera's null 4-velocities from the metric ``g [..., 4, 4]`` at
    the pixels and their tilted normals ``[..., 4]``."""
    m = [[g[..., a, b] for b in range(4)] for a in range(4)]
    n = [normal[..., c] for c in range(4)]
    t = inv4_column0(m)
    st = torch.sqrt(-quad(t, m, t))
    sn = torch.sqrt(quad(n, m, n))
    return torch.stack([(t[c] / st + n[c] / sn) / _SQRT2 for c in range(4)],
                       dim=-1)


def pixel_rays_plain(metric, pos: torch.Tensor,
                     normal: torch.Tensor) -> torch.Tensor:
    """K8's plain version: ``u [..., 4]``."""
    return null_normals(metric(pos), normal)


def _acc(acc, term):
    return term if acc is None else acc + term


def pixel_rays_vjp(metric: Metric, pos: torch.Tensor, normal: torch.Tensor,
                   ct_u: torch.Tensor) -> torch.Tensor:
    """K9's plain version: the per-ray cotangents ``(M_bar, a_bar)`` of
    ``pixel_rays_plain``'s u for the cotangent ``ct_u``, as ``[2, B]``
    over the flattened rays (M and a shared or one per ray). The forward
    is recomputed as ops/metrics.py kerr_schild and ``null_normals``
    compute it, then run in reverse: the normalization and the two
    contractions, the row-0 cofactors and the determinant (no cotangent
    where ``clamp_det`` bites, as ``torch.where``/``clamp`` give none),
    and the metric through ``clamped_rho2``'s floor and the ``textbook``
    clamps of ``kerr_schild_radius`` (``torch.maximum``'s tie split in
    half). Accumulations start from their first term; csrc/camera.cu
    k9_kernel follows this function operation by operation."""
    x = pos.reshape(-1, 4)
    nv = normal.reshape(-1, 4)
    ct = ct_u.reshape(-1, 4)
    B = x.shape[0]
    if metric.name != "kerr_schild":
        return x.new_zeros((2, B))
    M = _ray_values(metric.params.M, x)
    a = _ray_values(metric.params.a, x)
    as_written = metric.r_formula == R_AS_WRITTEN
    floored = not as_written and metric.rho_min > 0.0
    eps2 = metric.rho_min * metric.rho_min
    dmin = det_min(x.dtype)

    # The forward, as kerr_schild computes it.
    xs, ys, zs = x[:, 1], x[:, 2], x[:, 3]
    aa = a * a
    rho2_raw = xs * xs + ys * ys + zs * zs
    if as_written:
        floor = aa + eps2
        rho2 = torch.maximum(rho2_raw, floor)
    else:
        rho2 = torch.clamp_min(rho2_raw, eps2)
    half = (rho2 - aa) / 2
    inner0 = torch.sqrt(aa * zs * zs + half * half)
    if as_written:
        s = torch.sqrt(rho2 - aa)
        r = s / 2 + inner0
    else:
        h = half + (torch.clamp_min(inner0, eps2 / 2) if floored else inner0)
        r = torch.sqrt(torch.clamp_min(h, eps2) if floored else h)
    r2 = r * r
    r3 = r * r2
    two_m = 2 * M
    dn = r2 * r2 + aa * zs * zs
    f = two_m * r3 / dn
    denom = r2 + aa
    k = [None, (r * xs + a * ys) / denom, (r * ys - a * xs) / denom, zs / r]
    fk = [f] + [f * k[i] for i in range(1, 4)]
    g = [[(fk[i] * k[j] if j else fk[i]) for j in range(4)]
         for i in range(4)]
    for i in range(4):
        for j in range(4):
            g[i][j] = g[i][j] + (-1.0 if i == j == 0 else
                                 1.0 if i == j else 0.0)
    # null_normals, keeping its parts.
    cof = [((-1) ** c) * det3(g, 0, c) for c in range(4)]
    det = sum(g[0][c] * cof[c] for c in range(4))
    inv_det = 1.0 / clamp_det(det)
    t = [cof[c] * inv_det for c in range(4)]
    n = [nv[:, c] for c in range(4)]
    st = torch.sqrt(-quad(t, g, t))
    sn = torch.sqrt(quad(n, g, n))
    that = [t[c] / st for c in range(4)]
    nhat = [n[c] / sn for c in range(4)]

    # u = (that + nhat) / sqrt(2); nhat = n / sn, sn = sqrt(n.g.n); that =
    # t / st, st = sqrt(-t.g.t).
    sb = [ct[:, c] / _SQRT2 for c in range(4)]
    p = sb[0] * nhat[0] + sb[1] * nhat[1] + sb[2] * nhat[2] + sb[3] * nhat[3]
    n2b = (-p / sn) / (2 * sn)
    p = sb[0] * that[0] + sb[1] * that[1] + sb[2] * that[2] + sb[3] * that[3]
    t2b = p / st / (2 * st)
    tb = [sb[c] / st for c in range(4)]
    # The two contractions.
    ta = [t2b * t[c] for c in range(4)]
    na = [n2b * n[c] for c in range(4)]
    gb = [[ta[i] * t[j] + na[i] * n[j] for j in range(4)] for i in range(4)]
    for b in range(4):
        gvt = g[b][0] * t[0] + g[b][1] * t[1] + g[b][2] * t[2] + g[b][3] * t[3]
        tb[b] = tb[b] + t2b * gvt
        for i in range(4):
            tb[b] = tb[b] + ta[i] * g[i][b]
    # t = cof / clamp_det(det), det = g[0] . cof.
    cb = [tb[c] * inv_det for c in range(4)]
    p = tb[0] * cof[0] + tb[1] * cof[1] + tb[2] * cof[2] + tb[3] * cof[3]
    dcb = -(p * (inv_det * inv_det))
    passes = torch.where(det < 0, det <= -dmin, det >= dmin)
    detb = torch.where(passes, dcb, 0.0)
    for c in range(4):
        gb[0][c] = gb[0][c] + detb * cof[c]
        cb[c] = cb[c] + detb * g[0][c]
    # The cofactors: det3 of rows 1, 2, 3 without column c.
    for c in range(4):
        d = cb[c] if c % 2 == 0 else -cb[c]
        c0, c1, c2 = [j for j in range(4) if j != c]
        A, B_, C = g[1][c0], g[1][c1], g[1][c2]
        D, E, F = g[2][c0], g[2][c1], g[2][c2]
        G, H, I_ = g[3][c0], g[3][c1], g[3][c2]
        gb[1][c0] = gb[1][c0] + d * (E * I_ - F * H)
        gb[1][c1] = gb[1][c1] + -(d * (D * I_ - F * G))
        gb[1][c2] = gb[1][c2] + d * (D * H - E * G)
        p1b, p2b, p3b = d * A, -(d * B_), d * C
        gb[2][c0] = gb[2][c0] + (p2b * I_ + p3b * H)
        gb[2][c1] = gb[2][c1] + (p1b * I_ - p3b * G)
        gb[2][c2] = gb[2][c2] + -(p1b * H + p2b * G)
        gb[3][c0] = gb[3][c0] + -(p2b * F + p3b * E)
        gb[3][c1] = gb[3][c1] + (p3b * D - p1b * F)
        gb[3][c2] = gb[3][c2] + (p1b * E + p2b * D)
    # g = eta + (f k_i) k_j, k_0 = 1.
    fb, kb = None, [None] * 4
    for i in range(4):
        for j in range(4):
            qb = gb[i][j] * k[j] if j else gb[i][j]
            fb = _acc(fb, qb * k[i] if i else qb)
            if i:
                kb[i] = kb[i] + qb * f
            if j:
                kb[j] = _acc(kb[j], gb[i][j] * fk[i])
    # k = (1, (r x + a y) / denom, (r y - a x) / denom, z / r).
    n1b = kb[1] / denom
    n2b = kb[2] / denom
    denomb = -(kb[1] * k[1] + kb[2] * k[2]) / denom
    rb = -(kb[3] * k[3]) / r
    rb = rb + n1b * xs + n2b * ys
    ab = n1b * ys - n2b * xs
    # f = 2 M r^3 / (r2^2 + a^2 z^2), denom = r2 + a^2.
    numb = fb / dn
    dnb = -(fb * f) / dn
    mb = numb * r3 * 2
    r3b = numb * two_m
    rb = rb + r3b * r2
    r2b = denomb + r3b * r
    r2b = r2b + dnb * r2 * 2
    aab = denomb + dnb * zs * zs
    rb = rb + r2b * r * 2
    # The radius.
    if as_written:
        vb = rb * 0.25 / s
        wb = rb * 0.5 / inner0
        halfb = wb * half * 2
    else:
        hb = rb * 0.5 / r
        if floored:
            hb = torch.where(h >= eps2, hb, 0.0)
            ib = torch.where(inner0 >= eps2 / 2, hb, 0.0)
        else:
            ib = hb
        wb = ib * 0.5 / inner0
        halfb = hb + wb * half * 2
    aab = aab + wb * zs * zs
    aab = aab - halfb * 0.5
    if as_written:
        rho2b = vb + halfb * 0.5
        aab = aab - vb
        floorb = torch.where(rho2_raw > floor, 0.0,
                             torch.where(rho2_raw == floor, rho2b * 0.5,
                                         rho2b))
        aab = aab + floorb
    ab = ab + aab * a * 2
    return torch.stack([mb, ab])


def _ray_values(v, x: torch.Tensor) -> torch.Tensor:
    """M or a as the camera reads it, on ``x``'s device in its dtype: one
    value (0-d) or one per ray of ``x [B, 4]`` (``[B]``); a float as a
    fill on the device (no copy from the host), a tensor's gradient
    kept."""
    t = (v.to(dtype=x.dtype, device=x.device) if isinstance(v, torch.Tensor)
         else torch.full((), float(v), dtype=x.dtype, device=x.device))
    if t.numel() == 1:
        return t.reshape(())
    if t.numel() != x.shape[0]:
        raise ValueError(f"a camera parameter takes one value or one per "
                         f"ray ({x.shape[0]}), got {tuple(t.shape)}")
    return t.reshape(-1)


def camera_args(metric: Metric, pos: torch.Tensor, normal: torch.Tensor):
    """K8's and K9's inputs: ``pos`` and ``normal`` as contiguous ``[B,
    4]``, M and a as device tensors with their strides (0 for a shared
    value, 1 for one per ray: the kernels read them by pointer, so a graph
    replay reads the live parameters), then the flags ``(kerr, r_mode)``
    and the clamp constants ``(eps2, eps2 / 2, det_min)``."""
    if pos.device.type != "cuda" or normal.device != pos.device:
        raise ValueError(f"K8 and K9 need CUDA tensors on one device, got "
                         f"{pos.device} and {normal.device}")
    if pos.dtype not in (torch.float32, torch.float64) \
            or normal.dtype != pos.dtype:
        raise TypeError(f"unsupported dtypes {pos.dtype}, {normal.dtype}")
    if pos.shape != normal.shape or pos.shape[-1] != 4:
        raise ValueError(f"bad pixel batch {tuple(pos.shape)}, "
                         f"{tuple(normal.shape)}")
    x = pos.detach().reshape(-1, 4).contiguous()
    n = normal.detach().reshape(-1, 4).contiguous()
    M = _ray_values(metric.params.M, x).detach().contiguous()
    a = _ray_values(metric.params.a, x).detach().contiguous()
    eps2 = metric.rho_min * metric.rho_min
    return (x, n, M, a, M.dim(), a.dim(),
            (int(metric.name == "kerr_schild"), kernel_r_mode(metric)),
            (eps2, eps2 / 2, det_min(pos.dtype)))


def _lib():
    from ..utils import cuda_build
    return cuda_build.load("camera")


def _launch(kernel: str, args, tensors, strides=()) -> bool:
    """Launches ``rtgr_<kernel>_f32/f64`` on ``args`` (``camera_args``'s)
    with the extra pointers ``tensors`` (K9's cotangent, then the output)
    and K9's cotangent's two ``strides`` on the current stream; raises if
    the launch fails. False for an empty batch, which launches nothing."""
    x, n, M, a, sm, sa, flags, consts = args
    B = x.shape[0]
    if B == 0:
        return False
    lib = _lib()
    fn = getattr(lib, f"rtgr_{kernel}_f32" if x.dtype == torch.float32
                 else f"rtgr_{kernel}_f64")
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (x, n, M, a, *tensors)]
    with torch.cuda.device(x.device):
        rc = fn(*ptrs, B, sm, sa, *strides, *flags, *consts,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{kernel.upper()} launch failed: CUDA error {rc}")
    return True


def pixel_rays_cuda(metric: Metric, pos: torch.Tensor,
                    normal: torch.Tensor) -> torch.Tensor:
    """K8: ``pixel_rays_plain`` in one launch on the card, one thread per
    ray (csrc/camera.cu k8_kernel), bitwise. Reads nothing back. Adds one
    to ``pixel_rays_cuda.launches`` per launch."""
    args = camera_args(metric, pos, normal)
    u = torch.empty_like(args[0])
    if _launch("k8", args, (u,)):
        pixel_rays_cuda.launches += 1
    return u.reshape(pos.shape)


pixel_rays_cuda.launches = 0


def pixel_rays_vjp_cuda(metric: Metric, pos: torch.Tensor,
                        normal: torch.Tensor,
                        ct_u: torch.Tensor) -> torch.Tensor:
    """K9: ``pixel_rays_vjp`` in one launch on the card, one thread per ray
    (csrc/camera.cu k9_kernel), bitwise: ``[2, B]``, every entry written by
    the kernel. It reads ``ct_u`` through its strides, as the caller holds
    it (the training path's is a view of its planes' gradient): the call
    copies nothing. Adds one to ``pixel_rays_vjp_cuda.launches`` per
    launch."""
    if ct_u.shape != pos.shape:
        raise ValueError(f"bad cotangent {tuple(ct_u.shape)} for "
                         f"{tuple(pos.shape)}")
    args = camera_args(metric, pos, normal)
    x = args[0]
    ct = ct_u.detach().to(x.dtype).reshape(-1, 4)
    pbar = torch.empty((2, x.shape[0]), dtype=x.dtype, device=x.device)
    if _launch("k9", args, (ct, pbar), (ct.stride(0), ct.stride(1))):
        pixel_rays_vjp_cuda.launches += 1
    return pbar


pixel_rays_vjp_cuda.launches = 0


def _cotangent(per_ray: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A parameter's cotangent from its per-ray ones: a per-ray value's as
    they are (``ops.adjoint.per_ray`` sums them per group upstream), a
    shared value's summed in float64, as ``per_ray`` sums one group."""
    if v.numel() == 1:
        return group_sums(per_ray, 1).reshape(v.shape)
    return per_ray.reshape(v.shape)


class _Camera(torch.autograd.Function):
    """``(pos, normal, M, a, metric) -> u``: K8 (CUDA tensors) or
    ``pixel_rays_plain`` forward, K9 or ``pixel_rays_vjp`` backward; M and
    a (0-d, or one per ray) take the cotangents, the pixel batch none."""

    @staticmethod
    def forward(ctx, pos, normal, M, a, metric):
        metric = metric._replace(params=KerrSchildParams(M=M, a=a))
        ctx.metric = metric
        ctx.save_for_backward(pos, normal, M, a)
        if pos.is_cuda:
            return pixel_rays_cuda(metric, pos, normal)
        return pixel_rays_plain(metric, pos, normal)

    @staticmethod
    def backward(ctx, ct_u):
        pos, normal, M, a = ctx.saved_tensors
        metric = ctx.metric._replace(params=KerrSchildParams(M=M, a=a))
        vjp = pixel_rays_vjp_cuda if pos.is_cuda else pixel_rays_vjp
        pbar = vjp(metric, pos, normal, ct_u)
        return None, None, _cotangent(pbar[0], M), _cotangent(pbar[1], a), \
            None


def pixel_rays(metric, pos: torch.Tensor, normal: torch.Tensor):
    """Null 4-velocity for pixel(s): ``[..., 4]`` positions and tilted
    normals -> (pos, u). A ``Metric`` value goes through ``_Camera`` (K8
    and K9 on CUDA tensors), whose gradients reach M and a but not the
    pixel batch, which must not require one; a metric function through
    ``null_normals`` under autograd."""
    if not isinstance(metric, Metric):
        return pos, null_normals(metric(pos), normal)
    if pos.requires_grad or normal.requires_grad:
        raise ValueError("pixel_rays of a Metric value takes the pixel batch "
                         "as data: pos and normal must not require grad")
    x, n = pos.reshape(-1, 4), normal.reshape(-1, 4)
    u = _Camera.apply(x, n, _ray_values(metric.params.M, x),
                      _ray_values(metric.params.a, x), metric)
    return pos, u.reshape(pos.shape)


def pixel_grid(pos, widthx, widthy, normal, ni: int, nj: int,
               dtype=torch.float64, device=None):
    """Pixel positions and tilted (pre-normalisation) normals, [ni, nj, 4],
    on ``device`` (the CUDA card unless another is named)."""
    device = resolve_device(device)
    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    pos, widthx, widthy, normal = t(pos), t(widthx), t(widthy), t(normal)
    dx = (torch.arange(ni, dtype=dtype, device=device) + 0.5) / ni - 0.5
    dy = (torch.arange(nj, dtype=dtype, device=device) + 0.5) / nj - 0.5
    offset = dx[:, None, None] * widthx + dy[None, :, None] * widthy
    return pos + offset, normal + offset


def make_canvas(metric, pos, widthx, widthy, normal, ni: int, nj: int,
                dtype=torch.float64, device=None) -> Canvas:
    """The ni x nj canvas of ray initial conditions, on ``device`` (the
    CUDA card unless another is named)."""
    device = resolve_device(device)
    x, n = pixel_grid(pos, widthx, widthy, normal, ni, nj, dtype, device)
    x, u = pixel_rays(metric, x, n)
    return Canvas(pos=x, normal=u,
                  rgb=torch.zeros((ni, nj, 3), dtype=dtype, device=device))
