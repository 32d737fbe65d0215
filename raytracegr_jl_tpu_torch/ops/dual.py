"""Forward-mode dual numbers with vector-valued tangents, in PyTorch
(counterpart of raytracegr_jl_tpu/ops/dual.py, the reference's L0 layer).

The port's compute paths do not need it: the kernels carry hand-derived
adjoints and the row-major route differentiates with ``torch.func``. It
exists because the reference exports ``Dual`` as public API, and because a
hand-rolled forward mode shares no code with either, so it is an
independent check of both (ops/dual_oracle.py).

* ``Dual`` holds two tensors: ``val`` of any shape ``S`` and ``eps`` of
  shape ``S + (K,)``. The K-wide tangent travels as a trailing axis, so
  every rule is elementwise over whole batches.
* Each rule is the JAX package's expression, operation for operation, so
  that the two agree bitwise where the operations are correctly rounded.
* ``atan2(..., bug_compatible=True)`` reproduces the reference's wrong
  two-argument rule (its ``x.val .* y.eps`` term is not divided by rho2);
  the default is the correct rule.
* Comparisons (``==``, ``<``, ...) compare primals only, as the
  reference's do, so that error-control logic sees primal values.
* Constants are lifted with ``full_like``, never with a host-to-device
  copy, so that no rule waits on the card.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


class Dual:
    """Forward-mode number: primal ``val`` [...S] + tangent ``eps`` [...S, K].

    A class with slots rather than a tuple: numpy would broadcast a numpy
    scalar against a tuple's two fields (``np.float64(2.0) * d`` as a 2x2
    array) where it should defer to ``__rmul__``; ``__array_ufunc__ =
    None`` makes numpy defer."""

    __slots__ = ("val", "eps")
    __array_ufunc__ = None

    def __init__(self, val: torch.Tensor, eps: torch.Tensor):
        self.val = val
        self.eps = eps

    def __repr__(self) -> str:
        return f"Dual(val={self.val!r}, eps={self.eps!r})"

    # -- arithmetic --
    def __neg__(self):
        return Dual(-self.val, -self.eps)

    def __pos__(self):
        return self

    def __add__(self, o):
        o = lift(o, self)
        return Dual(self.val + o.val, self.eps + o.eps)

    __radd__ = __add__

    def __sub__(self, o):
        o = lift(o, self)
        return Dual(self.val - o.val, self.eps - o.eps)

    def __rsub__(self, o):
        return lift(o, self).__sub__(self)

    def __mul__(self, o):
        o = lift(o, self)
        return Dual(self.val * o.val,
                    self.eps * o.val[..., None] + self.val[..., None] * o.eps)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = lift(o, self)
        inv_v = 1.0 / o.val
        q = self.val * inv_v
        return Dual(q, (self.eps - q[..., None] * o.eps) * inv_v[..., None])

    def __rtruediv__(self, o):
        return lift(o, self).__truediv__(self)

    def __pow__(self, n):
        # Dual exponents: a^b = exp(b log a).
        if isinstance(n, Dual):
            return exp(n * log(self))
        # The reference's literal_pow guards: the general rule would give
        # 0 * val**-1 = NaN tangents at val == 0.
        if not hasattr(n, "shape"):
            if n == 0:
                return Dual(torch.ones_like(self.val),
                            torch.zeros_like(self.eps))
            if n == 1:
                return self
        dval = n * self.val ** (n - 1)
        return Dual(self.val ** n, dval[..., None] * self.eps)

    def __rpow__(self, base):
        return lift(base, self).__pow__(self)

    # -- comparisons: primal only --
    def __eq__(self, o):  # type: ignore[override]
        return self.val == (o.val if isinstance(o, Dual) else o)

    def __ne__(self, o):  # type: ignore[override]
        return self.val != (o.val if isinstance(o, Dual) else o)

    def __lt__(self, o):
        return self.val < (o.val if isinstance(o, Dual) else o)

    def __le__(self, o):
        return self.val <= (o.val if isinstance(o, Dual) else o)

    def __gt__(self, o):
        return self.val > (o.val if isinstance(o, Dual) else o)

    def __ge__(self, o):
        return self.val >= (o.val if isinstance(o, Dual) else o)

    def __getitem__(self, idx):
        # Indexes the batch shape. eps has one more trailing axis than val,
        # so the index is padded with a full slice: otherwise ``d[..., i]``
        # would pick tangent component i instead of coordinate i's row.
        tidx = idx if isinstance(idx, tuple) else (idx,)
        return Dual(self.val[idx], self.eps[tidx + (slice(None),)])


def lift(c, like: Dual) -> Dual:
    """Promote a constant to a Dual with zero tangent, shaped like ``like``
    (the reference's promote_rule/convert pairs)."""
    if isinstance(c, Dual):
        return c
    if isinstance(c, torch.Tensor):
        v = c.to(like.val.device, like.val.dtype).expand(like.val.shape)
    else:
        v = torch.full_like(like.val, c)
    return Dual(v, torch.zeros_like(like.eps))


def seed(x: torch.Tensor) -> Dual:
    """Seed coordinates with the unit tangent basis e_1..e_K: ``x [..., K]``
    gives a Dual whose component i (``d[..., i]``) carries tangent e_i, as
    the reference's dmetric seeds them."""
    k = x.shape[-1]
    basis = torch.eye(k, dtype=x.dtype, device=x.device)
    return Dual(x, basis.expand(x.shape + (k,)))


def constant(x: torch.Tensor, k: int) -> Dual:
    """A Dual carrying value ``x`` and a zero K-wide tangent."""
    return Dual(x, torch.zeros(x.shape + (k,), dtype=x.dtype,
                               device=x.device))


def _chain(v: torch.Tensor, dv: torch.Tensor, x: Dual) -> Dual:
    return Dual(v, dv[..., None] * x.eps)


# -- math functions --

def abs(x: Dual) -> Dual:  # noqa: A001 - the reference's name
    return _chain(torch.abs(x.val), torch.sign(x.val), x)


def acos(x: Dual) -> Dual:
    return _chain(torch.acos(x.val), -1.0 / torch.sqrt(1.0 - x.val ** 2), x)


def asin(x: Dual) -> Dual:
    return _chain(torch.asin(x.val), 1.0 / torch.sqrt(1.0 - x.val ** 2), x)


def atan(x: Dual) -> Dual:
    return _chain(torch.atan(x.val), 1.0 / (1.0 + x.val ** 2), x)


def atan2(y: Dual, x: Dual, *, bug_compatible: bool = False) -> Dual:
    """Two-argument arctangent, tangent ``(x dy - y dx) / (x^2 + y^2)``.
    ``bug_compatible=True`` gives the reference's rule, which divides only
    the ``y.val * x.eps`` term by rho2."""
    rho2 = x.val ** 2 + y.val ** 2
    v = torch.atan2(y.val, x.val)
    if bug_compatible:
        e = x.val[..., None] * y.eps - (y.val / rho2)[..., None] * x.eps
    else:
        e = (x.val[..., None] * y.eps - y.val[..., None] * x.eps) \
            / rho2[..., None]
    return Dual(v, e)


def _cbrt(v: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): ``|v|^(1/3)`` with its sign, then
    one Newton step, which takes the pow's error (1/3 is not a double) to
    about an ulp. Zeros and non-finite values keep the pow's result."""
    y = torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)
    y2 = y * y
    step = y - (y2 * y - v) / (3.0 * y2)
    return torch.where((y != 0) & torch.isfinite(step), step, y)


def cbrt(x: Dual) -> Dual:
    v = _cbrt(x.val)
    return _chain(v, 1.0 / (3.0 * v * v), x)


def cos(x: Dual) -> Dual:
    return _chain(torch.cos(x.val), -torch.sin(x.val), x)


def exp(x: Dual) -> Dual:
    v = torch.exp(x.val)
    return _chain(v, v, x)


def log(x: Dual) -> Dual:
    return _chain(torch.log(x.val), 1.0 / x.val, x)


def sin(x: Dual) -> Dual:
    return _chain(torch.sin(x.val), torch.cos(x.val), x)


def sqrt(x: Dual) -> Dual:
    v = torch.sqrt(x.val)
    return _chain(v, 0.5 / v, x)


def isnan(x: Dual) -> torch.Tensor:
    """NaN if the primal or any tangent component is NaN."""
    return torch.isnan(x.val) | torch.isnan(x.eps).any(-1)


def isinf(x: Dual) -> torch.Tensor:
    """Inf-ness of the primal only."""
    return torch.isinf(x.val)


def inv(x: Dual) -> Dual:
    """``1/(a + eps b) = (a - eps b)/a^2``."""
    iv = 1.0 / x.val
    return Dual(iv, (-(iv * iv))[..., None] * x.eps)


def ldiv(a, b):
    """Julia's left division ``a \\ b == b / a``; either argument may be a
    constant (at least one is a Dual, as in the reference's three
    overloads)."""
    if isinstance(a, Dual):
        return lift(b, a).__truediv__(a)
    return b.__truediv__(lift(a, b))


_FNV_PRIME = 0x01000193
_WORD = 0xFFFFFFFF


def _words(v: torch.Tensor):
    """The 32-bit words of ``v``'s bit patterns as int64 in [0, 2^32), low
    word first for 8-byte floats (the order of JAX's bitcast to uint32)."""
    n = v.element_size() // 4
    w = v.contiguous().reshape(-1, 1).view(torch.int32).to(torch.int64)
    w = (w & _WORD).reshape(v.shape + (n,))
    return [w[..., i] for i in range(n)]


def hash_dual(x: Dual) -> torch.Tensor:
    """Deterministic elementwise hash of val and eps: 32-bit FNV-1a over
    the components' bit patterns (an 8-byte float folds as two 32-bit
    words), seeded with the reference's 0xdccda268; equal (val, eps) pairs
    hash equal. The JAX package's recipe, bit for bit, computed in int64
    masked to 32 bits and returned as int64 in [0, 2^32)."""
    h = torch.full(x.val.shape, 0xdccda268, dtype=torch.int64,
                   device=x.val.device)
    for i in range(x.eps.shape[-1]):
        for w in _words(x.eps[..., i]):
            h = ((h ^ w) * _FNV_PRIME) & _WORD
    for w in _words(x.val):
        h = ((h ^ w) * _FNV_PRIME) & _WORD
    return h


def isequal(a: Dual, b: Dual) -> torch.Tensor:
    """Structural equality: val and every eps component (``==`` is
    primal-only)."""
    return (a.val == b.val) & (a.eps == b.eps).all(-1)


def isless(a: Dual, b: Dual) -> torch.Tensor:
    """Lexicographic (val, then eps) strict order."""
    val_lt = a.val < b.val
    val_eq = a.val == b.val
    eps_lt = torch.zeros_like(val_lt)
    eps_eq = torch.ones_like(val_eq)
    for i in range(a.eps.shape[-1]):
        eps_lt = eps_lt | (eps_eq & (a.eps[..., i] < b.eps[..., i]))
        eps_eq = eps_eq & (a.eps[..., i] == b.eps[..., i])
    return val_lt | (val_eq & eps_lt)


# -- metrics on duals: an oracle for the derivatives of the other paths --

def minkowski_dual(x: Dual) -> list:
    """Minkowski on duals: a 4x4 nested list of Duals (constant metric)."""
    k = x.eps.shape[-1]
    zero = constant(torch.zeros_like(x.val[..., 0]), k)
    sgn = [-1.0, 1.0, 1.0, 1.0]
    return [[zero + sgn[a] if a == b else zero for b in range(4)]
            for a in range(4)]


def where_dual(cond: torch.Tensor, a, b) -> Dual:
    """``torch.where`` over Duals: selects val and tangent by the primal
    mask; constants lift with zero tangent."""
    if not isinstance(a, Dual):
        a = lift(a, b)
    if not isinstance(b, Dual):
        b = lift(b, a)
    return Dual(torch.where(cond, a.val, b.val),
                torch.where(cond[..., None], a.eps, b.eps))


def clip_dual(x: Dual, lo: float, hi: float) -> Dual:
    """Clip with the tangent passing strictly inside and zero where
    clamped."""
    return where_dual(x.val < lo, lift(lo, x),
                      where_dual(x.val > hi, lift(hi, x), x))


def mod1(x: Dual) -> Dual:
    """``x mod 1`` with the sign of the divisor (``torch.remainder``, as
    ``jnp.mod``); unit tangent almost everywhere (the checker sawtooth)."""
    return Dual(torch.remainder(x.val, 1.0), x.eps)


def clamp_min(x: Dual, c: float) -> Dual:
    """``maximum(x, c)`` for a constant c with ``jnp.maximum``'s tangent:
    passed where val > c, zero where val < c, halved at exact ties."""
    v = torch.clamp_min(x.val, c)
    w = torch.where(x.val > c, 1.0, torch.where(x.val < c, 0.0, 0.5)
                    ).to(x.val.dtype)
    return Dual(v, w[..., None] * x.eps)


def kerr_schild_dual(x: Dual, M=1.0, a=0.0, *,
                     r_formula: str = "as_written",
                     rho_min: float = 1e-3) -> list:
    """Kerr-Schild g_ab = eta_ab + f k_a k_b with every scalar operation a
    Dual rule: independent of ``dmetric``'s automatic differentiation, with
    the same ``rho_min`` clamps and their tangents, so that the two agree
    at every point."""
    k = x.eps.shape[-1]
    xs, ys, zs = x[..., 1], x[..., 2], x[..., 3]
    rho2 = xs * xs + ys * ys + zs * zs
    # as_written takes sqrt(rho2 - a^2), so it floors at a^2 + rho_min^2.
    floor = rho_min * rho_min + (a * a if r_formula == "as_written" else 0.0)
    rho2 = clamp_min(rho2, floor)
    half = (rho2 - a * a) / 2.0
    inner = sqrt(half * half + (a * a) * (zs * zs))
    if r_formula == "as_written":
        r = sqrt(rho2 - a * a) / 2.0 + inner
    else:
        # The textbook radius's ring-singularity floor (inner >= rho_min^2
        # / 2, r^2 >= rho_min^2), as metrics.kerr_schild_radius.
        if rho_min > 0.0:
            eps2 = rho_min * rho_min
            inner = clamp_min(inner, eps2 / 2.0)
            r = sqrt(clamp_min(half + inner, eps2))
        else:
            r = sqrt(half + inner)
    r2 = r * r
    f = (2.0 * M) * (r * r2) / (r2 * r2 + (a * a) * (zs * zs))
    one = constant(torch.ones_like(x.val[..., 0]), k)
    denom = r2 + a * a
    kvec = [one,
            (r * xs + a * ys) / denom,
            (r * ys - a * xs) / denom,
            zs / r]
    eta = [-1.0, 1.0, 1.0, 1.0]
    return [[f * kvec[a_] * kvec[b_] + (eta[a_] if a_ == b_ else 0.0)
             for b_ in range(4)] for a_ in range(4)]


def dmetric_dual(metric_dual: Callable[[Dual], list],
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The metric and its coordinate derivative through duals: seed
    e_1..e_4, evaluate the metric once, unpack ``g[a, b] = .val`` and
    ``dg[a, b, c] = .eps[c]``. Returns ``([..., 4, 4], [..., 4, 4, 4])``."""
    gd = metric_dual(seed(x))
    g = torch.stack([torch.stack([gd[a][b].val for b in range(4)], -1)
                     for a in range(4)], -2)
    dg = torch.stack([torch.stack([gd[a][b].eps for b in range(4)], -2)
                      for a in range(4)], -3)
    return g, dg
