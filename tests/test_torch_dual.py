"""The port's Dual-number layer (raytracegr_jl_tpu_torch/ops/dual.py).

Three kinds of check, all on the CPU:

* the JAX package's tests of its Dual layer (tests/test_dual.py), on the
  port's ``Dual``, the production derivative being the port's
  ``ops.geometry.dmetric`` (reverse mode through ``torch.func``), at the
  same bars: g rtol 1e-12 / atol 1e-14, dg rtol 1e-10 / atol 1e-12;
* every rule against JAX's on the same seeded numpy inputs (eager JAX, a
  handful of elements): bitwise where both evaluate the same correctly
  rounded operations (arithmetic, selection, comparisons, the hash), within
  4 ulp for the transcendental functions, ``sqrt``, ``pow`` and ``cbrt``
  (torch has no cbrt; the two libraries' elementary functions differ by an
  ulp or two, and the tangent rules use them once more);
* ``kerr_schild_dual`` through ``dmetric_dual`` against JAX's within 1e-13
  of each array's largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import raytracegr_jl_tpu.ops.dual as jdu  # noqa: E402
import raytracegr_jl_tpu_torch.ops.dual as du  # noqa: E402
from raytracegr_jl_tpu_torch import KerrSchildParams, kerr_schild, minkowski  # noqa: E402
from raytracegr_jl_tpu_torch.ops.dual import Dual  # noqa: E402
from raytracegr_jl_tpu_torch.ops.geometry import dmetric  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64 = torch.float64
ULP_BAR = 4
N = 9  # elements per seeded input
K = 3  # tangent width


def t(v, dtype=F64):
    return torch.as_tensor(v, dtype=dtype)


def _probe_points():
    # the reference's 7 bitmask probe points
    return t([[0.0, 2.0 * (i & 1), 2.0 * (i & 2), 2.0 * (i & 4)]
              for i in range(1, 8)])


def _ks_production(M, a, r_formula="as_written", rho_min=1e-3):
    return lambda xx: kerr_schild(xx, KerrSchildParams(M, a),
                                  r_formula=r_formula, rho_min=rho_min)


def _assert_metric_close(g1, dg1, g2, dg2):
    np.testing.assert_allclose(g1.numpy(), g2.detach().numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(dg1.numpy(), dg2.detach().numpy(),
                               rtol=1e-10, atol=1e-12)


# -- tests/test_dual.py on the port's Dual --

def test_seed_unit_basis():
    x = t([0.0, 2.0, 1.0, 3.0])
    d = du.seed(x)
    np.testing.assert_array_equal(d.val.numpy(), x.numpy())
    np.testing.assert_array_equal(d.eps.numpy(), np.eye(4))


def test_arithmetic_rules():
    x = du.seed(t([1.5, 2.0, -0.5, 3.0]))
    a, b = x[0], x[1]
    p = a * b  # product rule
    assert float(p.val) == 3.0
    np.testing.assert_allclose(p.eps.numpy(), [2.0, 1.5, 0.0, 0.0])
    q = a / b  # quotient rule
    np.testing.assert_allclose(q.eps.numpy(), [1 / 2.0, -1.5 / 4.0, 0.0, 0.0])
    # constants lift with zero tangent
    np.testing.assert_allclose((a + 2.0).eps.numpy(), [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose((2.0 - a).eps.numpy(), [-1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose((3.0 / b).eps.numpy(),
                               [0.0, -3.0 / 4.0, 0.0, 0.0])
    for n in range(5):  # literal pow ^0..^4
        np.testing.assert_allclose((a ** n).eps.numpy()[0],
                                   n * 1.5 ** (n - 1) if n else 0.0)


def test_math_functions_match_derivatives():
    d = Dual(t(0.37), t([1.0]))
    cases = [
        (du.sin, np.cos(0.37)), (du.cos, -np.sin(0.37)),
        (du.exp, np.exp(0.37)), (du.log, 1 / 0.37),
        (du.sqrt, 0.5 / np.sqrt(0.37)),
        (du.asin, 1 / np.sqrt(1 - 0.37 ** 2)),
        (du.acos, -1 / np.sqrt(1 - 0.37 ** 2)),
        (du.atan, 1 / (1 + 0.37 ** 2)),
        (du.cbrt, 1 / (3 * np.cbrt(0.37) ** 2)),
        (du.abs, 1.0),
    ]
    for fn, want in cases:
        np.testing.assert_allclose(float(fn(d).eps[0]), want, rtol=1e-12,
                                   err_msg=fn.__name__)


def test_atan2_correct_vs_bug_compatible():
    y = Dual(t(0.8), t([1.0, 0.0]))
    x = Dual(t(0.6), t([0.0, 1.0]))
    rho2 = 0.6 ** 2 + 0.8 ** 2
    np.testing.assert_allclose(du.atan2(y, x).eps.numpy(),
                               [0.6 / rho2, -0.8 / rho2], rtol=1e-12)
    # the reference's rule: x.val * y.eps undivided
    np.testing.assert_allclose(du.atan2(y, x, bug_compatible=True).eps.numpy(),
                               [0.6, -0.8 / rho2], rtol=1e-12)


def test_comparisons_primal_only_and_isless_lexicographic():
    a = Dual(t(1.0), t([5.0]))
    b = Dual(t(1.0), t([7.0]))
    assert bool(a == b)  # primal-only equality
    assert not bool(a < b)  # primal-only order
    assert bool(du.isless(a, b))  # lexicographic, val then eps
    assert not bool(du.isless(b, a))


def test_isnan_any_component():
    ok = Dual(t(1.0), t([0.0, 1.0]))
    bad_eps = Dual(t(1.0), t([np.nan, 1.0]))
    bad_val = Dual(t(np.nan), t([0.0, 1.0]))
    assert not bool(du.isnan(ok))
    assert bool(du.isnan(bad_eps))
    assert bool(du.isnan(bad_val))
    assert not bool(du.isinf(bad_eps))


def test_dual_minkowski_constant_zero_derivative():
    g, dg = du.dmetric_dual(du.minkowski_dual, torch.zeros(4, dtype=F64))
    np.testing.assert_array_equal(g.numpy(), np.diag([-1.0, 1, 1, 1]))
    np.testing.assert_array_equal(dg.numpy(), np.zeros((4, 4, 4)))
    # agrees with the production path
    g2, dg2 = dmetric(minkowski, torch.zeros(4, dtype=F64))
    np.testing.assert_array_equal(g.numpy(), g2.numpy())
    np.testing.assert_array_equal(dg.numpy(), dg2.numpy())


@pytest.mark.parametrize("r_formula", ["as_written", "textbook"])
@pytest.mark.parametrize("M,a", [(1.0, 0.0), (1.3, 0.8)])
def test_dual_kerr_schild_matches_dmetric(r_formula, M, a):
    """The hand-rolled forward mode against the production dmetric at the
    reference's 7 probe points."""
    x = _probe_points()
    g1, dg1 = du.dmetric_dual(
        lambda d: du.kerr_schild_dual(d, M, a, r_formula=r_formula), x)
    g2, dg2 = dmetric(_ks_production(M, a, r_formula), x)
    _assert_metric_close(g1, dg1, g2, dg2)


def test_dual_batched_evaluation():
    """Duals carry batch shapes: one call evaluates all probe points."""
    xs = _probe_points()
    g, dg = du.dmetric_dual(lambda d: du.kerr_schild_dual(d, 1.0, 0.0), xs)
    assert g.shape == (7, 4, 4) and dg.shape == (7, 4, 4, 4)
    g0, dg0 = du.dmetric_dual(lambda d: du.kerr_schild_dual(d, 1.0, 0.0),
                              xs[0])
    np.testing.assert_allclose(g[0].numpy(), g0.numpy(), rtol=1e-12)
    np.testing.assert_allclose(dg[0].numpy(), dg0.numpy(), rtol=1e-12)


def test_getitem_nondiagonal_eps():
    """d[..., i] selects coordinate i's tangent row, not tangent component
    i: only an asymmetric eps tells them apart."""
    val = t([1.0, 2.0, 3.0])
    eps = t([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]])
    d = Dual(val, eps)
    d1 = d[..., 1]
    np.testing.assert_array_equal(d1.val.numpy(), 2.0)
    np.testing.assert_array_equal(d1.eps.numpy(), [4.0, 5.0, 6.0])
    # a reversal keeps the rows with their coordinates
    dr = d[..., torch.tensor([2, 1, 0])]
    np.testing.assert_array_equal(dr.val.numpy(), [3.0, 2.0, 1.0])
    np.testing.assert_array_equal(dr.eps.numpy(), eps.numpy()[::-1])
    # plain int / leading-axis indexing
    b = Dual(torch.stack([val, val + 10]), torch.stack([eps, eps * 2]))
    np.testing.assert_array_equal(b[1].eps.numpy(), eps.numpy() * 2)


def test_pow_zero_and_one_at_zero_base():
    """x**0 is the constant 1 with zero tangent even at x = 0 (the
    reference's literal_pow guard)."""
    d = Dual(t([0.0, 2.0]), t([[1.0, 0.0], [0.0, 1.0]]))
    p0 = d ** 0
    np.testing.assert_array_equal(p0.val.numpy(), [1.0, 1.0])
    assert np.all(p0.eps.numpy() == 0.0)
    p1 = d ** 1
    np.testing.assert_array_equal(p1.val.numpy(), d.val.numpy())
    np.testing.assert_array_equal(p1.eps.numpy(), d.eps.numpy())


def test_kerr_schild_dual_rho_clamp_matches_production():
    """The oracle shares the production rho_min clamp, tangents included,
    near the origin."""
    near_origin = t([0.0, 1e-5, -2e-5, 5e-6])
    g1, dg1 = du.dmetric_dual(lambda d: du.kerr_schild_dual(d, 1.0, 0.0),
                              near_origin)
    g2, dg2 = dmetric(_ks_production(1.0, 0.0), near_origin)
    _assert_metric_close(g1, dg1, g2, dg2)
    # clamp_min's tangent is torch.maximum's against a constant
    x = t([0.5, 2.0, 1.0])  # below / above / at the threshold
    c = du.clamp_min(Dual(x, torch.eye(3, dtype=F64)), 1.0)
    xr = x.clone().requires_grad_()
    torch.maximum(xr, t(1.0)).sum().backward()
    np.testing.assert_array_equal(c.val.numpy(), np.maximum(x.numpy(), 1.0))
    np.testing.assert_allclose(c.eps.sum(-1).numpy(), xr.grad.numpy())


def test_inv_ldiv_rpow_tail_api():
    """inv, ldiv (a \\ b) and base ** Dual."""
    x = Dual(t(2.0), t([1.0, 0.5, 0.0, 0.0]))
    y = Dual(t(3.0), t([0.0, 1.0, 2.0, 0.0]))
    iv, ref = du.inv(x), 1.0 / x
    np.testing.assert_allclose(float(iv.val), float(ref.val), rtol=1e-15)
    np.testing.assert_allclose(iv.eps.numpy(), ref.eps.numpy(), rtol=1e-15)
    for a, b in [(x, y), (2.0, y), (x, 3.0)]:  # all three overloads
        ld = du.ldiv(a, b)
        q = (b / a) if isinstance(b, Dual) else du.lift(b, a) / a
        np.testing.assert_allclose(float(ld.val), float(q.val), rtol=1e-15)
        np.testing.assert_allclose(ld.eps.numpy(), q.eps.numpy(), rtol=1e-15)
    r = 5.0 ** y  # d/dt b^y = b^y log(b) y'
    np.testing.assert_allclose(float(r.val), 5.0 ** 3.0, rtol=1e-12)
    np.testing.assert_allclose(r.eps.numpy(), (5.0 ** 3.0) * np.log(5.0)
                               * y.eps.numpy(), rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_hash_isequal_contract(dtype):
    """Structural equality over (val, eps); equal pairs hash equal, an eps
    change changes the hash of its element only. At f32 too (the JAX
    package's 32-bit configuration)."""
    a = Dual(t([1.0, 2.0], dtype), t([[0.1, 0.2], [0.3, 0.4]], dtype))
    b = Dual(t([1.0, 2.0], dtype), t([[0.1, 0.2], [0.3, 0.4]], dtype))
    c = Dual(t([1.0, 2.0], dtype), t([[0.1, 0.2], [0.3, 0.5]], dtype))
    assert bool(du.isequal(a, b).all())
    assert not bool(du.isequal(a, c).all())
    ha, hb, hc = du.hash_dual(a), du.hash_dual(b), du.hash_dual(c)
    assert ha.dtype == torch.int64
    assert bool(((ha >= 0) & (ha < 2 ** 32)).all())
    assert bool((ha == hb).all())
    assert bool(ha[1] != hc[1])
    assert bool(ha[0] == hc[0])


def test_kerr_schild_dual_textbook_ring_floor_matches_production():
    """The textbook branch applies the production's rho_min floor near the
    ring singularity (z = 0, rho = |a|), so the two agree there too. On
    the ring itself forward mode takes sqrt's tangent at 0 (0 * inf): the
    Dual's dg is NaN there, as the JAX package's forward-mode dmetric's
    is, while the port's reverse-mode dmetric stays finite. There the Dual
    is held to JAX's dmetric, NaNs included."""
    from raytracegr_jl_tpu import KerrSchildParams as JParams
    from raytracegr_jl_tpu import dmetric as jdmetric
    from raytracegr_jl_tpu import kerr_schild as jkerr_schild

    M, a, rho_min = 1.0, 0.8, 0.25
    pts = t([[0.0, a, 0.0, 0.0],  # on the ring
             [0.0, a + 0.05, 0.0, 0.01],  # just outside
             [0.0, a - 0.05, 0.0, -0.02],  # just inside
             [0.0, 0.6, 0.5, 0.001]])  # near the ring, off-axis
    for i, x in enumerate(pts):
        g1, dg1 = du.dmetric_dual(
            lambda d: du.kerr_schild_dual(d, M, a, r_formula="textbook",
                                          rho_min=rho_min), x)
        g2, dg2 = dmetric(_ks_production(M, a, "textbook", rho_min), x)
        if i == 0:
            assert bool(torch.isnan(dg1).all())
            g2, dg2 = (torch.from_numpy(np.array(v)) for v in jdmetric(
                lambda xx: jkerr_schild(xx, JParams(M, a),
                                        r_formula="textbook",
                                        rho_min=rho_min),
                jnp.asarray(x.numpy())))
        _assert_metric_close(g1, dg1, g2, dg2)


# -- numpy scalars --

def test_numpy_scalar_defers_to_dual():
    """A numpy scalar on the left of an operator defers to the Dual's
    reflected method (a tuple would be broadcast as a 2-array)."""
    d = Dual(t([1.5, -2.0]), t([[1.0, 0.0], [0.0, 1.0]]))
    for out, want in ((np.float64(2.0) * d, 2.0 * d),
                      (np.float64(2.0) + d, 2.0 + d),
                      (np.float64(2.0) - d, 2.0 - d),
                      (np.float64(2.0) / d, 2.0 / d),
                      (d * np.float64(2.0), d * 2.0)):
        assert isinstance(out, Dual)
        assert torch.equal(out.val, want.val)
        assert torch.equal(out.eps, want.eps)


# -- every rule against JAX's, on the same seeded inputs --

def _inputs(dtype, seed=0):
    """Seeded numpy inputs: ``a`` in (-0.9, 0.9) with an exact tie at
    0.3 (clamp_min) and at b's value (comparisons), ``b`` away from 0,
    ``p`` positive, ``x [N, 4]``."""
    rng = np.random.default_rng(seed)
    npd = np.float64 if dtype == torch.float64 else np.float32

    def dual(v):
        return v.astype(npd), rng.normal(size=(N, K)).astype(npd)

    av = rng.uniform(-0.9, 0.9, N)
    bv = rng.uniform(0.5, 2.0, N) * rng.choice([-1.0, 1.0], N)
    av[0] = 0.3
    av[1] = bv[1]
    a, b, p = dual(av), dual(bv), dual(rng.uniform(0.2, 3.0, N))
    b[1][1, 0] = a[1][1, 0]  # val and the first tangent tie: eps decides
    return a, b, p, rng.normal(size=(N, 4)).astype(npd)


BITWISE = {
    "add": lambda m, a, b, p, x: a + b,
    "sub": lambda m, a, b, p, x: a - b,
    "mul": lambda m, a, b, p, x: a * b,
    "div": lambda m, a, b, p, x: a / b,
    "neg": lambda m, a, b, p, x: -a,
    "radd": lambda m, a, b, p, x: 2.5 + a,
    "rsub": lambda m, a, b, p, x: 2.5 - a,
    "rmul": lambda m, a, b, p, x: 2.5 * a,
    "rdiv": lambda m, a, b, p, x: 2.5 / b,
    "inv": lambda m, a, b, p, x: m.inv(b),
    "ldiv": lambda m, a, b, p, x: m.ldiv(b, a),
    "abs": lambda m, a, b, p, x: m.abs(a),
    "lift": lambda m, a, b, p, x: m.lift(1.7, a),
    "seed": lambda m, a, b, p, x: m.seed(x),
    "getitem": lambda m, a, b, p, x: m.seed(x)[..., 2],
    "constant": lambda m, a, b, p, x: m.constant(a.val, K),
    "where_dual": lambda m, a, b, p, x: m.where_dual(a.val > 0, a, b),
    "clip_dual": lambda m, a, b, p, x: m.clip_dual(a, -0.5, 0.5),
    "clamp_min": lambda m, a, b, p, x: m.clamp_min(a, 0.3),
    "mod1": lambda m, a, b, p, x: m.mod1(4.0 * b),
    "minkowski_dual": lambda m, a, b, p, x: m.minkowski_dual(m.seed(x))[0][0],
    "cmp": lambda m, a, b, p, x: (a == b, a != b, a < b, a <= b, a > b,
                                  a >= b),
    "isequal": lambda m, a, b, p, x: (m.isequal(a, b), m.isequal(a, a)),
    "isless": lambda m, a, b, p, x: (m.isless(a, b), m.isless(b, a)),
    "isnan_isinf": lambda m, a, b, p, x: (m.isnan(m.log(a)),
                                          m.isinf(1.0 / (a - a))),
    "hash_dual": lambda m, a, b, p, x: (m.hash_dual(a), m.hash_dual(b)),
}
ULPS = {
    "acos": lambda m, a, b, p, x: m.acos(a),
    "asin": lambda m, a, b, p, x: m.asin(a),
    "atan": lambda m, a, b, p, x: m.atan(b),
    "atan2": lambda m, a, b, p, x: m.atan2(a, b),
    "atan2_bug": lambda m, a, b, p, x: m.atan2(a, b, bug_compatible=True),
    "cbrt": lambda m, a, b, p, x: m.cbrt(b),
    "cos": lambda m, a, b, p, x: m.cos(b),
    "sin": lambda m, a, b, p, x: m.sin(b),
    "exp": lambda m, a, b, p, x: m.exp(b),
    "log": lambda m, a, b, p, x: m.log(p),
    "sqrt": lambda m, a, b, p, x: m.sqrt(p),
    "pow2": lambda m, a, b, p, x: b ** 2,
    "pow3": lambda m, a, b, p, x: b ** 3,
    "pow_half": lambda m, a, b, p, x: p ** 0.5,
    "rpow": lambda m, a, b, p, x: 1.7 ** a,
    "pow_dual": lambda m, a, b, p, x: p ** a,
}


def _run(fn, lib, inputs):
    """``fn`` on the port's (lib "torch") or JAX's Dual layer; the outputs
    as a flat list of numpy arrays (val and eps of each Dual)."""
    if lib == "torch":
        m, dual, arr = du, du.Dual, torch.from_numpy
    else:
        m, dual, arr = jdu, jdu.Dual, jnp.asarray
    a, b, p, x = inputs
    out = fn(m, dual(arr(a[0]), arr(a[1])), dual(arr(b[0]), arr(b[1])),
             dual(arr(p[0]), arr(p[1])), arr(x))
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat += [o.val, o.eps] if isinstance(o, (du.Dual, jdu.Dual)) else [o]
    return [np.asarray(o).astype(np.int64) if np.asarray(o).dtype == np.uint32
            else np.asarray(o) for o in flat]


def _ulps(x: np.ndarray, y: np.ndarray) -> int:
    """The largest distance in units in the last place between two float
    arrays (their bit patterns in lexicographic order; NaNs must agree)."""
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
    ok = ~np.isnan(x)
    ints = np.int64 if x.dtype == np.float64 else np.int32

    def ordered(v):
        i = v[ok].view(ints).astype(np.int64)
        return np.where(i < 0, np.iinfo(ints).min - i, i)

    d = np.abs(ordered(x) - ordered(y))
    return int(d.max()) if d.size else 0


def _bits(v: np.ndarray) -> np.ndarray:
    """A float array's bit patterns (so that NaNs and signed zeros count);
    other arrays as they are."""
    if v.dtype.kind != "f":
        return v
    return np.ascontiguousarray(v).view(np.int64 if v.itemsize == 8
                                        else np.int32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("rule", list(BITWISE))
def test_rule_bitwise_equal_to_jax(rule, dtype):
    inputs = _inputs(dtype)
    got, want = (_run(BITWISE[rule], lib, inputs) for lib in ("torch", "jax"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=rule)


@pytest.mark.parametrize("rule", list(ULPS))
def test_rule_within_ulps_of_jax(rule):
    inputs = _inputs(torch.float64)
    got, want = (_run(ULPS[rule], lib, inputs) for lib in ("torch", "jax"))
    for g, w in zip(got, want):
        assert _ulps(g, w) <= ULP_BAR, (rule, _ulps(g, w))


@pytest.mark.parametrize("r_formula", ["as_written", "textbook"])
@pytest.mark.parametrize("M,a", [(1.0, 0.0), (1.3, 0.8)])
def test_kerr_schild_dual_matches_jax(r_formula, M, a):
    x = _probe_points()
    g1, dg1 = du.dmetric_dual(
        lambda d: du.kerr_schild_dual(d, M, a, r_formula=r_formula), x)
    g2, dg2 = jdu.dmetric_dual(
        lambda d: jdu.kerr_schild_dual(d, M, a, r_formula=r_formula),
        jnp.asarray(x.numpy()))
    for mine, ref in ((g1, g2), (dg1, dg2)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=1e-13 * np.abs(ref).max())
