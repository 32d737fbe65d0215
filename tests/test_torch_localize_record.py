"""The localization record (ops/adjoint.py ``REC_*``), on the CPU: what
``localize_plain`` (K6's plain version) keeps of each hit ray for the
reverse mode, and ``localize_vjp`` (K7's plain version) reading it instead
of replaying the crossing step and the bisection.

* ``localize_vjp`` given the record equals its replay route bit for bit, at
  f32 and f64, RK4 and Tsit5, on an ungrouped and on a grouped batch, and
  on the synthetic records that reach the polish's corners.
* The record holds the values ``crossing_stages`` and ``bisect_bracket``
  give: theta0, then Tsit5's k1..k7 or RK4's k1..k4, f(y1) and y1, for a
  hit ray, and zeros for any other; its shape is ``rec_planes``; and
  ``localize_events_cm(..., keep=True)`` returns those same values.
* ``step_vjp`` given the stages equals its recomputing route bit for bit.

The final states are tests/test_torch_localize.py's (the port's plain
forward at 8x8), built once per module. No JAX program runs here."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raytracegr_jl_tpu_torch.ops import adjoint as A  # noqa: E402
from raytracegr_jl_tpu_torch.ops import geodesic_cm as G  # noqa: E402
from test_torch_localize import (_cotangents, _final_state,  # noqa: E402
                                 _grouped_state, _synthetic)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F64, F32 = torch.float64, torch.float32
CASES = {
    "example2-rk4-f64": lambda: _final_state("example2", "rk4", F64, 64),
    "example2-rk4-f32": lambda: _final_state("example2", "rk4", F32, 64),
    "example2-tsit5-f64": lambda: _final_state("example2", "tsit5", F64, 48),
    "example2-tsit5-f32": lambda: _final_state("example2", "tsit5", F32, 48),
    "grouped-rk4-f64": lambda: _grouped_state("rk4", F64),
    "grouped-tsit5-f32": lambda: _grouped_state("tsit5", F32),
    "synthetic-rk4-f64": lambda: _synthetic("rk4"),
    "synthetic-tsit5-f64": lambda: _synthetic("tsit5"),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


def _bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int64 if a.dtype == F64 else torch.int32),
        b.view(torch.int64 if b.dtype == F64 else torch.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_record_route_equals_replay(case):
    """The VJP from the record (as K7 runs it) against the VJP that replays
    the crossing step, the bisection and the stages: bitwise, every plane
    and every parameter row."""
    route, P = _case(case)
    ct_y, ct_lam = _cotangents(P)
    rec = A.localize_plain(route, P)[2]
    c_rec, p_rec = A.localize_vjp(route, P, ct_y, ct_lam, rec)
    c_rep, p_rep = A.localize_vjp(route, P, ct_y, ct_lam)
    assert bool((P[A.P_HIT] > 0).any())
    assert _bits(c_rec, c_rep) and _bits(p_rec, p_rep)
    live = (P[A.P_HIT] > 0) & ((ct_y != 0).any(0) | (ct_lam != 0))
    assert bool(c_rec[A.P_EV_Y0:A.P_EV_Y0 + 8][:, live].any())


@pytest.mark.parametrize("case", ["example2-rk4-f64", "example2-tsit5-f32",
                                  "grouped-rk4-f64", "synthetic-tsit5-f64"])
def test_record_holds_the_crossing_step_and_bisection(case):
    """The record of a hit ray: theta0 from ``bisect_bracket``, then the
    crossing step's stages from ``crossing_stages`` (RK4 also f(y1) and
    y1), plane by plane; zeros for a ray that did not hit."""
    route, P = _case(case)
    tsit5 = route.cfg.method == "tsit5"
    rec = A.localize_plain(route, P)[2]
    assert rec.shape == (A.rec_planes(tsit5), P.shape[1])
    assert A.rec_planes(tsit5) == (57 if tsit5 else 49)
    metric, scene = A.route_rows(route, P.shape[1])
    st = A.unpack_state(P)
    y1, k1, k_last, ks, stages = G.crossing_stages(metric, route.cfg,
                                                   st.ev_y0, st.ev_dt)
    interp, _ = G._interpolants(st.ev_y0, y1, k1, k_last, st.ev_dt, ks, 4)
    th0 = G.bisect_bracket(G.scene_event_cm(scene), interp, route.cfg,
                           st.ev_lo, st.ev_hi)
    want = [th0[None], *stages] + ([] if tsit5 else [k_last, y1])
    assert len(stages) == (7 if tsit5 else 4)
    assert _bits(stages[0], k1) and (not tsit5 or _bits(stages[6], k_last))
    hit = st.hit
    want = torch.cat(want)
    assert _bits(rec[:, hit], want[:, hit])
    assert not bool(rec[:, ~hit].any()) and bool(hit.any())
    assert _bits(rec[A.REC_TH0, hit], th0[hit])
    kept = G.localize_events_cm(metric, G.scene_event_cm(scene), route.cfg,
                                st.ev_y0, st.ev_dt, st.ev_lo, st.ev_hi,
                                keep=True)
    assert _bits(kept[2], th0)
    assert all(_bits(a, b) for a, b in zip(kept[3][4], stages))


@pytest.mark.parametrize("method", ["rk4", "tsit5"])
def test_step_vjp_on_kept_stages_equals_recomputed(method):
    """``step_vjp`` given the stages a step computed equals its route that
    recomputes them, bit for bit, with and without injected stage
    cotangents (Tsit5), on seeded states of example2's metric at f64."""
    route, P = _case(f"example2-{method}-f64")
    metric = route.metric
    st = A.unpack_state(P)
    p = A.adj_params(metric, P.dtype, P.device)
    _, k1, _, _, stages = G.crossing_stages(metric, route.cfg, st.ev_y0,
                                            st.ev_dt)
    gen = np.random.default_rng(11)
    ct = [torch.from_numpy(gen.standard_normal(st.ev_y0.shape))
          for _ in range(8)]
    tsit5 = method == "tsit5"
    for ct_ks in ((None, ct[2:]) if tsit5 else (None,)):
        got = A.step_vjp(p, tsit5, st.ev_y0, k1, st.ev_dt, ct[0], ct[1],
                         ct_ks=ct_ks, ks=stages)
        want = A.step_vjp(p, tsit5, st.ev_y0, k1, st.ev_dt, ct[0], ct[1],
                          ct_ks=ct_ks)
        assert all(_bits(g, w) for g, w in zip(got, want))
