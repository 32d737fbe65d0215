"""Scene JSON across the two packages: the port's models/serialize.py
writes the JAX package's schema key for key, so a scene saved by either
loads in the other (equal dicts, equal specs), for example1, example2, the
accretion disk and the lensing scene of the inversion."""

import json

import pytest

torch = pytest.importorskip("torch")

from raytracegr_jl_tpu.models import scenes as j_scenes  # noqa: E402
from raytracegr_jl_tpu.models import serialize as j_ser  # noqa: E402
import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch.models import serialize as t_ser  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPECS = {
    "example1": (lambda: j_scenes.example1_spec(16, 8),
                 lambda: T.example1_spec(16, 8)),
    "example2": (lambda: j_scenes.example2_spec(12, 24, M=1.2, a=0.5,
                                                r_formula="textbook"),
                 lambda: T.example2_spec(12, 24, M=1.2, a=0.5,
                                         r_formula="textbook")),
    "disk": (lambda: j_scenes.accretion_disk_spec(32, 32),
             lambda: T.accretion_disk_spec(32, 32)),
    "lensing": (lambda: j_scenes.lensing_inverse_spec(8, 8),
                lambda: T.lensing_inverse_spec(8, 8)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_dicts_equal_across_packages(name):
    j_spec, t_spec = (f() for f in SPECS[name])
    d = t_ser.spec_to_dict(t_spec)
    assert d == j_ser.spec_to_dict(j_spec)
    assert json.dumps(d, sort_keys=True) == json.dumps(
        j_ser.spec_to_dict(j_spec), sort_keys=True)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_dict_roundtrip_both_ways(name):
    """The port reads JAX's dict back to its own spec, and JAX reads the
    port's dict back to JAX's; each round trip returns the spec."""
    j_spec, t_spec = (f() for f in SPECS[name])
    from_j = t_ser.spec_from_dict(j_ser.spec_to_dict(j_spec))
    assert from_j == t_spec
    assert type(from_j) is type(t_spec)
    assert all(type(a) is type(b) for a, b in zip(from_j.objects,
                                                  t_spec.objects))
    assert j_ser.spec_from_dict(t_ser.spec_to_dict(t_spec)) == j_spec
    assert t_ser.spec_from_dict(t_ser.spec_to_dict(t_spec)) == t_spec


@pytest.mark.parametrize("name", sorted(SPECS))
def test_files_load_in_the_other_package(tmp_path, name):
    j_spec, t_spec = (f() for f in SPECS[name])
    tp, jp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert t_ser.save_spec(tp, t_spec) == tp
    j_ser.save_spec(jp, j_spec)
    assert j_ser.load_spec(tp) == j_spec
    assert t_ser.load_spec(jp) == t_spec
    with open(tp) as a, open(jp) as b:
        assert json.load(a) == json.load(b)


def test_built_scene_from_a_loaded_file(tmp_path):
    """A scene loaded from a file builds the same arrays as the spec it
    was saved from."""
    spec = T.lensing_inverse_spec(8, 8)
    back = T.load_spec(T.save_spec(str(tmp_path / "s.json"), spec))
    _, scene_a, canvas_a = T.build(spec, torch.float64, "cpu")
    _, scene_b, canvas_b = T.build(back, torch.float64, "cpu")
    assert torch.equal(canvas_a.pos, canvas_b.pos)
    assert torch.equal(canvas_a.normal, canvas_b.normal)
    for f in scene_a._fields:
        assert torch.equal(getattr(scene_a, f), getattr(scene_b, f)), f


def test_unknown_object_type_is_refused():
    d = t_ser.spec_to_dict(T.example1_spec(4, 4))
    d["objects"][0]["type"] = "torus"
    with pytest.raises(ValueError):
        t_ser.spec_from_dict(d)
    with pytest.raises(TypeError):
        t_ser.spec_to_dict(T.example1_spec(4, 4)._replace(objects=(1,)))
