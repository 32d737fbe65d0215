"""Scene serialization: ``SceneSpec`` <-> JSON (counterpart of
raytracegr_jl_tpu/models/serialize.py). The schema is the JAX package's,
key for key, so that a file written by one package loads in the other: a
metric name and its parameters, the radius formula, the objects, the
camera and the resolution, as plain data."""

from __future__ import annotations

import json

from .objects import Disk, Plane, Sphere
from .scenes import SceneSpec
from ..ops.metrics import KerrSchildParams


def spec_to_dict(spec: SceneSpec) -> dict:
    objs = []
    for o in spec.objects:
        if isinstance(o, Sphere):
            objs.append({"type": "sphere", "pos": list(o.pos),
                         "vel": list(o.vel), "radius": float(o.radius)})
        elif isinstance(o, Plane):
            objs.append({"type": "plane", "time": float(o.time)})
        elif isinstance(o, Disk):
            objs.append({"type": "disk", "pos": list(o.pos),
                         "r_in": float(o.r_in), "r_out": float(o.r_out),
                         "half": float(o.half)})
        else:
            raise TypeError(f"unknown object: {o!r}")
    return {
        "metric": spec.metric_name,
        "params": {"M": float(spec.metric_params.M),
                   "a": float(spec.metric_params.a)},
        "r_formula": spec.r_formula,
        "objects": objs,
        "camera": {"pos": list(spec.cam_pos), "widthx": list(spec.cam_widthx),
                   "widthy": list(spec.cam_widthy),
                   "normal": list(spec.cam_normal)},
        "resolution": [spec.ni, spec.nj],
    }


def spec_from_dict(d: dict) -> SceneSpec:
    objs = []
    for o in d["objects"]:
        if o["type"] == "sphere":
            objs.append(Sphere(pos=tuple(o["pos"]), vel=tuple(o["vel"]),
                               radius=o["radius"]))
        elif o["type"] == "plane":
            objs.append(Plane(time=o["time"]))
        elif o["type"] == "disk":
            objs.append(Disk(pos=tuple(o["pos"]), r_in=o["r_in"],
                             r_out=o["r_out"], half=o["half"]))
        else:
            raise ValueError(f"unknown object type: {o['type']!r}")
    cam = d["camera"]
    return SceneSpec(
        metric_name=d["metric"],
        metric_params=KerrSchildParams(M=d["params"]["M"], a=d["params"]["a"]),
        r_formula=d.get("r_formula", "as_written"),
        objects=tuple(objs),
        cam_pos=tuple(cam["pos"]),
        cam_widthx=tuple(cam["widthx"]),
        cam_widthy=tuple(cam["widthy"]),
        cam_normal=tuple(cam["normal"]),
        ni=d["resolution"][0],
        nj=d["resolution"][1],
    )


def save_spec(path: str, spec: SceneSpec) -> str:
    with open(path, "w") as f:
        json.dump(spec_to_dict(spec), f, indent=2)
    return path


def load_spec(path: str) -> SceneSpec:
    with open(path) as f:
        return spec_from_dict(json.load(f))
