"""raytracegr_jl_tpu_torch — the general-relativistic ray tracer of
raytracegr_jl_tpu, ported to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (H100).

This first slice is the forward render of the reference's examples:
metrics, camera, scene objects, the geodesic integration (K1: the CUDA
kernel csrc/geodesic.cu and its plain PyTorch version) and the reference's
hard shading. Importing the package imports torch and never jax; the CUDA
kernel is built with nvcc at its first launch.
"""

from .ops.metrics import (D, KerrSchildParams, Metric, kerr_schild,
                          make_metric, minkowski)
from .ops.integrate import IntegratorConfig, TraceResult
from .ops.geodesic_cm import integrate_rays_cm, integrate_rays_cuda
from .models.objects import (Disk, Plane, Scene, Sphere, distances,
                             make_scene, min_distance, shade)
from .models.camera import Canvas, make_canvas
from .models.scenes import (SceneSpec, accretion_disk_spec, build, example1,
                            example1_spec, example2, example2_spec,
                            render_spec)
from .render import RenderConfig, default_tol, render_fn, trace_rays
from .utils.image import canvas_to_image, load_png, save_png

__version__ = "0.1.0"
