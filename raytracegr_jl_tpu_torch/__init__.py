"""raytracegr_jl_tpu_torch — the general-relativistic ray tracer of
raytracegr_jl_tpu, ported to PyTorch with hand-written CUDA kernels for
NVIDIA Hopper (H100).

Ported so far: the forward render of the reference's examples (metrics,
camera, scene objects, the geodesic integration with K1, csrc/geodesic.cu,
optionally sorted by impact parameter, and the reference's hard shading),
the training path (pixel-loss gradients through the checkpointed adjoint
with K3 and K4, csrc/adjoint.cu, soft shading, and the Adam fit of grad.py
and inverse.py), the accretion-disk render (mid-flight compaction with
K2, csrc/compaction.cu, and gravitational-redshift shading), and the
inversion workflow: the lensing scene (``lensing_inverse_spec``), fits
with learning-rate schedules (``cosine_decay_schedule``) that resume from
a checkpoint (``fit(..., opt_state=)``, utils/checkpoint.py), scene files
(models/serialize.py) and the vectorized multistart
(``fit_multistart``), whose starts share one grouped K3 and K4 launch per
Adam step; data parallelism over cards with torch.distributed
(parallel/sharding.py: the pixel batch split over ranks, the loss and
gradients all-reduced), and the generic-metric row-major route
(``backend="rowmajor"``: ``dmetric``, ``christoffel``, ``geodesic``,
``integrate_rays``) for any metric written as a function of torch ops,
and the reference's hand-rolled forward mode (``Dual``, ops/dual.py) with
the end-to-end gradient oracle built on it (ops/dual_oracle.py), which
checks the training path's gradients with a differentiation that shares
no code with them. Each kernel has its plain PyTorch version beside it. The
factories and the fits build on the CUDA card unless the caller names
another device (``device="cpu"``). Importing the package imports torch
and never jax; the CUDA kernels are built with nvcc at their first
launch.
"""

from .ops.metrics import (D, KerrSchildParams, Metric, kerr_schild,
                          make_metric, minkowski)
from .ops.dual import Dual
from .ops.geometry import Ray, christoffel, dmetric, geodesic, r2s, s2r
from .ops.integrate import IntegratorConfig, TraceResult, integrate_rays
from .ops.geodesic_cm import (impact_parameter_order, integrate_rays_cm,
                              integrate_rays_cuda)
from .models.objects import (Disk, Plane, Scene, Sphere, distances,
                             make_scene, min_distance, shade,
                             shade_soft)
from .models.camera import Canvas, make_canvas
from .models.shading import g_factors, keplerian_velocity, shade_redshift
from .models.scenes import (SceneSpec, accretion_disk_spec, build, example1,
                            example1_spec, example2, example2_spec,
                            lensing_inverse_spec, render_spec)
from .models.serialize import (load_spec, save_spec, spec_from_dict,
                               spec_to_dict)
from .render import RenderConfig, default_tol, render_fn, trace_rays
from .ops.adjoint import integrate_rays_ckpt, integrate_rays_ckpt_cuda
from .grad import (InverseParams, default_inverse_cfg, flat_pixel_grid,
                   make_loss_fn, make_multistart_loss_fn, make_ray_loss_fn,
                   make_ray_render_for_params, make_render_for_params)
from .inverse import (FitResult, cosine_decay_schedule, fit,
                      fit_multistart)
from .compaction import (make_compact_renderer, render_compacted,
                         trace_batch_compacted)
from .utils.stats import trace_stats
from .utils.image import canvas_to_image, load_png, save_png

__version__ = "0.3.0"
