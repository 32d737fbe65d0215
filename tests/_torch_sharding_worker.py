"""Worker of tests/test_torch_sharding.py: one rank of a gloo group on the
CPU (no jax). Runs the port's sharded training step and sharded render
and prints one ``RESULT {json}`` line for the parent to compare across
ranks and with the JAX package's values.

* The training step: ``sharded_value_and_grad`` of ``make_ray_loss_fn``
  on example2 at 16x8, f64, ``default_inverse_cfg(max_steps=32,
  rk4_dt=0.3)``, M = 1.02, against the JAX package's target image
  (``target`` of the reference file), the rows placed by
  ``global_pixels``. The rays each rank's plain route integrates are
  counted (``integrate_rays_ckpt`` wrapped).
* The render: example1 at 9x6, f64, RK4 at a step of 0.1, through
  ``shard_pixels``, ``sharded_render``, ``gather_rows`` and
  ``crop_rows``, against the same render in one piece.

Usage: python tests/_torch_sharding_worker.py <rank> <world> <port> <ref.npz>
"""

import json
import os
import sys

rank, world, port = (int(v) for v in sys.argv[1:4])
ref_path = sys.argv[4]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import raytracegr_jl_tpu_torch as T  # noqa: E402
from raytracegr_jl_tpu_torch import render as render_mod  # noqa: E402
from raytracegr_jl_tpu_torch.parallel import sharding as S  # noqa: E402

torch.set_num_threads(1)
assert S.init_distributed(f"localhost:{port}", world, rank, device="cpu")
mesh = S.make_mesh("cpu")
assert (mesh.get_rank(), mesh.size()) == (rank, world)
f64 = torch.float64

seen = []
plain_route = render_mod.integrate_rays_ckpt


def counted_route(metric, scene, y0, *args, **kw):
    seen.append(y0.shape[0])
    return plain_route(metric, scene, y0, *args, **kw)


render_mod.integrate_rays_ckpt = counted_route

spec = T.example2_spec(16, 8)
cfg = T.default_inverse_cfg(f64, max_steps=32, rk4_dt=0.3)
xg, ng = T.flat_pixel_grid(spec, f64, "cpu")
target = np.load(ref_path)["target"]
batch = S.global_pixels(mesh, xg.numpy(), ng.numpy(), target)
step = S.sharded_value_and_grad(T.make_ray_loss_fn(spec, cfg, 2, f64, "cpu"),
                                mesh)
params = T.InverseParams(1.02, 0.0, [0.0, 4.0, 0.0, 0.0], f64, "cpu")
loss, g = step(params, *batch)

spec1 = T.example1_spec(9, 6)
metric, scene, canvas = T.build(spec1, f64, "cpu")
render = T.render_fn(metric, scene, T.RenderConfig(
    integrator=T.IntegratorConfig(method="rk4", rk4_dt=0.1)))
single = render(canvas.pos, canvas.normal)
pos, normal = S.shard_pixels(mesh, canvas.pos, canvas.normal)
(rgb,) = S.crop_rows(spec1.ni, S.gather_rows(
    mesh, S.sharded_render(render, mesh)(pos, normal)))

print("RESULT " + json.dumps({
    "loss": float(loss).hex(),
    "grads": {k: [float(v).hex() for v in getattr(g, k).reshape(-1)]
              for k in g._fields},
    "train_rays_seen": seen, "local_rows": batch[0].shape[0],
    "render_rows": pos.shape[0], "render_shape": list(rgb.shape),
    "render_max_diff": float((rgb - single).abs().max())}), flush=True)
torch.distributed.destroy_process_group()
