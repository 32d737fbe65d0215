"""The port's data parallelism (raytracegr_jl_tpu_torch/parallel/
sharding.py) on the CPU: the row split against the JAX package's
``shard_pixels``/``global_pixels``/``crop_rows`` shard by shard, and two
gloo processes (tests/_torch_sharding_worker.py) running the sharded
training step and the sharded render.

Tolerances. The two ranks must agree bit for bit (one all-reduce gives
both the same sums). The loss within rtol 1e-12 and g.M within 1e-10 of
the JAX package's ``sharded_value_and_grad`` over its 8-device mesh on
the component-major checkpointed path (tests/test_sharding.py's f64 bar;
the values are committed in tests/torch_sharding_ref.npz, written by
tests/make_torch_slice8_ref.py); the sharded render within 1e-12 of the
render in one piece (rays are independent)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracegr_jl_tpu.parallel import sharding as J  # noqa: E402
from raytracegr_jl_tpu_torch.parallel import sharding as S  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tests' tensors are small, and under a
    parallel test run more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "torch_sharding_ref.npz")
WORLD = 2
TIMEOUT = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shards(arr) -> list:
    """A global jax.Array's shards in row order, as numpy arrays."""
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
    return [np.asarray(s.data) for s in shards]


def test_row_split_matches_jax():
    """10 rows over JAX's 8-device mesh: padded to 16 by the last row, 2
    rows per device; the port's split of (rank, world size) gives the same
    rows, and cropping the concatenation gives the array back."""
    mesh = J.make_mesh()
    W = mesh.devices.size
    assert W == 8
    a = np.arange(10 * 3, dtype=np.float64).reshape(10, 3)
    (js,) = J.shard_pixels(mesh, jnp.asarray(a))
    (jg,) = J.global_pixels(mesh, a)
    assert js.shape[0] == 16
    ours = [S.shard_rows(torch.from_numpy(a), r, W).numpy() for r in range(W)]
    ours_np = [S.shard_rows(a, r, W) for r in range(W)]
    for r, (s, g) in enumerate(zip(_shards(js), _shards(jg))):
        np.testing.assert_array_equal(ours[r], s, err_msg=f"rank {r}")
        np.testing.assert_array_equal(ours_np[r], g, err_msg=f"rank {r}")
    (jc,) = J.crop_rows(10, js)
    (tc,) = S.crop_rows(10, torch.from_numpy(np.concatenate(ours)))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_two_gloo_processes():
    worker = os.path.join(HERE, "_torch_sharding_worker.py")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(WORLD), str(port), REF],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
            assert lines, out
            results.append(json.loads(lines[0][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    a, b = results
    # Bit for bit on both ranks.
    assert a["loss"] == b["loss"] and a["grads"] == b["grads"]
    # Each rank's plain route saw its half of the 128 rays, once.
    for r in results:
        assert r["local_rows"] == 64 and r["train_rays_seen"] == [64]
        assert r["render_rows"] == 5 and r["render_shape"] == [9, 6, 3]
        assert r["render_max_diff"] <= 1e-12
    ref = np.load(REF)
    loss = float.fromhex(a["loss"])
    np.testing.assert_allclose(loss, float(ref["loss"]), rtol=1e-12)
    g = {k: np.array([float.fromhex(v) for v in vals])
         for k, vals in a["grads"].items()}
    np.testing.assert_allclose(g["M"][0], float(ref["M"]), rtol=1e-10)
    assert loss > 0 and g["M"][0] != 0.0
