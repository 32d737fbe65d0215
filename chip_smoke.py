"""Smoke test of the PyTorch port on one CUDA card: builds K1 from
raytracegr_jl_tpu_torch/csrc, checks it against its plain PyTorch version
and against the committed golden images, times it, and drives the flagship
forward render (the reference's example2) through the CUDA kernel.

    python3 chip_smoke.py

Prints one line per phase with its result and seconds, then a JSON line
with each kernel's launches, error and times, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, and when
no CUDA device is present. Imports no jax.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

RTOL_F32 = float(torch.finfo(torch.float32).eps) ** 0.75
MIN_PIXELS_WITHIN_2LSB = 0.995  # kernel vs plain (after bitwise), goldens
REPEATS = 5


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str, t0: float, **fields) -> None:
    parts = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{name}] {parts} seconds={time.perf_counter() - t0:.3f}",
          flush=True)


def frac_within_2lsb(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels whose 8-bit colours differ by at most 2 in every
    channel."""
    from raytracegr_jl_tpu_torch.utils.image import canvas_to_image
    ia = canvas_to_image(a).astype(np.int32)
    ib = canvas_to_image(b).astype(np.int32)
    return float((np.abs(ia - ib).max(-1) <= 2).mean())


def cuda_ms(fn, repeats: int = REPEATS):
    """Median milliseconds of ``fn()`` over ``repeats`` runs after one
    warm-up, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import raytracegr_jl_tpu_torch as rt
    from raytracegr_jl_tpu_torch.models.scenes import (build, example1_spec,
                                                       example2_spec)
    from raytracegr_jl_tpu_torch.ops.geodesic_cm import (integrate_rays_cm,
                                                         integrate_rays_cuda)
    from raytracegr_jl_tpu_torch.render import initial_dt
    from raytracegr_jl_tpu_torch.utils import cuda_build

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. Device and build.
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else kind
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    tb = time.perf_counter()
    cuda_build.load("geodesic")
    build_s = time.perf_counter() - tb
    for line in cuda_build.build_log("geodesic").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip(), flush=True)
    phase("device+build", t0, card=repr(card), build_s=f"{build_s:.1f}")

    bench_cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=RTOL_F32, atol=RTOL_F32, max_steps=20_000))

    def rays(spec, dtype):
        metric, scene, canvas = build(spec, dtype, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        return metric, scene, y0

    def compare(label, spec, dtype, integ):
        """K1 against its plain version on the same (y0, dt0) on the card.
        Both round operation by operation alike (the kernel is built with
        --fmad=false), so hit, steps, y and lam must agree bitwise on every
        ray; the pixel bar is a second check. Returns max |dy|, |dlam|."""
        t0 = time.perf_counter()
        metric, scene, y0 = rays(spec, dtype)
        dt0 = initial_dt(metric, y0, integ)
        ker = integrate_rays_cuda(metric, scene, y0, dt0, integ)
        torch.cuda.synchronize()
        plain = integrate_rays_cm(metric, scene, y0, dt0, integ)
        hit_eq = (ker.hit == plain.hit)
        st_eq = (ker.steps == plain.steps)
        max_dy = float((ker.y - plain.y).abs().max())
        max_dlam = float((ker.lam - plain.lam).abs().max())
        rgb_k = rt.shade(scene, ker.y[:, :4]).reshape(spec.ni, spec.nj, 3)
        rgb_p = rt.shade(scene, plain.y[:, :4]).reshape(spec.ni, spec.nj, 3)
        within = frac_within_2lsb(rgb_k, rgb_p)
        phase(f"kernel-vs-plain {label}", t0,
              hit_agree=f"{float(hit_eq.double().mean()):.6f}",
              step_agree=f"{float(st_eq.double().mean()):.6f}",
              max_abs_dy=f"{max_dy:.3e}", max_abs_dlam=f"{max_dlam:.3e}",
              pixels_within_2lsb=f"{within:.6f}",
              hits=int(plain.hit.sum()),
              mean_steps=f"{float(plain.steps.double().mean()):.2f}",
              plain_iters=plain.n_iters)
        require(bool(hit_eq.all()), f"{label}: hit differs on "
                f"{int((~hit_eq).sum())} rays")
        require(bool(st_eq.all()), f"{label}: steps differ on "
                f"{int((~st_eq).sum())} rays")
        require(torch.equal(ker.y, plain.y) and torch.equal(ker.lam, plain.lam),
                f"{label}: y or lam not bitwise equal (max |dy| {max_dy:.3e}, "
                f"max |dlam| {max_dlam:.3e})")
        require(within >= MIN_PIXELS_WITHIN_2LSB,
                f"{label}: only {within:.4%} of pixels within 2 LSB")
        return max(max_dy, max_dlam)

    # 2. Kernel against plain version on the card. The disk scene is the
    #    only one that sends a disk object through K1; max_steps 400 bounds
    #    its horizon rays, which would run to any cap.
    compare("example2 64x64 f32", example2_spec(64, 64), torch.float32,
            bench_cfg.integrator)
    compare("example1 64x64 f64 rk4", example1_spec(64, 64), torch.float64,
            rt.IntegratorConfig(method="rk4", rtol=1e-12, atol=1e-12))
    compare("example2 32x32 f64", example2_spec(32, 32), torch.float64,
            rt.IntegratorConfig(method="tsit5", rtol=rt.default_tol(
                torch.float64), atol=rt.default_tol(torch.float64),
                max_steps=20_000))
    disk_cfg = rt.IntegratorConfig(method="tsit5", rtol=RTOL_F32,
                                   atol=RTOL_F32, max_steps=400, stop_rho=1.0)
    compare("accretion disk 64x64 f32", rt.accretion_disk_spec(64, 64),
            torch.float32, disk_cfg)
    compare("accretion disk 32x32 f64", rt.accretion_disk_spec(32, 32),
            torch.float64, disk_cfg._replace(rtol=1e-8, atol=1e-8))

    # 3. Goldens through the "cuda" backend.
    golden_cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=1e-10, atol=1e-10, max_steps=4000),
        backend="cuda")
    tol64 = rt.default_tol(torch.float64)
    ref_cfg = rt.RenderConfig(integrator=rt.IntegratorConfig(
        method="tsit5", rtol=tol64, atol=tol64, max_steps=20_000),
        backend="cuda")
    for name, spec, cfg in [
            ("golden64_e1", example1_spec(64, 64), golden_cfg),
            ("golden64_e2", example2_spec(64, 64), golden_cfg),
            ("sphere2", example2_spec(200, 200), ref_cfg),
            ("sphere", example1_spec(200, 200), ref_cfg)]:
        t0 = time.perf_counter()
        canvas = rt.render_spec(spec, torch.float64, cfg, device=dev)
        img = rt.canvas_to_image(canvas.rgb).astype(np.int32)
        gold = np.round(rt.load_png(f"scenes/{name}.png") * 255).astype(
            np.int32)
        require(img.shape == gold.shape, f"{name}: shape {img.shape}")
        n_bad = int((np.abs(img - gold).max(-1) > 2).sum())
        phase(f"golden {name}", t0, differing_pixels=n_bad,
              of=img.shape[0] * img.shape[1])
        require(n_bad <= 0.005 * img.shape[0] * img.shape[1],
                f"{name}: {n_bad} pixels differ by more than 2 LSB")

    # 4. The main path once, counted: example2 at the reference's 200x200,
    #    the bench configuration, through render_fn on CUDA tensors.
    t0 = time.perf_counter()
    metric, scene, canvas = build(example2_spec(200, 200), torch.float32, dev)
    fn = rt.render_fn(metric, scene, bench_cfg)
    integrate_rays_cuda.launches = 0
    rgb = fn(canvas.pos, canvas.normal)
    torch.cuda.synchronize()
    launches = integrate_rays_cuda.launches
    require(launches >= 1, "the main path did not launch K1")
    require(tuple(rgb.shape) == (200, 200, 3)
            and bool(torch.isfinite(rgb).all()), "bad main-path output")
    plain_fn = rt.render_fn(metric, scene,
                            bench_cfg._replace(backend="torch"))
    rgb_plain = plain_fn(canvas.pos, canvas.normal)
    within = frac_within_2lsb(rgb, rgb_plain)
    phase("main path example2 200x200 f32", t0, k1_launches=launches,
          pixels_within_2lsb_of_plain=f"{within:.6f}")
    require(within >= MIN_PIXELS_WITHIN_2LSB, "main path disagrees with plain")
    main_err = compare("example2 200x200 f32 (the main path's shape)",
                       example2_spec(200, 200), torch.float32,
                       bench_cfg.integrator)

    # 5. Times (bench configuration: f32, tsit5, eps^(3/4), 20000 steps).
    timings = {}
    for n in (200, 1024):
        t0 = time.perf_counter()
        metric, scene, canvas = build(example2_spec(n, n), torch.float32, dev)
        y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
        dt0 = initial_dt(metric, y0, bench_cfg.integrator)
        fn = rt.render_fn(metric, scene, bench_cfg)
        k_ms = cuda_ms(lambda: integrate_rays_cuda(
            metric, scene, y0, dt0, bench_cfg.integrator))
        r_ms = cuda_ms(lambda: fn(canvas.pos, canvas.normal))
        timings[n] = (k_ms, r_ms)
        phase(f"time {n}x{n} f32", t0, card=repr(card),
              k1_ms=f"{k_ms:.4f}", k1_rays_per_s=f"{n * n / k_ms * 1e3:.1f}",
              render_ms=f"{r_ms:.4f}",
              render_rays_per_s=f"{n * n / r_ms * 1e3:.1f}")
    t0 = time.perf_counter()
    metric, scene, canvas = build(example2_spec(200, 200), torch.float32, dev)
    y0 = torch.cat([canvas.pos, canvas.normal], -1).reshape(-1, 8)
    dt0 = initial_dt(metric, y0, bench_cfg.integrator)
    plain_ms = cuda_ms(lambda: integrate_rays_cm(
        metric, scene, y0, dt0, bench_cfg.integrator))
    phase("time 200x200 f32 plain", t0, card=repr(card),
          plain_ms=f"{plain_ms:.4f}",
          plain_rays_per_s=f"{200 * 200 / plain_ms * 1e3:.1f}")

    print(json.dumps({"kernels": [{
        "name": "K1 integrate_rays_cuda",
        "route": "cuda",
        "source": "raytracegr_jl_tpu_torch/csrc/geodesic.cu",
        "replaces": "raytracegr_jl_tpu/ops/pallas_geodesic.py:1231",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": timings[200][0],
        "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
