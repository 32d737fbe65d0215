"""Build the CUDA sources under ``csrc/`` with nvcc into a shared library
with a plain C interface, and load it with ctypes.

The library goes to ``build/raytracegr_jl_tpu_torch/`` at the repo root,
named by a hash of its source and flags, so that a changed source is
rebuilt and a built one is reused. Building happens at first use and raises
on any failure: there is no fallback. The ptxas report (registers, spills
per kernel) is kept beside the library and returned by ``build_log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "raytracegr_jl_tpu_torch")
# sm_90a (Hopper). A library's source is built twice, with --fmad=false
# (every operation rounds on its own, like the plain PyTorch version the
# kernel is checked against): its f32 entry points as whole-program device
# code, its f64 ones as relocatable device code, linked to csrc/pow64.cu
# (the kernels' double pow), which is built with contraction on, as
# PyTorch's kernels are. See csrc/geodesic_common.cuh.
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_COMMON = _ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
NVCC_FLAGS = _COMMON + ("--fmad=false", "-Xptxas", "-v")
F32_FLAGS = NVCC_FLAGS + ("-DRTGR_F32=1",)
F64_FLAGS = NVCC_FLAGS + ("-rdc=true", "-DRTGR_F64=1")
POW_FLAGS = _COMMON + ("-rdc=true", "--fmad=true")
LINK_FLAGS = _ARCH + ("-shared", "-rdc=true", "-Xcompiler", "-fPIC")
# The C entry points, each returning a cudaError_t. Every one but K8's,
# K9's, K11's and K12's takes the packed parameter block (prm:
# ops/geodesic_cm.py pack_params), copies it into the library's constant
# memory on the stream and launches there. K1:
# (y0, dt0, y, lam, hit, steps, prm: pointers; n, kerr, tsit5, r_mode,
# scene, max_steps, n_obj, npts, bisect_iters: ints; stream). K2: (P_in, y0,
# dt0, P_out, y_fin, lam_fin, prm; n, kerr, tsit5, r_mode, scene, n_obj,
# npts, bisect_iters, budget, init, threads (per block); stream). K3: (y0,
# dt0 (or null), ck, used, ends, prm; n, kerr, tsit5, r_mode, scene, n_obj,
# npts, seg_len, n_seg; groups; rays_per_group, group_stride; stream).
# K4: (ck, ends, order, ct, ct0, pbar, prm; n, kerr, tsit5, r_mode, scene,
# n_obj, npts, seg_len; groups; rays_per_group, group_stride; stream). K10:
# (ck, ct0, ct_y0, pbar, prm; n, kerr, r_mode; groups; n_obj,
# rays_per_group, group_stride; stream). K4's work order: (ends, order; n,
# bins; stream).
# K6: (P, y, lam, rec, prm; n, kerr, tsit5, r_mode, scene, n_obj, npts,
# bisect_iters; groups; rays_per_group, group_stride; stream). K7: (P, rec,
# ct_y, ct_lam, ct_P, pbar, prm; the ints of K6 but bisect_iters; groups;
# rays_per_group, group_stride; stream). groups is the group table of a
# grouped launch, or null. The adjoint and localize libraries' fence around a graph replay:
# (stream). K5: (y0, y, y's plane stride
# (long long; 0 for rows), vel, rgb, prm; n, kerr, r_mode, n_obj; hit_dmin,
# beaming, exposure: doubles; stream).
# K8, K9 (no parameter block: M and a by pointer): (pos, normal, M, a, u;
# n, M's stride, a's stride, kerr, r_mode; eps2, eps2 / 2, det_min:
# doubles; stream), K9 with the cotangent after a, pbar for u, and the
# cotangent's two strides (long long) after a's stride. K11 (no parameter
# block: the scene's fields by pointer): (x, pos, radius, time, r_in,
# r_out, half, rgb, rec (K11's record, or null); n, x's two strides, the
# per-ray mask, n_obj, soft; the kinds (unsigned 64 bits); hit_dmin, temp,
# freq: doubles; stream), K12 with the cotangent, the record (hard), ct_x
# and the six fields' cotangents (or nulls) in place of rgb and rec.
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_U64, _LL = ctypes.c_ulonglong, ctypes.c_longlong
_SIGNATURES = {
    "geodesic": {name: [_P] * 7 + [_I] * 9 + [_P]
                 for name in ("rtgr_k1_f32", "rtgr_k1_f64")},
    "compaction": {name: [_P] * 7 + [_I] * 11 + [_P]
                   for name in ("rtgr_k2_f32", "rtgr_k2_f64")},
    "adjoint": {**{name: [_P] * 6 + [_I] * 9 + [_P, _I, _I, _P]
                   for name in ("rtgr_k3_f32", "rtgr_k3_f64")},
                **{name: [_P] * 7 + [_I] * 8 + [_P, _I, _I, _P]
                   for name in ("rtgr_k4_f32", "rtgr_k4_f64")},
                **{name: [_P] * 5 + [_I] * 3 + [_P, _I, _I, _I, _P]
                   for name in ("rtgr_k10_f32", "rtgr_k10_f64")},
                "rtgr_k4_order": [_P] * 2 + [_I] * 2 + [_P],
                **{name: [_P] for name in ("rtgr_fence_f32",
                                           "rtgr_fence_f64")}},
    "localize": {**{name: [_P] * 5 + [_I] * 8 + [_P, _I, _I, _P]
                    for name in ("rtgr_k6_f32", "rtgr_k6_f64")},
                 **{name: [_P] * 7 + [_I] * 7 + [_P, _I, _I, _P]
                    for name in ("rtgr_k7_f32", "rtgr_k7_f64")},
                 **{name: [_P] for name in ("rtgr_fence_f32",
                                            "rtgr_fence_f64")}},
    "shading": {name: [_P, _P, ctypes.c_longlong] + [_P] * 3 + [_I] * 4
                + [_D] * 3 + [_P]
                for name in ("rtgr_k5_f32", "rtgr_k5_f64")},
    "camera": {**{name: [_P] * 5 + [_I] * 5 + [_D] * 3 + [_P]
                  for name in ("rtgr_k8_f32", "rtgr_k8_f64")},
               **{name: [_P] * 6 + [_I] * 3 + [_LL] * 2 + [_I] * 2
                  + [_D] * 3 + [_P]
                  for name in ("rtgr_k9_f32", "rtgr_k9_f64")}},
    "objects": {**{name: [_P] * 9 + [_I] * 6 + [_U64] + [_D] * 3 + [_P]
                   for name in ("rtgr_k11_f32", "rtgr_k11_f64")},
                **{name: [_P] * 16 + [_I] * 6 + [_U64] + [_D] * 3 + [_P]
                   for name in ("rtgr_k12_f32", "rtgr_k12_f64")}},
}

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    """nvcc from PATH, else ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels cannot be built")


POW_SRC = os.path.join(CSRC, "pow64.cu")


def _paths(name: str):
    """Source, library and log paths; the name hashes the source, the
    shared headers of csrc/, pow64.cu and the flags."""
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(F32_FLAGS + F64_FLAGS + POW_FLAGS
                                     + LINK_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src, POW_SRC] + [os.path.join(CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}")
    return src, stem + ".so", stem + ".log"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an identical build exists; returns
    the library's path. Its f32 half, its f64 half and pow64.cu compile in
    parallel, then one nvcc links them. Safe to call for several names at
    once from threads: each runs its own nvcc."""
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}"
    nvcc = find_nvcc()
    objs = (f"{tmp}.f32.o", f"{tmp}.f64.o", f"{tmp}.pow.o")
    compiles = [(src, [nvcc, *F32_FLAGS, "-c", src, "-o", objs[0]]),
                (src, [nvcc, *F64_FLAGS, "-c", src, "-o", objs[1]]),
                (POW_SRC, [nvcc, *POW_FLAGS, "-c", POW_SRC, "-o", objs[2]])]
    link = ("the link", [nvcc, *LINK_FLAGS, *objs, "-o", f"{tmp}.so"])
    report = []

    def check(what, proc, out, err):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{what}:\n{err[-4000:]}")
        report.append(out + err)

    try:
        procs = [(what, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))
                 for what, cmd in compiles]
        outs = [(what, p, *p.communicate()) for what, p in procs]
        for args in outs:
            check(*args)
        proc = subprocess.run(link[1], capture_output=True, text=True)
        check(link[0], proc, proc.stdout, proc.stderr)
        with open(log, "w") as f:
            f.write("".join(report[:2]))
        os.replace(f"{tmp}.so", lib)
    finally:
        for path in objs + (f"{tmp}.so",):
            if os.path.exists(path):
                os.remove(path)
    return lib


def build_log(name: str) -> str:
    """The compiler's report of the current build of ``name``."""
    with open(_paths(name)[2]) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``'s library, with the
    argument and result types of its entry points declared."""
    lib = _libs.get(name)
    if lib is not None:  # the launch path: no hashing, no file access
        return lib
    build(name)
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
