"""The two BVH trace kernels: build, bind and call csrc/trace.cu.

Counterpart of lighthouse2_tpu/render/kernels/trace.py, whose two Pallas
kernels (_make_closest_kernel and _make_anyhit_kernel, launched by
_trace_chunk and wrapped by trace_cluster_bvh) these replace on the BVH4
path (intersector "auto"); render/kernels/cluster.py holds their second
counterparts, which take the Pallas kernels' own inputs. Both kernels here
walk the BVH4 that bvh/wide.py packs at upload (DeviceBVH.node4, .tri4); the
CUDA source explains the design. Their plain PyTorch version is bvh/wide.py
(wide_intersect, wide_occluded), which walks the same BVH4 in the same order;
bvh/traverse.py (bvh_intersect, bvh_occluded) is the BVH2 reference that both
are checked against.

The library is built with nvcc at first use from the checkout's sources into
build/lighthouse2_tpu_torch/trace_<hash>.so (the hash covers the source and
the flags) and loaded with ctypes. Each wrapper takes the plain version for
tensors on the CPU and launches the kernel for tensors on a CUDA device; it
never falls back from one to the other. `trace_closest.launches` and
`trace_occluded.launches` count kernel launches. The same library holds the
stage marks (lh2_mark_*): launch_mark, installed here as utils/telemetry.py's
launcher, launches them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from lighthouse2_tpu_torch.bvh.traverse import DeviceBVH, check_depth
from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
from lighthouse2_tpu_torch.core.geometry import per_lane
from lighthouse2_tpu_torch.utils import telemetry

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SOURCE = os.path.join(_PKG, "csrc", "trace.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "lighthouse2_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the trace kernels are built from "
                           "csrc/trace.cu on a machine with the CUDA toolkit")
    return path


def build_library(source: str = SOURCE,
                  deps: tuple = ()) -> tuple[str, str]:
    """Compile `source` (csrc/trace.cu by default) unless this source, the
    files it includes (`deps`) and these flags were built already. Returns
    (path of the .so, the compiler's log incl. -Xptxas -v)."""
    src = b""
    for path in (source, *deps):
        with open(path, "rb") as fh:
            src += fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"{stem}_{key}.so")
    log_path = so[:-3] + ".log"
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        with open(log_path, "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    with open(log_path) as fh:
        return so, fh.read()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library()[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lh2_trace_closest.argtypes = [p] * 5 + [i] * 2 + [p] * 6
        lib.lh2_trace_closest.restype = i
        lib.lh2_trace_occluded.argtypes = [p] * 5 + [i] * 2 + [p] * 3
        lib.lh2_trace_occluded.restype = i
        lib.lh2_mark.argtypes = [i, p, p]
        lib.lh2_mark.restype = i
        lib.lh2_mark_stages.restype = ctypes.c_char_p
        if lib.lh2_mark_stages().decode().split() != list(telemetry.STAGES):
            raise RuntimeError("csrc/trace.cu numbers its stage marks "
                               f"{lib.lh2_mark_stages().decode()!r}, "
                               f"utils/telemetry.py {telemetry.STAGES}")
        _lib = lib
    return _lib


def _prepare(o, d, tmax, bvh: DeviceBVH):
    """Check the ray and BVH tensors; return (o, d, tmax) detached, tmax as
    a contiguous [N] f32. Traversal is discrete and takes no gradient on
    either route (the JAX package stop_gradients its traversal too), so a
    plain walk on the CPU never builds an autograd graph."""
    o, d = o.detach(), d.detach()
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o and d must both be [N,3], got {tuple(o.shape)} "
                         f"and {tuple(d.shape)}")
    n = o.shape[0]
    tmax = per_lane(tmax, n, o.device)
    tensors = dict(o=o, d=d, node4=bvh.node4, tri4=bvh.tri4)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if bvh.node4.dim() != 2 or bvh.node4.shape[1] != 32 \
            or bvh.tri4.dim() != 2 or bvh.tri4.shape[1] != 12:
        raise ValueError("bvh.node4 must be [M4, 32] and bvh.tri4 [T, 12]")
    for name, t in dict(tensors, tmax=tmax).items():
        if t.device != o.device:
            raise ValueError(f"{name} is on {t.device}, rays on {o.device}")
    check_depth(bvh)
    return o, d, tmax.detach().contiguous()


def _ptrs(o, d, tmax, bvh: DeviceBVH):
    for name, t in dict(o=o, d=d, node4=bvh.node4, tri4=bvh.tri4).items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in dict(node4=bvh.node4, tri4=bvh.tri4).items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    return [o.data_ptr(), d.data_ptr(), tmax.data_ptr(), bvh.node4.data_ptr(),
            bvh.tri4.data_ptr(), bvh.max_leaf, o.shape[0]]


def _check_rc(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def trace_closest(o, d, tmax, bvh: DeviceBVH, stats: bool = False):
    """Closest hit of rays o, d [N,3] with 1e-6 < t < tmax against bvh.

    Returns (t f32 [N], prim int32 [N] (-1 on a miss, then t = tmax),
    u, v f32 [N]); with stats=True also int32 [3, N] per-ray counts of
    steps, child-box tests and triangle tests over the BVH4. tmax is a
    scalar or [N];
    tmax <= 0 is a dead lane."""
    o, d, tmax = _prepare(o, d, tmax, bvh)
    if o.device.type == "cpu":
        return wide_intersect(o, d, bvh, t_max=tmax, stats=stats)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = o.shape[0]
    dev = o.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    st = torch.empty((3, n), dtype=torch.int32, device=dev) if stats else None
    rc = _load().lh2_trace_closest(
        *_ptrs(o, d, tmax, bvh), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
        v.data_ptr(), st.data_ptr() if stats else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(rc, "trace_closest")
    trace_closest.launches += 1
    return (t, prim, u, v, st) if stats else (t, prim, u, v)


def trace_occluded(o, d, tmax, bvh: DeviceBVH, stats: bool = False):
    """Any-hit: True where some triangle has 1e-6 < t < tmax. Dead lanes
    (tmax <= 0) report False. Returns bool [N] (and the int32 [3, N] counts
    with stats=True)."""
    o, d, tmax = _prepare(o, d, tmax, bvh)
    if o.device.type == "cpu":
        return wide_occluded(o, d, tmax, bvh, stats=stats)
    if o.device.type != "cuda":
        raise ValueError(f"unsupported device {o.device}")
    n = o.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    st = (torch.empty((3, n), dtype=torch.int32, device=o.device)
          if stats else None)
    rc = _load().lh2_trace_occluded(
        *_ptrs(o, d, tmax, bvh), occ.data_ptr(),
        st.data_ptr() if stats else None,
        torch.cuda.current_stream(o.device).cuda_stream)
    _check_rc(rc, "trace_occluded")
    trace_occluded.launches += 1
    return (occ, st) if stats else occ


trace_closest.launches = 0
trace_occluded.launches = 0


def launch_mark(stage: str, device):
    """utils/telemetry.py's launcher: lh2_mark_<stage> on the current stream
    of a CUDA device, adding into the device's mark buffer; nothing on any
    other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    buf = telemetry.stage_buffer(device)
    index = -1 if stage == "end" else telemetry.STAGES.index(stage)
    _check_rc(_load().lh2_mark(index, buf.data_ptr(),
                               torch.cuda.current_stream(device).cuda_stream),
              "stage mark")


telemetry.launcher = launch_mark
