"""The native (C++) SAH builder: built at first use, loaded with ctypes.

Counterpart of lighthouse2_tpu/native/__init__.py (load, available,
build_sah_bvh_native) over a copy of its bvh_builder.cpp, compiled with the
same command (g++ -O3 -std=c++17 -shared -fPIC) so that both packages build
the same tree on one machine. Deliberate differences:
  - the library goes to build/lighthouse2_tpu_torch/ (beside the nvcc
    library), named by a hash of the source, the compiler and the flags; no
    environment variable moves it (the JAX package reads LH2_NATIVE_CACHE);
  - no silent fallback: a failed build or load raises RuntimeError with the
    compiler's message, where the JAX package returns None and its
    build_sah_bvh then builds the numpy tree (it also reads LH2_NO_NATIVE);
  - the compiler is an argument (default "g++").
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "bvh_builder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "lighthouse2_tpu_torch")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
ABI_VERSION = 1

_libs: dict = {}


def build_library(compiler: str = CXX) -> str:
    """Compile bvh_builder.cpp unless this source was built with this
    compiler and these flags already; returns the .so path."""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(
        src + " ".join([compiler, *CXX_FLAGS]).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"bvh_builder_{key}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([compiler, *CXX_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler!r} to build "
                               f"{SOURCE}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {SOURCE}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    return so


def load(compiler: str = CXX) -> ctypes.CDLL:
    """The native library (built if needed); raises RuntimeError if it
    cannot be built or loaded."""
    so = build_library(compiler)
    lib = _libs.get(so)
    if lib is None:
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"cannot load {so}: {e}") from e
        lib.lh2_native_abi_version.restype = ctypes.c_int
        abi = lib.lh2_native_abi_version()
        if abi != ABI_VERSION:
            raise RuntimeError(f"{so} has ABI {abi}, not {ABI_VERSION}")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.lh2_build_bvh.restype = ctypes.c_int32
        lib.lh2_build_bvh.argtypes = [
            f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, i32p, i32p, i32p, i32p, ctypes.c_int32]
        _libs[so] = lib
    return lib


def available(compiler: str = CXX) -> bool:
    """Whether the native builder builds and loads here (the port uses it
    for no fallback: build_sah_bvh still raises when it cannot)."""
    try:
        load(compiler)
    except RuntimeError:
        return False
    return True


def build_sah_bvh_native(v0, v1, v2, max_leaf: int = 4, bins: int = 8,
                         compiler: str = CXX) -> dict:
    """The native twin of bvh/builder.py build_sah_bvh_numpy: the same flat
    dict layout. Raises RuntimeError where the JAX package returns None."""
    lib = load(compiler)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    t = v0.shape[0]
    cap = max(2 * t, 2)
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim = np.empty(max(t, 1), np.int32)
    n = lib.lh2_build_bvh(v0, v1, v2, t, max_leaf, bins,
                          nmin, nmax, left, right, count, prim, cap)
    if n <= 0:
        raise RuntimeError(f"the native builder failed on {t} triangles "
                           f"(returned {n})")
    return dict(nmin=nmin[:n].copy(), nmax=nmax[:n].copy(),
                left=left[:n].copy(), right=right[:n].copy(),
                count=count[:n].copy(), prim=prim.copy(),
                n_nodes=int(n), n_prims=t)
