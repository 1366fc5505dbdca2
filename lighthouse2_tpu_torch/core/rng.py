"""Counter-based WangHash / xorshift32 RNG, bit-exact with the JAX package.

Counterpart of lighthouse2_tpu/core/rng.py (wang_hash, xorshift32,
random_uint, random_float, path_seed, raygen_seed, frame_r0).

Deliberate difference: uint32 values are carried in int64 tensors (or
Python ints) and masked with `& 0xFFFFFFFF` after every multiply, left shift
and add — torch's uint32 dtype has no shifts, add or comparisons. Every
function accepts either an int64 tensor or a Python int.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
# float scale = 1/2^32 as used by the reference (tools_shared.h:62)
_INV_2_32 = 2.3283064365387e-10
CAM_RNG_SEED = 0x12345678  # restart value (rendercore_optix7/rendercore.cpp:633)


def wang_hash(s):
    """WangHash over uint32 (tools_shared.h:60)."""
    s = s & M32
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & M32
    s = s ^ (s >> 15)
    return s


def xorshift32(seed):
    """One xorshift32 step; returns the new seed (== the random uint)."""
    seed = seed ^ ((seed << 13) & M32)
    seed = seed ^ (seed >> 17)
    seed = seed ^ ((seed << 5) & M32)
    return seed


def random_uint(seed):
    """(new_seed, value) — reference RandomUInt updates the seed in place."""
    seed = xorshift32(seed)
    return seed, seed


def random_float(seed: torch.Tensor):
    """(new_seed, float32 in [0,1)) — reference RandomFloat."""
    seed, v = random_uint(seed)
    # a Python scalar operand: no host-to-device copy (which would
    # synchronise the stream); the product is still float32 * float32
    return seed, v.to(torch.float32) * _INV_2_32


def path_seed(path_idx, r0):
    """Per-path shade-stage seed: WangHash(pathIdx*17 + R0) (pathtracer.h:155)."""
    return wang_hash((path_idx * 17 + r0) & M32)


def raygen_seed(path_idx, sample_idx):
    """Per-path raygen seed: WangHash(pathIdx*16789 + pass*1791) (.optix.cu:111).
    An integer tensor sample_idx (the int32 sample count) is widened to
    int64 first, so that the product cannot wrap before the mask."""
    if isinstance(sample_idx, torch.Tensor):
        sample_idx = sample_idx.to(torch.int64)
    return wang_hash((path_idx * 16789 + sample_idx * 1791) & M32)


def frame_r0(cam_seed, path_length):
    """(new_cam_seed, R0): R0 = RandomUInt(camRNGseed) + pathLength * 91771
    (rendercore_optix7/rendercore.cpp:719)."""
    cam_seed, v = random_uint(cam_seed)
    return cam_seed, (v + 91771 * path_length) & M32
