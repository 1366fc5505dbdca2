"""Blue-noise low-discrepancy sampler (the BLUENOISE feature of the optix7
core — optix/.optix.cu:72-79, tools_shared.h:335-350).

Counterpart of lighthouse2_tpu/core/bluenoise.py (generate_mask, get_mask,
sample): a 128x128 void-and-cluster rank mask built deterministically in
numpy, R2 sequences per dimension, Cranley-Patterson rotation by the mask at
a per-dimension toroidal shift of the pixel. Bit-exact with the JAX package.

Difference: the mask is cached under build/lighthouse2_tpu_torch/ in the
repository checkout, and `device_mask` keeps one tensor per device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from lighthouse2_tpu_torch.device import resolve_device

MASK_N = 128
_SIGMA = 1.9          # Ulichney's recommended gaussian sigma
# R2 additive-recurrence alphas (generalized golden ratio, d=2)
_PLASTIC = 1.32471795724474602596
_ALPHA = (1.0 / _PLASTIC, 1.0 / (_PLASTIC * _PLASTIC))
_SHIFT_X = 59
_SHIFT_Y = 83
_CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "build", "lighthouse2_tpu_torch")


def _wrapped_gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    ax = np.arange(n)
    d = np.minimum(ax, n - ax).astype(np.float64)
    g1 = np.exp(-(d * d) / (2 * sigma * sigma))
    return np.outer(g1, g1)


def generate_mask(n: int = MASK_N, seed: int = 0x1337,
                  initial_fraction: float = 0.1) -> np.ndarray:
    """Void-and-cluster (Ulichney 1993) toroidal blue-noise rank mask.
    Returns [n,n] float32 in [0,1) (rank / n^2). Deterministic."""
    rng = np.random.RandomState(seed)
    total = n * n
    kern = _wrapped_gaussian_kernel(n, _SIGMA)

    def splat(energy, x, y, sign):
        energy += sign * np.roll(np.roll(kern, x, axis=0), y, axis=1)

    # phase 0: random initial pattern + relaxation
    ones = int(total * initial_fraction)
    pattern = np.zeros((n, n), bool)
    idx = rng.choice(total, ones, replace=False)
    pattern.flat[idx] = True
    energy = np.zeros((n, n))
    for x, y in zip(*np.nonzero(pattern)):
        splat(energy, x, y, +1.0)
    big = 1e18
    for _ in range(total):
        e1 = np.where(pattern, energy, -big)
        cx, cy = np.unravel_index(np.argmax(e1), (n, n))
        pattern[cx, cy] = False
        splat(energy, cx, cy, -1.0)
        e0 = np.where(pattern, big, energy)
        vx, vy = np.unravel_index(np.argmin(e0), (n, n))
        if (vx, vy) == (cx, cy):
            pattern[cx, cy] = True
            splat(energy, cx, cy, +1.0)
            break
        pattern[vx, vy] = True
        splat(energy, vx, vy, +1.0)

    rank = np.zeros((n, n), np.int32)
    # phase 1: rank the initial ones by removing tightest clusters
    pat = pattern.copy()
    e = energy.copy()
    for r in range(ones - 1, -1, -1):
        e1 = np.where(pat, e, -big)
        cx, cy = np.unravel_index(np.argmax(e1), (n, n))
        pat[cx, cy] = False
        splat(e, cx, cy, -1.0)
        rank[cx, cy] = r
    # phase 2/3: fill largest voids upward
    pat = pattern.copy()
    e = energy.copy()
    for r in range(ones, total):
        e0 = np.where(pat, big, e)
        vx, vy = np.unravel_index(np.argmin(e0), (n, n))
        pat[vx, vy] = True
        splat(e, vx, vy, +1.0)
        rank[vx, vy] = r
    return (rank.astype(np.float32) + 0.5) / np.float32(total)


_cached_mask = None
_device_masks: dict = {}


def get_mask() -> np.ndarray:
    """The process-wide mask, generated once and cached on disk."""
    global _cached_mask
    if _cached_mask is not None:
        return _cached_mask
    path = os.path.join(_CACHE_DIR, f"bluenoise_{MASK_N}.npy")
    if os.path.exists(path):
        _cached_mask = np.load(path)
    else:
        _cached_mask = generate_mask()
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, _cached_mask)
        os.replace(tmp, path)
    return _cached_mask


def device_mask(device=None) -> torch.Tensor:
    """The mask as a float32 tensor on `device` (default: the card),
    uploaded once per device."""
    if device is None:
        device = resolve_device()
    key = str(device)
    if key not in _device_masks:
        _device_masks[key] = torch.from_numpy(get_mask()).to(device)
    return _device_masks[key]


def sample(mask, x, y, sample_idx, dim):
    """blueNoiseSampler analog: [0,1) for pixel (x,y), sample, dimension.

    x, y, dim are integer tensors (or ints); sample_idx carries uint32 in
    int64. R2 sequence value + Cranley-Patterson rotation by the mask."""
    s = sample_idx.to(torch.float32)
    # an int dim becomes a device scalar without a host-to-device copy
    d = (dim if isinstance(dim, torch.Tensor)
         else torch.full((), dim, dtype=torch.int64, device=s.device))
    alpha = torch.where(d % 2 == 0, _ALPHA[0], _ALPHA[1]).to(torch.float32)
    pair = torch.div(d, 2, rounding_mode="floor").to(torch.float32)
    seq = torch.fmod(alpha * (s + 1.0) + 0.41421356 * pair, 1.0)
    mx = (x + _SHIFT_X * d) & (MASK_N - 1)
    my = (y + _SHIFT_Y * d) & (MASK_N - 1)
    rot = mask[mx, my]
    return torch.fmod(seq + rot, 1.0)
