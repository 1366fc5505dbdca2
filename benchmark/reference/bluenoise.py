"""The reference's blue-noise sampler (Lighthouse 2's BLUENOISE feature:
optix/.optix.cu:72-79, tools_shared.h:335-350): a 128x128 void-and-cluster
rank mask (Ulichney 1993) built deterministically, R2 sequences per
dimension, Cranley-Patterson rotation by the mask at a per-dimension
toroidal shift of the pixel. Written for the reference; the mask is cached
at a fixed path inside the checkout (build/benchmark/), so only a
checkout's first run builds it.
"""
from __future__ import annotations

import os

import numpy as np
import torch

MASK_N = 128
_SIGMA = 1.9
_PLASTIC = 1.32471795724474602596
ALPHA = (1.0 / _PLASTIC, 1.0 / (_PLASTIC * _PLASTIC))
SHIFT_X, SHIFT_Y = 59, 83
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                     "build", "benchmark", f"bluenoise_{MASK_N}.npy")


def generate_mask(n=MASK_N, seed=0x1337, initial_fraction=0.1):
    """Toroidal void-and-cluster rank mask, [n, n] float32 (rank + 0.5)/n^2."""
    rng = np.random.RandomState(seed)
    total = n * n
    ax = np.arange(n)
    dd = np.minimum(ax, n - ax).astype(np.float64)
    g1 = np.exp(-(dd * dd) / (2 * _SIGMA * _SIGMA))
    kern = np.outer(g1, g1)

    def splat(energy, x, y, sign):
        energy += sign * np.roll(np.roll(kern, x, axis=0), y, axis=1)

    ones = int(total * initial_fraction)
    pattern = np.zeros((n, n), bool)
    pattern.flat[rng.choice(total, ones, replace=False)] = True
    energy = np.zeros((n, n))
    for x, y in zip(*np.nonzero(pattern)):
        splat(energy, x, y, +1.0)
    big = 1e18
    for _ in range(total):
        cx, cy = np.unravel_index(np.argmax(np.where(pattern, energy, -big)),
                                  (n, n))
        pattern[cx, cy] = False
        splat(energy, cx, cy, -1.0)
        vx, vy = np.unravel_index(np.argmin(np.where(pattern, big, energy)),
                                  (n, n))
        if (vx, vy) == (cx, cy):
            pattern[cx, cy] = True
            splat(energy, cx, cy, +1.0)
            break
        pattern[vx, vy] = True
        splat(energy, vx, vy, +1.0)
    rank = np.zeros((n, n), np.int32)
    pat, e = pattern.copy(), energy.copy()
    for r in range(ones - 1, -1, -1):
        cx, cy = np.unravel_index(np.argmax(np.where(pat, e, -big)), (n, n))
        pat[cx, cy] = False
        splat(e, cx, cy, -1.0)
        rank[cx, cy] = r
    pat, e = pattern.copy(), energy.copy()
    for r in range(ones, total):
        vx, vy = np.unravel_index(np.argmin(np.where(pat, big, e)), (n, n))
        pat[vx, vy] = True
        splat(e, vx, vy, +1.0)
        rank[vx, vy] = r
    return (rank.astype(np.float32) + 0.5) / np.float32(total)


def mask() -> np.ndarray:
    if os.path.exists(CACHE):
        return np.load(CACHE)
    m = generate_mask()
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    tmp = CACHE + ".part.npy"
    np.save(tmp, m)
    os.replace(tmp, CACHE)
    return m


def sample(mask_t, x, y, sample_idx, dim):
    """[0, 1) for pixel (x, y), sample number and dimension (int tensors)."""
    s = sample_idx.to(torch.float32)
    alpha = torch.where(dim % 2 == 0, ALPHA[0], ALPHA[1]).to(torch.float32)
    pair = torch.div(dim, 2, rounding_mode="floor").to(torch.float32)
    seq = torch.fmod(alpha * (s + 1.0) + 0.41421356 * pair, 1.0)
    rot = mask_t[(x + SHIFT_X * dim) & (MASK_N - 1),
                 (y + SHIFT_Y * dim) & (MASK_N - 1)]
    return torch.fmod(seq + rot, 1.0)
