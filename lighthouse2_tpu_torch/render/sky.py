"""Skydome lookup (tools_shared.h:185-192, Debevec equirect mapping) and IBL
importance sampling (host_skydome.cpp:20-47: pdf/cdf tables built at sync).

Counterpart of lighthouse2_tpu/render/sky.py (sample_skydome with its
bilinear option, build_sky_cdf as a numpy copy, sample_sky,
sky_pixel_pdf_to_solid, sky_pdf). The IBL design is inverse-CDF over the
equirect pixel grid: pixel pdf proportional to luminance * sin(theta), a
marginal CDF over rows and a conditional CDF per row; sampling rescales the
uniforms inside the chosen segment, and the solid-angle pdf of a texel is
p(pixel) / ((2 pi / W)(pi / H) sin(theta)).

Difference from the JAX package: sample_sky does not gather each lane's
whole conditional CDF row ([N, W], 2.1 GB for a 2048-wide sky at 262,144
lanes). The row index comes from torch.searchsorted over cdf_rows, the
column from a batched binary search of ceil(log2 W) gathers into the
flattened cdf_cond at row * W + mid. Both find the first index whose CDF
value is > r (side="right"), the index JAX's searchsorted finds, on every
lane. The CDF rows are searched as they are, not offset into one sorted
array, which would move bins by f32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from lighthouse2_tpu_torch.scene.device_scene import DeviceSky


def sample_skydome(sky: DeviceSky, d, bilinear: bool = False):
    """Equirect lookup for directions d [N,3] -> radiance [N,3]:
    u = w/2 (1 + atan2(D.x, -D.z)/pi), v = h acos(D.y)/pi. The nearest
    texel by default (tools_shared.h:185-192); bilinear=True blends the
    four neighbours, wrapping in u and clamping in v."""
    h, w = sky.pixels.shape[0], sky.pixels.shape[1]
    inv_pi = 1.0 / math.pi
    uf = w * 0.5 * (1.0 + torch.atan2(d[..., 0], -d[..., 2]) * inv_pi)
    vf = h * torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) * inv_pi
    if not bilinear:
        u = torch.clamp(uf.to(torch.int64), 0, w - 1)
        v = torch.clamp(vf.to(torch.int64), 0, h - 1)
        return sky.pixels[v, u]
    uf = uf - 0.5
    vf = vf - 0.5
    u0 = torch.floor(uf)
    v0 = torch.floor(vf)
    fu = (uf - u0)[..., None]
    fv = (vf - v0)[..., None]
    u0 = u0.to(torch.int64)
    v0 = v0.to(torch.int64)
    u0w = torch.remainder(u0, w)
    u1w = torch.remainder(u0 + 1, w)
    v0c = torch.clamp(v0, 0, h - 1)
    v1c = torch.clamp(v0 + 1, 0, h - 1)
    p = sky.pixels
    return ((p[v0c, u0w] * (1 - fu) + p[v0c, u1w] * fu) * (1 - fv)
            + (p[v1c, u0w] * (1 - fu) + p[v1c, u1w] * fu) * fv)


def build_sky_cdf(pixels: np.ndarray):
    """Host-side pdf/cdf tables from [H,W,3] linear radiance. Returns (pdf
    [H,W], cdf_rows [H], cdf_cond [H,W], nee_energy float); nee_energy is
    pi * mean luminance, the sky's NEE potential."""
    p = np.asarray(pixels, np.float32)
    h, w = p.shape[0], p.shape[1]
    lum = p[..., 0] * 0.299 + p[..., 1] * 0.587 + p[..., 2] * 0.114
    sin_t = np.sin(np.pi * (np.arange(h, dtype=np.float32) + 0.5) / h)
    weight = lum * sin_t[:, None]
    total = weight.sum()
    if total <= 0 or h * w <= 1:
        pdf = np.full((h, w), 1.0 / (h * w), np.float32)
    else:
        pdf = (weight / total).astype(np.float32)
    row = pdf.sum(axis=1)                       # [H]
    cdf_rows = np.cumsum(row).astype(np.float32)
    row_safe = np.where(row > 0, row, 1.0)
    cdf_cond = np.cumsum(pdf / row_safe[:, None], axis=1).astype(np.float32)
    nee_energy = float(np.pi * lum.mean())
    return pdf, cdf_rows, cdf_cond, nee_energy


def search_rows(cdf_flat, row, w: int, r):
    """Per lane, the first column j of row `row` with cdf[row, j] > r,
    clipped to w - 1: a binary search of ceil(log2 w) gathers into the
    flattened [H*W] table. Equals min(searchsorted(cdf[row], r, right),
    w - 1) for every lane."""
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w - 1)
    base = row * w
    for _ in range(math.ceil(math.log2(w))):
        mid = (lo + hi) >> 1
        above = cdf_flat[base + mid] > r
        open_ = lo < hi
        hi = torch.where(open_ & above, mid, hi)
        lo = torch.where(open_ & ~above, mid + 1, lo)
    return lo


def sample_sky(sky: DeviceSky, r0, r1):
    """Importance-sample the skydome: uniforms r0/r1 [N] -> dict(dir [N,3],
    radiance [N,3], pdf [N] solid-angle). Requires the IBL tables."""
    h, w = sky.pixels.shape[0], sky.pixels.shape[1]
    # row via the marginal CDF
    yi = torch.clamp(torch.searchsorted(sky.cdf_rows, r0.contiguous(),
                                        right=True), 0, h - 1)
    lo = torch.where(yi > 0, sky.cdf_rows[torch.clamp(yi - 1, min=0)], 0.0)
    seg = torch.clamp(sky.cdf_rows[yi] - lo, min=1e-12)
    fy = torch.clamp((r0 - lo) / seg, 0.0, 1.0)
    # column via the conditional CDF of that row
    flat = sky.cdf_cond.reshape(-1)
    xi = search_rows(flat, yi, w, r1)
    lo_x = torch.where(xi > 0, flat[yi * w + torch.clamp(xi - 1, min=0)], 0.0)
    seg_x = torch.clamp(flat[yi * w + xi] - lo_x, min=1e-12)
    fx = torch.clamp((r1 - lo_x) / seg_x, 0.0, 1.0)

    theta = math.pi * (yi.to(torch.float32) + fy) / h
    phi = math.pi * (2.0 * (xi.to(torch.float32) + fx) / w - 1.0)
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                     -sin_t * torch.cos(phi)], dim=-1)
    radiance = sky.pixels[yi, xi]
    pdf = sky_pixel_pdf_to_solid(sky, sky.pdf[yi, xi], sin_t)
    return dict(dir=d, radiance=radiance, pdf=pdf)


def sky_pixel_pdf_to_solid(sky: DeviceSky, p_pixel, sin_theta):
    """Pixel-measure pdf -> solid-angle pdf: / dw, dw = (2pi/W)(pi/H) sin."""
    h, w = sky.pixels.shape[0], sky.pixels.shape[1]
    dw = (2.0 * math.pi / w) * (math.pi / h) * torch.clamp(sin_theta,
                                                           min=1e-4)
    return p_pixel / dw


def sky_pdf(sky: DeviceSky, d):
    """Solid-angle pdf with which sample_sky generates direction d [N,3]:
    the MIS counterpart for implicit sky hits (misses)."""
    h, w = sky.pixels.shape[0], sky.pixels.shape[1]
    inv_pi = 1.0 / math.pi
    u = torch.clamp((w * 0.5 * (1.0 + torch.atan2(d[..., 0], -d[..., 2])
                                * inv_pi)).to(torch.int64), 0, w - 1)
    cy = torch.clamp(d[..., 1], -1.0, 1.0)
    v = torch.clamp((h * torch.arccos(cy) * inv_pi).to(torch.int64), 0, h - 1)
    sin_t = torch.sqrt(torch.clamp(1.0 - cy * cy, min=1e-8))
    return sky_pixel_pdf_to_solid(sky, sky.pdf[v, u], sin_t)
