"""Skydome lookup (tools_shared.h:185-192, Debevec equirect mapping).

Counterpart of lighthouse2_tpu/render/sky.py sample_skydome, nearest texel
only (no caller asks for its bilinear option). The IBL half of that module
(build_sky_cdf, sample_sky, sky_pdf) and lights.py's sky_pick_prob read
importance-sampling tables the port does not build yet; they come with
sky IBL.
"""
from __future__ import annotations

import math

import torch

from lighthouse2_tpu_torch.scene.device_scene import DeviceSky


def sample_skydome(sky: DeviceSky, d):
    """Equirect lookup for directions d [N,3] -> radiance [N,3]:
    u = w/2 (1 + atan2(D.x, -D.z)/pi), v = h acos(D.y)/pi, nearest texel."""
    h, w = sky.pixels.shape[0], sky.pixels.shape[1]
    inv_pi = 1.0 / math.pi
    uf = w * 0.5 * (1.0 + torch.atan2(d[..., 0], -d[..., 2]) * inv_pi)
    vf = h * torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) * inv_pi
    u = torch.clamp(uf.to(torch.int64), 0, w - 1)
    v = torch.clamp(vf.to(torch.int64), 0, h - 1)
    return sky.pixels[v, u]
