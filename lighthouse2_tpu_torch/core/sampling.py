"""Sampling warps (tools_shared.h:242-275, lights_shared.h:145-164).

Counterpart of lighthouse2_tpu/core/sampling.py (cosine_hemisphere,
uniform_sphere, uniform_hemisphere, uniform_cone, random_barycentrics,
sample_triangle_simple). All warps take uniform float32 tensors in [0,1).
"""
from __future__ import annotations

import math

import torch

from lighthouse2_tpu_torch.core.rng import M32


def cosine_hemisphere(r0, r1):
    """Cosine-weighted hemisphere about +z. pdf = z/pi."""
    term1 = 2.0 * math.pi * r0
    term2 = torch.sqrt(torch.clamp(1.0 - r1, min=0.0))
    s = torch.sqrt(torch.clamp(r1, min=0.0))
    return torch.stack([torch.cos(term1) * s, torch.sin(term1) * s, term2],
                       dim=-1)


def uniform_sphere(r0, r1):
    z = 1.0 - 2.0 * r0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * r1
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_hemisphere(r0, r1):
    z = r0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * r1
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_cone(r0, r1, cos_theta_max):
    cos_theta = (1.0 - r0) + r0 * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * r1
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def random_barycentrics(r):
    """Uniform triangle warp via 16-digit base-4 subdivision
    (lights_shared.h:145-164). Returns (u, v) with u+v <= 1.

    The float->uint32 conversion saturates at 2^32-1, as XLA's does."""
    uf = torch.clamp((r * 4294967296.0).to(torch.int64), 0, M32)
    zero = torch.zeros_like(r)
    a, b, c = zero + 1.0, zero, zero
    d, e, f = zero, zero + 1.0, zero
    g, h, i = zero, zero, zero + 1.0
    for _ in range(16):
        uf = (uf * 4) & M32
        dd = uf >> 30
        an, bn, cn = 0.5 * (b + c), 0.5 * (c + a), 0.5 * (a + b)
        dn, en, fn = 0.5 * (e + f), 0.5 * (f + d), 0.5 * (d + e)
        gn, hn, in_ = 0.5 * (h + i), 0.5 * (i + g), 0.5 * (g + h)

        def w(x0, x1, x2, x3):
            return torch.where(dd == 0, x0, torch.where(
                dd == 1, x1, torch.where(dd == 2, x2, x3)))

        a, b, c, d, e, f, g, h, i = (
            w(an, a, an, bn), w(bn, bn, b, an), w(cn, cn, cn, c),
            w(dn, d, dn, en), w(en, en, e, dn), w(fn, fn, fn, f),
            w(gn, g, gn, hn), w(hn, hn, h, gn), w(in_, in_, in_, i))
    u = (a + b + c) / 3.0
    v = (d + e + f) / 3.0
    return u, v


def sample_triangle_simple(r0, r1):
    """The a+b>1 reflection trick used by the Bart core (raytracer.cpp:9-13)."""
    flip = r0 + r1 > 1.0
    return torch.where(flip, 1.0 - r0, r0), torch.where(flip, 1.0 - r1, r1)
