"""Device texture fetch: bilinear and trilinear MIP sampling.

Counterpart of lighthouse2_tpu/render/textures.py (fetch_bilinear,
fetch_trilinear): wrap-repeat bilinear taps via the +1000 offset trick
(sampling_shared.h:35-71) and trilinear blending between MIP levels
(sampling_shared.h:73-89), gathering from the component-major [4,P] pool.
"""
from __future__ import annotations

import torch

from lighthouse2_tpu_torch.scene.device_scene import DeviceTextures
from lighthouse2_tpu_torch.scene.host_texture import MIP_LEVELS


def _fetch_bilinear_rows(tex: DeviceTextures, tex_id, uv, level):
    """Bilinear wrap-repeat fetch; returns [4, N] component rows."""
    tid = torch.clamp(tex_id, min=0).to(torch.int64)
    lvl = torch.clamp(level, 0, MIP_LEVELS - 1).to(torch.int64)
    nt, nm, _ = tex.desc.shape
    di = tex.desc.reshape(nt * nm, 3)[tid * nm + lvl].to(torch.int64)  # [N,3]
    off, w, h = di[:, 0], di[:, 1], di[:, 2]
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    x = (uv[:, 0] + 1000.0) * wf - 0.5
    y = (uv[:, 1] + 1000.0) * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def texel(xi, yi):
        xi = torch.remainder(xi.to(torch.int64), torch.clamp(w, min=1))
        yi = torch.remainder(yi.to(torch.int64), torch.clamp(h, min=1))
        return tex.pool[:, off + xi + yi * w]     # [4, N]

    t00 = texel(x0, y0)
    t10 = texel(x0 + 1, y0)
    t01 = texel(x0, y0 + 1)
    t11 = texel(x0 + 1, y0 + 1)
    top = t00 * (1 - fx)[None] + t10 * fx[None]
    bot = t01 * (1 - fx)[None] + t11 * fx[None]
    return top * (1 - fy)[None] + bot * fy[None]


def fetch_bilinear(tex: DeviceTextures, tex_id, uv, level):
    """Bilinear wrap-repeat fetch. tex_id [N] int (clamped >= 0), uv [N,2],
    level [N] int mip. Returns [N,4]."""
    return _fetch_bilinear_rows(tex, tex_id, uv, level).T


def fetch_trilinear(tex: DeviceTextures, tex_id, uv, lam):
    """Trilinear MIP fetch; lam is the float LOD. Returns [N,4]."""
    lam = torch.clamp(lam, 0.0, MIP_LEVELS - 1.0)
    l0 = torch.floor(lam).to(torch.int64)
    frac = lam - l0.to(torch.float32)
    a = _fetch_bilinear_rows(tex, tex_id, uv, l0)
    b = _fetch_bilinear_rows(tex, tex_id, uv,
                             torch.clamp(l0 + 1, max=MIP_LEVELS - 1))
    return (a * (1 - frac)[None] + b * frac[None]).T
