"""Tonemap / postprocess: the app-side tonemap pass on tensors
(apps/imguiapp/shaders/tonemap.frag; camera.h:40-47 parameters).

Counterpart of lighthouse2_tpu/render/tonemap.py (the clip and five
tonemap operators, vignette_mask, tonemap), with the same arithmetic.
Operates on a linear HDR image [H,W,3]; differentiable. Pipeline:
vignette -> contrast/brightness -> tonemap(method) -> gamma. Defaults match
the shader (method 4 reinhard-jodie, gamma 2.2).
"""
from __future__ import annotations

import torch


def _luminance(v):
    return 0.2126 * v[..., 0] + 0.7152 * v[..., 1] + 0.0722 * v[..., 2]


def _reinhard(v):
    return v / (1.0 + v)


def _reinhard_extended(v, max_white=6.0):
    return v * (1.0 + v / (max_white * max_white)) / (1.0 + v)


def _reinhard_extended_luminance(v, max_white_l=1.5):
    l_old = _luminance(v)
    l_new = l_old * (1.0 + l_old / (max_white_l * max_white_l)) / (1.0 + l_old)
    scale = l_new / torch.clamp(l_old, min=1e-20)
    return v * scale[..., None]


def _reinhard_jodie(v):
    lum = _luminance(v)[..., None]
    tv = v / (1.0 + v)
    return tv * tv + (v / (1.0 + lum)) * (1.0 - tv)


def _uncharted2_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def _uncharted2(v):
    curr = _uncharted2_partial(v * 2.0)
    white_scale = 1.0 / _uncharted2_partial(torch.tensor(11.2))
    return curr * white_scale.to(v.device)


TONEMAPPERS = [
    lambda v: torch.clamp(v, 0.0, 1.0),
    _reinhard,
    _reinhard_extended,
    _reinhard_extended_luminance,
    _reinhard_jodie,
    _uncharted2,
]


def vignette_mask(h, w, vignetting=0.35, device=None):
    yy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    cy = (yy - 0.5) * 2.0
    cx = (xx - 0.5) * 2.0
    rf = torch.sqrt(cx[None, :] ** 2 + cy[:, None] ** 2) * vignetting
    rf21 = rf * rf + 1.0
    return 1.0 / (rf21 * rf21)


def tonemap(image, method=4, gamma=2.2, contrast=0.0, brightness=0.0,
            vignetting=0.0):
    """image [H,W,3] linear HDR -> [H,W,3] display values in [0,1]."""
    v = image
    if vignetting > 0:
        v = v * vignette_mask(image.shape[0], image.shape[1], vignetting,
                              image.device)[..., None]
    # contrast/brightness (tonemap.frag adjust())
    cf = ((259.0 * (contrast * 256.0 + 255.0))
          / (255.0 * (259.0 - 256.0 * contrast)))
    v = torch.clamp((v - 0.5) * cf + 0.5 + brightness, min=0.0)
    v = TONEMAPPERS[int(method)](v)
    return torch.clamp(v, 0.0, 1.0) ** (1.0 / gamma)
