"""Host-side textures: sRGB->linear, MIP chain, device pool.

Counterpart of lighthouse2_tpu/scene/host_texture.py (HostTexture,
build_texture_pool). No image-file loading yet; build_texture_pool returns
the port's DeviceTextures on a torch device.
"""
from __future__ import annotations

import numpy as np
import torch

MIP_LEVELS = 5  # common_settings.h:50


class HostTexture:
    def __init__(self, pixels: np.ndarray, name: str = "", srgb: bool = True):
        """pixels: [H,W,3|4] uint8 or float32 (linear if float)."""
        p = np.asarray(pixels)
        if p.dtype == np.uint8:
            p = p.astype(np.float32) / 255.0
            if srgb:
                p = np.where(p <= 0.04045, p / 12.92,
                             ((p + 0.055) / 1.055) ** 2.4).astype(np.float32)
        if p.ndim == 2:
            p = p[:, :, None].repeat(3, axis=2)
        if p.shape[2] == 3:
            p = np.concatenate([p, np.ones_like(p[:, :, :1])], 2)
        self.mips = [p.astype(np.float32)]
        for _ in range(MIP_LEVELS - 1):
            prev = self.mips[-1]
            h, w = prev.shape[:2]
            if h < 2 or w < 2:
                self.mips.append(prev)
                continue
            h2, w2 = h // 2, w // 2
            c = prev[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 4)
            m = c.mean(axis=(1, 3))
            # alpha takes the MIN of the box (host_texture.cpp:128-151)
            m[:, :, 3] = c[:, :, :, :, 3].min(axis=(1, 3))
            self.mips.append(m.astype(np.float32))
        self.name = name


def build_texture_pool(textures: list, device):
    """Pack all textures + MIPs into one flat component-major [4,P] pool with
    [NTEX, MIPS, 3] (offset, width, height) descriptors."""
    from lighthouse2_tpu_torch.scene.device_scene import DeviceTextures
    chunks = []
    desc = np.zeros((max(1, len(textures)), MIP_LEVELS, 3), np.int32)
    offset = 0
    for ti, tex in enumerate(textures):
        for mi, mip in enumerate(tex.mips):
            h, w = mip.shape[:2]
            desc[ti, mi] = (offset, w, h)
            chunks.append(mip.reshape(-1, 4))
            offset += w * h
    pool = np.concatenate(chunks, 0) if chunks else np.zeros((1, 4), np.float32)
    return DeviceTextures(pool=torch.from_numpy(pool.T.copy()).to(device),
                          desc=torch.from_numpy(desc).to(device))
