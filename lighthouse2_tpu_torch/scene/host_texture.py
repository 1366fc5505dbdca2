"""Host-side textures: loading, sRGB->linear, MIP chain, device pool.

Counterpart of lighthouse2_tpu/scene/host_texture.py (HostTexture with
load and its .lh2c.npz side-cache, _read_ppm, build_texture_pool).
Differences: HostTexture.load takes only its `cache` argument (the JAX
package also reads LH2_NO_TEXCACHE); build_texture_pool returns the port's
DeviceTextures on a torch device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from lighthouse2_tpu_torch.utils import image as im

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

    @property
    def width(self):
        return self.mips[0].shape[1]

    @property
    def height(self):
        return self.mips[0].shape[0]

    @staticmethod
    def load(path: str, srgb: bool = True, cache: bool = True) -> "HostTexture":
        """Load with a binary side-cache: the decoded, linearised and MIPped
        texels are stored next to the source as `<path>.lh2c.npz`, keyed by
        the source's mtime (host_texture.cpp CACHEIMAGES). cache=False
        decodes afresh and writes no cache."""
        cpath = path + ".lh2c.npz"
        key = None
        if cache:
            try:
                key = np.array([os.path.getmtime(path), float(srgb),
                                float(MIP_LEVELS)], np.float64)
                with np.load(cpath) as z:
                    if np.array_equal(z["key"], key):
                        tex = HostTexture.__new__(HostTexture)
                        tex.mips = [z[f"mip{i}"] for i in range(MIP_LEVELS)]
                        tex.name = path
                        return tex
            except (OSError, KeyError, ValueError):
                pass
        ext = os.path.splitext(path)[1].lower()
        if ext == ".png":
            tex = HostTexture(im.read_png(path), name=path, srgb=srgb)
        elif ext in (".jpg", ".jpeg"):
            tex = HostTexture(im.read_jpeg(path), name=path, srgb=srgb)
        elif ext == ".hdr":
            tex = HostTexture(im.read_hdr(path), name=path, srgb=False)
        elif ext in (".ppm", ".pgm"):
            tex = HostTexture(_read_ppm(path), name=path, srgb=srgb)
        else:
            raise ValueError(f"unsupported texture format: {path}")
        if cache and key is not None:
            try:
                np.savez(cpath, key=key,
                         **{f"mip{i}": m for i, m in enumerate(tex.mips)})
            except OSError:
                pass                      # read-only asset dir: no cache
        return tex


def _read_ppm(path):
    with open(path, "rb") as f:
        data = f.read()
    tok = data.split(maxsplit=4)
    assert tok[0] in (b"P6", b"P5"), "only binary PPM/PGM"
    w, h = int(tok[1]), int(tok[2])
    ch = 3 if tok[0] == b"P6" else 1
    return np.frombuffer(tok[4][: w * h * ch], np.uint8).reshape(h, w, ch)


def build_texture_pool(textures: list, device=None):
    """Pack all textures + MIPs into one flat component-major [4,P] pool with
    [NTEX, MIPS, 3] (offset, width, height) descriptors, on `device`
    (default: the card)."""
    from lighthouse2_tpu_torch.device import resolve_device
    from lighthouse2_tpu_torch.scene.device_scene import DeviceTextures
    device = resolve_device(device)
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
