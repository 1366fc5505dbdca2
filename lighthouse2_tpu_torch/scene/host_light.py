"""Host-side lights (reference: lib/RenderSystem/host_light.h:25-108).

Numpy copy of lighthouse2_tpu/scene/host_light.py (HostPointLight,
HostSpotLight, HostDirectionalLight, extract_area_lights).
"""
from __future__ import annotations

import math

import numpy as np


class HostPointLight:
    def __init__(self, position, radiance):
        self.position = np.asarray(position, np.float32)
        self.radiance = np.asarray(radiance, np.float32)


class HostSpotLight:
    def __init__(self, position, radiance, direction, inner_deg=30.0,
                 outer_deg=45.0):
        self.position = np.asarray(position, np.float32)
        self.radiance = np.asarray(radiance, np.float32)
        d = np.asarray(direction, np.float32)
        self.direction = d / np.linalg.norm(d)
        self.cos_inner = float(math.cos(math.radians(inner_deg)))
        self.cos_outer = float(math.cos(math.radians(outer_deg)))


class HostDirectionalLight:
    def __init__(self, direction, radiance):
        d = np.asarray(direction, np.float32)
        self.direction = d / np.linalg.norm(d)
        self.radiance = np.asarray(radiance, np.float32)


def extract_area_lights(v0, v1, v2, mat_ids, mat_colors):
    """CoreLightTri-style arrays from emissive world-space triangles
    (host_node.cpp:203-233, host_light.cpp:25-41).

    Returns (tri_light_dict, ltri_idx[T]) where ltri_idx maps every triangle
    to its area-light slot (-1 for non-emissive)."""
    colors = mat_colors[mat_ids]                     # [T,3]
    emissive = colors.max(-1) > 1.0                  # host_material.h:79
    idx = np.nonzero(emissive)[0].astype(np.int32)
    ltri = np.full((v0.shape[0],), -1, np.int32)
    ltri[idx] = np.arange(idx.shape[0], dtype=np.int32)
    if idx.shape[0] == 0:
        return dict(v0=[], v1=[], v2=[], centre=[], N=[], radiance=[], area=[],
                    energy=[], prim=[]), ltri
    a, b, c = v0[idx], v1[idx], v2[idx]
    cr = np.cross(b - a, c - a)
    l = np.linalg.norm(cr, axis=-1)
    area = 0.5 * l
    n = cr / np.maximum(l[..., None], 1e-20)
    rad = colors[idx]
    return dict(
        v0=a, v1=b, v2=c,
        centre=(a + b + c) / 3.0,
        N=n.astype(np.float32),
        radiance=rad,
        area=area.astype(np.float32),
        energy=rad.sum(-1).astype(np.float32),
        prim=idx,
    ), ltri
