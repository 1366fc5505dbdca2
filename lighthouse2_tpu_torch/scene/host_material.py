"""Host-side material (reference: lib/RenderSystem/host_material.h:25-154).

Numpy copy of lighthouse2_tpu/scene/host_material.py (HostMaterial,
materials_to_numpy, the flag constants), without JSON serialization.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# flags (host_material.h:66-71)
MAT_SMOOTH = 1
MAT_HASALPHA = 2


@dataclasses.dataclass
class HostMaterial:
    name: str = "default"
    color: tuple = (0.5, 0.5, 0.5)       # base color / diffuse; >1 → emissive
    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 0.5
    roughness: float = 1.0               # 1 = pure diffuse in the Lambert path
    spec_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    transmission: float = 0.0            # refraction weight (Lambert path)
    reflection: float = 0.0              # mirror weight (Lambert path)
    eta: float = 1.0                     # index of refraction
    absorption: tuple = (0.0, 0.0, 0.0)  # Beer absorption
    flags: int = MAT_SMOOTH
    tex_diffuse: int = -1
    tex_normal: int = -1
    tex_roughness: int = -1
    tex_metal_rough: int = -1
    tex_sheen: int = -1
    tex_clearcoat: int = -1
    tex_specular: int = -1
    tex_anisotropic: int = -1
    tex_absorption: int = -1


def materials_to_numpy(mats: list) -> dict:
    """Stack a material list into SoA numpy arrays for DeviceMaterials."""
    n = max(1, len(mats))
    ms = mats if mats else [HostMaterial()]
    g = lambda f: np.array([getattr(m, f) for m in ms], np.float32)
    gi = lambda f: np.array([getattr(m, f) for m in ms], np.int32)
    return dict(
        color=np.array([m.color for m in ms], np.float32).reshape(n, 3),
        metallic=g("metallic"), subsurface=g("subsurface"), specular=g("specular"),
        roughness=g("roughness"), spec_tint=g("spec_tint"),
        anisotropic=g("anisotropic"), sheen=g("sheen"), sheen_tint=g("sheen_tint"),
        clearcoat=g("clearcoat"), clearcoat_gloss=g("clearcoat_gloss"),
        transmission=g("transmission"), reflection=g("reflection"), eta=g("eta"),
        absorption=np.array([m.absorption for m in ms], np.float32).reshape(n, 3),
        flags=gi("flags"), tex_diffuse=gi("tex_diffuse"),
        tex_normal=gi("tex_normal"), tex_roughness=gi("tex_roughness"),
        tex_metal_rough=gi("tex_metal_rough"),
        tex_sheen=gi("tex_sheen"), tex_clearcoat=gi("tex_clearcoat"),
        tex_specular=gi("tex_specular"),
        tex_anisotropic=gi("tex_anisotropic"),
        tex_absorption=gi("tex_absorption"),
    )
