"""Host-side material (reference: lib/RenderSystem/host_material.h:25-154).

Numpy copy of lighthouse2_tpu/scene/host_material.py (HostMaterial with
to_dict / from_dict, the flag constants, serialize_materials /
deserialize_materials as JSON, materials_to_numpy), with no deliberate
difference. A material is emissive when a colour channel exceeds 1.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

# flags (host_material.h:66-71)
MAT_SMOOTH = 1
MAT_HASALPHA = 2
MAT_FROM_MTL = 4


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
    tex_roughness: int = -1         # scalar roughness map (reads R; OBJ/map_Ns)
    tex_metal_rough: int = -1       # glTF metallicRoughnessTexture (G=rough, B=metal)
    # per-param texture-or-constant slots (common_classes.h:177-238
    # Vec3Value/ScalarValue: EVERY Disney parameter can be driven by a map;
    # the constant value scales the fetched texel). Scalar slots read .r
    tex_sheen: int = -1
    tex_clearcoat: int = -1
    tex_specular: int = -1
    tex_anisotropic: int = -1
    tex_absorption: int = -1        # Vec3 slot (reads .rgb)

    def is_emissive(self) -> bool:
        return max(self.color) > 1.0

    def replace(self, **kw) -> "HostMaterial":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["color"] = list(d["color"])
        d["absorption"] = list(d["absorption"])
        return d

    @staticmethod
    def from_dict(d: dict) -> "HostMaterial":
        known = {f.name for f in dataclasses.fields(HostMaterial)}
        kw = {k: v for k, v in d.items() if k in known}
        if "color" in kw:
            kw["color"] = tuple(kw["color"])
        if "absorption" in kw:
            kw["absorption"] = tuple(kw["absorption"])
        return HostMaterial(**kw)


def serialize_materials(mats: list, path: str) -> None:
    """Material JSON save — the analog of HostScene::SerializeMaterials
    (host_scene.cpp:60-104, XML there; JSON here, same per-material fields)."""
    with open(path, "w") as fh:
        json.dump({"materials": [m.to_dict() for m in mats]}, fh, indent=2)


def deserialize_materials(path: str) -> list:
    """Material JSON load (host_scene.cpp:107-163 analog). Returns a list of
    HostMaterial; callers match them into the scene by name."""
    with open(path) as fh:
        d = json.load(fh)
    return [HostMaterial.from_dict(m) for m in d.get("materials", [])]


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
