"""DeviceScene — the device-resident SoA scene, as dataclasses of tensors.

Counterpart of lighthouse2_tpu/scene/device_scene.py (DeviceTriangles,
DeviceMaterials, DeviceLights, DeviceSky, DeviceTextures, DeviceScene,
build_lights_np). Differences: plain dataclasses instead of flax pytrees;
the static presence counts (s_tri, s_base_maps, ...) and DeviceSky.has_ibl
are ordinary int / bool fields; there is no cluster BVH.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lighthouse2_tpu_torch.device import resolve_device


@dataclasses.dataclass
class DeviceTriangles:
    v0: torch.Tensor      # [T,3] vertex 0 (world space)
    e1: torch.Tensor      # [T,3] v1-v0
    e2: torch.Tensor      # [T,3] v2-v0
    n0: torch.Tensor      # [T,3] vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    face_n: torch.Tensor  # [T,3] geometric normal (CoreTri.N)
    uv0: torch.Tensor     # [T,2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    alpha: torch.Tensor   # [T,3] consistent-normal alphas (Reshetov)
    mat: torch.Tensor     # [T] int32 material id
    ltri: torch.Tensor    # [T] int32 area-light index or -1
    area: torch.Tensor    # [T]
    inv_area: torch.Tensor
    lod: torch.Tensor     # [T] texture LOD base
    tri9: torch.Tensor    # [9,T] v0/e1/e2 component-major
    tangent: torch.Tensor    # [T,3] uv tangent (zero = none)
    bitangent: torch.Tensor  # [T,3]

    @property
    def count(self):
        return self.v0.shape[0]


@dataclasses.dataclass
class DeviceMaterials:
    """Disney+Lambert superset, SoA (common_classes.h:177-238)."""
    color: torch.Tensor            # [M,3]; emissive if any channel > 1
    metallic: torch.Tensor         # [M]
    subsurface: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    spec_tint: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    transmission: torch.Tensor
    reflection: torch.Tensor
    eta: torch.Tensor
    absorption: torch.Tensor       # [M,3]
    flags: torch.Tensor            # [M] int32
    tex_diffuse: torch.Tensor      # [M] int32 texture id or -1
    tex_normal: torch.Tensor
    tex_roughness: torch.Tensor
    tex_metal_rough: torch.Tensor
    tex_sheen: torch.Tensor
    tex_clearcoat: torch.Tensor
    tex_specular: torch.Tensor
    tex_anisotropic: torch.Tensor
    tex_absorption: torch.Tensor
    # bitmask of per-param maps present (bit0 sheen, 1 clearcoat,
    # 2 specular, 3 anisotropic, 4 absorption)
    s_param_maps: int = 0
    # bitmask of base maps present (bit0 diffuse, 1 normal, 2 roughness,
    # 3 metal_rough)
    s_base_maps: int = 0b1111

    @property
    def count(self):
        return self.color.shape[0]


@dataclasses.dataclass
class DeviceLights:
    """All four light types, padded SoA (common_classes.h:275-356)."""
    tri_v0: torch.Tensor        # [LT,3]
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_centre: torch.Tensor
    tri_n: torch.Tensor
    tri_radiance: torch.Tensor  # [LT,3]
    tri_area: torch.Tensor      # [LT]
    tri_energy: torch.Tensor    # [LT]
    tri_prim: torch.Tensor      # [LT] int32 global triangle index
    point_pos: torch.Tensor       # [LP,3]
    point_radiance: torch.Tensor
    point_energy: torch.Tensor    # [LP]
    spot_pos: torch.Tensor        # [LS,3]
    spot_radiance: torch.Tensor
    spot_dir: torch.Tensor
    spot_cos_inner: torch.Tensor  # [LS]
    spot_cos_outer: torch.Tensor
    spot_energy: torch.Tensor
    dir_dir: torch.Tensor         # [LD,3]
    dir_radiance: torch.Tensor
    dir_energy: torch.Tensor
    # actual (unpadded) counts; the light-sampling code skips absent types
    s_tri: int = 1
    s_point: int = 1
    s_spot: int = 1
    s_dir: int = 1


@dataclasses.dataclass
class DeviceSky:
    """Equirectangular HDR skydome [H,W,3]; constant colour when 1x1.

    The IBL tables (render/sky.py build_sky_cdf, built at sync when the sky
    has more than one texel): pixel-measure pdf, marginal and conditional
    CDFs, and the NEE potential. has_ibl is a plain bool, true only when
    the tables exist."""
    pixels: torch.Tensor
    pdf: torch.Tensor | None = None        # [H,W] pixel-measure probabilities
    cdf_rows: torch.Tensor | None = None   # [H] marginal CDF over rows
    cdf_cond: torch.Tensor | None = None   # [H,W] conditional CDF per row
    nee_energy: torch.Tensor | None = None  # 0-d potential (pi * mean lum)
    has_ibl: bool = False

    def __post_init__(self):
        self.has_ibl = bool(self.has_ibl)


@dataclasses.dataclass
class DeviceTextures:
    """Pooled texels: component-major [4,P] float32 pool plus
    [NTEX, MIPS, 3] int32 (offset, width, height) descriptors."""
    pool: torch.Tensor
    desc: torch.Tensor


@dataclasses.dataclass
class DeviceScene:
    tris: DeviceTriangles
    materials: DeviceMaterials
    lights: DeviceLights
    sky: DeviceSky
    textures: DeviceTextures
    bvh: "object"                 # DeviceBVH (bvh/traverse.py)
    cbvh: "object" = None         # ClusterBVH (bvh/clusters.py) or None

    @property
    def device(self) -> torch.device:
        return self.tris.v0.device


def empty_textures(mips: int = 5, *, device=None) -> DeviceTextures:
    """The one-texel pool of a scene without textures, on `device`
    (default: the card)."""
    device = resolve_device(device)
    return DeviceTextures(
        pool=torch.zeros((4, 1), dtype=torch.float32, device=device),
        desc=torch.zeros((1, mips, 3), dtype=torch.int32, device=device))


def build_lights_np(tri_lights: dict, points: list, spots: list,
                    dirs: list) -> dict:
    """The DeviceLights fields as numpy arrays (padded to at least one row
    per type) plus the s_* counts. tri_lights: extract_area_lights output;
    points/spots/dirs: host light objects."""
    f3 = lambda: np.zeros((1, 3), np.float32)
    f1 = lambda: np.zeros((1,), np.float32)

    def stack_or(key, empty):
        v = tri_lights.get(key)
        if v is None or len(v) == 0:
            return empty()
        return np.asarray(v, np.float32)

    tri_prim = tri_lights.get("prim")
    tri_prim = (np.asarray(tri_prim, np.int32)
                if tri_prim is not None and len(tri_prim)
                else np.full((1,), -1, np.int32))
    stk = lambda objs, f: (np.stack([getattr(o, f) for o in objs], 0)
                           .astype(np.float32) if objs else f3())
    p_rad = stk(points, "radiance")
    s_rad = stk(spots, "radiance")
    d_rad = stk(dirs, "radiance")
    return dict(
        tri_v0=stack_or("v0", f3), tri_v1=stack_or("v1", f3),
        tri_v2=stack_or("v2", f3), tri_centre=stack_or("centre", f3),
        tri_n=stack_or("N", f3), tri_radiance=stack_or("radiance", f3),
        tri_area=stack_or("area", f1), tri_energy=stack_or("energy", f1),
        tri_prim=tri_prim,
        point_pos=stk(points, "position"), point_radiance=p_rad,
        point_energy=p_rad.sum(-1),
        spot_pos=stk(spots, "position"), spot_radiance=s_rad,
        spot_dir=stk(spots, "direction"),
        spot_cos_inner=(np.array([s.cos_inner for s in spots], np.float32)
                        if spots else f1()),
        spot_cos_outer=(np.array([s.cos_outer for s in spots], np.float32)
                        if spots else f1()),
        spot_energy=s_rad.sum(-1),
        dir_dir=stk(dirs, "direction"), dir_radiance=d_rad,
        dir_energy=d_rad.sum(-1),
        s_tri=len(tri_lights.get("v0", [])), s_point=len(points),
        s_spot=len(spots), s_dir=len(dirs),
    )


def to_device(cls, arrays: dict, device):
    """Build dataclass `cls` from a dict of numpy arrays (tensor fields) and
    ints (static fields), moving every array to `device`."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            continue
        v = arrays[f.name]
        kw[f.name] = (torch.from_numpy(np.array(v)).to(device)
                      if isinstance(v, np.ndarray) else v)
    return cls(**kw)
