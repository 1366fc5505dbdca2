"""Shading-data assembly — the GetShadingData analog (material_shared.h:35-178).

Counterpart of lighthouse2_tpu/render/shading.py (ShadingData,
MAT_PACK_ROWS, material_pack, get_shading_data, shading_from_payload,
_assemble_shading) and of the PAY_* row layout of
lighthouse2_tpu/bvh/clusters.py: interpolated normals and uvs with the
OptiX7 barycentric convention, textures with ray-cone LOD, consistent
normals, normal maps and the back-face flip.

get_shading_data gathers from the scene's triangle and material tables.
shading_from_payload reads the same data from per-ray payload rows: with
geom_reattach=True the cluster trace path's 72-row payload
(bvh/clusters.py PAY_*), whose gradients re-attach to the global tables
through render/fetch.py reattach_rows; with geom_reattach=False the 63-row
payload (PAY_* below) that scene-sharded rendering
(parallel/scene_shard.py) assembles across shards, used as it is; no
device holds the global triangle tables there.

Differences from the JAX package:
  - the scene-sharded payload is narrower (PAY_ROWS = 63 rows, not 72): no
    sublane pads (JAX rows 38:40 and 68:72), and no PAY_PRIM, PAY_MAT or
    PAY_VALID rows. The hit's global triangle id rides beside the payload
    as an int32 tensor (exact at any triangle count, where a float32 row is
    exact only below 2^24), and the material id and the valid flag have no
    reader once the material rows are in the payload;
  - shading_from_payload takes that id as its keyword-only `prim`
    argument on both branches (the cluster path reads it from
    ClusterBVH.prim; without it the cluster layout's PAY_PRIM row is read,
    as in JAX); the material id of geom_reattach=True comes from the
    payload's PAY_MAT row as in JAX;
  - lanes without a hit take no gradient and get a unit area facing the
    ray on both branches: JAX's geom_reattach=True re-attaches their
    material rows to material 0 and computes an infinite light pdf from
    the miss column's zero rows, whose zero cotangent turns into NaN
    (found on the port's vertex gradients). The values on hit lanes are
    JAX's.
"""
from __future__ import annotations

import dataclasses

import torch

from lighthouse2_tpu_torch.bvh import clusters as CL
from lighthouse2_tpu_torch.core.geometry import (
    consistent_normal, cross, dot, normalize, oriented_frame)
from lighthouse2_tpu_torch.render.fetch import reattach_rows
from lighthouse2_tpu_torch.render.textures import fetch_trilinear
from lighthouse2_tpu_torch.scene.device_scene import DeviceScene
from lighthouse2_tpu_torch.scene.host_material import MAT_HASALPHA


@dataclasses.dataclass
class ShadingData:
    """Per-ray shading info (tools_shared.h:26-56 ShadingData analog)."""
    color: torch.Tensor          # [N,3] base color (possibly textured)
    absorption: torch.Tensor     # [N,3]
    metallic: torch.Tensor       # [N]
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
    eta: torch.Tensor
    flags: torch.Tensor          # [N] int material flags
    n_geom: torch.Tensor         # [N,3] geometric (face) normal
    n_interp: torch.Tensor       # [N,3] interpolated vertex normal
    n_shading: torch.Tensor      # [N,3] final (consistent / bent) normal
    face_dir: torch.Tensor       # [N] +1 front, -1 back
    emissive: torch.Tensor       # [N] bool
    ltri: torch.Tensor           # [N] area-light slot of the hit triangle
    area: torch.Tensor           # [N] triangle area
    uv: torch.Tensor             # [N,2]
    lod: torch.Tensor            # [N] texture lambda
    alpha_cutout: torch.Tensor   # [N] bool
    tangent: torch.Tensor        # [N,3]
    bitangent: torch.Tensor      # [N,3]


MAT_PACK_ROWS = 28

# payload rows [PAY_ROWS, N] f32: the hit triangle's data, then its material
PAY_V0 = 0          # 0:9  v0, e1, e2
PAY_E1 = 3
PAY_E2 = 6
PAY_N0 = 9          # 9:18 vertex normals
PAY_N1 = 12
PAY_N2 = 15
PAY_UV0 = 18        # 18:24 uv0, uv1, uv2
PAY_UV1 = 20
PAY_UV2 = 22
PAY_ALPHA = 24      # 24:27 consistent-normal alphas
PAY_LTRI = 27       # area-light slot as f32 (-1 = none)
PAY_LOD = 28        # texture LOD base
PAY_TAN = 29        # 29:32 uv tangent
PAY_BIT = 32        # 32:35 uv bitangent
PAY_GEO_ROWS = 35
PAY_ROWS = PAY_GEO_ROWS + MAT_PACK_ROWS    # 63: material_pack rows last


def material_pack(mats) -> torch.Tensor:
    """The [28, M] component-major material table: float rows 0..17, then
    the int slots (flags, texture ids) as exact f32 rows 18..27."""
    fi = lambda a: a.to(torch.float32)[None]
    return torch.cat([
        mats.color.T,                             # 0:3
        mats.absorption.T,                        # 3:6
        mats.metallic[None], mats.subsurface[None],
        mats.specular[None], mats.roughness[None],
        mats.spec_tint[None], mats.anisotropic[None],
        mats.sheen[None], mats.sheen_tint[None],
        mats.clearcoat[None], mats.clearcoat_gloss[None],
        mats.transmission[None], mats.eta[None],  # 6..17
        fi(mats.flags),                           # 18
        fi(mats.tex_diffuse), fi(mats.tex_normal),
        fi(mats.tex_roughness),                   # 19..21
        fi(mats.tex_metal_rough),                 # 22
        fi(mats.tex_sheen), fi(mats.tex_clearcoat), fi(mats.tex_specular),
        fi(mats.tex_anisotropic), fi(mats.tex_absorption),   # 23..27
    ], dim=0)


def _v3(a, rows):
    return torch.stack([a[rows], a[rows + 1], a[rows + 2]], dim=-1)


def get_shading_data(scene: DeviceScene, d, t, prim, u, v, spread_angle,
                     consistent_normals=True) -> ShadingData:
    """ShadingData for hits (prim >= 0); garbage but finite elsewhere. All
    per-triangle and per-material data is packed component-major and
    fetched with one gather each."""
    tris, mats = scene.tris, scene.materials
    p = torch.clamp(prim, min=0).to(torch.int64)
    w = 1.0 - u - v

    tpack = torch.cat([
        tris.n0.T, tris.n1.T, tris.n2.T,          # 0:9
        tris.face_n.T,                            # 9:12
        tris.uv0.T, tris.uv1.T, tris.uv2.T,       # 12:18
        tris.alpha.T,                             # 18:21
        tris.area[None], tris.lod[None],          # 21, 22
        tris.tangent.T, tris.bitangent.T,         # 23:29
    ], dim=0)
    g = tpack[:, p]                               # [29, N] one gather

    n_geom = _v3(g, 9)
    n_int = normalize(w[:, None] * _v3(g, 0) + u[:, None] * _v3(g, 3)
                      + v[:, None] * _v3(g, 6))
    uv = (w[:, None] * torch.stack([g[12], g[13]], -1)
          + u[:, None] * torch.stack([g[14], g[15]], -1)
          + v[:, None] * torch.stack([g[16], g[17]], -1))

    mat = tris.mat[p].to(torch.int64)
    m = material_pack(mats)[:, mat]               # [28, N] one gather
    mi = m[18:28].to(torch.int32)                 # flags, tex ids
    return _assemble_shading(scene, d, t, prim, u, v, w, spread_angle,
                             consistent_normals, n_geom, n_int, uv, m, mi,
                             color=_v3(m, 0), rough=m[9],
                             alpha3=(g[18], g[19], g[20]), area=g[21],
                             ltri=tris.ltri[p], lod_base=g[22],
                             tangent=_v3(g, 23), bitangent=_v3(g, 26))


def shading_from_payload(scene: DeviceScene, d, t, payload, u, v,
                         spread_angle, consistent_normals=True,
                         geom_reattach=True, *, prim=None) -> ShadingData:
    """GetShadingData from per-ray payload rows of the hit triangles (prim
    >= 0 hits, the global triangle id, int32 [N]; read from the payload's
    PAY_PRIM row as in JAX when not given, which only the cluster layout
    of geom_reattach=True has). n_geom and the area come from e1 x e2 (JAX
    shading.py:96-97), not from the host's face normal.

    geom_reattach=True: `payload` is the cluster trace path's [72, N]
    (bvh/clusters.py PAY_*), which carries no gradient; the geometry,
    attribute, LOD and material rows re-attach to the scene's tri9, vertex
    attributes, lod and material_pack (render/fetch.py). Otherwise the
    rows [PAY_ROWS, N] are used as they are, so their gradient flows back
    through whatever assembled them (scene sharding)."""
    if prim is None:
        if not geom_reattach:
            raise ValueError("the scene-sharded payload has no PAY_PRIM "
                             "row: pass prim=")
        row = payload[CL.PAY_PRIM].detach()
        prim = torch.where(row >= 0.0, row.to(torch.int32), -1)
    w = 1.0 - u - v
    if geom_reattach:
        return _shading_reattached(scene, d, t, prim, payload.detach(), u,
                                   v, w, spread_angle, consistent_normals)
    ltri = torch.where(prim >= 0, payload[PAY_LTRI].detach().to(torch.int32),
                       -1)
    g9 = payload[PAY_V0:PAY_V0 + 9]
    ga = payload[PAY_N0:PAY_N0 + 18]
    e1 = _v3(g9, 3)
    e2 = _v3(g9, 6)
    cr = cross(e1, e2)
    # lanes without a hit carry zero rows: give them a unit area facing the
    # ray, so that the light pdf there (t^2 / (cos * area)) stays finite and
    # its zero cotangent does not turn into NaN (get_shading_data's miss
    # lanes read triangle 0 for the same reason)
    hit = (prim >= 0)[:, None]
    area = torch.where(hit[:, 0], 0.5 * torch.sqrt(
        torch.clamp(dot(cr, cr), min=1e-30)), 1.0)
    n_geom = torch.where(hit, normalize(cr), -d.detach())
    n_int = normalize(w[:, None] * _v3(ga, 0) + u[:, None] * _v3(ga, 3)
                      + v[:, None] * _v3(ga, 6))
    uv = (w[:, None] * torch.stack([ga[9], ga[10]], -1)
          + u[:, None] * torch.stack([ga[11], ga[12]], -1)
          + v[:, None] * torch.stack([ga[13], ga[14]], -1))
    m = payload[PAY_GEO_ROWS:PAY_GEO_ROWS + MAT_PACK_ROWS]
    mi = m[18:28].detach().to(torch.int32)
    return _assemble_shading(scene, d, t, prim, u, v, w, spread_angle,
                             consistent_normals, n_geom, n_int, uv, m, mi,
                             color=_v3(m, 0), rough=m[9],
                             alpha3=(ga[15], ga[16], ga[17]), area=area,
                             ltri=ltri, lod_base=payload[PAY_LOD],
                             tangent=_v3(payload, PAY_TAN),
                             bitangent=_v3(payload, PAY_BIT))


def _shading_reattached(scene, d, t, prim, payload, u, v, w, spread_angle,
                        consistent_normals) -> ShadingData:
    """shading_from_payload(geom_reattach=True) on the cluster payload
    (JAX shading.py:112-152): the rows re-attach to the global packs."""
    tris = scene.tris
    hit = prim >= 0
    mat = torch.where(hit, payload[CL.PAY_MAT].to(torch.int64), -1)
    ltri = torch.where(hit, payload[CL.PAY_LTRI].to(torch.int32), -1)
    g9 = reattach_rows(tris.tri9, prim, payload[CL.PAY_V0:CL.PAY_V0 + 9])
    apack = torch.cat([tris.n0.T, tris.n1.T, tris.n2.T,         # 0:9
                       tris.uv0.T, tris.uv1.T, tris.uv2.T,      # 9:15
                       tris.alpha.T], 0)                        # 15:18
    ga = reattach_rows(apack, prim, payload[CL.PAY_N0:CL.PAY_N0 + 18])
    lodb = reattach_rows(tris.lod[None], prim,
                         payload[CL.PAY_LOD:CL.PAY_LOD + 1])[0]
    e1 = _v3(g9, 3)
    e2 = _v3(g9, 6)
    cr = cross(e1, e2)
    # miss lanes (the pack's zero miss column): a unit area facing the ray,
    # as on the sharded branch below
    area = torch.where(hit, 0.5 * torch.sqrt(
        torch.clamp(dot(cr, cr), min=1e-30)), 1.0)
    n_geom = torch.where(hit[:, None], normalize(cr), -d.detach())
    n_int = normalize(w[:, None] * _v3(ga, 0) + u[:, None] * _v3(ga, 3)
                      + v[:, None] * _v3(ga, 6))
    uv = (w[:, None] * torch.stack([ga[9], ga[10]], -1)
          + u[:, None] * torch.stack([ga[11], ga[12]], -1)
          + v[:, None] * torch.stack([ga[13], ga[14]], -1))
    m = reattach_rows(material_pack(scene.materials), mat,
                      payload[CL.PAY_GEO_ROWS:CL.PAY_GEO_ROWS + MAT_PACK_ROWS])
    mi = m[18:28].detach().to(torch.int32)
    return _assemble_shading(scene, d, t, prim, u, v, w, spread_angle,
                             consistent_normals, n_geom, n_int, uv, m, mi,
                             color=_v3(m, 0), rough=m[9],
                             alpha3=(ga[15], ga[16], ga[17]), area=area,
                             ltri=ltri, lod_base=lodb,
                             tangent=_v3(payload, CL.PAY_TAN),
                             bitangent=_v3(payload, CL.PAY_BIT))


def _assemble_shading(scene, d, t, prim, u, v, w, spread_angle,
                      consistent_normals, n_geom, n_int, uv, m, mi,
                      color, rough, alpha3, area, ltri, lod_base,
                      tangent, bitangent) -> ShadingData:
    """Shared tail of GetShadingData: textures, consistent normals, normal
    map, flags. Absent texture slots (the scene's s_base_maps /
    s_param_maps bitmasks) skip their fetches."""
    # ray-cone LOD: lambda = triLOD + log2(coneWidth / |D.N|)
    cone_width = spread_angle * t
    lam = lod_base + torch.log2(
        torch.clamp(cone_width, min=1e-20)
        / torch.clamp(torch.abs(dot(d, n_int)), min=1e-6))
    tex_d = mi[1]
    has_any_tex = scene.textures.pool.shape[1] > 1
    bmaps = scene.materials.s_base_maps if has_any_tex else 0
    alpha_cutout = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    metallic = m[6]
    tex = scene.textures
    if bmaps & 0b0001:
        texel = fetch_trilinear(tex, tex_d, uv, lam)
        color = torch.where((tex_d >= 0)[:, None], color * texel[:, :3], color)
        # alpha cutout -> passthrough extension ray (pathtracer.h:107-118)
        alpha_cutout = (((mi[0] & MAT_HASALPHA) != 0) & (tex_d >= 0)
                        & (texel[:, 3] < 0.5))
    if bmaps & 0b0100:
        tex_r = mi[3]
        rtex = fetch_trilinear(tex, tex_r, uv, lam)
        rough = torch.where(tex_r >= 0, rough * rtex[:, 0], rough)
    if bmaps & 0b1000:
        # glTF metallicRoughness: roughness in G, metallic in B; wins over a
        # plain roughness map when both are set
        tex_mr = mi[4]
        mrtex = fetch_trilinear(tex, tex_mr, uv, lam)
        rough = torch.where(tex_mr >= 0, m[9] * mrtex[:, 1], rough)
        metallic = torch.where(tex_mr >= 0, m[6] * mrtex[:, 2], m[6])

    # per-param texture-or-constant slots: the constant scales the texel
    sheen, clearcoat, spec_p = m[12], m[14], m[8]
    aniso, absorption = m[11], _v3(m, 3)
    pm = scene.materials.s_param_maps if has_any_tex else 0

    def scalar_map(bit, mi_row, const):
        if not (pm >> bit) & 1:
            return const
        tid = mi[mi_row]
        texel_p = fetch_trilinear(tex, tid, uv, lam)
        return torch.where(tid >= 0, const * texel_p[:, 0], const)

    sheen = scalar_map(0, 5, sheen)
    clearcoat = scalar_map(1, 6, clearcoat)
    spec_p = scalar_map(2, 7, spec_p)
    aniso = scalar_map(3, 8, aniso)
    if (pm >> 4) & 1:          # Vec3 slot: absorption reads .rgb
        tid = mi[9]
        texel_a = fetch_trilinear(tex, tid, uv, lam)
        absorption = torch.where((tid >= 0)[:, None],
                                 absorption * texel_a[:, :3], absorption)

    # consistent normal correction (tools_shared.h:297-311), backside flip
    alpha = w * alpha3[0] + u * alpha3[1] + v * alpha3[2]
    backside = dot(d, n_int) > 0
    if consistent_normals:
        n_in = torch.where(backside[:, None], -n_int, n_int)
        n_c = consistent_normal(d, n_in, alpha)
        n_shading = torch.where(backside[:, None], -n_c, n_c)
        n_shading = torch.where((alpha > 0)[:, None], n_shading, n_int)
    else:
        n_shading = n_int

    # normal mapping in the uv tangent frame (ONB fallback)
    if bmaps & 0b0010:
        tex_n = mi[2]
        nm = fetch_trilinear(tex, tex_n, uv, lam)
        n_tan = normalize(nm[:, :3] * 2.0 - 1.0)
        tb, bb = oriented_frame(n_shading, tangent, bitangent)
        n_mapped = normalize(tb * n_tan[:, 0:1] + bb * n_tan[:, 1:2]
                             + n_shading * n_tan[:, 2:3])
        n_shading = torch.where((tex_n >= 0)[:, None], n_mapped, n_shading)

    face_dir = torch.where(dot(d, n_geom) > 0, -1.0, 1.0)
    emissive = color.amax(dim=-1) > 1.0          # host_material.h:79

    return ShadingData(
        color=color, absorption=absorption, metallic=metallic,
        subsurface=m[7], specular=spec_p, roughness=rough, spec_tint=m[10],
        anisotropic=aniso, sheen=sheen, sheen_tint=m[13], clearcoat=clearcoat,
        clearcoat_gloss=m[15], transmission=m[16], eta=m[17], flags=mi[0],
        n_geom=n_geom, n_interp=n_int, n_shading=n_shading,
        face_dir=face_dir, emissive=emissive, ltri=ltri, area=area, uv=uv,
        lod=lam, alpha_cutout=alpha_cutout, tangent=tangent,
        bitangent=bitangent)
