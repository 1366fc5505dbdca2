"""Wavefront OBJ + MTL loading (reference: host_mesh.cpp:131
LoadGeometryFromOBJ via tinyobjloader; host_material.cpp MTL conversion).

Copy of lighthouse2_tpu/scene/obj.py (load_mtl, load_obj), with no
deliberate difference: a pure-python parser producing a HostMesh with
per-triangle material ids, registering the MTL materials (and map_Kd
textures, through HostTexture.load and its cache) on the scene.
"""
from __future__ import annotations

import os

import numpy as np

from lighthouse2_tpu_torch.scene.host_material import HostMaterial, MAT_FROM_MTL
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh
from lighthouse2_tpu_torch.scene.host_texture import HostTexture


def load_mtl(path: str) -> dict:
    """Parse an MTL file → {name: HostMaterial}. Mapping follows the
    reference's tinyobj conversion (host_material.cpp ConvertFrom):
    Kd → color, Ks magnitude → reflection, d/Tr → transmission, Ni → eta,
    Ke → emissive color override."""
    mats: dict[str, HostMaterial] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            tok = line.strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0].lower()
            if key == "newmtl":
                cur = HostMaterial(name=tok[1], flags=MAT_FROM_MTL)
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif key == "kd":
                cur.color = tuple(float(x) for x in tok[1:4])
            elif key == "ks":
                ks = [float(x) for x in tok[1:4]]
                cur.reflection = float(np.mean(ks))
                # strong specular → low roughness in the Lambert path
                if cur.reflection > 0:
                    cur.roughness = max(0.0, 1.0 - cur.reflection)
            elif key == "ke":
                ke = tuple(float(x) for x in tok[1:4])
                if max(ke) > 0:
                    cur.color = ke  # emissive when any channel > 1
            elif key in ("d",):
                cur.transmission = max(0.0, 1.0 - float(tok[1]))
            elif key in ("tr",):
                cur.transmission = max(0.0, float(tok[1]))
            elif key == "ni":
                cur.eta = float(tok[1])
            elif key == "map_kd":
                cur._map_kd = tok[-1]          # resolved by the caller
            elif key in ("map_bump", "bump", "norm"):
                cur._map_bump = tok[-1]
    return mats


def load_obj(path: str, scene=None, material: int = 0, flat_shaded=False,
             scale: float = 1.0) -> HostMesh:
    """Load an OBJ file into a HostMesh.

    If `scene` (HostScene) is given, MTL materials are registered on it and
    per-face material ids are used; else all faces get `material`.
    Vertex/normal/uv indices are fully supported (v, v//n, v/t/n, v/t,
    negative indices). Faces are fan-triangulated like tinyobjloader.
    """
    vs: list = []
    vns: list = []
    vts: list = []
    faces: list = []            # (vidx3, tidx3, nidx3, mat_id)
    mtl_ids: dict[str, int] = {}
    cur_mat = material

    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="ignore") as fh:
        for line in fh:
            tok = line.strip().split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                vs.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vn":
                vns.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif key == "vt":
                vts.append([float(tok[1]), float(tok[2])])
            elif key == "mtllib" and scene is not None:
                mats = load_mtl(os.path.join(base_dir, " ".join(tok[1:])))
                for name, m in mats.items():
                    if hasattr(m, "_map_kd"):
                        tp = os.path.join(base_dir, m._map_kd)
                        if os.path.exists(tp):
                            m.tex_diffuse = scene.add_texture(
                                HostTexture.load(tp))
                    mtl_ids[name] = scene.add_material(m)
            elif key == "usemtl":
                cur_mat = mtl_ids.get(tok[1], material)
            elif key == "f":
                idx = []
                for v in tok[1:]:
                    parts = v.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    idx.append((vi, ti, ni))
                for k in range(1, len(idx) - 1):   # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1], cur_mat))

    v = np.asarray(vs, np.float32) * scale
    vn = np.asarray(vns, np.float32) if vns else None
    vt = np.asarray(vts, np.float32) if vts else None

    def res(i, n):
        return i - 1 if i > 0 else n + i

    tri_v = np.array([[res(a[0], len(vs)), res(b[0], len(vs)), res(c[0], len(vs))]
                      for a, b, c, _ in faces], np.int32)
    mat_per_tri = np.array([m for _, _, _, m in faces], np.int32)

    # OBJ indexes normals/uvs per corner, not per vertex — expand to a
    # corner-indexed mesh when they disagree with positions
    has_n = vn is not None and any(a[2] or b[2] or c[2] for a, b, c, _ in faces)
    has_t = vt is not None and any(a[1] or b[1] or c[1] for a, b, c, _ in faces)

    if not has_n and not has_t:
        return HostMesh.from_indexed_data(
            v, tri_v, materials_per_tri=mat_per_tri, flat=flat_shaded,
            name=os.path.basename(path))

    # corner expansion: unique (v,t,n) triples
    corners = []
    for a, b, c, _ in faces:
        corners.extend([a, b, c])
    uniq = {}
    new_idx = np.zeros(len(corners), np.int32)
    for i, cnr in enumerate(corners):
        if cnr not in uniq:
            uniq[cnr] = len(uniq)
        new_idx[i] = uniq[cnr]
    nv = np.zeros((len(uniq), 3), np.float32)
    nn = np.zeros((len(uniq), 3), np.float32) if has_n else None
    nt = np.zeros((len(uniq), 2), np.float32) if has_t else None
    for cnr, j in uniq.items():
        nv[j] = v[res(cnr[0], len(vs))]
        if has_n and cnr[2]:
            nn[j] = vn[res(cnr[2], len(vns))]
        if has_t and cnr[1]:
            nt[j] = vt[res(cnr[1], len(vts))]
    mesh = HostMesh.from_indexed_data(
        nv, new_idx.reshape(-1, 3),
        normals=nn if has_n else None,
        uvs=nt if has_t else None,
        materials_per_tri=mat_per_tri, flat=flat_shaded and not has_n,
        name=os.path.basename(path))
    return mesh
