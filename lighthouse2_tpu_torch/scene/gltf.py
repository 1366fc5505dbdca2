"""glTF 2.0 loader, stdlib only (reference: host_scene.cpp:230 AddScene via
tinygltf; mesh conversion host_mesh.cpp:310/477; node graph host_node.cpp;
animations host_anim.cpp; skins host_mesh.h:25-35).

Copy of lighthouse2_tpu/scene/gltf.py (_Gltf, _convert_material,
_convert_mesh, load_gltf): .gltf (JSON + external or data-URI buffers) and
.glb; meshes with POSITION / NORMAL / TEXCOORD_0 / JOINTS_0 / WEIGHTS_0 and
morph targets, 16/32-bit indices, pbrMetallicRoughness materials with
base-colour / normal / metal-roughness textures (PNG; JPEG through PIL),
the node hierarchy with TRS or matrix, skins and animations. Deliberate
difference: an image embedded in a buffer or a data URI is decoded in
memory (utils/image.read_png takes bytes), where the JAX package writes it
to /tmp/_gltf_tex_<i>.png first.
"""
from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from lighthouse2_tpu_torch.scene.host_anim import HostAnimation
from lighthouse2_tpu_torch.scene.host_material import HostMaterial
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh
from lighthouse2_tpu_torch.scene.host_scene import HostNode, HostSkin
from lighthouse2_tpu_torch.scene.host_texture import HostTexture
from lighthouse2_tpu_torch.utils import image as im

_COMP_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}


class _Gltf:
    def __init__(self, path):
        self.base = os.path.dirname(os.path.abspath(path))
        if path.lower().endswith(".glb"):
            with open(path, "rb") as f:
                data = f.read()
            magic, _ver, _len = struct.unpack("<III", data[:12])
            assert magic == 0x46546C67, "not a glb"
            pos = 12
            self.json = None
            self.bin = b""
            while pos < len(data):
                clen, ctype = struct.unpack("<II", data[pos:pos + 8])
                chunk = data[pos + 8:pos + 8 + clen]
                if ctype == 0x4E4F534A:
                    self.json = json.loads(chunk)
                elif ctype == 0x004E4942:
                    self.bin = chunk
                pos += 8 + clen
        else:
            with open(path) as f:
                self.json = json.load(f)
            self.bin = None
        self._buffers = {}

    def buffer(self, i):
        if i in self._buffers:
            return self._buffers[i]
        b = self.json["buffers"][i]
        uri = b.get("uri")
        if uri is None:
            data = self.bin
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            from urllib.parse import unquote
            with open(os.path.join(self.base, unquote(uri)), "rb") as f:
                data = f.read()
        self._buffers[i] = data
        return data

    def accessor(self, i) -> np.ndarray:
        a = self.json["accessors"][i]
        n = a["count"]
        ncomp = _TYPE_COUNT[a["type"]]
        dt = _COMP_DTYPE[a["componentType"]]
        itemsize = np.dtype(dt).itemsize * ncomp
        if "bufferView" not in a:
            arr = np.zeros((n, ncomp), dt)
        else:
            bv = self.json["bufferViews"][a["bufferView"]]
            data = self.buffer(bv["buffer"])
            off = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            if stride == itemsize:
                arr = np.frombuffer(data, dt, count=n * ncomp, offset=off)
                arr = arr.reshape(n, ncomp)
            else:
                raw = np.frombuffer(data, np.uint8)
                rows = np.stack([
                    raw[off + k * stride: off + k * stride + itemsize]
                    for k in range(n)])
                arr = rows.view(dt).reshape(n, ncomp)
        arr = np.array(arr)
        if a.get("normalized") and dt != np.float32:
            info = np.iinfo(dt)
            arr = arr.astype(np.float32) / info.max
        return arr


def _convert_material(g: _Gltf, mi: int, scene, tex_map) -> HostMaterial:
    """pbrMetallicRoughness → HostMaterial (host_material.cpp ConvertFrom
    glTF path)."""
    m = g.json.get("materials", [])[mi]
    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    mat = HostMaterial(
        name=m.get("name", f"gltf_mat_{mi}"),
        color=tuple(base[:3]),
        metallic=float(pbr.get("metallicFactor", 1.0)),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
    )
    em = m.get("emissiveFactor")
    if em and max(em) > 0:
        # emissive wins: any channel >1 marks the material emissive
        strength = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
        mat.color = tuple(float(10.0 * strength * e) for e in em)
    if "baseColorTexture" in pbr:
        mat.tex_diffuse = tex_map(pbr["baseColorTexture"]["index"])
    if "normalTexture" in m:
        mat.tex_normal = tex_map(m["normalTexture"]["index"], srgb=False)
    if "metallicRoughnessTexture" in pbr:
        # G = roughness, B = metallic (glTF 2.0); stored linear
        mat.tex_metal_rough = tex_map(
            pbr["metallicRoughnessTexture"]["index"], srgb=False)
    return mat


def _convert_mesh(g: _Gltf, mesh_json, mat_base, default_mat) -> HostMesh:
    """Merge all primitives into one HostMesh (host_mesh.cpp:310)."""
    parts = []
    for prim in mesh_json.get("primitives", []):
        if prim.get("mode", 4) != 4:
            continue  # triangles only
        attrs = prim["attributes"]
        pos = g.accessor(attrs["POSITION"]).astype(np.float32)
        if "indices" in prim:
            idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int32)
        else:
            idx = np.arange(pos.shape[0], dtype=np.int32)
        idx = idx.reshape(-1, 3)
        normals = (g.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
        uvs = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
               if "TEXCOORD_0" in attrs else None)
        joints = (g.accessor(attrs["JOINTS_0"]).astype(np.int32)
                  if "JOINTS_0" in attrs else None)
        weights = (g.accessor(attrs["WEIGHTS_0"]).astype(np.float32)
                   if "WEIGHTS_0" in attrs else None)
        morphs = []
        for tgt in prim.get("targets", []):
            dp = g.accessor(tgt["POSITION"]).astype(np.float32) \
                if "POSITION" in tgt else np.zeros_like(pos)
            dn = g.accessor(tgt["NORMAL"]).astype(np.float32) \
                if "NORMAL" in tgt else None
            morphs.append((dp, dn))
        mat = prim.get("material")
        mat_id = mat_base + mat if mat is not None else default_mat
        parts.append(HostMesh.from_indexed_data(
            pos, idx, normals=normals, uvs=uvs, material=mat_id,
            joints=joints, weights=weights,
            morph_targets=morphs or None,
            name=mesh_json.get("name", "")))
    if len(parts) == 1:
        return parts[0]
    # concatenate primitives (indexed data merged with vertex offsets)
    verts = np.concatenate([p.base_vertices for p in parts])
    offs = np.cumsum([0] + [p.base_vertices.shape[0] for p in parts[:-1]])
    idx = np.concatenate([p.indices + o for p, o in zip(parts, offs)])
    normals = (np.concatenate([p.base_normals for p in parts])
               if all(p.base_normals is not None for p in parts) else None)
    mats = np.concatenate([p.mat for p in parts])
    uv_all = np.concatenate(
        [np.stack([p.uv0, p.uv1, p.uv2], 1).reshape(-1, 2) for p in parts])
    m = HostMesh.from_indexed_data(verts, idx, normals=normals,
                                   materials_per_tri=mats,
                                   name=mesh_json.get("name", ""))
    m.uv0 = uv_all[0::3]
    m.uv1 = uv_all[1::3]
    m.uv2 = uv_all[2::3]
    return m


def load_gltf(path: str, scene, transform=None) -> list:
    """Load a glTF/glb file into `scene` (HostScene). Returns root node ids.

    Mirrors HostScene::AddScene (host_scene.cpp:230-338): textures →
    materials → meshes → nodes → skins → animations.
    """
    g = _Gltf(path)
    doc = g.json

    # textures
    tex_cache = {}

    def tex_map(ti, srgb=True):
        if (ti, srgb) in tex_cache:
            return tex_cache[(ti, srgb)]
        def _store(v):
            tex_cache[(ti, srgb)] = v
            return v
        src = doc["textures"][ti].get("source")
        img = doc["images"][src]
        if "uri" in img and not img["uri"].startswith("data:"):
            from urllib.parse import unquote
            p = os.path.join(g.base, unquote(img["uri"]))
            if p.lower().endswith(".png"):
                ht = HostTexture(im.read_png(p), name=img["uri"], srgb=srgb)
            elif p.lower().endswith((".jpg", ".jpeg")):
                ht = HostTexture(im.read_jpeg(p), name=img["uri"], srgb=srgb)
            else:
                return _store(-1)
        else:
            if "uri" in img:
                raw = base64.b64decode(img["uri"].split(",", 1)[1])
                mime = img["uri"].split(";")[0]
            else:
                bv = doc["bufferViews"][img["bufferView"]]
                data = g.buffer(bv["buffer"])
                off = bv.get("byteOffset", 0)
                raw = data[off: off + bv["byteLength"]]
                mime = img.get("mimeType", "")
            is_png = "png" in mime or raw[:8] == b"\x89PNG\r\n\x1a\n"
            is_jpg = "jpeg" in mime or "jpg" in mime or raw[:2] == b"\xff\xd8"
            if is_png:
                ht = HostTexture(im.read_png(bytes(raw)),
                                 name=f"embedded_{ti}", srgb=srgb)
            elif is_jpg:
                ht = HostTexture(im.read_jpeg(bytes(raw)),
                                 name=f"embedded_{ti}", srgb=srgb)
            else:
                return _store(-1)
        return _store(scene.add_texture(ht))

    # materials
    mat_base = len(scene.materials)
    default_mat = None
    for mi in range(len(doc.get("materials", []))):
        scene.add_material(_convert_material(g, mi, scene, tex_map))
    if not doc.get("materials"):
        default_mat = scene.add_material(HostMaterial(name="gltf_default"))
    else:
        default_mat = mat_base

    # meshes
    mesh_base = len(scene.meshes)
    for mj in doc.get("meshes", []):
        scene.add_mesh(_convert_mesh(g, mj, mat_base, default_mat))

    # nodes
    node_base = len(scene.nodes)
    for nj in doc.get("nodes", []):
        node = HostNode(
            mesh_id=(mesh_base + nj["mesh"]) if "mesh" in nj else -1,
            transform=np.asarray(nj["matrix"], np.float32).reshape(4, 4).T
            if "matrix" in nj else None,
            translation=nj.get("translation"),
            rotation=nj.get("rotation"),
            scale=nj.get("scale"),
            name=nj.get("name", ""),
            skin_id=nj.get("skin", -1),
            morph_weights=nj.get("weights"),
        )
        if "matrix" not in nj:
            node.has_trs = True
        node.children = [node_base + c for c in nj.get("children", [])]
        scene.add_node(node, root=False)
    # skins (joint ids remapped into the scene node pool)
    skin_base = len(scene.skins)
    for sj in doc.get("skins", []):
        ibm = (g.accessor(sj["inverseBindMatrices"]).reshape(-1, 4, 4)
               .transpose(0, 2, 1).astype(np.float32)
               if "inverseBindMatrices" in sj
               else np.tile(np.eye(4, dtype=np.float32),
                            (len(sj["joints"]), 1, 1)))
        scene.skins.append(HostSkin(
            [node_base + j for j in sj["joints"]], ibm))
    for nj, node in zip(doc.get("nodes", []), scene.nodes[node_base:]):
        if node.skin_id >= 0:
            node.skin_id += skin_base
    # default morph weights from the mesh when node has none
    for node in scene.nodes[node_base:]:
        if node.mesh_id >= 0 and node.morph_weights is None:
            mj = doc["meshes"][node.mesh_id - mesh_base]
            if "weights" in mj:
                node.morph_weights = mj["weights"]

    # scene roots
    roots = []
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes", []))))}])
    root_ids = scenes[scene_idx].get("nodes", [])
    if transform is not None:
        wrapper = HostNode(transform=np.asarray(transform, np.float32),
                           children=[node_base + r for r in root_ids],
                           name="gltf_root")
        roots.append(scene.add_node(wrapper))
    else:
        for r in root_ids:
            scene.root_nodes.append(node_base + r)
            roots.append(node_base + r)
    scene.dirty = True

    # animations
    for aj in doc.get("animations", []):
        scene.animations.append(HostAnimation.from_gltf(g, aj, node_base))
    return roots
