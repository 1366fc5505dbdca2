"""HostScene — the scene database and its upload to a torch device.

Counterpart of lighthouse2_tpu/scene/host_scene.py (HostNode, HostSkin,
HostScene with its construction API, OBJ / glTF / sky loading, material
(de)serialisation, skinning and morph targets, and sync). sync() builds the
JAX package's default tree: a TLAS composed over per-mesh BLASes
(bvh/tlas.py) that the native SAH builder builds in mesh space and
_mesh_blas caches, so a rigid move costs one compose and a new pose rebuilds
only the posed mesh's BLAS. two_level=False builds one tree over all world
triangles; native=False uses the numpy builder.

Deliberate differences:
  - sync(device, rebuild_bvh, two_level, native) uploads to a torch device
    (default the card; device.resolve_device) and caches per device and
    builder choice; the JAX sync caches one scene whatever it was asked;
  - `native` is an argument, and a native build that fails raises (the
    JAX package falls back to numpy silently and reads LH2_NO_NATIVE);
    the BLAS cache keys each entry by the builder too;
  - the cluster tiles (bvh/clusters.py cut_clusters) are cut from the same
    composed tree and triangle attributes as JAX's, but only when sync is
    asked for them (clusters=True; the JAX sync always cuts them), since
    only intersector="cluster" reads them; the cut takes cut_clusters'
    default min_tpc (JAX reads LH2_MIN_TPC);
  - a skinned or morphed mesh keeps its texture coordinates (the JAX
    package's _apply_skin / _apply_morph rebuild the posed mesh without
    them, so its posed meshes sample every texture at uv (0, 0));
  - load_sky takes only its `cache` argument (the JAX package also reads
    LH2_NO_TEXCACHE);
  - `sync_seconds` holds the host seconds of the last sync by step (pose,
    blas, compose, tables, textures, pack, cut, upload), beside the JAX
    package's `build_stats` counters.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh
from lighthouse2_tpu_torch.bvh.clusters import cut_clusters
from lighthouse2_tpu_torch.bvh.tlas import compose_two_level
from lighthouse2_tpu_torch.bvh.traverse import pack_flat, upload_bvh
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.render.sky import build_sky_cdf
from lighthouse2_tpu_torch.scene.device_scene import (
    DeviceLights, DeviceMaterials, DeviceScene, DeviceSky, DeviceTriangles,
    build_lights_np, empty_textures, to_device)
from lighthouse2_tpu_torch.scene.host_light import (
    HostDirectionalLight, HostPointLight, HostSpotLight, extract_area_lights)
from lighthouse2_tpu_torch.scene.host_material import (
    HostMaterial, deserialize_materials, materials_to_numpy,
    serialize_materials)
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh, compute_uv_tangents
from lighthouse2_tpu_torch.scene.host_texture import build_texture_pool
from lighthouse2_tpu_torch.utils import image as im
from lighthouse2_tpu_torch.utils import telemetry

SYNC_STEPS = ("pose", "blas", "compose", "tables", "textures", "pack",
              "cut", "upload")


class HostNode:
    """Scene-graph node (host_node.h:28-63): TRS or matrix + optional mesh."""

    def __init__(self, mesh_id=-1, transform=None, translation=None,
                 rotation=None, scale=None, children=None, name="", skin_id=-1,
                 morph_weights=None):
        self.mesh_id = mesh_id
        self.matrix = np.eye(4, dtype=np.float32) if transform is None \
            else np.asarray(transform, np.float32)
        self.translation = np.zeros(3, np.float32) if translation is None \
            else np.asarray(translation, np.float32)
        self.rotation = np.array([0, 0, 0, 1], np.float32) if rotation is None \
            else np.asarray(rotation, np.float32)   # xyzw quaternion
        self.scale = np.ones(3, np.float32) if scale is None \
            else np.asarray(scale, np.float32)
        self.has_trs = transform is None and (
            translation is not None or rotation is not None or scale is not None)
        self.children = list(children) if children else []
        self.name = name
        self.skin_id = skin_id
        self.morph_weights = morph_weights
        self.combined = None  # world transform after update

    def local_transform(self):
        """node matrix = T·R·S·matrix (host_node.cpp:130-136)."""
        if not self.has_trs:
            return self.matrix
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = self.translation
        x, y, z, w = self.rotation
        r = np.eye(4, dtype=np.float32)
        r[:3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        s = np.diag(list(self.scale) + [1.0]).astype(np.float32)
        return t @ r @ s @ self.matrix


class HostSkin:
    """glTF skin (host_mesh.h:25-35): joint node ids + inverse bind matrices."""

    def __init__(self, joint_nodes, inverse_bind_matrices):
        self.joint_nodes = list(joint_nodes)
        self.inverse_bind = np.asarray(inverse_bind_matrices, np.float32)


class HostScene:
    def __init__(self):
        self.materials: list[HostMaterial] = []
        self.meshes: list[HostMesh] = []
        self.nodes: list[HostNode] = []
        self.root_nodes: list[int] = []
        self.skins: list[HostSkin] = []
        self.animations: list = []
        self.point_lights: list[HostPointLight] = []
        self.spot_lights: list[HostSpotLight] = []
        self.dir_lights: list[HostDirectionalLight] = []
        self.textures: list = []
        self.sky_pixels = None
        self._sky_ibl = None
        self.dirty = True
        self._cached = None
        self._cached_key = None
        self._blas_cache: dict = {}   # mesh_id -> (pose fingerprint, native, flat)
        # acceleration-structure build counters: static BLASes are not rebuilt
        self.build_stats = {"blas_builds": 0, "tlas_composes": 0}
        self.sync_seconds = dict.fromkeys(SYNC_STEPS, 0.0)

    # -- construction API (render_api.h:28-69) -------------------------------

    def add_material(self, material=None, **kw) -> int:
        self.materials.append(material if material is not None
                              else HostMaterial(**kw))
        self.dirty = True
        return len(self.materials) - 1

    def find_material(self, name: str) -> int:
        for i, m in enumerate(self.materials):
            if m.name == name:
                return i
        return -1

    def serialize_materials(self, path) -> None:
        """Save all materials as JSON (host_scene.cpp:60-104)."""
        serialize_materials(self.materials, path)

    def deserialize_materials(self, path) -> int:
        """Load materials from JSON, matched into the scene by name
        (host_scene.cpp:107-163). Returns the number matched."""
        n = 0
        for m in deserialize_materials(path):
            i = self.find_material(m.name)
            if i >= 0:
                self.materials[i] = m
                n += 1
        if n:
            self.dirty = True
        return n

    def add_mesh(self, mesh: HostMesh) -> int:
        self.meshes.append(mesh)
        self.dirty = True
        return len(self.meshes) - 1

    def add_quad(self, n, pos, width, height, mat_id) -> int:
        return self.add_mesh(HostMesh.quad(n, pos, width, height, mat_id))

    def add_node(self, node: HostNode, root=True) -> int:
        self.nodes.append(node)
        nid = len(self.nodes) - 1
        if root:
            self.root_nodes.append(nid)
        self.dirty = True
        return nid

    def add_instance(self, mesh_id: int, transform=None) -> int:
        """A root node referencing a mesh (host_scene.cpp:399)."""
        return self.add_node(HostNode(mesh_id=mesh_id, transform=transform))

    def set_node_transform(self, node_id: int, transform) -> None:
        """Move an instance (render_api.h SetNodeTransform). With the
        two-level BVH this costs a TLAS compose, not a BLAS rebuild."""
        n = self.nodes[node_id]
        n.matrix = np.asarray(transform, np.float32)
        n.has_trs = False
        self.dirty = True

    def remove_node(self, node_id: int):
        """host_scene.cpp:434 (keeps pool indices stable)."""
        if node_id in self.root_nodes:
            self.root_nodes.remove(node_id)
        self.nodes[node_id].mesh_id = -1
        self.nodes[node_id].children = []
        self.dirty = True

    def add_point_light(self, position, radiance) -> int:
        self.point_lights.append(HostPointLight(position, radiance))
        self.dirty = True
        return len(self.point_lights) - 1

    def add_spot_light(self, position, radiance, direction,
                       inner_deg=30.0, outer_deg=45.0) -> int:
        self.spot_lights.append(
            HostSpotLight(position, radiance, direction, inner_deg, outer_deg))
        self.dirty = True
        return len(self.spot_lights) - 1

    def add_directional_light(self, direction, radiance) -> int:
        self.dir_lights.append(HostDirectionalLight(direction, radiance))
        self.dirty = True
        return len(self.dir_lights) - 1

    def add_texture(self, texture) -> int:
        self.textures.append(texture)
        self.dirty = True
        return len(self.textures) - 1

    def load_obj(self, path, scale=1.0, flat_shaded=False) -> int:
        """AddMesh from an OBJ file (its MTL materials join the scene)."""
        from lighthouse2_tpu_torch.scene.obj import load_obj
        return self.add_mesh(load_obj(path, scene=self, scale=scale,
                                      flat_shaded=flat_shaded))

    def load_gltf(self, path, transform=None) -> list:
        """AddScene (host_scene.cpp:230): a whole glTF scene graph; returns
        the new root node ids."""
        from lighthouse2_tpu_torch.scene.gltf import load_gltf
        return load_gltf(path, self, transform)

    def set_sky(self, pixels) -> None:
        """Equirect HDR pixels [H,W,3] or a constant colour (a 1-D colour
        becomes 1x1)."""
        p = np.asarray(pixels, np.float32)
        if p.ndim == 1:
            p = p.reshape(1, 1, 3)
        self.sky_pixels = p
        self._sky_ibl = None
        self.dirty = True

    def load_sky(self, path: str, cache: bool = True) -> None:
        """Load an equirect HDR skydome with a side-cache of the decoded
        pixels and the IBL tables (`<path>.lh2sky.npz`, keyed by the
        source's mtime; host_skydome.cpp:82-96). cache=False decodes afresh
        and writes no cache."""
        cpath = path + ".lh2sky.npz"
        if cache:
            try:
                key = np.float64(os.path.getmtime(path))
                with np.load(cpath) as z:
                    if float(z["key"]) == float(key):
                        self.sky_pixels = z["pixels"]
                        self._sky_ibl = (z["pdf"], z["cdf_rows"],
                                         z["cdf_cond"], float(z["nee"]))
                        self.dirty = True
                        return
            except (OSError, KeyError, ValueError):
                pass
        px = np.asarray(im.read_hdr(path), np.float32)
        pdf, cdf_rows, cdf_cond, nee = build_sky_cdf(px)
        self.sky_pixels = px
        self._sky_ibl = (pdf, cdf_rows, cdf_cond, nee)
        self.dirty = True
        if cache:
            try:
                np.savez(cpath, key=np.float64(os.path.getmtime(path)),
                         pixels=px, pdf=pdf, cdf_rows=cdf_rows,
                         cdf_cond=cdf_cond, nee=np.float64(nee))
            except OSError:
                pass

    def sky_arrays(self) -> dict:
        """The DeviceSky fields as numpy arrays: the pixels (1x1 black
        without a sky) and, for more than one texel, the IBL tables (those
        load_sky read or built, else built here)."""
        px = (self.sky_pixels if self.sky_pixels is not None
              else np.zeros((1, 1, 3), np.float32))
        if px.shape[0] * px.shape[1] <= 1:
            return dict(pixels=px)
        pdf, cdf_rows, cdf_cond, nee_e = (
            self._sky_ibl if self._sky_ibl is not None else build_sky_cdf(px))
        return dict(pixels=px, pdf=pdf, cdf_rows=cdf_rows, cdf_cond=cdf_cond,
                    nee_energy=np.asarray(nee_e, np.float32), has_ibl=True)

    # -- scene-graph flatten (host_node.cpp:144-197) -------------------------

    def flatten_instances(self):
        """Walk the root nodes, setting each node's `combined` world
        transform; returns [(mesh_id, world 4x4, node)]."""
        out = []

        def walk(nid, parent):
            node = self.nodes[nid]
            world = parent @ node.local_transform()
            node.combined = world
            if node.mesh_id >= 0:
                out.append((node.mesh_id, world, node))
            for c in node.children:
                walk(c, world)

        eye = np.eye(4, dtype=np.float32)
        for r in self.root_nodes:
            walk(r, eye)
        return out

    def _posed_mesh(self, mesh: HostMesh, node: HostNode) -> HostMesh:
        """Apply morph targets, then skinning (host_node.cpp:181-192)."""
        posed = mesh
        if node.morph_weights is not None and mesh.morph_targets:
            posed = _apply_morph(mesh, np.asarray(node.morph_weights, np.float32))
        if node.skin_id >= 0 and mesh.joints is not None:
            posed = _apply_skin(posed, self, node)
        return posed

    def _mesh_blas(self, mesh_id: int, posed: HostMesh,
                   native: bool = True) -> dict:
        """Cached mesh-space SAH BLAS (core_mesh.cpp:36-133 GAS).

        Static meshes build once and persist across transform changes and
        TLAS composes. Posed (skinned / morphed) copies are keyed by a
        fingerprint of their vertices, so a new pose rebuilds only that
        mesh."""
        fp = None
        if posed is not self.meshes[mesh_id]:
            fp = hash(posed.v0.tobytes()) ^ hash(posed.v1.tobytes())
        entry = self._blas_cache.get(mesh_id)
        if entry is not None and entry[0] == fp and entry[1] == native:
            return entry[2]
        blas = build_sah_bvh(posed.v0, posed.v1, posed.v2,
                             prefer_native=native)
        self._blas_cache[mesh_id] = (fp, native, blas)
        self.build_stats["blas_builds"] += 1
        return blas

    # -- device sync (rendersystem.cpp:214) ----------------------------------

    def world_arrays(self, rebuild_bvh=True, two_level=True,
                     native=True) -> dict:
        """The scene's numpy arrays as uploaded: flattened world-space
        triangles, materials, lights, sky and the BVH2's flat dict (None
        without rebuild_bvh). Adds its host seconds to sync_seconds."""
        secs = self.sync_seconds
        with telemetry.span("sync.pose") as pose:
            world, blas_entries, blas_s = self._posed_world(
                rebuild_bvh, two_level, native)
        secs["pose"] += pose.seconds - blas_s

        flat = None
        if rebuild_bvh:
            if blas_entries:
                # two levels: a TLAS over the cached per-mesh BLASes
                # (bvh/tlas.py; rendercore_optix7/rendercore.cpp:387-428)
                with telemetry.span("sync.compose", secs, "compose"):
                    flat = compose_two_level(blas_entries)
                self.build_stats["tlas_composes"] += 1
            else:
                with telemetry.span("sync.blas", secs, "blas"):
                    flat = build_sah_bvh(world["v0"], world["v1"],
                                         world["v2"], prefer_native=native)
        with telemetry.span("sync.tables", secs, "tables"):
            tables = self._tables(world)
        return dict(tables, bvh=flat, world=world)

    def _posed_world(self, rebuild_bvh, two_level, native):
        """The posed instances' world-space triangles, the BLAS entries of
        the two-level tree (None without instances) and the seconds spent
        building BLASes (the span sync.blas)."""
        secs = self.sync_seconds
        blas_s = 0.0
        instances = self.flatten_instances()
        blas_entries = None
        if not instances:
            # keep shapes non-empty: one degenerate triangle
            z = np.zeros((1, 3), np.float32)
            world = dict(v0=z, v1=z, v2=z, n0=z, n1=z, n2=z, face_n=z,
                         uv0=z[:, :2], uv1=z[:, :2], uv2=z[:, :2],
                         alpha=z, mat=np.zeros(1, np.int32))
        else:
            parts = []
            blas_entries = []
            tri_off = 0
            for mesh_id, world_m, node in instances:
                mesh = self._posed_mesh(self.meshes[mesh_id], node)
                parts.append(mesh.transformed(world_m))
                if rebuild_bvh and two_level:
                    with telemetry.span("sync.blas", secs, "blas") as b:
                        blas_entries.append(
                            (self._mesh_blas(mesh_id, mesh, native), world_m,
                             tri_off))
                    blas_s += b.seconds
                tri_off += mesh.n_tris
            world = {f: np.concatenate([getattr(p, f) for p in parts], 0)
                     for f in ("v0", "v1", "v2", "n0", "n1", "n2", "face_n",
                               "uv0", "uv1", "uv2", "alpha", "mat")}
        return world, blas_entries, blas_s

    def _tables(self, world) -> dict:
        """The triangle, material, light and sky tables of `world`."""
        mats_np = materials_to_numpy(self.materials)
        tri_lights, ltri = extract_area_lights(
            world["v0"], world["v1"], world["v2"], world["mat"],
            mats_np["color"])
        e1 = world["v1"] - world["v0"]
        e2 = world["v2"] - world["v0"]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        inv_area = 1.0 / np.maximum(area, 1e-20)
        # triLOD = 0.5 log2(uv area / world area), 0 without uvs
        du1 = world["uv1"] - world["uv0"]
        du2 = world["uv2"] - world["uv0"]
        uva = 0.5 * np.abs(du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0])
        lod = np.where(uva > 0,
                       0.5 * np.log2(np.maximum(uva, 1e-20) * inv_area), 0.0)
        tan_t, tan_b = compute_uv_tangents(
            world["v0"], world["v1"], world["v2"],
            world["uv0"], world["uv1"], world["uv2"])
        tris = dict(
            world, e1=e1, e2=e2, ltri=ltri, area=area.astype(np.float32),
            inv_area=inv_area.astype(np.float32), lod=lod.astype(np.float32),
            tangent=tan_t, bitangent=tan_b,
            tri9=np.concatenate([world["v0"].T, e1.T, e2.T], 0).astype(
                np.float32))
        bits = lambda keys: sum((1 << b) for b, k in enumerate(keys)
                                if (mats_np[k] >= 0).any())
        materials = dict(
            mats_np,
            s_param_maps=bits(("tex_sheen", "tex_clearcoat", "tex_specular",
                               "tex_anisotropic", "tex_absorption")),
            s_base_maps=bits(("tex_diffuse", "tex_normal", "tex_roughness",
                              "tex_metal_rough")))
        lights = build_lights_np(tri_lights, self.point_lights,
                                 self.spot_lights, self.dir_lights)
        sky = self.sky_arrays()
        return dict(tris=tris, materials=materials, lights=lights, sky=sky)

    def sync(self, device=None, rebuild_bvh=True, two_level=True,
             native=True, clusters=False) -> DeviceScene:
        """Upload the scene to `device` (default: the card; see
        device.resolve_device). The BVH is the two-level tree over native
        BLASes unless two_level / native say otherwise, and none without
        rebuild_bvh; with `clusters` the cluster tiles of intersector=
        "cluster" (DeviceScene.cbvh) are cut from the same tree. Cached
        until the scene changes."""
        dev = resolve_device(device)
        key = (dev, rebuild_bvh, two_level, native, clusters)
        if not self.dirty and self._cached is not None \
                and self._cached_key == key:
            return self._cached
        self.sync_seconds = secs = dict.fromkeys(SYNC_STEPS, 0.0)
        a = self.world_arrays(rebuild_bvh, two_level, native)
        w = a["world"]
        with telemetry.span("sync.textures", secs, "textures"):
            textures = (build_texture_pool(self.textures, dev)
                        if self.textures else empty_textures(device=dev))
        with telemetry.span("sync.pack", secs, "pack"):
            packed = (pack_flat(a["bvh"], w["v0"], w["v1"], w["v2"])
                      if rebuild_bvh else None)
        cbvh = None
        with telemetry.span("sync.cut", secs, "cut"):
            if rebuild_bvh and clusters:
                tr = a["tris"]
                cbvh = cut_clusters(
                    a["bvh"], dict(w, ltri=tr["ltri"], lod=tr["lod"],
                                   tangent=tr["tangent"],
                                   bitangent=tr["bitangent"]), device=dev)
        with telemetry.span("sync.upload", secs, "upload"):
            scene = DeviceScene(
                tris=to_device(DeviceTriangles, a["tris"], dev),
                materials=to_device(DeviceMaterials, a["materials"], dev),
                lights=to_device(DeviceLights, a["lights"], dev),
                sky=to_device(DeviceSky, a["sky"], dev),
                textures=textures,
                bvh=upload_bvh(packed, dev) if rebuild_bvh else None,
                cbvh=cbvh)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self._cached = scene
        self._cached_key = key
        self.dirty = False
        return scene


def _apply_morph(mesh: HostMesh, weights: np.ndarray) -> HostMesh:
    """Morph-target pose (host_mesh.cpp:639 SetPose(weights))."""
    verts = mesh.base_vertices.copy()
    norms = mesh.base_normals.copy() if mesh.base_normals is not None else None
    for w, (dp, dn) in zip(weights, mesh.morph_targets):
        if w == 0.0:
            continue
        verts = verts + w * dp
        if norms is not None and dn is not None:
            norms = norms + w * dn
    if norms is not None:
        norms = norms / np.maximum(
            np.linalg.norm(norms, axis=-1, keepdims=True), 1e-20)
    return _with_uvs(HostMesh.from_indexed_data(
        verts, mesh.indices, normals=norms, uvs=None,
        materials_per_tri=mesh.mat, name=mesh.name,
        joints=mesh.joints, weights=mesh.weights,
        morph_targets=mesh.morph_targets,
    ), mesh)


def _apply_skin(mesh: HostMesh, scene: HostScene, node: HostNode) -> HostMesh:
    """Linear-blend skinning (host_node.cpp:181-192): v' = Σ wᵢ Jᵢ v with
    Jᵢ = meshTransform⁻¹ · jointWorld · inverseBind."""
    skin = scene.skins[node.skin_id]
    mesh_inv = np.linalg.inv(node.combined if node.combined is not None
                             else np.eye(4, dtype=np.float32))
    joint_mats = np.zeros((len(skin.joint_nodes), 4, 4), np.float32)
    for i, jn in enumerate(skin.joint_nodes):
        jw = scene.nodes[jn].combined
        if jw is None:
            jw = np.eye(4, dtype=np.float32)
        joint_mats[i] = mesh_inv @ jw @ skin.inverse_bind[i]
    w = mesh.weights                          # [V,4]
    j = mesh.joints                           # [V,4]
    m = np.einsum("vk,vkab->vab", w, joint_mats[j])   # [V,4,4]
    verts = np.einsum("vab,vb->va",
                      m, np.concatenate([mesh.base_vertices,
                                         np.ones((mesh.base_vertices.shape[0], 1),
                                                 np.float32)], -1))[:, :3]
    norms = None
    if mesh.base_normals is not None:
        nm = np.linalg.inv(m[:, :3, :3]).transpose(0, 2, 1)
        norms = np.einsum("vab,vb->va", nm, mesh.base_normals)
        norms = norms / np.maximum(np.linalg.norm(norms, axis=-1, keepdims=True), 1e-20)
    return _with_uvs(HostMesh.from_indexed_data(
        verts, mesh.indices, normals=norms, materials_per_tri=mesh.mat,
        name=mesh.name, joints=mesh.joints, weights=mesh.weights,
        morph_targets=mesh.morph_targets,
    ), mesh)


def _with_uvs(posed: HostMesh, mesh: HostMesh) -> HostMesh:
    """The posed mesh with the unposed mesh's per-corner texture
    coordinates (posing moves vertices, not the texture mapping)."""
    posed.uv0, posed.uv1, posed.uv2 = mesh.uv0, mesh.uv1, mesh.uv2
    return posed
