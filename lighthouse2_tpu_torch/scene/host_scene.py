"""HostScene — the scene database and its upload to a torch device.

Counterpart of lighthouse2_tpu/scene/host_scene.py (HostNode, HostScene and
HostScene.sync), holding what the procedural scenes (presets.cornell_box,
bench_scene.bathroom) use. Differences:
  - sync(device) builds the single-level BVH (the numpy SAH builder over all
    world triangles) — the JAX package's sync(two_level=False) path. The
    two-level TLAS, the native builder and the TPU cluster tiles are not
    built;
  - set_sky takes pixels; load_sky (HDR files and their .npz cache) is not
    ported, nor OBJ/glTF loading, skinning, morph targets or material
    serialization.
"""
from __future__ import annotations

import numpy as np

from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh_numpy
from lighthouse2_tpu_torch.bvh.traverse import device_bvh_from_flat
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.render.sky import build_sky_cdf
from lighthouse2_tpu_torch.scene.device_scene import (
    DeviceLights, DeviceMaterials, DeviceScene, DeviceSky, DeviceTriangles,
    build_lights_np, empty_textures, to_device)
from lighthouse2_tpu_torch.scene.host_light import (
    HostDirectionalLight, HostPointLight, HostSpotLight, extract_area_lights)
from lighthouse2_tpu_torch.scene.host_material import (
    HostMaterial, materials_to_numpy)
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh, compute_uv_tangents
from lighthouse2_tpu_torch.scene.host_texture import build_texture_pool


class HostNode:
    """Scene-graph node: a 4x4 transform, an optional mesh and children."""

    def __init__(self, mesh_id=-1, transform=None, children=None):
        self.mesh_id = mesh_id
        self.matrix = (np.eye(4, dtype=np.float32) if transform is None
                       else np.asarray(transform, np.float32))
        self.children = list(children) if children else []


class HostScene:
    def __init__(self):
        self.materials: list[HostMaterial] = []
        self.meshes: list[HostMesh] = []
        self.nodes: list[HostNode] = []
        self.root_nodes: list[int] = []
        self.point_lights: list[HostPointLight] = []
        self.spot_lights: list[HostSpotLight] = []
        self.dir_lights: list[HostDirectionalLight] = []
        self.textures: list = []
        self.sky_pixels = None
        self.dirty = True
        self._cached = None

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

    def add_mesh(self, mesh: HostMesh) -> int:
        self.meshes.append(mesh)
        self.dirty = True
        return len(self.meshes) - 1

    def add_quad(self, n, pos, width, height, mat_id) -> int:
        return self.add_mesh(HostMesh.quad(n, pos, width, height, mat_id))

    def add_instance(self, mesh_id: int, transform=None) -> int:
        """A root node referencing a mesh (host_scene.cpp:399)."""
        self.nodes.append(HostNode(mesh_id=mesh_id, transform=transform))
        self.root_nodes.append(len(self.nodes) - 1)
        self.dirty = True
        return len(self.nodes) - 1

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

    def set_sky(self, pixels) -> None:
        """Equirect HDR pixels [H,W,3] or a constant colour (a 1-D colour
        becomes 1x1)."""
        p = np.asarray(pixels, np.float32)
        if p.ndim == 1:
            p = p.reshape(1, 1, 3)
        self.sky_pixels = p
        self.dirty = True

    def sky_arrays(self) -> dict:
        """The DeviceSky fields as numpy arrays: the pixels (1x1 black
        without a sky) and, for more than one texel, the IBL tables."""
        px = (self.sky_pixels if self.sky_pixels is not None
              else np.zeros((1, 1, 3), np.float32))
        if px.shape[0] * px.shape[1] <= 1:
            return dict(pixels=px)
        pdf, cdf_rows, cdf_cond, nee_e = build_sky_cdf(px)
        return dict(pixels=px, pdf=pdf, cdf_rows=cdf_rows, cdf_cond=cdf_cond,
                    nee_energy=np.asarray(nee_e, np.float32), has_ibl=True)

    def flatten_instances(self):
        """Walk the root nodes; returns [(mesh_id, world 4x4)]."""
        out = []

        def walk(nid, parent):
            node = self.nodes[nid]
            world = parent @ node.matrix
            if node.mesh_id >= 0:
                out.append((node.mesh_id, world))
            for c in node.children:
                walk(c, world)

        for r in self.root_nodes:
            walk(r, np.eye(4, dtype=np.float32))
        return out

    def world_arrays(self) -> dict:
        """The scene's numpy arrays as uploaded: flattened world-space
        triangles, materials, lights, sky, texture pool inputs and the
        single-level BVH's flat dict."""
        instances = self.flatten_instances()
        if not instances:
            z = np.zeros((1, 3), np.float32)
            world = dict(v0=z, v1=z, v2=z, n0=z, n1=z, n2=z, face_n=z,
                         uv0=z[:, :2], uv1=z[:, :2], uv2=z[:, :2],
                         alpha=z, mat=np.zeros(1, np.int32))
        else:
            parts = [self.meshes[m].transformed(w) for m, w in instances]
            world = {f: np.concatenate([getattr(p, f) for p in parts], 0)
                     for f in ("v0", "v1", "v2", "n0", "n1", "n2", "face_n",
                               "uv0", "uv1", "uv2", "alpha", "mat")}

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
        flat = build_sah_bvh_numpy(world["v0"], world["v1"], world["v2"])
        return dict(tris=tris, materials=materials, lights=lights,
                    sky=self.sky_arrays(), bvh=flat, world=world)

    def sync(self, device=None) -> DeviceScene:
        """Upload the scene to `device` (default: the card; see
        device.resolve_device). Cached until the scene changes."""
        dev = resolve_device(device)
        if not self.dirty and self._cached is not None \
                and self._cached.device == dev:
            return self._cached
        a = self.world_arrays()
        w = a["world"]
        textures = (build_texture_pool(self.textures, dev) if self.textures
                    else empty_textures(dev))
        scene = DeviceScene(
            tris=to_device(DeviceTriangles, a["tris"], dev),
            materials=to_device(DeviceMaterials, a["materials"], dev),
            lights=to_device(DeviceLights, a["lights"], dev),
            sky=to_device(DeviceSky, a["sky"], dev),
            textures=textures,
            bvh=device_bvh_from_flat(a["bvh"], w["v0"], w["v1"], w["v2"], dev))
        self._cached = scene
        self.dirty = False
        return scene
