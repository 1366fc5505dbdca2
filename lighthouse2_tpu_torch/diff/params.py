"""Differentiable scene parameterisations.

Counterpart of lighthouse2_tpu/diff/params.py (set_material_fields,
set_light_radiance, displace_vertices, material_color_params): functions
that put parameter tensors into a DeviceScene with every derived tensor
recomputed in torch, so gradients flow from pixels back to the parameters:
  - materials: any DeviceMaterials field (color, roughness, ...);
  - lights: area-light radiance (NEE and implicit hits);
  - geometry: per-triangle-vertex offsets; e1, e2, tri9, face normals and
    areas are derived again differentiably. Traversal takes no gradient and
    refine_hit re-evaluates each hit (bvh/traverse.py), so vertex gradients
    are the reparameterised-hit estimator.

Difference from the JAX package: the BVH4 trace kernels test
DeviceBVH.tri4, the leaf-ordered float4 triangle rows of bvh/wide.py, so
displace_vertices refreshes tri4 (and the BVH2 walk's bvh.tri9) from the
displaced triangles, besides the cluster tiles (rebake_geometry) that JAX
refreshes.
"""
from __future__ import annotations

import dataclasses

import torch

from lighthouse2_tpu_torch.bvh.clusters import rebake_geometry
from lighthouse2_tpu_torch.core.geometry import cross
from lighthouse2_tpu_torch.scene.device_scene import DeviceScene


def set_material_fields(scene: DeviceScene, **fields) -> DeviceScene:
    """Replace DeviceMaterials fields (e.g. color=[M,3]) differentiably."""
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **fields))


def set_light_radiance(scene: DeviceScene, tri_radiance) -> DeviceScene:
    """Replace the area-light radiance [LT,3]. The light-pick energy is
    derived again (host_light.cpp:25-41) but detached: sampling
    distributions are not differentiated."""
    return dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, tri_radiance=tri_radiance,
        tri_energy=tri_radiance.sum(-1).detach()))


def _leaf_rows(tri9, prim):
    """tri9 [9,T] in the BVH's leaf order as tri4's xyz columns [T,3,3]."""
    return tri9[:, prim.to(torch.int64)].T.reshape(-1, 3, 3)


def displace_vertices(scene: DeviceScene, offset) -> DeviceScene:
    """Apply per-triangle-vertex world-space offsets [T,3,3] (or
    broadcastable) and derive every dependent triangle tensor again.

    Vertex normals and alphas stay fixed (their dependence on positions is
    a smooth-shading choice, not part of the light-transport gradient); the
    face normal, area and the refine layout tri9 are recomputed. The
    triangles the traversal tests (bvh.tri4, and bvh.tri9 for the BVH2
    walk) are refreshed, detached, so that shadow rays leaving the displaced
    surface do not hit its stale copy, and so are the cluster tiles of a
    scene that has them (rebake_geometry), so that the cluster kernels
    never trace stale tiles; the boxes stay as they are."""
    tris = scene.tris
    offset = torch.broadcast_to(
        torch.as_tensor(offset, dtype=torch.float32, device=tris.v0.device),
        (tris.count, 3, 3))
    v0 = tris.v0 + offset[:, 0]
    v1 = tris.v0 + tris.e1 + offset[:, 1]
    v2 = tris.v0 + tris.e2 + offset[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    cr = cross(e1, e2)
    nlen = torch.sqrt(torch.clamp((cr * cr).sum(-1), min=1e-30))
    area = 0.5 * nlen
    tri9 = torch.cat([v0.T, e1.T, e2.T], 0)
    tris = dataclasses.replace(
        tris, v0=v0, e1=e1, e2=e2, face_n=cr / nlen[:, None], area=area,
        inv_area=1.0 / torch.clamp(area, min=1e-30), tri9=tri9)
    bvh, cbvh = scene.bvh, scene.cbvh
    with torch.no_grad():
        tri9_d = tri9.detach()
        tri4 = bvh.tri4.clone()
        tri4.view(-1, 3, 4)[:, :, :3] = _leaf_rows(tri9_d, bvh.prim)
        if cbvh is not None:
            cbvh = rebake_geometry(cbvh, tri9_d)
    return dataclasses.replace(
        scene, tris=tris, cbvh=cbvh,
        bvh=dataclasses.replace(bvh, tri9=tri9_d, tri4=tri4))


def material_color_params(scene: DeviceScene):
    """(initial colours, insert) for optimising material base colours."""
    def insert(s, color):
        return set_material_fields(s, color=color)

    return scene.materials.color, insert
