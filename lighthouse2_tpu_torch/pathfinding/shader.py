"""NavMeshShader: visualize navmesh / paths / agents through the scene API.

Reference (navmesh_shader.h:53-179): adds meshes for navmesh polys, path
edges, and agents to the render scene via RenderAPI. Here the same — the
shader owns node ids it adds to a HostScene and can replace/remove them.

A copy of lighthouse2_tpu/pathfinding/shader.py (numpy only), using the port's HostMesh.
"""
from __future__ import annotations

import numpy as np

from lighthouse2_tpu_torch.pathfinding.builder import NavMesh
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh


def _region_color(rid: int) -> np.ndarray:
    rng = np.random.default_rng(rid * 7919 + 17)
    c = 0.25 + 0.75 * rng.random(3)
    return c.astype(np.float32)


class NavMeshShader:
    def __init__(self, scene):
        self.scene = scene
        self._node_ids: list[int] = []
        self._mat_cache: dict = {}

    def _material(self, color, emissive=False) -> int:
        key = (tuple(np.round(np.asarray(color, np.float64), 4)), emissive)
        if key not in self._mat_cache:
            c = np.asarray(color, np.float32)
            if emissive:
                c = c * 4.0 + 1.01  # any channel > 1 marks emissive
            self._mat_cache[key] = self.scene.add_material(
                color=c, roughness=1.0)
        return self._mat_cache[key]

    # -- navmesh surface overlay (AddNavMeshToScene analog) --------------
    def add_navmesh(self, navmesh: NavMesh, y_offset: float = 0.02) -> int:
        """Adds one mesh instance per region: two triangles per walkable
        cell, tinted by region id. Returns the count of nodes added."""
        cs = navmesh.config.cell_size
        added = 0
        for rid in range(navmesh.n_regions):
            xs, zs = np.nonzero(navmesh.region == rid)
            if len(xs) == 0:
                continue
            v0 = np.stack([navmesh.origin[0] + xs * cs,
                           navmesh.floor[xs, zs] + y_offset,
                           navmesh.origin[2] + zs * cs], 1)
            quads = []
            for k in range(len(xs)):
                x, y, z = v0[k]
                a = (x, y, z); b = (x + cs, y, z)
                c = (x + cs, y, z + cs); d = (x, y, z + cs)
                quads.append((a, b, c))
                quads.append((a, c, d))
            verts = np.asarray(quads, np.float32).reshape(-1, 3, 3)
            mat = self._material(_region_color(rid))
            mesh = _soup_mesh(verts, mat)
            mid = self.scene.add_mesh(mesh)
            nid = self.scene.add_instance(mid)
            self._node_ids.append(nid)
            added += 1
        return added

    # -- path visualization (AddPathToScene analog) ----------------------
    def add_path(self, path: np.ndarray, width: float = 0.08,
                 color=(0.1, 0.9, 0.2), y_offset: float = 0.05) -> int:
        """Draws the path polyline as flat quads lying on the ground."""
        path = np.asarray(path, np.float32)
        tris = []
        for a, b in zip(path[:-1], path[1:]):
            d = b - a
            L = np.hypot(d[0], d[2])
            if L < 1e-6:
                continue
            side = np.array([-d[2] / L, 0.0, d[0] / L], np.float32) * width
            up = np.array([0.0, y_offset, 0.0], np.float32)
            p0, p1 = a + side + up, a - side + up
            p2, p3 = b - side + up, b + side + up
            tris.append((p0, p1, p2))
            tris.append((p0, p2, p3))
        verts = np.asarray(tris, np.float32).reshape(-1, 3, 3)
        mat = self._material(color, emissive=True)
        mid = self.scene.add_mesh(_soup_mesh(verts, mat))
        nid = self.scene.add_instance(mid)
        self._node_ids.append(nid)
        return nid

    # -- agent markers (AddAgentToScene analog) --------------------------
    def add_agent(self, position, radius: float = 0.25, height: float = 1.6,
                  color=(0.9, 0.2, 0.1)) -> int:
        """Agent = small box marker at `position`."""
        p = np.asarray(position, np.float32)
        r, h = radius, height
        corners = np.array([[p[0] - r, p[1], p[2] - r],
                            [p[0] + r, p[1] + h, p[2] + r]], np.float32)
        verts = _box_tris(corners[0], corners[1])
        mat = self._material(color)
        mid = self.scene.add_mesh(_soup_mesh(verts, mat))
        nid = self.scene.add_instance(mid)
        self._node_ids.append(nid)
        return nid

    def clear(self):
        """RemoveNavMeshFromScene / RemoveAllAgents analog."""
        for nid in self._node_ids:
            self.scene.remove_node(nid)
        self._node_ids = []


def _soup_mesh(verts: np.ndarray, mat_id: int) -> HostMesh:
    """(T,3,3) triangle soup -> HostMesh with flat shading."""
    t = verts.shape[0]
    flat = verts.reshape(-1, 3)
    idx = np.arange(3 * t, dtype=np.int32).reshape(t, 3)
    return HostMesh.from_indexed_data(
        flat, idx, materials_per_tri=np.full(t, mat_id, np.int32), flat=True)


def _box_tris(lo, hi):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    c = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
        np.float32)
    faces = [(0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7),
             (0, 1, 5), (0, 5, 4), (3, 7, 6), (3, 6, 2),
             (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5)]
    return c[np.asarray(faces, np.int32)]
