"""Host-side fat-triangle mesh building (reference: host_mesh.cpp:477-592).

Numpy copy of lighthouse2_tpu/scene/host_mesh.py (HostMesh with its
skinning and morph-target fields, from_indexed_data, quad, transformed,
compute_uv_tangents), with no deliberate difference.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostMesh:
    """SoA fat triangles, object space. All arrays are [T,...] numpy float32."""
    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    face_n: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    alpha: np.ndarray          # [T,3] consistent-normal alphas
    mat: np.ndarray            # [T] int32
    name: str = ""
    # skinning/morph data (filled by glTF loader; None otherwise)
    joints: "np.ndarray | None" = None    # [V,4] int32 per original vertex
    weights: "np.ndarray | None" = None   # [V,4] float32
    # original indexed data retained for skinning/morphing re-pose
    base_vertices: "np.ndarray | None" = None  # [V,3]
    base_normals: "np.ndarray | None" = None   # [V,3]
    indices: "np.ndarray | None" = None        # [T,3] int32
    morph_targets: "list | None" = None        # list of (dpos[V,3], dnorm[V,3])

    @property
    def n_tris(self) -> int:
        return self.v0.shape[0]

    @staticmethod
    def from_indexed_data(
        vertices: np.ndarray,
        indices: np.ndarray,
        normals: "np.ndarray | None" = None,
        uvs: "np.ndarray | None" = None,
        material: int = 0,
        materials_per_tri: "np.ndarray | None" = None,
        flat: bool = False,
        name: str = "",
        joints: "np.ndarray | None" = None,
        weights: "np.ndarray | None" = None,
        morph_targets: "list | None" = None,
    ) -> "HostMesh":
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        t = indices.shape[0]
        v0 = vertices[indices[:, 0]]
        v1 = vertices[indices[:, 1]]
        v2 = vertices[indices[:, 2]]
        fn = np.cross(v1 - v0, v2 - v0)
        area2 = np.linalg.norm(fn, axis=-1, keepdims=True)
        face_n = fn / np.maximum(area2, 1e-20)

        if normals is None or flat:
            if flat or normals is None:
                # smooth vertex normals = area-weighted average of adjacent faces
                # (host_mesh.cpp computes these when the source has none)
                vn = np.zeros_like(vertices)
                for k in range(3):
                    np.add.at(vn, indices[:, k], fn)
                vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
                normals = vn
        else:
            normals = np.asarray(normals, np.float32).reshape(-1, 3)
        if flat:
            n0 = n1 = n2 = face_n
        else:
            n0 = normals[indices[:, 0]]
            n1 = normals[indices[:, 1]]
            n2 = normals[indices[:, 2]]

        # Reshetov consistent-normal alphas (host_mesh.cpp:481-509): per vertex,
        # nnv = min over adjacent faces of dot(vertexNormal, faceNormal),
        # clamped at 0.7; alpha = acos(nnv) * (1 + 0.03632 (1-nnv)^2).
        if flat:
            alpha = np.zeros((t, 3), np.float32)
        else:
            nnv = np.ones((vertices.shape[0],), np.float32)
            d = np.stack(
                [np.sum(normals[indices[:, k]] * face_n, -1) for k in range(3)], -1
            )
            for k in range(3):
                np.minimum.at(nnv, indices[:, k], d[:, k])
            nnv = np.clip(nnv, 0.7, 1.0)
            a = np.arccos(np.clip(nnv, -1, 1)) * (1.0 + 0.03632 * (1.0 - nnv) ** 2)
            alpha = a[indices].astype(np.float32)

        if uvs is None:
            uv0 = uv1 = uv2 = np.zeros((t, 2), np.float32)
        else:
            uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
            uv0 = uvs[indices[:, 0]]
            uv1 = uvs[indices[:, 1]]
            uv2 = uvs[indices[:, 2]]

        mat = (
            np.asarray(materials_per_tri, np.int32)
            if materials_per_tri is not None
            else np.full((t,), material, np.int32)
        )
        return HostMesh(
            v0=v0, v1=v1, v2=v2, n0=n0.astype(np.float32),
            n1=n1.astype(np.float32), n2=n2.astype(np.float32),
            face_n=face_n.astype(np.float32),
            uv0=uv0, uv1=uv1, uv2=uv2, alpha=alpha, mat=mat, name=name,
            joints=joints, weights=weights,
            base_vertices=vertices, base_normals=np.asarray(normals, np.float32)
            if normals is not None else None,
            indices=indices, morph_targets=morph_targets,
        )

    @staticmethod
    def quad(n, pos, width, height, mat_id) -> "HostMesh":
        """Two-triangle quad facing n (host_scene.cpp:346-394 semantics)."""
        n = np.asarray(n, np.float32)
        n = n / np.linalg.norm(n)
        # reference tests N.x > 0.9, which degenerates for N = (-1,0,0);
        # use |N.x| (robustness fix, documented deviation)
        tmp = np.array([0, 1, 0], np.float32) if abs(n[0]) > 0.9 \
            else np.array([1, 0, 0], np.float32)
        t = np.cross(n, tmp)
        t = 0.5 * width * t / np.linalg.norm(t)
        b = np.cross(t / np.linalg.norm(t), n)
        b = 0.5 * height * b / np.linalg.norm(b)
        pos = np.asarray(pos, np.float32)
        verts = np.stack(
            [pos - b - t, pos + b - t, pos - b + t, pos + b - t, pos + b + t, pos - b + t]
        )
        idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        m = HostMesh.from_indexed_data(verts, idx, material=mat_id)
        # quad uses the face normal for all vertex normals, alphas 0
        m.n0 = m.n1 = m.n2 = np.broadcast_to(n, (2, 3)).astype(np.float32).copy()
        m.face_n = m.n0.copy()
        m.alpha = np.zeros((2, 3), np.float32)
        # unit UVs across the quad (u along t, v along b) so textured
        # materials map naturally (host_scene.cpp:346-394 sets the same)
        uvs = np.array([[0, 0], [0, 1], [1, 0], [0, 1], [1, 1], [1, 0]],
                       np.float32)
        m.uv0 = uvs[idx[:, 0]]
        m.uv1 = uvs[idx[:, 1]]
        m.uv2 = uvs[idx[:, 2]]
        return m

    def transformed(self, transform: "np.ndarray | None"):
        """Return world-space copies of the triangle arrays under a 4x4 transform.

        Normals use the inverse-transpose — a deliberate improvement over the
        reference which forward-transforms normals (bvh.cpp:606-618, noted in
        SURVEY.md Appendix A)."""
        if transform is None:
            return self
        m = np.asarray(transform, np.float32)
        r = m[:3, :3]
        tr = m[:3, 3]
        nrm_m = np.linalg.inv(r).T
        out = dataclasses.replace(self)
        for f in ("v0", "v1", "v2"):
            setattr(out, f, getattr(self, f) @ r.T + tr)
        for f in ("n0", "n1", "n2", "face_n"):
            v = getattr(self, f) @ nrm_m.T
            v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)
            setattr(out, f, v.astype(np.float32))
        return out


def compute_uv_tangents(v0, v1, v2, uv0, uv1, uv2):
    """Per-triangle uv tangent/bitangent (host_mesh.cpp:545-565): solve the
    2x2 uv system T*duv1.x + B*duv1.y = e1 etc. Degenerate uv triangles
    (no uv area) get zero vectors — shading falls back to the branchless
    ONB frame there. Returns (T [T,3], B [T,3]) float32, normalized."""
    e1 = (v1 - v0).astype(np.float64)
    e2 = (v2 - v0).astype(np.float64)
    d1 = (uv1 - uv0).astype(np.float64)
    d2 = (uv2 - uv0).astype(np.float64)
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    bad = np.abs(det) < 1e-12
    r = np.where(bad, 0.0, 1.0 / np.where(bad, 1.0, det))[:, None]
    t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r
    b = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r
    tn = np.linalg.norm(t, axis=-1, keepdims=True)
    bn = np.linalg.norm(b, axis=-1, keepdims=True)
    t = np.where(tn > 1e-12, t / np.maximum(tn, 1e-12), 0.0)
    b = np.where(bn > 1e-12, b / np.maximum(bn, 1e-12), 0.0)
    return t.astype(np.float32), b.astype(np.float32)
