"""The plain reference's own scene tables, worked out from the benchmark's
raw arrays (benchmark/scenes/) and nothing of the program.

World-space triangles (positions by the instance transform, normals by its
inverse transpose), smooth vertex normals (area-weighted face normals),
Reshetov consistent-normal alphas, texture-LOD bases, area-light tables and
a MIP chain per texture: the semantics of Lighthouse 2's host scene
(host_mesh.cpp, host_light.cpp, host_texture.cpp) that the program
implements, written again here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MIP_LEVELS = 5
MAT_HASALPHA = 2


def _mesh_arrays(mesh):
    """Fat triangles of one indexed mesh in object space."""
    verts, idx = mesh["vertices"], mesh["indices"]
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    face_n = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)
    t = idx.shape[0]
    if mesh["flat"]:
        n0 = n1 = n2 = face_n
        alpha = np.zeros((t, 3), np.float32)
    else:
        n0, n1, n2 = vn[idx[:, 0]], vn[idx[:, 1]], vn[idx[:, 2]]
        nnv = np.ones((verts.shape[0],), np.float32)
        dd = np.stack([np.sum(vn[idx[:, k]] * face_n, -1) for k in range(3)], -1)
        for k in range(3):
            np.minimum.at(nnv, idx[:, k], dd[:, k])
        nnv = np.clip(nnv, 0.7, 1.0)
        a = np.arccos(np.clip(nnv, -1, 1)) * (1.0 + 0.03632 * (1.0 - nnv) ** 2)
        alpha = a[idx].astype(np.float32)
    uvs = mesh["uvs"]
    if uvs is None:
        uv0 = uv1 = uv2 = np.zeros((t, 2), np.float32)
    else:
        uv0, uv1, uv2 = uvs[idx[:, 0]], uvs[idx[:, 1]], uvs[idx[:, 2]]
    return dict(v0=v0, v1=v1, v2=v2, n0=n0, n1=n1, n2=n2, face_n=face_n,
                uv0=uv0, uv1=uv1, uv2=uv2, alpha=alpha,
                mat=np.full((t,), mesh["material"], np.int32))


def _transformed(a, m):
    if m is None:
        return a
    m = np.asarray(m, np.float32)
    r, tr = m[:3, :3], m[:3, 3]
    nm = np.linalg.inv(r).T
    out = dict(a)
    for f in ("v0", "v1", "v2"):
        out[f] = a[f] @ r.T + tr
    for f in ("n0", "n1", "n2", "face_n"):
        v = a[f] @ nm.T
        out[f] = (v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True),
                                 1e-20)).astype(np.float32)
    return out


def _mips(img):
    p = np.concatenate([img, np.ones_like(img[:, :, :1])], 2).astype(np.float32)
    mips = [p]
    for _ in range(MIP_LEVELS - 1):
        prev = mips[-1]
        h, w = prev.shape[:2]
        if h < 2 or w < 2:
            mips.append(prev)
            continue
        h2, w2 = h // 2, w // 2
        c = prev[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2, 4)
        m = c.mean(axis=(1, 3))
        m[:, :, 3] = c[:, :, :, :, 3].min(axis=(1, 3))
        mips.append(m.astype(np.float32))
    return mips


def _camera_view(cam, width, height):
    """The camera's view pyramid (pos, p1, p2, p3) and ray-cone spread."""
    pos = np.asarray(cam["origin"], np.float32)
    d = np.asarray(cam["target"], np.float32) - pos
    z = (d / np.linalg.norm(d)).astype(np.float32)
    y = (np.array([1, 0, 0], np.float32) if abs(z[1]) > 0.99
         else np.array([0, 1, 0], np.float32))
    x = np.cross(z, y)
    x = x / np.linalg.norm(x)
    y = np.cross(x, z)
    fov = cam["fov"]
    fd = cam["focal_distance"]
    aspect = width / height
    screen = math.tan(fov / 2 / (180 / math.pi))
    c = pos + fd * z
    sx, sy = screen * fd * aspect, screen * fd
    return dict(pos=pos, p1=c - sx * x + sy * y, p2=c + sx * x + sy * y,
                p3=c - sx * x - sy * y,
                spread=(fov * math.pi / 180.0) / height)


class RefScene:
    """Device tensors of the reference's tables, in `dtype` (float32, or a
    lower precision for the control)."""

    def __init__(self, raw: dict, width: int, height: int, device,
                 dtype=torch.float32):
        parts = [_transformed(_mesh_arrays(raw["meshes"][m]), t)
                 for m, t in raw["instances"]]
        w = {f: np.concatenate([p[f] for p in parts], 0)
             for f in parts[0]}
        mats = raw["materials"]
        g = lambda k, dflt: np.array([m.get(k, dflt) for m in mats], np.float32)
        color = np.array([m.get("color", (0.5, 0.5, 0.5)) for m in mats],
                         np.float32)
        flags = np.array([m.get("flags", 1) for m in mats], np.int64)
        if (flags & MAT_HASALPHA).any():
            raise ValueError("the reference has no alpha cutout")
        for k in ("tex_normal", "tex_metal_rough", "tex_sheen",
                  "tex_clearcoat", "tex_specular", "tex_anisotropic",
                  "tex_absorption"):
            if any(m.get(k, -1) >= 0 for m in mats):
                raise ValueError(f"the reference has no {k}")
        e1, e2 = w["v1"] - w["v0"], w["v2"] - w["v0"]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        du1, du2 = w["uv1"] - w["uv0"], w["uv2"] - w["uv0"]
        uva = 0.5 * np.abs(du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0])
        lod = np.where(uva > 0, 0.5 * np.log2(
            np.maximum(uva, 1e-20) / np.maximum(area, 1e-20)), 0.0)
        emissive = color[w["mat"]].max(-1) > 1.0
        lidx = np.nonzero(emissive)[0]
        ltri = np.full(w["v0"].shape[0], -1, np.int64)
        ltri[lidx] = np.arange(lidx.shape[0])
        la, lb, lc = w["v0"][lidx], w["v1"][lidx], w["v2"][lidx]
        lcr = np.cross(lb - la, lc - la)
        lln = np.linalg.norm(lcr, axis=-1)
        lrad = color[w["mat"][lidx]]
        spots, points = raw["spot_lights"], raw["point_lights"]

        # the texture pool: every texture's MIP chain, flat [P, 4], with
        # (offset, width, height) per texture and level
        chunks, desc, off = [], np.zeros((max(1, len(raw["textures"])),
                                          MIP_LEVELS, 3), np.int64), 0
        for ti, img in enumerate(raw["textures"]):
            for li, mip in enumerate(_mips(img)):
                h, wd = mip.shape[:2]
                desc[ti, li] = (off, wd, h)
                chunks.append(mip.reshape(-1, 4))
                off += wd * h
        pool = np.concatenate(chunks, 0)

        f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device,
                                      dtype=dtype)
        i64 = lambda a: torch.as_tensor(np.asarray(a), device=device,
                                        dtype=torch.int64)
        self.dtype, self.device = dtype, device
        self.world = dict(v0=w["v0"], v1=w["v1"], v2=w["v2"])
        self.width, self.height = width, height
        self.count = w["v0"].shape[0]
        self.v0, self.e1, self.e2 = f(w["v0"]), f(e1), f(e2)
        self.n0, self.n1, self.n2 = f(w["n0"]), f(w["n1"]), f(w["n2"])
        self.face_n, self.alpha = f(w["face_n"]), f(w["alpha"])
        self.uv0, self.uv1, self.uv2 = f(w["uv0"]), f(w["uv1"]), f(w["uv2"])
        self.area, self.lod = f(area), f(lod)
        self.mat, self.ltri = i64(w["mat"]), i64(ltri)
        self.m_color = f(color)
        self.m_rough = f(g("roughness", 1.0))
        self.m_trans = f(g("transmission", 0.0))
        self.m_eta = f(g("eta", 1.0))
        self.m_absorb = f(np.array([m.get("absorption", (0.0, 0.0, 0.0))
                                    for m in mats], np.float32))
        self.m_tex_d = i64([m.get("tex_diffuse", -1) for m in mats])
        self.m_tex_r = i64([m.get("tex_roughness", -1) for m in mats])
        self.tex_pool, self.tex_desc = f(pool), i64(desc)
        self.l_v0, self.l_v1, self.l_v2 = f(la), f(lb), f(lc)
        self.l_centre = f((la + lb + lc) / 3.0)
        self.l_n = f(lcr / np.maximum(lln[:, None], 1e-20))
        self.l_area = f(0.5 * lln)
        self.l_rad = f(lrad)
        self.l_energy = f(lrad.sum(-1))
        self.p_pos = f([p["position"] for p in points]).reshape(-1, 3)
        self.p_rad = f([p["radiance"] for p in points]).reshape(-1, 3)
        sdir = np.array([s["direction"] for s in spots], np.float32)
        sdir = sdir / np.linalg.norm(sdir, axis=-1, keepdims=True)
        self.s_pos = f([s["position"] for s in spots]).reshape(-1, 3)
        self.s_rad = f([s["radiance"] for s in spots]).reshape(-1, 3)
        self.s_dir = f(sdir).reshape(-1, 3)
        self.s_cos_in = f([math.cos(math.radians(s["inner_deg"])) for s in spots])
        self.s_cos_out = f([math.cos(math.radians(s["outer_deg"])) for s in spots])
        view = _camera_view(raw["camera"], width, height)
        self.cam_pos, self.p1 = f(view["pos"]), f(view["p1"])
        self.p2, self.p3 = f(view["p2"]), f(view["p3"])
        self.spread = float(view["spread"])
