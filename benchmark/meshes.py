"""Procedural meshes, textures and transforms as plain numpy arrays, frozen
with the benchmark: numpy copies of the generators in
lighthouse2_tpu_torch/scene/bench_scene.py, shared by the scenes in
benchmark/scenes/.
"""
from __future__ import annotations

import numpy as np


def _mesh(name, verts, idx, uvs, material, flat=False):
    return dict(name=name, vertices=np.asarray(verts, np.float32).reshape(-1, 3),
                indices=np.asarray(idx, np.int32).reshape(-1, 3),
                uvs=None if uvs is None else np.asarray(uvs, np.float32).reshape(-1, 2),
                material=int(material), flat=bool(flat))


def grid_mesh(nx, nz, width, depth, material, uv_scale=1.0, name="grid"):
    """Subdivided XZ plane facing +y, centred at the origin, y = 0."""
    xs = np.linspace(-width / 2, width / 2, nx + 1, dtype=np.float32)
    zs = np.linspace(-depth / 2, depth / 2, nz + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
    uvs = np.stack([gx / width + 0.5, gz / depth + 0.5], -1).reshape(-1, 2)
    uvs *= uv_scale
    i, j = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    a = (i * (nz + 1) + j).reshape(-1)
    b = ((i + 1) * (nz + 1) + j).reshape(-1)
    idx = np.stack([np.stack([a, b + 1, b], -1),
                    np.stack([a, a + 1, b + 1], -1)], 1).reshape(-1, 3)
    return _mesh(name, verts, idx, uvs, material)


def lathe_mesh(profile_r, profile_y, segments, material, name="lathe",
               cap_bottom=True):
    """Surface of revolution around +y from an (r, y) profile polyline."""
    profile_r = np.asarray(profile_r, np.float32)
    profile_y = np.asarray(profile_y, np.float32)
    m = profile_r.shape[0]
    ang = np.linspace(0, 2 * np.pi, segments + 1, dtype=np.float32)[:-1]
    ca, sa = np.cos(ang), np.sin(ang)
    verts = np.stack([profile_r[:, None] * ca[None, :],
                      np.broadcast_to(profile_y[:, None], (m, segments)),
                      profile_r[:, None] * sa[None, :]], -1).reshape(-1, 3)
    u = np.broadcast_to(ang[None, :] / (2 * np.pi), (m, segments))
    v = np.broadcast_to(profile_y[:, None], (m, segments))
    uvs = np.stack([u, v], -1).reshape(-1, 2)
    idx = []
    for i in range(m - 1):
        for j in range(segments):
            jn = (j + 1) % segments
            a, b = i * segments + j, i * segments + jn
            c, d = (i + 1) * segments + j, (i + 1) * segments + jn
            idx.append([a, b, d])
            idx.append([a, d, c])
    if cap_bottom and profile_r[0] > 1e-6:
        centre = verts.shape[0]
        verts = np.concatenate(
            [verts, np.array([[0, profile_y[0], 0]], np.float32)], 0)
        uvs = np.concatenate([uvs, np.array([[0.5, 0.5]], np.float32)], 0)
        for j in range(segments):
            idx.append([centre, j, (j + 1) % segments])
    return _mesh(name, verts, idx, uvs, material)


def sphere_mesh(radius, stacks, slices, material, name="sphere"):
    th = np.linspace(0, np.pi, stacks + 1, dtype=np.float32)
    ph = np.linspace(0, 2 * np.pi, slices + 1, dtype=np.float32)[:-1]
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = radius * np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                               np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    uvs = np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2)
    idx = []
    for i in range(stacks):
        for j in range(slices):
            jn = (j + 1) % slices
            a, b = i * slices + j, i * slices + jn
            c, d = (i + 1) * slices + j, (i + 1) * slices + jn
            if i > 0:
                idx.append([a, b, d])
            if i < stacks - 1:
                idx.append([a, d, c])
    return _mesh(name, verts, idx, uvs, material)


def box_mesh(w, h, d, material, name="box", subdiv=1):
    """Box on y = 0 centred in xz, each face subdivided subdiv x subdiv."""
    verts, idx, uvs = [], [], []

    def face(origin, du, dv):
        base = len(verts)
        for i in range(subdiv + 1):
            for j in range(subdiv + 1):
                fi, fj = i / subdiv, j / subdiv
                verts.append(origin + fi * du + fj * dv)
                uvs.append([fi, fj])
        for i in range(subdiv):
            for j in range(subdiv):
                a = base + i * (subdiv + 1) + j
                b = base + (i + 1) * (subdiv + 1) + j
                idx.append([a, b + 1, b])
                idx.append([a, a + 1, b + 1])

    hw, hd = w / 2, d / 2
    x, y, z = np.eye(3, dtype=np.float32)
    face(np.array([-hw, h, -hd]), 2 * hw * x, 2 * hd * z)
    face(np.array([-hw, 0, hd]), 2 * hw * x, -2 * hd * z)
    face(np.array([-hw, 0, hd]), 2 * hw * x, h * y)
    face(np.array([hw, 0, -hd]), -2 * hw * x, h * y)
    face(np.array([-hw, 0, -hd]), 2 * hd * z, h * y)
    face(np.array([hw, 0, hd]), -2 * hd * z, h * y)
    return _mesh(name, verts, idx, uvs, material, flat=(subdiv == 1))


def quad_mesh(n, pos, width, height, material, name="quad"):
    """Two-triangle quad facing n with unit uvs (the program's add_quad
    layout), as flat indexed data."""
    n = np.asarray(n, np.float32)
    n = n / np.linalg.norm(n)
    tmp = (np.array([0, 1, 0], np.float32) if abs(n[0]) > 0.9
           else np.array([1, 0, 0], np.float32))
    t = np.cross(n, tmp)
    t = 0.5 * width * t / np.linalg.norm(t)
    b = np.cross(t / np.linalg.norm(t), n)
    b = 0.5 * height * b / np.linalg.norm(b)
    pos = np.asarray(pos, np.float32)
    verts = np.stack([pos - b - t, pos + b - t, pos - b + t,
                      pos + b - t, pos + b + t, pos - b + t])
    uvs = np.array([[0, 0], [0, 1], [1, 0], [0, 1], [1, 1], [1, 0]],
                   np.float32)
    return _mesh(name, verts, [[0, 1, 2], [3, 4, 5]], uvs, material, flat=True)


def _value_noise(n, cells, seed):
    rng = np.random.default_rng(seed)
    g = rng.random((cells + 1, cells + 1)).astype(np.float32)
    xs = np.linspace(0, cells, n, endpoint=False)
    i = xs.astype(np.int32)
    f = (xs - i).astype(np.float32)
    f = f * f * (3 - 2 * f)
    a, b = g[np.ix_(i, i)], g[np.ix_(i + 1, i)]
    c, d = g[np.ix_(i, i + 1)], g[np.ix_(i + 1, i + 1)]
    return (a * (1 - f[:, None]) * (1 - f[None, :])
            + b * f[:, None] * (1 - f[None, :])
            + c * (1 - f[:, None]) * f[None, :]
            + d * f[:, None] * f[None, :])


def checker_texture(n=512, tiles=16, c0=(0.9, 0.9, 0.88), c1=(0.35, 0.4, 0.45)):
    ij = np.arange(n)
    mask = ((ij[:, None] * tiles // n) + (ij[None, :] * tiles // n)) % 2
    img = np.where(mask[:, :, None] == 0, np.float32(c0), np.float32(c1))
    g = ((ij[:, None] * tiles % n) < 4) | ((ij[None, :] * tiles % n) < 4)
    img = np.where(g[:, :, None], np.float32((0.2, 0.2, 0.2)), img)
    return img.astype(np.float32)


def marble_texture(n=512, seed=7):
    acc = np.zeros((n, n), np.float32)
    for o, c in enumerate((4, 8, 16, 32)):
        acc += _value_noise(n, c, seed + o) / (2 ** o)
    x = np.linspace(0, 8 * np.pi, n, dtype=np.float32)
    veins = 0.5 + 0.5 * np.sin(x[None, :] + 18.0 * acc)
    base = np.float32((0.85, 0.83, 0.8))
    dark = np.float32((0.45, 0.42, 0.48))
    img = (base[None, None] * veins[:, :, None]
           + dark[None, None] * (1 - veins[:, :, None]))
    return img.astype(np.float32)


def noise_roughness_texture(n=256, seed=11, lo=0.15, hi=0.8):
    v = _value_noise(n, 16, seed)
    v = lo + (hi - lo) * (v - v.min()) / max(np.ptp(v), 1e-6)
    return np.repeat(v[:, :, None], 3, axis=2).astype(np.float32)


def transform(t=(0, 0, 0), rx=0.0, ry=0.0, rz=0.0, sx=1.0, sy=1.0, sz=1.0):
    """T . Rz . Ry . Rx . S as a 4x4 float32 matrix."""
    def rot(axis, a):
        c, sn = np.cos(a), np.sin(a)
        m = np.eye(4, dtype=np.float32)
        i, j = {"x": (1, 2), "y": (0, 2), "z": (0, 1)}[axis]
        m[i, i] = c
        m[j, j] = c
        m[i, j] = -sn if axis != "y" else sn
        m[j, i] = sn if axis != "y" else -sn
        return m
    m = np.diag([sx, sy, sz, 1.0]).astype(np.float32)
    m = rot("x", rx) @ m
    m = rot("y", ry) @ m
    m = rot("z", rz) @ m
    m[:3, 3] = t
    return m
