"""Procedural benchmark interior — the bathroom2-class workload.

Numpy copy of lighthouse2_tpu/scene/bench_scene.py (bathroom and the mesh and
texture generators it calls). detail=1 gives the 129,252-triangle scene the
benchmark renders; detail=0 a ~20k-triangle variant for tests.
"""
from __future__ import annotations

import numpy as np

from lighthouse2_tpu_torch.scene.camera import Camera
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh
from lighthouse2_tpu_torch.scene.host_scene import HostScene
from lighthouse2_tpu_torch.scene.host_texture import HostTexture


def grid_mesh(nx: int, nz: int, width: float, depth: float, material: int,
              uv_scale: float = 1.0, name: str = "grid") -> HostMesh:
    """Subdivided XZ plane facing +y, centered at origin, y=0."""
    xs = np.linspace(-width / 2, width / 2, nx + 1, dtype=np.float32)
    zs = np.linspace(-depth / 2, depth / 2, nz + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
    uvs = np.stack([gx / width + 0.5, gz / depth + 0.5], -1).reshape(-1, 2)
    uvs *= uv_scale
    idx = []
    for i in range(nx):
        for j in range(nz):
            a = i * (nz + 1) + j
            b = (i + 1) * (nz + 1) + j
            idx.append([a, b + 1, b])
            idx.append([a, a + 1, b + 1])
    return HostMesh.from_indexed_data(verts, np.array(idx, np.int32),
                                      uvs=uvs, material=material, name=name)


def lathe_mesh(profile_r, profile_y, segments: int, material: int,
               name: str = "lathe", cap_bottom: bool = True) -> HostMesh:
    """Surface of revolution around +y from a (r, y) profile polyline."""
    profile_r = np.asarray(profile_r, np.float32)
    profile_y = np.asarray(profile_y, np.float32)
    m = profile_r.shape[0]
    ang = np.linspace(0, 2 * np.pi, segments + 1, dtype=np.float32)[:-1]
    ca, sa = np.cos(ang), np.sin(ang)
    verts = np.stack([profile_r[:, None] * ca[None, :],
                      np.broadcast_to(profile_y[:, None], (m, segments)),
                      profile_r[:, None] * sa[None, :]], -1)
    verts = verts.reshape(-1, 3)
    u = np.broadcast_to(ang[None, :] / (2 * np.pi), (m, segments))
    v = np.broadcast_to(profile_y[:, None], (m, segments))
    uvs = np.stack([u, v], -1).reshape(-1, 2)
    idx = []
    for i in range(m - 1):
        for j in range(segments):
            jn = (j + 1) % segments
            a = i * segments + j
            b = i * segments + jn
            c = (i + 1) * segments + j
            d = (i + 1) * segments + jn
            idx.append([a, b, d])
            idx.append([a, d, c])
    if cap_bottom and profile_r[0] > 1e-6:
        centre = verts.shape[0]
        verts = np.concatenate(
            [verts, np.array([[0, profile_y[0], 0]], np.float32)], 0)
        uvs = np.concatenate([uvs, np.array([[0.5, 0.5]], np.float32)], 0)
        for j in range(segments):
            jn = (j + 1) % segments
            idx.append([centre, j, jn])
    return HostMesh.from_indexed_data(verts, np.array(idx, np.int32),
                                      uvs=uvs, material=material, name=name)


def sphere_mesh(radius: float, stacks: int, slices: int, material: int,
                name: str = "sphere") -> HostMesh:
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
            a = i * slices + j
            b = i * slices + jn
            c = (i + 1) * slices + j
            d = (i + 1) * slices + jn
            if i > 0:
                idx.append([a, b, d])
            if i < stacks - 1:
                idx.append([a, d, c])
    return HostMesh.from_indexed_data(verts, np.array(idx, np.int32),
                                      uvs=uvs, material=material, name=name)


def box_mesh(w, h, d, material, name="box", subdiv: int = 1) -> HostMesh:
    """Box on y=0 centered in xz, each face subdivided subdiv x subdiv."""
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
    face(np.array([-hw, h, -hd]), 2 * hw * x, 2 * hd * z)       # top
    face(np.array([-hw, 0, hd]), 2 * hw * x, -2 * hd * z)       # bottom
    face(np.array([-hw, 0, hd]), 2 * hw * x, h * y)             # front +z
    face(np.array([hw, 0, -hd]), -2 * hw * x, h * y)            # back -z
    face(np.array([-hw, 0, -hd]), 2 * hd * z, h * y)            # left -x
    face(np.array([hw, 0, hd]), -2 * hd * z, h * y)             # right +x
    return HostMesh.from_indexed_data(
        np.array(verts, np.float32), np.array(idx, np.int32),
        uvs=np.array(uvs, np.float32), material=material, flat=(subdiv == 1),
        name=name)


def checker_texture(n=512, tiles=16, c0=(0.9, 0.9, 0.88), c1=(0.35, 0.4, 0.45)):
    ij = np.arange(n)
    mask = ((ij[:, None] * tiles // n) + (ij[None, :] * tiles // n)) % 2
    img = np.where(mask[:, :, None] == 0, np.float32(c0), np.float32(c1))
    g = ((ij[:, None] * tiles % n) < 4) | ((ij[None, :] * tiles % n) < 4)
    img = np.where(g[:, :, None], np.float32((0.2, 0.2, 0.2)), img)
    return HostTexture(img.astype(np.float32), name="checker", srgb=False)


def _value_noise(n, cells, seed):
    rng = np.random.default_rng(seed)
    g = rng.random((cells + 1, cells + 1)).astype(np.float32)
    xs = np.linspace(0, cells, n, endpoint=False)
    i = xs.astype(np.int32)
    f = (xs - i).astype(np.float32)
    f = f * f * (3 - 2 * f)
    a = g[np.ix_(i, i)]
    b = g[np.ix_(i + 1, i)]
    c = g[np.ix_(i, i + 1)]
    d = g[np.ix_(i + 1, i + 1)]
    return (a * (1 - f[:, None]) * (1 - f[None, :])
            + b * f[:, None] * (1 - f[None, :])
            + c * (1 - f[:, None]) * f[None, :]
            + d * f[:, None] * f[None, :])


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
    return HostTexture(img.astype(np.float32), name="marble", srgb=False)


def noise_roughness_texture(n=256, seed=11, lo=0.15, hi=0.8):
    v = _value_noise(n, 16, seed)
    v = lo + (hi - lo) * (v - v.min()) / max(np.ptp(v), 1e-6)
    img = np.repeat(v[:, :, None], 3, axis=2)
    return HostTexture(img.astype(np.float32), name="rough", srgb=False)


def bathroom(width=1280, height=720, detail: int = 1):
    """The benchmark interior. detail=1 -> 129,252 tris; detail=0 -> the
    ~20k-tri smoke-test variant. Returns (HostScene, Camera)."""
    s = HostScene()
    d = max(0, detail)
    seg = 128 if d else 32         # lathe/sphere tessellation
    gsub = 128 if d else 24        # floor/wall grid subdivision

    tex_floor = s.add_texture(checker_texture())
    tex_marble = s.add_texture(marble_texture())
    tex_rough = s.add_texture(noise_roughness_texture())

    m_floor = s.add_material(name="tile_floor", color=(1.0, 1.0, 1.0),
                             roughness=0.4, specular=0.7,
                             tex_diffuse=tex_floor)
    m_wall = s.add_material(name="wall_tiles", color=(0.75, 0.8, 0.82),
                            roughness=0.6, tex_roughness=tex_rough)
    m_marble = s.add_material(name="marble", color=(1.0, 1.0, 1.0),
                              roughness=0.25, specular=0.9,
                              tex_diffuse=tex_marble)
    m_ceramic = s.add_material(name="ceramic", color=(0.92, 0.93, 0.95),
                               roughness=0.2, specular=0.8, reflection=0.08)
    m_chrome = s.add_material(name="chrome", color=(0.85, 0.87, 0.9),
                              roughness=0.0, reflection=1.0)
    m_mirror = s.add_material(name="mirror", color=(0.95, 0.95, 0.97),
                              roughness=0.0, reflection=1.0)
    m_glass = s.add_material(name="glass", color=(1.0, 1.0, 1.0),
                             roughness=0.0, transmission=1.0, eta=1.5,
                             absorption=(0.02, 0.01, 0.0))
    m_towel_r = s.add_material(name="towel_red", color=(0.65, 0.12, 0.12),
                               roughness=1.0)
    m_towel_b = s.add_material(name="towel_blue", color=(0.15, 0.25, 0.6),
                               roughness=1.0)
    m_wood = s.add_material(name="wood", color=(0.45, 0.3, 0.18),
                            roughness=0.8)

    W, H, D = 6.0, 3.0, 4.5          # room extents

    floor = grid_mesh(gsub, gsub, W, D, m_floor, uv_scale=3.0, name="floor")
    s.add_instance(s.add_mesh(floor))
    ceil = grid_mesh(gsub // 2, gsub // 2, W, D, m_wall, name="ceiling")
    s.add_instance(s.add_mesh(ceil), _tr(t=(0, H, 0), rx=np.pi))
    wall_b = grid_mesh(gsub, gsub // 2, W, H, m_wall, uv_scale=2.0,
                       name="wall_back")
    s.add_instance(s.add_mesh(wall_b), _tr(t=(0, H / 2, -D / 2), rx=np.pi / 2))
    wall_f = grid_mesh(gsub, gsub // 2, W, H, m_wall, name="wall_front")
    s.add_instance(s.add_mesh(wall_f), _tr(t=(0, H / 2, D / 2), rx=-np.pi / 2))
    wall_l = grid_mesh(gsub, gsub // 2, D, H, m_wall, name="wall_left")
    s.add_instance(s.add_mesh(wall_l),
                   _tr(t=(-W / 2, H / 2, 0), rz=-np.pi / 2, ry=np.pi / 2))
    wall_r = grid_mesh(gsub, gsub // 2, D, H, m_wall, name="wall_right")
    s.add_instance(s.add_mesh(wall_r),
                   _tr(t=(W / 2, H / 2, 0), rz=np.pi / 2, ry=np.pi / 2))

    # bathtub: outer+inner lathe shells
    pr = np.array([0.0, 0.55, 0.62, 0.65, 0.65, 0.55, 0.50, 0.12, 0.0])
    py = np.array([0.02, 0.02, 0.10, 0.30, 0.62, 0.62, 0.58, 0.10, 0.08])
    tub = lathe_mesh(pr, py, seg, m_ceramic, name="tub")
    tub_t = _tr(t=(-1.8, 0.0, -1.2), sx=1.8, sy=1.0, sz=1.1)
    s.add_instance(s.add_mesh(tub), tub_t)

    # pedestal sink: column + basin
    col = lathe_mesh(np.array([0.10, 0.12, 0.09, 0.09, 0.14]),
                     np.array([0.0, 0.02, 0.1, 0.72, 0.78]),
                     seg // 2, m_ceramic, name="sink_col")
    s.add_instance(s.add_mesh(col), _tr(t=(1.9, 0.0, -1.7)))
    basin = lathe_mesh(np.array([0.0, 0.28, 0.30, 0.26, 0.05, 0.0]),
                       np.array([0.78, 0.80, 0.92, 0.94, 0.82, 0.81]),
                       seg, m_marble, name="sink_basin")
    s.add_instance(s.add_mesh(basin), _tr(t=(1.9, 0.0, -1.7)))

    # chrome faucets (small lathes) on tub and sink
    fau = s.add_mesh(lathe_mesh(np.array([0.025, 0.03, 0.02, 0.04]),
                                np.array([0.0, 0.12, 0.2, 0.24]),
                                seg // 3, m_chrome, name="faucet"))
    s.add_instance(fau, _tr(t=(1.9, 0.94, -1.95)))
    s.add_instance(fau, _tr(t=(-1.8, 0.65, -2.2)))

    mirror = grid_mesh(2, 2, 1.1, 0.9, m_mirror, name="mirror")
    s.add_instance(s.add_mesh(mirror),
                   _tr(t=(1.9, 1.75, -D / 2 + 0.03), rx=np.pi / 2))

    panel = box_mesh(0.04, 2.0, 1.4, m_glass, name="shower_glass")
    s.add_instance(s.add_mesh(panel), _tr(t=(0.4, 0.0, -1.45)))

    towel1 = box_mesh(0.5, 0.08, 0.35, m_towel_r, subdiv=16 if d else 2,
                      name="towel1")
    s.add_instance(s.add_mesh(towel1), _tr(t=(1.0, 0.9, 1.6), ry=0.3))
    towel2 = box_mesh(0.5, 0.08, 0.35, m_towel_b, subdiv=16 if d else 2,
                      name="towel2")
    s.add_instance(s.add_mesh(towel2), _tr(t=(1.05, 0.99, 1.62), ry=0.25))
    bench = box_mesh(1.2, 0.45, 0.45, m_wood, subdiv=4, name="bench")
    s.add_instance(s.add_mesh(bench), _tr(t=(1.05, 0.0, 1.6)))

    st, sl = (32, 64) if d else (8, 16)
    s.add_instance(s.add_mesh(sphere_mesh(0.12, st, sl, m_glass, "bubble1")),
                   _tr(t=(-1.5, 0.75, -1.1)))
    s.add_instance(s.add_mesh(sphere_mesh(0.09, st, sl, m_ceramic, "soap")),
                   _tr(t=(2.05, 0.96, -1.62)))
    s.add_instance(s.add_mesh(sphere_mesh(0.15, st, sl, m_chrome, "ball")),
                   _tr(t=(0.9, 0.45 + 0.15, 1.35)))

    # lights: ceiling area panel + warm area strip + spot + a dim point
    m_panel = s.add_material(name="light_panel", color=(14.0, 13.0, 11.0))
    lp = s.add_quad((0, -1, 0), (0.0, H - 0.01, 0.0), 1.6, 1.0, m_panel)
    s.add_instance(lp)
    m_strip = s.add_material(name="light_strip", color=(10.0, 7.0, 3.5))
    ls = s.add_quad((0, 0, 1), (1.9, 2.45, -D / 2 + 0.02), 1.3, 0.12, m_strip)
    s.add_instance(ls)
    s.add_spot_light((-2.2, 2.8, 1.6), (18.0, 16.0, 13.0),
                     direction=(0.45, -0.85, -0.28),
                     inner_deg=16.0, outer_deg=26.0)
    s.add_point_light((0.0, 1.2, 1.9), (0.6, 0.7, 0.9))

    cam = Camera(pixel_count=(width, height), fov=58.0)
    cam.look_at((2.2, 1.5, 1.9), (-0.6, 0.9, -1.2))
    cam.focal_distance = 3.2
    return s, cam


def _tr(t=(0, 0, 0), rx=0.0, ry=0.0, rz=0.0, sx=1.0, sy=1.0, sz=1.0):
    """Compose T · Rz · Ry · Rx · S as a 4x4 float32 matrix."""
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
