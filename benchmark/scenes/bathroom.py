"""The bathroom: a numpy copy of the procedural "bathroom2-class" interior of
lighthouse2_tpu_torch/scene/bench_scene.py (129,252 triangles at detail 1,
the project's own benchmark headline).

build(conf) returns raw arrays only: meshes as indexed vertices, textures
as float images, materials as keyword dicts, lights and the camera as
numbers. The harness hands the same arrays to the program through its
public API (HostMesh, HostScene, Camera) and to the plain reference
(reference/scene.py), so a later change to the program's own scene code
cannot move what is rendered.
"""
from __future__ import annotations

import numpy as np

from benchmark.meshes import (box_mesh, checker_texture, grid_mesh,
                              lathe_mesh, marble_texture,
                              noise_roughness_texture, quad_mesh, sphere_mesh,
                              transform)


def build(conf):
    """The configuration's bathroom (its key `detail`)."""
    return bathroom(detail=conf["detail"])


def bathroom(detail=1):
    """The benchmark interior as raw arrays: a dict with textures (list of
    [H, W, 3] float32 linear images), materials (list of keyword dicts of
    the program's HostMaterial), meshes (list of indexed meshes), instances
    (list of (mesh index, 4x4 world transform)), spot_lights, point_lights
    and camera (look-at, fov, focal distance). detail=1 is the 129,252-
    triangle headline; detail=0 a ~20k-triangle variant for CPU tests."""
    d = max(0, int(detail))
    seg = 128 if d else 32
    gsub = 128 if d else 24
    textures = [checker_texture(), marble_texture(), noise_roughness_texture()]
    tex_floor, tex_marble, tex_rough = 0, 1, 2
    materials = [
        dict(name="tile_floor", color=(1.0, 1.0, 1.0), roughness=0.4,
             specular=0.7, tex_diffuse=tex_floor),
        dict(name="wall_tiles", color=(0.75, 0.8, 0.82), roughness=0.6,
             tex_roughness=tex_rough),
        dict(name="marble", color=(1.0, 1.0, 1.0), roughness=0.25,
             specular=0.9, tex_diffuse=tex_marble),
        dict(name="ceramic", color=(0.92, 0.93, 0.95), roughness=0.2,
             specular=0.8, reflection=0.08),
        dict(name="chrome", color=(0.85, 0.87, 0.9), roughness=0.0,
             reflection=1.0),
        dict(name="mirror", color=(0.95, 0.95, 0.97), roughness=0.0,
             reflection=1.0),
        dict(name="glass", color=(1.0, 1.0, 1.0), roughness=0.0,
             transmission=1.0, eta=1.5, absorption=(0.02, 0.01, 0.0)),
        dict(name="towel_red", color=(0.65, 0.12, 0.12), roughness=1.0),
        dict(name="towel_blue", color=(0.15, 0.25, 0.6), roughness=1.0),
        dict(name="wood", color=(0.45, 0.3, 0.18), roughness=0.8),
        dict(name="light_panel", color=(14.0, 13.0, 11.0)),
        dict(name="light_strip", color=(10.0, 7.0, 3.5)),
    ]
    (m_floor, m_wall, m_marble, m_ceramic, m_chrome, m_mirror, m_glass,
     m_towel_r, m_towel_b, m_wood, m_panel, m_strip) = range(12)
    meshes, instances = [], []

    def add(mesh, *transforms):
        meshes.append(mesh)
        for t in transforms:
            instances.append((len(meshes) - 1, t))

    W, H, D = 6.0, 3.0, 4.5
    add(grid_mesh(gsub, gsub, W, D, m_floor, uv_scale=3.0, name="floor"), None)
    add(grid_mesh(gsub // 2, gsub // 2, W, D, m_wall, name="ceiling"),
        transform(t=(0, H, 0), rx=np.pi))
    add(grid_mesh(gsub, gsub // 2, W, H, m_wall, uv_scale=2.0,
                  name="wall_back"), transform(t=(0, H / 2, -D / 2), rx=np.pi / 2))
    add(grid_mesh(gsub, gsub // 2, W, H, m_wall, name="wall_front"),
        transform(t=(0, H / 2, D / 2), rx=-np.pi / 2))
    add(grid_mesh(gsub, gsub // 2, D, H, m_wall, name="wall_left"),
        transform(t=(-W / 2, H / 2, 0), rz=-np.pi / 2, ry=np.pi / 2))
    add(grid_mesh(gsub, gsub // 2, D, H, m_wall, name="wall_right"),
        transform(t=(W / 2, H / 2, 0), rz=np.pi / 2, ry=np.pi / 2))
    pr = np.array([0.0, 0.55, 0.62, 0.65, 0.65, 0.55, 0.50, 0.12, 0.0])
    py = np.array([0.02, 0.02, 0.10, 0.30, 0.62, 0.62, 0.58, 0.10, 0.08])
    add(lathe_mesh(pr, py, seg, m_ceramic, name="tub"),
        transform(t=(-1.8, 0.0, -1.2), sx=1.8, sy=1.0, sz=1.1))
    add(lathe_mesh(np.array([0.10, 0.12, 0.09, 0.09, 0.14]),
                   np.array([0.0, 0.02, 0.1, 0.72, 0.78]), seg // 2,
                   m_ceramic, name="sink_col"), transform(t=(1.9, 0.0, -1.7)))
    add(lathe_mesh(np.array([0.0, 0.28, 0.30, 0.26, 0.05, 0.0]),
                   np.array([0.78, 0.80, 0.92, 0.94, 0.82, 0.81]), seg,
                   m_marble, name="sink_basin"), transform(t=(1.9, 0.0, -1.7)))
    add(lathe_mesh(np.array([0.025, 0.03, 0.02, 0.04]),
                   np.array([0.0, 0.12, 0.2, 0.24]), seg // 3, m_chrome,
                   name="faucet"),
        transform(t=(1.9, 0.94, -1.95)), transform(t=(-1.8, 0.65, -2.2)))
    add(grid_mesh(2, 2, 1.1, 0.9, m_mirror, name="mirror"),
        transform(t=(1.9, 1.75, -D / 2 + 0.03), rx=np.pi / 2))
    add(box_mesh(0.04, 2.0, 1.4, m_glass, name="shower_glass"),
        transform(t=(0.4, 0.0, -1.45)))
    add(box_mesh(0.5, 0.08, 0.35, m_towel_r, subdiv=16 if d else 2,
                 name="towel1"), transform(t=(1.0, 0.9, 1.6), ry=0.3))
    add(box_mesh(0.5, 0.08, 0.35, m_towel_b, subdiv=16 if d else 2,
                 name="towel2"), transform(t=(1.05, 0.99, 1.62), ry=0.25))
    add(box_mesh(1.2, 0.45, 0.45, m_wood, subdiv=4, name="bench"),
        transform(t=(1.05, 0.0, 1.6)))
    st, sl = (32, 64) if d else (8, 16)
    add(sphere_mesh(0.12, st, sl, m_glass, "bubble1"), transform(t=(-1.5, 0.75, -1.1)))
    add(sphere_mesh(0.09, st, sl, m_ceramic, "soap"), transform(t=(2.05, 0.96, -1.62)))
    add(sphere_mesh(0.15, st, sl, m_chrome, "ball"),
        transform(t=(0.9, 0.45 + 0.15, 1.35)))
    add(quad_mesh((0, -1, 0), (0.0, H - 0.01, 0.0), 1.6, 1.0, m_panel,
                  name="light_panel"), None)
    add(quad_mesh((0, 0, 1), (1.9, 2.45, -D / 2 + 0.02), 1.3, 0.12, m_strip,
                  name="light_strip"), None)
    return dict(
        textures=textures, materials=materials, meshes=meshes,
        instances=instances,
        spot_lights=[dict(position=(-2.2, 2.8, 1.6), radiance=(18.0, 16.0, 13.0),
                          direction=(0.45, -0.85, -0.28), inner_deg=16.0,
                          outer_deg=26.0)],
        point_lights=[dict(position=(0.0, 1.2, 1.9), radiance=(0.6, 0.7, 0.9))],
        camera=dict(origin=(2.2, 1.5, 1.9), target=(-0.6, 0.9, -1.2),
                    fov=58.0, focal_distance=3.2))
