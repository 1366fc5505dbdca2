"""Programmatic test scenes.

Numpy copy of lighthouse2_tpu/scene/presets.py: test_sky, cornell_box and
its helpers, single_triangle.
"""
from __future__ import annotations

import numpy as np

from lighthouse2_tpu_torch.scene.camera import Camera
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh
from lighthouse2_tpu_torch.scene.host_scene import HostScene


def test_sky(scene: HostScene, h=8, w=16):
    """TESTSKY analog (host_skydome.cpp:72-80): R/G/B thirds by latitude."""
    sky = np.zeros((h, w, 3), np.float32)
    sky[: h // 3, :, 0] = 1.0
    sky[h // 3: 2 * h // 3, :, 1] = 1.0
    sky[2 * h // 3:, :, 2] = 1.0
    scene.set_sky(sky)


def _box_meshes(scene: HostScene, size=1.0):
    """Cornell-style box interior: floor/ceiling/back/left/right walls."""
    white = scene.add_material(name="white", color=(0.73, 0.73, 0.73))
    red = scene.add_material(name="red", color=(0.65, 0.05, 0.05))
    green = scene.add_material(name="green", color=(0.12, 0.45, 0.15))
    s = size
    floor = scene.add_quad((0, 1, 0), (0, 0, 0), 2 * s, 2 * s, white)
    ceil = scene.add_quad((0, -1, 0), (0, 2 * s, 0), 2 * s, 2 * s, white)
    back = scene.add_quad((0, 0, 1), (0, s, -s), 2 * s, 2 * s, white)
    left = scene.add_quad((1, 0, 0), (-s, s, 0), 2 * s, 2 * s, red)
    right = scene.add_quad((-1, 0, 0), (s, s, 0), 2 * s, 2 * s, green)
    for m in (floor, ceil, back, left, right):
        scene.add_instance(m)
    return white, red, green


def cornell_box(width=128, height=128, light_scale=1.0,
                tall_block=True, short_block=True):
    """The classic Cornell box. Returns (HostScene, Camera); the box spans
    [-1,1]x[0,2]x[-1,1], camera at +z looking in -z."""
    scene = HostScene()
    _box_meshes(scene)
    light_mat = scene.add_material(
        name="light", color=(17.0 * light_scale, 12.0 * light_scale,
                             4.0 * light_scale))
    lm = scene.add_quad((0, -1, 0), (0, 1.999, 0), 0.6, 0.6, light_mat)
    scene.add_instance(lm)

    if tall_block:
        white = scene.find_material("white")
        bm = _block_mesh(0.6, 1.2, 0.6, white)
        t = np.eye(4, dtype=np.float32)
        c, sn = np.cos(np.radians(18)), np.sin(np.radians(18))
        t[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
        t[:3, 3] = (-0.35, 0.0, -0.35)
        scene.add_instance(scene.add_mesh(bm), t)
    if short_block:
        white = scene.find_material("white")
        bm = _block_mesh(0.6, 0.6, 0.6, white)
        t = np.eye(4, dtype=np.float32)
        c, sn = np.cos(np.radians(-20)), np.sin(np.radians(-20))
        t[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]], np.float32)
        t[:3, 3] = (0.4, 0.0, 0.3)
        scene.add_instance(scene.add_mesh(bm), t)

    cam = Camera(pixel_count=(width, height), fov=40.0)
    cam.look_at((0.0, 1.0, 3.4), (0.0, 1.0, 0.0))
    cam.focal_distance = 3.4
    return scene, cam


def _block_mesh(w, h, d, mat):
    """Axis-aligned box sitting on y=0, centered at origin in x/z (flat faces)."""
    hw, hd = w / 2, d / 2
    v = np.array([
        [-hw, 0, -hd], [hw, 0, -hd], [hw, 0, hd], [-hw, 0, hd],
        [-hw, h, -hd], [hw, h, -hd], [hw, h, hd], [-hw, h, hd],
    ], np.float32)
    faces = np.array([
        [4, 6, 5], [4, 7, 6],        # top (+y)
        [0, 1, 2], [0, 2, 3],        # bottom (-y)
        [3, 2, 6], [3, 6, 7],        # front (+z)
        [1, 0, 4], [1, 4, 5],        # back (-z)
        [0, 3, 7], [0, 7, 4],        # left (-x)
        [2, 1, 5], [2, 5, 6],        # right (+x)
    ], np.int32)
    return HostMesh.from_indexed_data(v, faces, material=mat, flat=True)


def single_triangle(width=64, height=64):
    """BASELINE config 1: a single triangle in front of the camera."""
    scene = HostScene()
    mat = scene.add_material(name="tri", color=(0.8, 0.3, 0.2))
    v = np.array([[-1, 0, 0], [1, 0, 0], [0, 1.5, 0]], np.float32)
    idx = np.array([[0, 1, 2]], np.int32)
    scene.add_instance(scene.add_mesh(
        HostMesh.from_indexed_data(v, idx, material=mat, flat=True)))
    scene.set_sky((0.1, 0.1, 0.1))
    cam = Camera(pixel_count=(width, height))
    cam.look_at((0, 0.5, 3.0), (0, 0.5, 0.0))
    return scene, cam
