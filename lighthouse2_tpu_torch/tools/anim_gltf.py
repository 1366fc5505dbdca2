"""Write an animated glTF 2.0 asset from numbers alone (json, struct and
utils/image.py; nothing is downloaded).

The asset holds what the glTF loader and the scene's animation path read:
  - a tube of `2 * segments * (rings - 1)` triangles skinned to a chain of
    three joints, the second rotated by a LINEAR channel and the third by a
    CUBICSPLINE channel;
  - a sphere of `2 * slices * (stacks - 1)` triangles with one morph target
    (a displacement along the normal) and a LINEAR weights channel;
  - a rigid box of 12 triangles with a PNG base-colour texture (a checker)
    and a LINEAR translation channel.
The animation lasts 2 s. The default sizes are those of the card test
(tests/test_torch_apps_card.py: 65,536 + 16,384 + 12 triangles); the CPU
tests pass small ones.

    path = write_anim_gltf(directory)                 # .gltf + .bin + .png
    path = write_anim_gltf(directory, glb=True)       # one .glb, image inside
"""
from __future__ import annotations

import json
import os
import struct

import numpy as np

from lighthouse2_tpu_torch.utils.image import read_png, write_png

TUBE_RADIUS, TUBE_HEIGHT = 0.15, 1.2
SPHERE_RADIUS = 0.25


def _tube(segments, rings):
    a = 2 * np.pi * np.arange(segments) / segments
    y = TUBE_HEIGHT * np.arange(rings) / (rings - 1)
    aa, yy = np.meshgrid(a, y)                       # [rings, segments]
    pos = np.stack([TUBE_RADIUS * np.cos(aa), yy, TUBE_RADIUS * np.sin(aa)],
                   -1).reshape(-1, 3)
    nrm = np.stack([np.cos(aa), np.zeros_like(aa), np.sin(aa)], -1).reshape(-1, 3)
    uv = np.stack([aa / (2 * np.pi), yy / TUBE_HEIGHT], -1).reshape(-1, 2)
    r, s = np.meshgrid(np.arange(rings - 1), np.arange(segments), indexing="ij")
    i00 = r * segments + s
    i01 = r * segments + (s + 1) % segments
    i10 = i00 + segments
    i11 = i01 + segments
    idx = np.stack([np.stack([i00, i10, i01], -1),
                    np.stack([i01, i10, i11], -1)], -2).reshape(-1, 3)
    # hat weights around the joints at 0, h/3 and 2h/3 (the top third
    # follows the last joint alone); they sum to 1
    hj = TUBE_HEIGHT / 3 * np.arange(3)
    yc = np.minimum(pos[:, 1:2], hj[-1])
    w = np.maximum(0.0, 1.0 - np.abs(yc - hj[None]) / hj[1])
    weights = np.concatenate([w, np.zeros((w.shape[0], 1))], -1)
    joints = np.tile(np.array([0, 1, 2, 0], np.uint16), (pos.shape[0], 1))
    return pos, nrm, uv, idx, joints, weights


def _sphere(slices, stacks):
    th = np.pi * np.arange(1, stacks) / stacks       # interior rings
    ph = 2 * np.pi * np.arange(slices) / slices
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    ring = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    nrm = np.concatenate([[[0, 1, 0]], ring, [[0, -1, 0]]], 0)
    n_ring = ring.shape[0]
    r, s = np.meshgrid(np.arange(stacks - 2), np.arange(slices), indexing="ij")
    i00 = 1 + r * slices + s
    i01 = 1 + r * slices + (s + 1) % slices
    i10, i11 = i00 + slices, i01 + slices
    body = np.stack([np.stack([i00, i01, i10], -1),
                     np.stack([i01, i11, i10], -1)], -2).reshape(-1, 3)
    s = np.arange(slices)
    top = np.stack([np.zeros_like(s), 1 + (s + 1) % slices, 1 + s], -1)
    last = 1 + (stacks - 2) * slices
    bottom = np.stack([np.full_like(s, n_ring + 1), last + s,
                       last + (s + 1) % slices], -1)
    idx = np.concatenate([top, body, bottom], 0)
    dpos = 0.25 * SPHERE_RADIUS * nrm * nrm[:, 1:2] ** 2
    return SPHERE_RADIUS * nrm, nrm, idx, dpos


def _box(half=0.15):
    pos, nrm, uv, idx = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            n = np.zeros(3)
            n[axis] = sign
            u = np.zeros(3)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            base = len(pos)
            for cu, cv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                pos.append(half * (n + (2 * cu - 1) * u + (2 * cv - 1) * v))
                nrm.append(n)
                uv.append((cu, cv))
            idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return (np.array(pos), np.array(nrm), np.array(uv), np.array(idx))


def _quat(axis, angle):
    q = np.zeros(4)
    q[axis] = np.sin(angle / 2)
    q[3] = np.cos(angle / 2)
    return q


class _Buffer:
    """Accessors over one little-endian binary buffer, 4-byte aligned."""

    def __init__(self):
        self.data = b""
        self.views, self.accessors = [], []

    def view(self, raw: bytes) -> int:
        self.data += b"\x00" * (-len(self.data) % 4)
        self.views.append({"buffer": 0, "byteOffset": len(self.data),
                           "byteLength": len(raw)})
        self.data += raw
        return len(self.views) - 1

    def accessor(self, arr, kind: str, comp: int, dtype) -> int:
        arr = np.ascontiguousarray(arr, dtype)
        acc = {"bufferView": self.view(arr.tobytes()), "componentType": comp,
               "count": int(arr.shape[0]), "type": kind}
        if kind == "VEC3" and comp == 5126:
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        self.accessors.append(acc)
        return len(self.accessors) - 1


def write_anim_gltf(directory: str, segments: int = 128, rings: int = 257,
                    slices: int = 128, stacks: int = 65, tex_size: int = 64,
                    glb: bool = False, name: str = "anim") -> str:
    """Write the asset into `directory`; returns the .gltf or .glb path."""
    os.makedirs(directory, exist_ok=True)
    b = _Buffer()
    f32 = lambda a, kind: b.accessor(a, kind, 5126, np.float32)
    u32 = lambda a: b.accessor(np.asarray(a).reshape(-1), "SCALAR", 5125,
                               np.uint32)

    tpos, tnrm, tuv, tidx, tj, tw = _tube(segments, rings)
    tube = {"attributes": {"POSITION": f32(tpos, "VEC3"),
                           "NORMAL": f32(tnrm, "VEC3"),
                           "TEXCOORD_0": f32(tuv, "VEC2"),
                           "JOINTS_0": b.accessor(tj, "VEC4", 5123, np.uint16),
                           "WEIGHTS_0": f32(tw, "VEC4")},
            "indices": u32(tidx), "material": 0}
    spos, snrm, sidx, sdp = _sphere(slices, stacks)
    sphere = {"attributes": {"POSITION": f32(spos, "VEC3"),
                             "NORMAL": f32(snrm, "VEC3")},
              "indices": u32(sidx), "material": 1,
              "targets": [{"POSITION": f32(sdp, "VEC3")}]}
    bpos, bnrm, buv, bidx = _box()
    box = {"attributes": {"POSITION": f32(bpos, "VEC3"),
                          "NORMAL": f32(bnrm, "VEC3"),
                          "TEXCOORD_0": f32(buv, "VEC2")},
           "indices": u32(bidx), "material": 2}

    h3 = TUBE_HEIGHT / 3
    ibm = np.tile(np.eye(4), (3, 1, 1))
    ibm[:, 1, 3] = -h3 * np.arange(3)
    ibm_acc = f32(ibm.transpose(0, 2, 1).reshape(3, 16), "MAT4")

    times3 = f32(np.array([0.0, 1.0, 2.0]), "SCALAR")
    times2 = f32(np.array([0.0, 2.0]), "SCALAR")
    rot_lin = f32(np.stack([_quat(2, a) for a in (0.0, 0.5, 0.0)]), "VEC4")
    zero_q = np.zeros(4)
    rot_cub = f32(np.stack([x for a in (0.0, -0.6, 0.0)
                            for x in (zero_q, _quat(0, a), zero_q)]), "VEC4")
    weights = f32(np.array([0.0, 1.0, 0.0]), "SCALAR")
    trans = f32(np.array([[-0.7, 0.2, 0.1], [-0.7, 0.5, 0.3]]), "VEC3")

    checker = ((np.indices((tex_size, tex_size)) // 8).sum(0) % 2).astype(bool)
    tex = np.where(checker[..., None], [230, 200, 40], [40, 60, 200])
    tex = tex.astype(np.uint8)
    png_name = f"{name}_checker.png"
    write_png(os.path.join(directory, png_name), tex)
    image = {"uri": png_name}
    if glb:
        with open(os.path.join(directory, png_name), "rb") as fh:
            png = fh.read()
        assert read_png(png).shape == tex.shape
        image = {"bufferView": b.view(png), "mimeType": "image/png"}

    doc = {
        "asset": {"version": "2.0", "generator": "lighthouse2_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0, 3, 4, 5]}],
        "nodes": [
            {"name": "joint0", "children": [1]},
            {"name": "joint1", "translation": [0.0, h3, 0.0], "children": [2]},
            {"name": "joint2", "translation": [0.0, h3, 0.0]},
            {"name": "tube", "mesh": 0, "skin": 0},
            {"name": "sphere", "mesh": 1, "translation": [0.7, 0.45, 0.0],
             "weights": [0.0]},
            {"name": "box", "mesh": 2, "translation": [-0.7, 0.2, 0.1]},
        ],
        "meshes": [{"name": "tube", "primitives": [tube]},
                   {"name": "sphere", "primitives": [sphere],
                    "weights": [0.0]},
                   {"name": "box", "primitives": [box]}],
        "skins": [{"joints": [0, 1, 2], "inverseBindMatrices": ibm_acc}],
        "materials": [
            {"name": "anim_tube", "pbrMetallicRoughness": {
                "baseColorFactor": [0.8, 0.5, 0.2, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 1.0}},
            {"name": "anim_sphere", "pbrMetallicRoughness": {
                "baseColorFactor": [0.3, 0.6, 0.9, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 1.0}},
            {"name": "anim_box", "pbrMetallicRoughness": {
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0, "roughnessFactor": 1.0}}],
        "textures": [{"source": 0}],
        "images": [image],
        "animations": [{"name": "anim", "samplers": [
            {"input": times3, "output": rot_lin, "interpolation": "LINEAR"},
            {"input": times3, "output": rot_cub,
             "interpolation": "CUBICSPLINE"},
            {"input": times3, "output": weights, "interpolation": "LINEAR"},
            {"input": times2, "output": trans, "interpolation": "LINEAR"}],
            "channels": [
                {"sampler": 0, "target": {"node": 1, "path": "rotation"}},
                {"sampler": 1, "target": {"node": 2, "path": "rotation"}},
                {"sampler": 2, "target": {"node": 4, "path": "weights"}},
                {"sampler": 3, "target": {"node": 5, "path": "translation"}}]}],
        "bufferViews": b.views,
        "accessors": b.accessors,
    }
    data = b.data + b"\x00" * (-len(b.data) % 4)
    if glb:
        doc["buffers"] = [{"byteLength": len(data)}]
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        path = os.path.join(directory, f"{name}.glb")
        with open(path, "wb") as fh:
            fh.write(b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(data)))
            fh.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            fh.write(struct.pack("<II", len(data), 0x004E4942) + data)
        return path
    doc["buffers"] = [{"byteLength": len(data), "uri": f"{name}.bin"}]
    with open(os.path.join(directory, f"{name}.bin"), "wb") as fh:
        fh.write(data)
    path = os.path.join(directory, f"{name}.gltf")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path
