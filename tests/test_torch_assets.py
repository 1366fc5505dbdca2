"""The port's file loading against the JAX package's, on files written to
tmp_path: OBJ + MTL, glTF and GLB, PNG / HDR, the texture and sky caches,
and material (de)serialisation.

Tolerance: none. Every comparison is exact: the loaders, codecs and caches
are numpy copies, so the same file gives the same arrays, the same
materials, nodes, skins and animation samplers, and byte-equal files.
Each package reads its own copy of a file where a cache could let one reuse
what the other decoded.
"""
import dataclasses
import os
import shutil

import jax  # noqa: F401  (both frameworks share the process, as in every test_torch_* file)
import numpy as np
import torch

from lighthouse2_tpu.scene import host_material as jmat
from lighthouse2_tpu.scene.host_scene import HostScene as JScene
from lighthouse2_tpu.scene.host_texture import HostTexture as JTexture
from lighthouse2_tpu.utils import image as jim
from lighthouse2_tpu_torch.api import RenderAPI
from lighthouse2_tpu_torch.scene.host_scene import HostScene as TScene
from lighthouse2_tpu_torch.scene.host_texture import MIP_LEVELS
from lighthouse2_tpu_torch.scene.host_texture import HostTexture as TTexture
from lighthouse2_tpu_torch.tools.anim_gltf import write_anim_gltf
from lighthouse2_tpu_torch.utils import image as tim

torch.set_num_threads(1)

OBJ = """mtllib box.mtl
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0 -1
usemtl tex
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl lamp
f -5//2 -4//2 -3//2
f 2 3 5
"""
MTL = """newmtl tex
Kd 0.8 0.7 0.6
Ks 0.2 0.2 0.2
map_Kd tex.png
newmtl lamp
Kd 0.1 0.1 0.1
Ke 5 4 3
d 0.5
Ni 1.4
"""


def _png(path, seed=3, shape=(12, 20, 3)):
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    tim.write_png(path, img)
    return img


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
    elif isinstance(a, (list, tuple)) and a and isinstance(
            a[0], (np.ndarray, tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


def _assert_scenes_equal(t, j):
    """Meshes, materials, textures, nodes, skins, animations and roots."""
    assert len(t.meshes) == len(j.meshes)
    for i, (tm, jm) in enumerate(zip(t.meshes, j.meshes)):
        for f in dataclasses.fields(jm):
            _same(getattr(tm, f.name), getattr(jm, f.name), f"mesh{i}.{f.name}")
    assert [m.to_dict() for m in t.materials] == \
        [m.to_dict() for m in j.materials]
    assert len(t.textures) == len(j.textures)
    for tt, jt in zip(t.textures, j.textures):
        _same(tt.mips, jt.mips, "mips")
    assert len(t.nodes) == len(j.nodes)
    for i, (tn, jn) in enumerate(zip(t.nodes, j.nodes)):
        for k in ("mesh_id", "matrix", "translation", "rotation", "scale",
                  "has_trs", "children", "name", "skin_id", "morph_weights"):
            _same(getattr(tn, k), getattr(jn, k), f"node{i}.{k}")
    for ts, js in zip(t.skins, j.skins):
        _same(ts.joint_nodes, js.joint_nodes, "joints")
        _same(ts.inverse_bind, js.inverse_bind, "inverse_bind")
    assert len(t.skins) == len(j.skins)
    assert len(t.animations) == len(j.animations)
    for ta, ja in zip(t.animations, j.animations):
        for ts, js in zip(ta.samplers, ja.samplers):
            _same((ts.t, ts.v, ts.interp), (js.t, js.v, js.interp), "sampler")
        assert [(c.sampler, c.node, c.target) for c in ta.channels] == \
            [(c.sampler, c.node, c.target) for c in ja.channels]
    assert t.root_nodes == j.root_nodes


def test_obj_and_mtl_equal_jax(tmp_path):
    for side in ("t", "j"):
        d = tmp_path / side
        d.mkdir()
        (d / "box.obj").write_text(OBJ)
        (d / "box.mtl").write_text(MTL)
        _png(str(d / "tex.png"))
    t, j = TScene(), JScene()
    tid = t.load_obj(str(tmp_path / "t" / "box.obj"), scale=2.0)
    jid = j.load_obj(str(tmp_path / "j" / "box.obj"), scale=2.0)
    assert tid == jid == 0
    _assert_scenes_equal(t, j)
    assert t.meshes[0].n_tris == 4 and len(t.textures) == 1
    lamp = t.materials[t.find_material("lamp")]
    assert lamp.color == (5.0, 4.0, 3.0) and lamp.transmission == 0.5
    assert t.materials[t.find_material("tex")].tex_diffuse == 0


def test_gltf_and_glb_equal_jax(tmp_path):
    """A skinned tube, a morphing sphere and a textured box (the
    asset of test_torch_apps_card.py at a small size) as .gltf with an external
    buffer and PNG, and as .glb with the PNG inside; loaded under a
    transform, and a second time without one into the same scene."""
    xf = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    xf[:3, 3] = (0.5, -1.0, 0.25)
    for glb in (False, True):
        paths = [write_anim_gltf(str(tmp_path / f"{side}{glb}"), 8, 5, 8, 5,
                                 16, glb=glb) for side in ("t", "j")]
        t, j = TScene(), JScene()
        for x in (xf, None):
            assert t.load_gltf(paths[0], transform=x) == \
                j.load_gltf(paths[1], transform=x)
        _assert_scenes_equal(t, j)
        assert [m.n_tris for m in t.meshes] == [64, 64, 12] * 2
        assert t.meshes[0].joints.shape == (40, 4)
        assert len(t.meshes[1].morph_targets) == 1
        assert t.materials[2].tex_diffuse == 0 and len(t.animations) == 2


def test_png_and_hdr_round_trips_equal_jax(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (13, 17, 3), np.uint8)
    f = np.random.default_rng(1).uniform(0, 1, (5, 9, 3)).astype(np.float32)
    hdr = (np.abs(np.random.default_rng(2).normal(size=(9, 11, 3))) * 5
           ).astype(np.float32)
    for name, src, tw, jw, tr, jr in (
            ("u8.png", img, tim.write_png, jim.write_png, tim.read_png,
             jim.read_png),
            ("f32.png", f, tim.write_png, jim.write_png, tim.read_png,
             jim.read_png),
            ("x.hdr", hdr, tim.write_hdr, jim.write_hdr, tim.read_hdr,
             jim.read_hdr)):
        tp, jp = str(tmp_path / ("t" + name)), str(tmp_path / ("j" + name))
        tw(tp, src)
        jw(jp, src)
        with open(tp, "rb") as a, open(jp, "rb") as b:
            raw = a.read()
            assert raw == b.read(), name
        _same(tr(tp), jr(jp), name)
        if name.endswith(".png"):
            _same(tim.read_png(raw), jim.read_png(jp), name + " bytes")
    np.testing.assert_array_equal(tim.read_png(str(tmp_path / "tu8.png")), img)


def test_texture_and_sky_caches(tmp_path):
    p = str(tmp_path / "t.png")
    _png(p, shape=(32, 48, 3))
    t1 = TTexture.load(p)
    assert os.path.exists(p + ".lh2c.npz")
    _same(TTexture.load(p).mips, t1.mips, "cached")
    q = str(tmp_path / "j.png")
    shutil.copy(p, q)
    _same(t1.mips, JTexture.load(q).mips, "jax")
    # a changed mtime re-decodes: new pixels, same path
    _png(p, seed=9, shape=(32, 48, 3))
    os.utime(p, (os.path.getmtime(p) + 10,) * 2)
    t2 = TTexture.load(p)
    assert not np.array_equal(t2.mips[0], t1.mips[0])
    _same(t2.mips, TTexture(tim.read_png(p)).mips, "re-decoded")
    assert len(t2.mips) == MIP_LEVELS
    r = str(tmp_path / "r.png")
    _png(r)
    TTexture.load(r, cache=False)
    assert not os.path.exists(r + ".lh2c.npz")

    s = str(tmp_path / "sky.hdr")
    rng = np.random.default_rng(7)
    tim.write_hdr(s, rng.uniform(0.1, 3.0, (16, 32, 3)).astype(np.float32))
    shutil.copy(s, str(tmp_path / "jsky.hdr"))
    a, b, jb = TScene(), TScene(), JScene()
    a.load_sky(s)
    assert os.path.exists(s + ".lh2sky.npz")
    b.load_sky(s)
    jb.load_sky(str(tmp_path / "jsky.hdr"))
    for x in (b, jb):
        _same(x.sky_pixels, a.sky_pixels, "sky pixels")
        for u, v in zip(x._sky_ibl, a._sky_ibl):
            _same(np.asarray(u), np.asarray(v), "sky tables")
    sky = b.sync("cpu", rebuild_bvh=False).sky
    assert sky.has_ibl and b.sync("cpu", rebuild_bvh=False).bvh is None
    _same(sky.pdf.numpy(), a._sky_ibl[0], "uploaded pdf")
    tim.write_hdr(s, np.full((8, 8, 3), 0.5, np.float32))
    os.utime(s, (os.path.getmtime(s) + 10,) * 2)
    c = TScene()
    c.load_sky(s)
    assert c.sky_pixels.shape == (8, 8, 3)


def test_material_serialisation_round_trip(tmp_path):
    t = TScene()
    t.add_material(name="red", color=(0.8, 0.1, 0.1), roughness=0.3)
    t.add_material(name="lamp", color=(5.0, 4.0, 3.0), tex_diffuse=2,
                   absorption=(0.1, 0.2, 0.3))
    api = RenderAPI.create("wavefront", width=8, height=8, device="cpu")
    api.scene = t
    path = str(tmp_path / "m.json")
    api.serialize_materials(path)
    assert [m.to_dict() for m in jmat.deserialize_materials(path)] == \
        [m.to_dict() for m in t.materials]
    # a JAX-written file, matched into the port's scene by name
    j = JScene()
    j.add_material(name="lamp", color=(9.0, 9.0, 9.0), metallic=0.5)
    j.add_material(name="absent", color=(0.1, 0.1, 0.1))
    j.serialize_materials(str(tmp_path / "j.json"))
    t.dirty = False
    assert api.deserialize_materials(str(tmp_path / "j.json")) == 1
    assert t.dirty and t.materials[1].to_dict() == j.materials[0].to_dict()
    assert t.materials[0].name == "red"
    assert api.deserialize_materials(str(tmp_path / "none.json")) == 0
