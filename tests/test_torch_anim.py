"""The port's animation, skinning and morph targets against the JAX
package's, the BLAS cache, an animated render and the render CLI.

  - Sampler values (STEP, LINEAR, CUBICSPLINE; inside, at and outside the
    keys) and every node's local and world matrix after
    HostAnimation.apply / update equal the JAX package's exactly;
  - skinned and morphed posed vertices and normals within 1e-6 (absolute)
    of the JAX _apply_skin / _apply_morph; the port's posed meshes keep the
    unposed texture coordinates (the JAX package's come back zero);
  - build_stats: a rigid move costs 0 BLAS builds and 1 compose, a new
    morph pose rebuilds only that mesh, an animation frame rebuilds the two
    posed meshes; the JAX package counts the same;
  - a 16x16, path-2 CPU render of an animated frame on the two-level tree
    agrees with the single-level (numpy) tree's render on >= 99.9% of
    pixels (rtol 1e-4, atol 1e-6 per channel); the trees differ, so only
    hits at exactly equal t may pick another triangle;
  - render_cli.main([... "--device", "cpu"]) returns 0 and writes a PNG
    that the JAX read_png reads at (height, width, 3).
No JAX render is compiled.
"""
import jax  # noqa: F401  (both frameworks share the process, as in every test_torch_* file)
import numpy as np
import torch

from lighthouse2_tpu.scene import host_anim as janim
from lighthouse2_tpu.scene.host_scene import HostScene as JScene
from lighthouse2_tpu.utils.image import read_png as jax_read_png
from lighthouse2_tpu_torch.apps import render_cli
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, finalize, render_pass_auto)
from lighthouse2_tpu_torch.scene import host_anim as tanim
from lighthouse2_tpu_torch.scene import presets as tpresets
from lighthouse2_tpu_torch.scene.host_scene import HostScene as TScene
from lighthouse2_tpu_torch.tools.anim_gltf import write_anim_gltf

torch.set_num_threads(1)

SMALL = (16, 9, 16, 9, 16)   # tube 16x9, sphere 16x9, a 16x16 texture


def _pair(tmp_path, size=SMALL):
    path = write_anim_gltf(str(tmp_path), *size)
    t, j = TScene(), JScene()
    t.load_gltf(path)
    j.load_gltf(path)
    return t, j, path


def test_samplers_and_node_matrices_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    times = np.sort(rng.uniform(0, 2, 5)).astype(np.float32)
    probes = np.concatenate([[-1.0, 3.0], times, rng.uniform(0, 2, 20)])
    for interp, n_val, width in (("STEP", 5, 3), ("LINEAR", 5, 4),
                                 ("CUBICSPLINE", 15, 4), ("LINEAR", 1, 3),
                                 ("CUBICSPLINE", 3, 4)):
        vals = rng.normal(size=(n_val, width)).astype(np.float32)
        tt = times[:max(1, n_val // (3 if interp == "CUBICSPLINE" else 1))]
        ts, js = (m.Sampler(tt, vals, interp) for m in (tanim, janim))
        for x in probes:
            np.testing.assert_array_equal(ts.sample(x), js.sample(x),
                                          err_msg=f"{interp} {x}")
    t, j, _ = _pair(tmp_path)
    for step in (0.0, 0.25, 0.6, 1.3, 0.9):
        t.animations[0].update(t, step)
        j.animations[0].update(j, step)
        assert t.animations[0].time == j.animations[0].time
        for inst_t, inst_j in zip(t.flatten_instances(), j.flatten_instances()):
            np.testing.assert_array_equal(inst_t[1], inst_j[1])
        for tn, jn in zip(t.nodes, j.nodes):
            np.testing.assert_array_equal(tn.local_transform(),
                                          jn.local_transform())
            np.testing.assert_array_equal(tn.combined, jn.combined)
            np.testing.assert_array_equal(tn.morph_weights, jn.morph_weights)


def test_skin_and_morph_poses_equal_jax(tmp_path):
    t, j, _ = _pair(tmp_path, (32, 17, 32, 17, 16))
    for a in (t, j):
        a.animations[0].apply(a, 0.7)
    posed = []
    for a in (t, j):
        insts = a.flatten_instances()
        posed.append([a._posed_mesh(a.meshes[m], node) for m, _, node in insts])
    moved = 0
    for mesh, pt, pj in zip(t.meshes, *posed):
        for f in ("v0", "v1", "v2", "n0", "n1", "n2", "face_n", "alpha"):
            np.testing.assert_allclose(getattr(pt, f), getattr(pj, f),
                                       rtol=0, atol=1e-6, err_msg=f)
        for f in ("uv0", "uv1", "uv2"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(mesh, f))
        if pt is not mesh:
            moved += 1
            assert np.abs(pt.v0 - mesh.v0).max() > 1e-2
            np.testing.assert_array_equal(pt.mat, mesh.mat)
    assert moved == 2
    # the JAX package's posed tube has lost its texture coordinates
    assert not posed[1][0].uv1.any() and t.meshes[0].uv1.any()


def test_build_stats_rebuild_only_what_moved(tmp_path):
    t, j, _ = _pair(tmp_path)
    box = [i for i, n in enumerate(t.nodes) if n.name == "box"][0]
    sphere = [i for i, n in enumerate(t.nodes) if n.name == "sphere"][0]
    deltas = []
    for a in (t, j):
        sync = (lambda: a.sync("cpu")) if a is t else a.sync
        sync()
        steps = []
        for move in ("rigid", "morph", "frame", "none"):
            before = dict(a.build_stats)
            if move == "rigid":
                m = np.eye(4, dtype=np.float32)
                m[:3, 3] = (0.1, 0.2, 0.3)
                a.set_node_transform(box, m)
            elif move == "morph":
                a.nodes[sphere].morph_weights = [0.5]
                a.dirty = True
            elif move == "frame":
                a.animations[0].update(a, 0.1)
            sync()
            steps.append({k: a.build_stats[k] - before[k] for k in before})
        deltas.append(steps)
    assert deltas[0] == deltas[1]
    assert deltas[0] == [dict(blas_builds=0, tlas_composes=1),
                         dict(blas_builds=1, tlas_composes=1),
                         dict(blas_builds=2, tlas_composes=1),
                         dict(blas_builds=0, tlas_composes=0)]


def test_animated_frame_two_level_equals_single_level(tmp_path):
    host, cam = tpresets.cornell_box(16, 16)
    xf = np.diag([0.7, 0.7, 0.7, 1.0]).astype(np.float32)
    xf[:3, 3] = (0.1, 0.0, 0.0)
    host.load_gltf(write_anim_gltf(str(tmp_path), *SMALL), transform=xf)
    host.animations[0].update(host, 0.4)
    cfg = RenderConfig(width=16, height=16, max_path_length=2,
                       path_regen=True)
    view = cam.get_view("cpu")
    imgs = []
    for kw in (dict(), dict(two_level=False, native=False)):
        ds = host.sync("cpu", **kw)
        state, _ = render_pass_auto(ds, view, AccumState.make(cfg, "cpu"),
                                    cfg)
        imgs.append(finalize(state))
    assert host.build_stats["tlas_composes"] == 1
    assert torch.isfinite(imgs[0]).all() and imgs[0].mean() > 0
    close = torch.isclose(imgs[0], imgs[1], rtol=1e-4, atol=1e-6).all(-1)
    assert close.float().mean() >= 0.999


def test_render_cli_writes_a_png(tmp_path, capsys):
    path = write_anim_gltf(str(tmp_path), *SMALL)
    out = str(tmp_path / "out.png")
    rc = render_cli.main([path, "-o", out, "--width", "24", "--height", "16",
                          "--spp", "2", "--spp-per-pass", "1", "--max-path",
                          "2", "--anim-time", "0.5", "--sky", "0.8,0.8,0.8",
                          "--device", "cpu",
                          "--hdr-output", str(tmp_path / "out.hdr")])
    assert rc == 0
    img = jax_read_png(out)
    assert img.shape == (16, 24, 3) and img.max() > 0
    assert "wrote" in capsys.readouterr().out
