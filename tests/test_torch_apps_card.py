"""The applications on the card: an animated glTF, the render CLI, the
viewer and the AI debugger (tools/anim_gltf.py, scene/, apps/).

- tools/anim_gltf.py writes an animated glTF (a tube of 65,536 triangles
  skinned to three joints with a LINEAR and a CUBICSPLINE rotation
  channel, a sphere of 16,384 triangles with a morph target and a weights
  channel, a rigid box with a translation channel and a PNG texture);
  HostScene.load_gltf places it in the bathroom (211,184 triangles), and
  RenderAPI renders it at 512x512, path 16, regen, Lambert: 1 warm-up and
  ANIM_FRAMES frames of anim.update(scene, ANIM_DT) + api.render(
  converge=False). Every frame rebuilds the two posed BLASes and composes
  once, and launches each trace kernel 16 times through its wrapper (a
  re-synced frame's tree has new shapes, so the pass runs eagerly and
  replays no graph); on the last frame both kernels equal their plain BVH4
  walk on every lane of its three batches (card_support.trace_batches:
  t, prim, u, v, occlusion); the image finite and positive.
- apps/render_cli.main on that glTF at 256x256, 2 spp, on the card,
  returns 0 and writes a PNG that reads back at (256, 256, 3), not black.
- A ViewerSession on the bathroom at 256x256 running VIEWER_SCRIPT: every
  frame and debug file written, the probe selects a material, and the
  FrameServer on 127.0.0.1 returns the last frame's PNG bytes and the
  stats.
- apps/ai_debugger_cli.main with its Cornell defaults on the card returns
  0 and writes a 256x256 PNG; its navmesh arrays and its navmesh, path and
  agent lines equal a CPU run's (16x16, 1 spp: the navmesh does not depend
  on the render).

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import contextlib
import io
import os
import urllib.request

import numpy as np
import pytest
import torch

from card_support import card  # noqa: F401 (fixtures)
from card_support import MAIN, PATH, counts, deltas, trace_batches

ANIM_FRAMES = 8            # frames after the warm-up
ANIM_DT = 1.0 / 30.0       # seconds of animation a frame
# where the glTF is placed in the bathroom: on the floor, in view
ANIM_XF = ((1.0, 0.0, 0.0, -0.3), (0.0, 1.0, 0.0, 0.0),
           (0.0, 0.0, 1.0, -0.2), (0.0, 0.0, 0.0, 1.0))
VIEWER_SCRIPT = """\
frames 2
probe 128 160
mat color 0.9 0.2 0.2
snap
move 0.05 0 0.05
turn 3 1
frames 1
debug bvh
debug gbuffer
debug tree
camera save {d}/cam.json
camera load {d}/cam.json
materials save {d}/mats.json
snap
"""


@pytest.fixture(scope="module")
def anim_gltf(card, tmp_path_factory):
    from lighthouse2_tpu_torch.tools.anim_gltf import write_anim_gltf
    return write_anim_gltf(str(tmp_path_factory.mktemp("anim")))


@pytest.mark.card
def test_animated_gltf_frames(anim_gltf, card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    api = RenderAPI.create("wavefront", MAIN, device=card)
    api.scene, api.camera = bathroom(MAIN.width, MAIN.height)
    api.scene.load_gltf(anim_gltf, transform=np.asarray(ANIM_XF, np.float32))
    scene = api.scene
    anim = scene.animations[0]
    frames = []
    for i in range(ANIM_FRAMES + 1):               # frame 0 is the warm-up
        stats0, counts0 = dict(scene.build_stats), counts()
        anim.update(scene, ANIM_DT)
        api.render(converge=False)
        if i:
            frames.append((deltas(stats0, scene.build_stats),
                           deltas(counts0, counts())))
    ds = api.device_scene()
    lanes = {}
    for name, (o, d, tmax) in trace_batches(
            ds, api.camera.get_view(card), MAIN, card).items():
        got = trace_closest(o, d, tmax, ds.bvh)
        want = wide_intersect(o, d, ds.bvh, t_max=tmax)
        eq = [g == w for g, w in zip(got, want)] + [
            trace_occluded(o, d, tmax, ds.bvh)
            == wide_occluded(o, d, tmax, ds.bvh)]
        lanes[name] = torch.stack(eq).all(0).float().mean().item()
    img = api.get_image()
    assert all(v == 1.0 for v in lanes.values()), lanes
    for built, launched in frames:
        assert launched == {k: PATH for k in launched}, launched
        assert built == dict(blas_builds=2, tlas_composes=1), built
    assert np.isfinite(img).all() and img.mean() > 0


@pytest.mark.card
def test_render_cli_on_the_gltf(anim_gltf, card, tmp_path):
    from lighthouse2_tpu_torch.apps import render_cli
    from lighthouse2_tpu_torch.utils.image import read_png
    out = str(tmp_path / "cli.png")
    rc = render_cli.main([anim_gltf, "-o", out, "--size", "256", "--spp", "2",
                          "--spp-per-pass", "1", "--sky", "0.8,0.8,0.8"])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (256, 256, 3) and img.max() > 0, img.shape


@pytest.mark.card
def test_viewer_session(card, tmp_path):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.apps.viewer_cli import FrameServer, ViewerSession
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    d = str(tmp_path)
    api = RenderAPI.create("wavefront", RenderConfig(
        width=256, height=256, spp_per_pass=2, max_path_length=6),
        device=card)
    api.scene, api.camera = bathroom(256, 256)
    server = FrameServer(0)
    try:
        session = ViewerSession(api, os.path.join(d, "frames"), server=server)
        session.run_script(VIEWER_SCRIPT.format(d=d))
        url = f"http://127.0.0.1:{server.port}"
        png = urllib.request.urlopen(url + "/frame.png", timeout=30).read()
        stats = urllib.request.urlopen(url + "/stats", timeout=30).read()
    finally:
        server.close()
    files = sorted(os.listdir(session.out_dir))
    want = [f"frame_{i:04d}.png" for i in range(5)] + [
        "debug_bvh_0004.png", "debug_gbuffer_0004.png"]
    missing = [f for f in want if f not in files] + [
        f for f in ("cam.json", "mats.json")
        if not os.path.exists(os.path.join(d, f))]
    assert not missing, missing
    with open(os.path.join(session.out_dir, "frame_0004.png"), "rb") as fh:
        last = fh.read()
    assert session.selected_mat >= 0, session.log
    assert png == last and b"render_time" in stats


@pytest.mark.card
def test_ai_debugger_card_matches_cpu(card, tmp_path):
    from lighthouse2_tpu_torch.apps import ai_debugger_cli
    from lighthouse2_tpu_torch.pathfinding.io import load_navmesh
    from lighthouse2_tpu_torch.utils.image import read_png
    out = {}
    for where, extra in (("card", ["--device", str(card)]),
                         ("cpu", ["--device", "cpu", "--size", "16", "--spp",
                                  "1"])):
        png = str(tmp_path / f"ai_{where}.png")
        nav = str(tmp_path / f"ai_{where}.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ai_debugger_cli.main(["cornell", "-o", png,
                                       "--save-navmesh", nav] + extra)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(("navmesh:", "path:", "agent at"))]
        out[where] = dict(rc=rc, lines=lines, png=png, nav=load_navmesh(nav))
    c, p = out["card"], out["cpu"]
    assert c["rc"] == 0 and p["rc"] == 0
    assert read_png(c["png"]).shape == (256, 256, 3)
    assert all(np.array_equal(getattr(c["nav"], f), getattr(p["nav"], f))
               for f in ("walkable", "region", "floor", "origin"))
    assert c["lines"] == p["lines"] and len(c["lines"]) == 3, (c["lines"],
                                                               p["lines"])
