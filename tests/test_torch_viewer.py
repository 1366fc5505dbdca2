"""The port's interactive applications on the CPU.

  - tests/test_viewer.py's session script (frames, probe of the red wall,
    a live material edit, camera save) plus turn / move / snap, camera
    load, materials save and the three debug views, on a 32x32 Cornell box
    through the port's ViewerSession: every frame file, the probed material
    ("red"), the focal distance set by the probe, the restart of the
    accumulation after an edit or a camera move, the heatmap [32,32,3] and
    the G-buffer mosaic [64,64,3] (PNG files), the BVH2 and BVH4 lines;
  - FrameServer on 127.0.0.1 (the default): /, /frame.png (the last frame's
    PNG bytes) and /stats, fetched with urllib;
  - render_cli --no-bvh: a brute-force render that writes its PNG and
    equals the BVH render of the same scene (>= 99% of pixels within
    rtol 1e-3 / atol 1e-4 in linear HDR; the same hits but for t-ties);
  - ai_debugger_cli on the CPU: exit 0, its PNG, and its saved navmesh
    equal to the JAX package's builder on the JAX Cornell box (the JAX CLI
    itself is not run: it would compile a JAX render).
"""
import os
import urllib.request

import numpy as np
import pytest
import torch

from lighthouse2_tpu.pathfinding import NavMeshBuilder as JBuilder
from lighthouse2_tpu.pathfinding import NavMeshConfig as JNavConfig
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.api import RenderAPI
from lighthouse2_tpu_torch.apps import ai_debugger_cli, render_cli
from lighthouse2_tpu_torch.apps.viewer_cli import FrameServer, ViewerSession
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.pathfinding.io import load_navmesh
from lighthouse2_tpu_torch.scene.presets import cornell_box
from lighthouse2_tpu_torch.utils.image import read_hdr, read_png

torch.set_num_threads(1)


@pytest.fixture
def session(tmp_path):
    cfg = RenderConfig(width=32, height=32, spp_per_pass=2,
                       max_path_length=4, use_bvh=True)
    api = RenderAPI.create("wavefront", cfg, device="cpu")
    api.scene, api.camera = cornell_box(32, 32)
    return ViewerSession(api, str(tmp_path / "frames"))


def test_scripted_session(session, tmp_path):
    cam = tmp_path / "cam.json"
    session.run_script(f"""
# converge two passes
frames 2
# probe the red wall (left side of the image)
probe 2 16
# brighten the probed material and re-render (restart semantics)
mat color 0.9 0.1 0.1
frames 1
camera save {cam}
""")
    assert sorted(os.listdir(session.out_dir)) == [
        "frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert cam.exists()
    api = session.api
    assert api.scene.materials[session.selected_mat].name == "red"
    assert 0.5 < api.camera.focal_distance < 10.0
    assert api.core.stats["spp"] == 2          # the edit restarted
    assert tuple(api.scene.materials[session.selected_mat].color) == (
        0.9, 0.1, 0.1)

    session.run_script(f"""
snap
move 0.1 0 0
frames 1
turn 5 0
frames 1
camera load {cam}
materials save {tmp_path / "mats.json"}
debug bvh {tmp_path / "bvh.png"}
debug gbuffer {tmp_path / "gb.png"}
debug tree
""")
    assert api.core.stats["spp"] == 2          # the camera move restarted
    assert len(os.listdir(session.out_dir)) == 6
    assert (tmp_path / "mats.json").exists()
    probe = [line for line in session.log if line.startswith("probe")]
    np.testing.assert_allclose(api.camera.focal_distance,
                               float(probe[0].split("dist=")[1]), rtol=1e-4)
    b = read_png(str(tmp_path / "bvh.png"))
    assert b.shape == (32, 32, 3) and b.std() > 0
    g = read_png(str(tmp_path / "gb.png"))
    assert g.shape == (64, 64, 3)
    assert any(line.startswith("BVH2 (lockstep)") for line in session.log)
    assert any("BVH4 (trace kernels)" in line for line in session.log)
    assert np.isfinite(api.get_image()).all()


def test_frame_server_on_localhost(session):
    srv = FrameServer(0)
    try:
        assert srv.httpd.server_address[0] == "127.0.0.1"
        session.server = srv
        session.run_line("snap")
        url = f"http://127.0.0.1:{srv.port}"
        page = urllib.request.urlopen(url + "/", timeout=10).read()
        assert b"frame.png" in page
        png = urllib.request.urlopen(url + "/frame.png", timeout=10).read()
        with open(os.path.join(session.out_dir, "frame_0000.png"), "rb") as f:
            assert png == f.read()
        stats = urllib.request.urlopen(url + "/stats", timeout=10).read()
        assert b"render_time" in stats
    finally:
        srv.close()


def test_render_cli_no_bvh(tmp_path):
    args = ["cornell", "--size", "16", "--spp", "2", "--spp-per-pass", "1",
            "--max-path", "3", "--device", "cpu"]
    out = {}
    for name, extra in (("brute", ["--no-bvh"]), ("bvh", [])):
        png = tmp_path / f"{name}.png"
        hdr = tmp_path / f"{name}.hdr"
        assert render_cli.main(args + extra + ["-o", str(png),
                                               "--hdr-output", str(hdr)]) == 0
        assert read_png(str(png)).shape == (16, 16, 3)
        out[name] = read_hdr(str(hdr))
    close = np.isclose(out["brute"], out["bvh"], rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_ai_debugger_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "nav.png"
    nav = tmp_path / "nav.npz"
    rc = ai_debugger_cli.main(["cornell", "--size", "16", "--spp", "1",
                               "--device", "cpu", "-o", str(out),
                               "--save-navmesh", str(nav), "--steps", "10"])
    assert rc == 0 and out.stat().st_size > 100
    assert read_png(str(out)).shape == (16, 16, 3)
    nm = load_navmesh(str(nav))
    jhost, _ = jpresets.cornell_box(16, 16)
    want = JBuilder(JNavConfig(cell_size=0.1, agent_height=1.0,
                               agent_radius=0.2, agent_max_climb=0.35)
                    ).build_from_scene(jhost)
    for f in ("walkable", "region", "origin"):
        np.testing.assert_array_equal(getattr(nm, f), getattr(want, f))
    text = capsys.readouterr().out
    assert f"{int(want.walkable.sum())} walkable" in text
    assert "arrived=" in text
