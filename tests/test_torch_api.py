"""The port's RenderAPI, render cores and tonemap.

  - two RenderAPI.render() calls equal two render_pass_auto calls by hand (the
    accumulator bit for bit), moving the camera restarts the accumulation,
    get_ldr_image is finite and in [0, 1], the camera survives a JSON
    round trip, and a camera the JAX package wrote loads with every field;
  - tonemap against the JAX function for the clip and each of the five
    operators, with contrast, brightness and vignetting, within rtol 1e-5
    / atol 1e-6;
  - PreviewCore and MinimalCore against the JAX package's cores on a 16x16
    Cornell box carried across with scene_from_numpy (the JAX preview core
    with intersector="lockstep"): the minimal core's dots equal, the
    preview image within rtol 1e-4 / atol 1e-5 on >= 99% of pixels and the
    depth within rtol 1e-5;
  - create_core raises ValueError for an unknown core and builds every
    core the JAX package registers, wavefront_filter and bdpt included
    (bdpt with roulette and the firefly clamp off);
  - RenderAPI.create without a device raises RuntimeError on a host
    without a card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import tonemap as jtonemap
from lighthouse2_tpu.render.cores import base as jbase
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.api import RenderAPI
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import tonemap as ttonemap
from lighthouse2_tpu_torch.render import wavefront as twf
from lighthouse2_tpu_torch.render.cores.base import create_core
from lighthouse2_tpu_torch.scene.camera import Camera
from lighthouse2_tpu_torch.scene.presets import cornell_box
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE = 16


def test_render_api_equals_render_pass_by_hand(tmp_path):
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=3,
                       path_regen=True)
    api = RenderAPI.create("wavefront", cfg, device="cpu")
    api.scene, api.camera = cornell_box(SIZE, SIZE)
    for _ in range(2):
        stats = api.render()
    assert stats["total_rays"] > 0 and api.core.stats["spp"] > 0

    host, cam = cornell_box(SIZE, SIZE)
    ds, view = host.sync("cpu"), cam.get_view("cpu")
    state = twf.AccumState.make(cfg, "cpu")
    for _ in range(2):
        state, _ = twf.render_pass_auto(ds, view, state, cfg)
    assert api.core.state.sample_count == state.sample_count == 2
    torch.testing.assert_close(api.core.state.accumulator, state.accumulator,
                               rtol=0, atol=0)
    np.testing.assert_array_equal(
        api.get_image(), twf.finalize(state).numpy().reshape(SIZE, SIZE, 3))
    ldr = api.get_ldr_image()
    assert ldr.shape == (SIZE, SIZE, 3) and np.isfinite(ldr).all()
    assert ldr.min() >= 0.0 and ldr.max() <= 1.0

    # the camera moves: the next pass starts a fresh accumulation
    api.camera.look_at((0.1, 1.0, 3.4), (0.0, 1.0, 0.0))
    api.render()
    assert api.core.state.sample_count == 1
    path = str(tmp_path / "cam.json")
    api.camera.gamma = 1.8
    api.serialize_camera(path)
    back = Camera.deserialize(path)
    for f in dataclasses.fields(back):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(api.camera, f.name))

    # a camera file of the JAX package, tonemap and clamp fields included
    jcam = jpresets.cornell_box(SIZE, SIZE)[1]
    jcam.tonemapper, jcam.clamp_value, jcam.contrast = 2, 4.5, 0.3
    jcam.serialize(path)
    back = Camera.deserialize(path)
    assert [f.name for f in dataclasses.fields(back)] == [
        f.name for f in dataclasses.fields(jcam)]
    for f in dataclasses.fields(back):
        np.testing.assert_array_equal(getattr(back, f.name),
                                      getattr(jcam, f.name), err_msg=f.name)


def test_tonemap_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.exponential(0.8, (24, 20, 3)).astype(np.float32)
    for method in range(6):
        for kw in (dict(), dict(contrast=0.2, brightness=0.05,
                                vignetting=0.35, gamma=1.8)):
            want = np.asarray(jtonemap.tonemap(jnp.asarray(img),
                                               method=method, **kw))
            got = ttonemap.tonemap(torch.from_numpy(img), method=method, **kw)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=str((method, kw)))


def test_preview_and_minimal_cores_match_jax(monkeypatch):
    monkeypatch.setenv("LH2_NO_NATIVE", "1")
    host, cam = jpresets.cornell_box(SIZE, SIZE)
    jds, jview = host.sync(two_level=False), cam.get_view()
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    jcfg = JConfig(width=SIZE, height=SIZE, intersector="lockstep")
    tcfg = RenderConfig(width=SIZE, height=SIZE)

    jmin, tmin = jbase.create_core("minimal", jcfg), create_core("minimal",
                                                                 tcfg)
    jmin.render(jds, jview)
    tmin.render(tds, tview)
    np.testing.assert_array_equal(tmin.get_image(), jmin.get_image())
    assert tmin.get_image().max() == 1.0

    jpre, tpre = jbase.create_core("preview", jcfg), create_core("preview",
                                                                 tcfg)
    jpre.render(jds, jview)
    stats = tpre.render(tds, tview)
    assert stats["primary_rays"] == SIZE * SIZE
    close = np.isclose(tpre.get_image(), jpre.get_image(), rtol=1e-4,
                       atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(tpre.depth, jpre.depth, rtol=1e-5)
    assert np.isfinite(tpre.depth).mean() > 0.9


def test_create_core_rejects_cores_not_ported():
    with pytest.raises(ValueError, match="available"):
        create_core("no_such_core")
    for name in ("wavefront", "primeref", "minimal", "preview",
                 "wavefront_filter", "bdpt"):
        assert create_core(name).core_name == name
    assert create_core("primeref").config.max_path_length == 64
    assert create_core("wavefront_filter").config.filter_enabled
    bdpt = create_core("bdpt").config
    assert not bdpt.russian_roulette and not bdpt.clamp_fireflies


def test_render_api_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError):
        RenderAPI.create("wavefront")
    with pytest.raises(RuntimeError):
        RenderAPI.create("wavefront", device="cuda")
    assert RenderAPI.create("preview", device="cpu").device.type == "cpu"
