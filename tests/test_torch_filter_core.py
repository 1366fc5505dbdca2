"""The classic executor's G-buffer stream and the "wavefront_filter" core of
the port against the JAX package.

One JAX reference is compiled: render_pass_jit with filter_enabled on the
carried-across 16x16 Cornell box at path 2, intersector="lockstep", XLA
optimisation level 0 (as tests/test_torch_classic.py). Its view is an
argument, so the same executable renders every frame below.
  - the port's filter_aux and direct accumulator against that pass: >= 99%
    of pixels within rtol 1e-3 / atol 1e-4 in every field (as
    test_torch_classic.py: transcendentals round differently and one
    flipped decision changes a lane), the stats' keys equal;
  - on the port alone (32x32, spp 2, path 4): the filter-off accumulator
    equals the filter-on direct accumulator + indirect on every pixel
    (rtol 1e-5 / atol 1e-6: the two streams are summed apart, then added),
    depth channel, cam_seed and ray counts equal; filter_enabled with
    path_regen raises ValueError in render_pass_auto (the regen executor);
  - three frames of create_core("wavefront_filter") with TAA and a moving
    camera against JAX's svgf_filter / taa / unsharpen applied to the
    compiled pass's aux, as JAX's FilteredWavefrontCore.render does:
    >= 99% of pixels within rtol 1e-3 / atol 1e-4 each frame, the history
    lengths equal on >= 98% (HIST_AGREE says why: test_torch_filter.py
    holds them to 99.9% on inputs equal bit for bit);
  - tests/test_filter.py's end-to-end check on the port: 3 frames at 32x32
    with use_bvh=False are finite and smoother than a raw 1-spp frame
    (variance of vertical neighbour differences).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import filter as jf
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.api import RenderAPI
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig, ViewPyramid
from lighthouse2_tpu_torch.render import wavefront as twf
from lighthouse2_tpu_torch.render.cores.base import create_core
from lighthouse2_tpu_torch.scene.presets import cornell_box
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE, PATH = 16, 2
PIXELS_CLOSE = 0.99
# the compiled pass's world positions differ from the port's in the last
# bits (XLA contracts o + t * d into a fused multiply-add), and the
# reprojected history length is an average of equal lengths truncated
# toward zero, which such a bit can flip (2 of 256 pixels seen)
HIST_AGREE = 0.98
AUX = ("indirect", "albedo", "normal", "depth", "world_pos")
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def port_view(jv):
    return ViewPyramid(**{f.name: torch.from_numpy(np.array(getattr(
        jv, f.name))) for f in dataclasses.fields(ViewPyramid)})


@pytest.fixture(scope="module")
def filter_pass():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jds = host.sync(two_level=False)
    jcfg = JConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                   filter_enabled=True, taa_enabled=True,
                   intersector="lockstep")
    jview = cam.get_view()
    step = jwf.render_pass_jit.lower(
        jds, jview, jwf.AccumState.make(jcfg), config=jcfg).compile(
            compiler_options=FAST_COMPILE)
    tds, _ = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    views = []
    for f in range(3):        # the camera moves a little every frame
        cam.position = cam.position + np.float32([0.03, 0.01, 0.02])
        views.append(cam.get_view())
    return dict(jcfg=jcfg, jds=jds, jview=jview, tds=tds, views=views,
                run=lambda v: step(jds, v, jwf.AccumState.make(jcfg)))


def pixels_close(t, j):
    t = t.numpy().reshape(SIZE * SIZE, -1)
    j = np.asarray(j).reshape(SIZE * SIZE, -1)
    return np.isclose(t, j, rtol=1e-3, atol=1e-4).all(-1).mean()


def test_filter_aux_matches_jax(filter_pass):
    p = filter_pass
    jstate, jst = p["run"](p["jview"])
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       filter_enabled=True)
    tstate, tst = twf.render_pass(p["tds"], port_view(p["jview"]),
                                  twf.AccumState.make(cfg, "cpu"), cfg)
    assert sorted(tst) == sorted(jst)
    assert sorted(tst["filter_aux"]) == sorted(jst["filter_aux"])
    assert pixels_close(tstate.accumulator, jstate.accumulator) \
        >= PIXELS_CLOSE
    for k in AUX:
        got, want = tst["filter_aux"][k], jst["filter_aux"][k]
        assert tuple(got.shape) == want.shape, k
        assert pixels_close(got, want) >= PIXELS_CLOSE, k
    aux = tst["filter_aux"]
    assert float(aux["indirect"].sum()) > 0
    assert (aux["depth"] > 0).all()          # the closed box: no miss


def test_filter_off_equals_direct_plus_indirect():
    host, cam = cornell_box(32, 32)
    ds, view = host.sync("cpu"), cam.get_view("cpu")
    off = RenderConfig(width=32, height=32, spp_per_pass=2, max_path_length=4)
    on = dataclasses.replace(off, filter_enabled=True)
    s_off, st_off = twf.render_pass(ds, view, twf.AccumState.make(off, "cpu"),
                                    off)
    s_on, st_on = twf.render_pass(ds, view, twf.AccumState.make(on, "cpu"),
                                  on)
    ind = st_on["filter_aux"]["indirect"]
    assert float(ind.sum()) > 0.05 * float(s_on.accumulator[:, :3].sum())
    torch.testing.assert_close(s_on.accumulator[:, :3] + ind,
                               s_off.accumulator[:, :3], rtol=1e-5, atol=1e-6)
    assert torch.equal(s_on.accumulator[:, 3], s_off.accumulator[:, 3])
    assert s_on.cam_seed == s_off.cam_seed
    for k in ("extension_rays", "shadow_rays"):
        assert torch.equal(st_on[k], st_off[k])
    regen = dataclasses.replace(on, path_regen=True)
    with pytest.raises(ValueError, match="path_regen"):
        twf.render_pass_auto(ds, view, twf.AccumState.make(regen, "cpu"),
                             regen)


def test_filtered_core_frames_match_jax(filter_pass):
    p = filter_pass
    jcfg = p["jcfg"]
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       taa_enabled=True)
    core = create_core("wavefront_filter", cfg)
    fs, ts = jf.FilterState.make(SIZE, SIZE), jf.TAAState.make(SIZE, SIZE)
    prev = None
    img = lambda x: jnp.asarray(x).reshape(SIZE, SIZE, *x.shape[1:])
    for f, jv in enumerate(p["views"]):
        # JAX's FilteredWavefrontCore.render, on the compiled pass
        jv, _ = jf.jittered_view(jv, f, SIZE, SIZE)
        state, stats = p["run"](jv)
        aux = stats["filter_aux"]
        wp = img(aux["world_pos"])
        color, fs = jf.svgf_filter(
            img(state.accumulator[:, :3]), img(aux["indirect"]),
            img(aux["albedo"]), img(aux["normal"]), img(aux["depth"]), wp,
            fs, direct_clamp=jcfg.clamp_direct,
            indirect_clamp=jcfg.clamp_indirect, prev_view=prev)
        color, ts = jf.taa(color, ts, world_pos=wp, prev_view=prev)
        color = np.asarray(jf.unsharpen(color))
        prev = jv

        st = core.render(p["tds"], port_view(p["views"][f]))
        got = core.get_image()
        assert got.shape == (SIZE, SIZE, 3) and np.isfinite(got).all()
        assert pixels_close(torch.from_numpy(got), color) >= PIXELS_CLOSE, f
        hist = core.filter_state.history.numpy()
        assert (hist == np.asarray(fs.history)).mean() >= HIST_AGREE, f
        assert st["pass_time"] > 0 and st["filter_time"] > 0
    assert (hist > 0).mean() > 0.5          # history kept across the moves


def test_filtered_core_smoother_than_raw():
    cfg = RenderConfig(width=32, height=32, spp_per_pass=1, max_path_length=3,
                       use_bvh=False, taa_enabled=True)
    api = RenderAPI.create("wavefront_filter", cfg, device="cpu")
    scene, cam = cornell_box(32, 32)
    api.scene, api.camera = scene, cam
    for _ in range(3):
        api.render()
    assert api.device_scene().bvh is None
    img = api.get_image()
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    assert img.max() > 0.05
    raw_api = RenderAPI.create("wavefront", dataclasses.replace(
        cfg, taa_enabled=False), device="cpu")
    raw_api.scene, raw_api.camera = scene, cam
    raw_api.render()
    raw = raw_api.get_image()
    assert np.var(np.diff(img, axis=0)) < np.var(np.diff(raw, axis=0))
