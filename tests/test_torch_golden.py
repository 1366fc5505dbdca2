"""The golden frame and the Disney + sky IBL path of the port's renderer.

  - the port's golden constants equal lighthouse2_tpu.utils.golden's;
  - render_golden(device="cpu"): the golden bathroom (Disney, textures,
    IBL on the 16x32 gradient sky, 64x64, path 3, classic, white noise)
    has mean and population standard deviation within 1e-3 of
    ANCHOR_MEAN / ANCHOR_STD, the JAX package's CPU lockstep anchor;
  - regen with remat, Disney and IBL, fwd+bwd on a 16x16 Cornell box with
    test_sky, path 2, the port alone: the gradients of the material
    colours, the light radiance and the sky pixels are finite, nonzero and
    equal to those without remat within rtol 1e-5. The recomputed bounce
    must replay the two extra random draws of the sky sample;
  - a classic pass of the same Cornell box, Disney and IBL, on the scene
    carried across with scene_from_numpy, against the JAX package's
    render_pass_jit with intersector="lockstep": >= 99% of pixels within
    rtol 1e-3 / atol 1e-4 and the image means within 1e-3 relative, as in
    test_torch_classic.py. The JAX side is compiled once, at XLA's backend
    optimisation level 0.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks share the process)
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu.utils import golden as jgolden
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.params import (
    set_light_radiance, set_material_fields)
from lighthouse2_tpu_torch.render import wavefront as twf
from lighthouse2_tpu_torch.scene import presets as tpresets
from lighthouse2_tpu_torch.utils import golden as tgolden
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE, PATH = 16, 2
ANCHOR_TOL = 1e-3
PIXELS_CLOSE = 0.99
MEAN_RTOL = 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def test_golden_constants_equal_jax():
    for k in ("SIZE", "PATHS", "ANCHOR_MEAN", "ANCHOR_STD"):
        assert getattr(tgolden, k) == getattr(jgolden, k), k
    t, j = tgolden.golden_config(), jgolden.golden_config("lockstep")
    for f in dataclasses.fields(t):
        if f.name != "intersector":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.intersector == "auto"


def test_render_golden_on_the_cpu_hits_the_anchor():
    a = tgolden.render_golden(device="cpu")
    assert a.shape == (tgolden.SIZE * tgolden.SIZE, 3)
    assert a.dtype == torch.float32 and torch.isfinite(a).all()
    assert abs(a.mean().item() - tgolden.ANCHOR_MEAN) < ANCHOR_TOL
    assert abs(a.std(correction=0).item() - tgolden.ANCHOR_STD) < ANCHOR_TOL


def _cornell_with_sky():
    host, cam = tpresets.cornell_box(SIZE, SIZE)
    tpresets.test_sky(host)
    return host.sync("cpu"), cam.get_view("cpu")


def _regen_grads(ds, view, cfg):
    """One regen pass; gradients of the mean image with respect to the
    colours, the light radiance and the sky pixels."""
    params = dict(color=ds.materials.color.clone().requires_grad_(),
                  light=ds.lights.tri_radiance.clone().requires_grad_(),
                  sky=ds.sky.pixels.clone().requires_grad_())
    s = set_light_radiance(set_material_fields(ds, color=params["color"]),
                           params["light"])
    s = dataclasses.replace(s, sky=dataclasses.replace(s.sky,
                                                       pixels=params["sky"]))
    state = twf.ensure_regen_state(view, twf.AccumState.make(cfg, "cpu"), cfg)
    acc, count, _, _, _ = twf.trace_paths_regen(s, view, cfg, state)
    img = acc[:, :3] / torch.clamp(count, min=1.0)[:, None]
    loss = (img ** 2).mean()
    return loss.detach(), dict(zip(params, torch.autograd.grad(
        loss, list(params.values()))))


def test_regen_remat_disney_ibl_gradients_equal_no_remat():
    ds, view = _cornell_with_sky()
    assert ds.sky.has_ibl
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       path_regen=True, bsdf="disney", sky_ibl=True,
                       remat=True)
    loss_r, g_r = _regen_grads(ds, view, cfg)
    loss_n, g_n = _regen_grads(ds, view, dataclasses.replace(cfg,
                                                             remat=False))
    torch.testing.assert_close(loss_r, loss_n, rtol=1e-5, atol=0)
    for k in g_n:
        assert torch.isfinite(g_r[k]).all(), k
        assert (g_r[k] != 0).any(), k
        torch.testing.assert_close(g_r[k], g_n[k], rtol=1e-5, atol=1e-9,
                                   msg=k)


@pytest.fixture(scope="module")
def classic_ibl():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jpresets.test_sky(host)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    jcfg = JConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                   bsdf="disney", sky_ibl=True, intersector="lockstep")
    jstate = jwf.AccumState.make(jcfg)
    step = jwf.render_pass_jit.lower(jds, jview, jstate, config=jcfg).compile(
        compiler_options=FAST_COMPILE)
    jstate, _ = step(jds, jview, jstate)
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    return jstate, tds, tview


def test_classic_disney_ibl_pass_matches_jax_lockstep(classic_ibl):
    jstate, tds, tview = classic_ibl
    assert tds.sky.has_ibl
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       bsdf="disney", sky_ibl=True)
    state, _ = twf.render_pass(tds, tview, twf.AccumState.make(cfg, "cpu"),
                               cfg)
    assert state.cam_seed == int(jstate.cam_seed)
    ja, ta = np.asarray(jstate.accumulator), state.accumulator.numpy()
    close = np.isclose(ta, ja, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= PIXELS_CLOSE, close.mean()
    ji = np.asarray(jwf.finalize(jstate))
    ti = twf.finalize(state).numpy()
    assert np.isfinite(ti).all() and ti.mean() > 0
    assert abs(ti.mean() - ji.mean()) <= MEAN_RTOL * abs(ji.mean())
