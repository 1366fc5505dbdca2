"""The cores and what they render on the card (api.py, render/cores/,
utils/golden.py, render/filter.py, render/probe.py, render/bdpt.py), on
the bathroom at 512x512, path 16 unless named.

- RenderAPI "wavefront" on the Lambert bathroom (regen) and on the
  bathroom with the golden 16x32 gradient sky under Disney and IBL: 2
  warm-ups (the sync and eager pass, the capture), API_PASSES api.render()
  calls and one more under the profiler, all replays, pass the launch
  gates (tests/card_support.py; IBL sky NEE shades composed: no shade
  kernel); the image finite and positive, get_ldr_image finite in [0, 1];
  the Disney scene's sky carries its IBL tables.
- The golden frame (utils/golden.py render_golden) on the card and on the
  CPU: >= 99% of pixels within rtol 1e-3 / atol 1e-4 of each other, both
  means and population stds within ANCHOR_TOL of ANCHOR_MEAN / ANCHOR_STD.
- "wavefront_filter" (classic, spp 1, Lambert, TAA): 2 warm-ups and
  FILTER_FRAMES frames, the camera moving FILTER_MOVE and turning
  FILTER_TURN a frame, one more frame profiled, under the launch gates
  (the core's render_pass_auto runs render_pass_unrolled on the card: each
  kernel once a bounce, live or not); every frame finite, some history
  surviving reprojection; the last filtered frame smoother than a raw
  1-spp frame of the same view (variance of neighbour differences). On a
  64x64 Cornell box, path 4, 4 frames with a moving camera, the card
  against the CPU: >= FILTER_PIXELS_MIN of the pixels within rtol / atol
  1e-3 every frame.
- The probes: bvh_heatmap launches the closest kernel once and its counts
  equal the plain BVH4 walk's on every lane; probe_pixel on a 4x4 grid
  launches it once a pixel and finds the brute force's prim but for
  t-ties within 1e-5; gbuffer_views is a [1024, 1024, 3] mosaic in
  [0, 1]; bvh_print names both trees; a 64x64 Cornell box through
  RenderAPI with use_bvh=False launches no kernel and agrees with the BVH
  render on >= 99% of pixels within rtol 1e-3.
- "bdpt" (classic, spp 1, 5 + 5 vertices a side, Lambert): every pass
  launches 9 closest (5 + 4 walk steps) and 30 any-hit kernels (5 x 5
  connections + 5 lens connections); both kernels equal their plain BVH4
  walk on every lane (t, prim, u, v, occlusion, the counts) of three
  batches captured from a pass: the first light-walk segment, the (s=2,
  t=3) connection batch and the s=2 lens batch; the image finite and
  positive; one Disney pass finite. On a 16x16 Cornell box, path 8, two
  passes on the card against the CPU: Lambert on >= 99% of pixels within
  rtol / atol 1e-3, Disney on >= BDPT_DISNEY_PIXELS_MIN; and the estimator
  check of tests/test_bdpt.py:52-84 on the card (the walls dimmed to 0.48,
  16x16, spp 8, path 8, no BVH, clamp off, BDPT_EST_PASSES passes of BDPT
  and of the path tracer): the means within 4% and mean |BDPT - PT| under
  0.25 of the PT mean.

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from card_support import bathroom, card  # noqa: F401 (fixtures)
from card_support import (MAIN, clear_graphs, counts, deltas, profiled_replay,
                          replay_gates, tallied)

API_PASSES = 3             # replayed api.render() calls
ANCHOR_TOL = 1e-3          # golden mean / std against the anchor
FILTER_FRAMES = 8          # moving frames of the filter core
FILTER_MOVE = (0.01, 0.0, 0.005)   # camera translation a frame (metres)
FILTER_TURN = 0.5          # camera yaw a frame (degrees)
FILTER_PIXELS_MIN = 0.99
BDPT_PASSES = 3            # counted passes of the BDPT core
BDPT_EST_PASSES = 24       # passes of each estimator (tests/test_bdpt.py:73-74)
BDPT_DISNEY_PIXELS_MIN = 0.95


def _api_passes(api, dev):
    """The launch gates of 2 warm-ups, API_PASSES api.render() calls and
    one profiled; the images."""
    clear_graphs()
    per_call = []
    for _ in range(2 + API_PASSES):
        tallied(api.render, per_call)
    prof = profiled_replay(api.render, dev, per_call)
    replay_gates(api.config, api.device_scene(), per_call,
                 ("eager", "capture") + ("replay",) * (API_PASSES + 1), prof)
    img, ldr = api.get_image(), api.get_ldr_image()
    assert np.isfinite(img).all() and img.mean() > 0
    assert np.isfinite(ldr).all() and ldr.min() >= 0.0 and ldr.max() <= 1.0


@pytest.mark.card
@pytest.mark.parametrize("bsdf", ["lambert", "disney"])
def test_render_api_replays_its_graph(bathroom, card, bsdf):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom as make
    from lighthouse2_tpu_torch.utils.golden import golden_sky
    if bsdf == "disney":
        api = RenderAPI.create("wavefront", dataclasses.replace(
            MAIN, bsdf="disney", sky_ibl=True), device=card)
        api.scene, api.camera = make(MAIN.width, MAIN.height)
        api.scene.set_sky(golden_sky())
    else:
        api = RenderAPI.create("wavefront", MAIN, device=card)
        api.scene, api.camera = bathroom
    _api_passes(api, card)
    if bsdf == "disney":
        assert api.device_scene().sky.has_ibl


@pytest.mark.card
def test_golden_frame_on_the_card(card):
    from lighthouse2_tpu_torch.utils import golden
    ga, ca = (golden.render_golden(device=w).cpu()
              for w in (card, torch.device("cpu")))
    close = torch.isclose(ga, ca, rtol=1e-3, atol=1e-4).all(-1)
    assert close.float().mean().item() >= 0.99
    for side, a in (("card", ga), ("cpu", ca)):
        mean, std = a.mean().item(), a.std(correction=0).item()
        assert (torch.isfinite(a).all()
                and abs(mean - golden.ANCHOR_MEAN) < ANCHOR_TOL
                and abs(std - golden.ANCHOR_STD) < ANCHOR_TOL), (side, mean,
                                                                 std)


def _neighbour_var(img):
    """Variance of vertical neighbour differences (tests/test_filter.py
    :118-123): the noise measure a filtered frame must lower."""
    return float(np.var(np.diff(img, axis=0)))


@pytest.mark.card
def test_filter_core_replays_and_smooths(bathroom, card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.apps.viewer_cli import _rotate
    from lighthouse2_tpu_torch.core.types import RenderConfig
    host, cam = bathroom
    cfg = RenderConfig(width=MAIN.width, height=MAIN.height, spp_per_pass=1,
                       max_path_length=MAIN.max_path_length, taa_enabled=True)
    api = RenderAPI.create("wavefront_filter", cfg, device=card)
    api.scene, api.camera = host, copy.deepcopy(cam)

    def move():
        c = api.camera
        c.position = (np.asarray(c.position, np.float32)
                      + np.float32(FILTER_MOVE))
        c.direction = _rotate(c.direction, FILTER_TURN, 0.0)

    clear_graphs()
    per_call, frames = [], []
    for _ in range(2):                  # the sync and warm-up, the capture
        tallied(api.render, per_call)
    for _ in range(FILTER_FRAMES):
        move()
        tallied(api.render, per_call)
        frames.append((bool(np.isfinite(api.get_image()).all()),
                       (api.core.filter_state.history > 0).float()
                       .mean().item()))
    prof = profiled_replay(lambda: (move(), api.render()), card, per_call)
    filtered = api.get_image()
    # the raw 1-spp frame of the same (unjittered) view
    raw_api = RenderAPI.create("wavefront", dataclasses.replace(
        cfg, taa_enabled=False), device=card)
    raw_api.scene, raw_api.camera = host, api.camera
    raw_api.render()
    replay_gates(api.core.config, api.device_scene(), per_call,
                 ("eager", "capture") + ("replay",) * (FILTER_FRAMES + 1),
                 prof)
    assert all(finite and history > 0.0 for finite, history in frames), (
        frames)
    assert _neighbour_var(filtered) < _neighbour_var(raw_api.get_image())


@pytest.mark.card
def test_filter_core_card_matches_cpu(card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       taa_enabled=True)
    out = []                                   # card, then CPU
    for where in (card, torch.device("cpu")):
        api = RenderAPI.create("wavefront_filter", cfg, device=where)
        api.scene, api.camera = cornell_box(64, 64)
        imgs = []
        for _ in range(4):
            api.camera.position = (api.camera.position
                                   + np.float32([0.02, 0.01, 0.0]))
            api.render()
            imgs.append(api.get_image())
        out.append(imgs)
    close = [float(np.isclose(g, c, rtol=1e-3, atol=1e-3).all(-1).mean())
             for g, c in zip(*out)]
    assert min(close) >= FILTER_PIXELS_MIN, close


@pytest.mark.card
def test_probes(bathroom, card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect
    from lighthouse2_tpu_torch.core.geometry import BIG_T
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render import probe
    from lighthouse2_tpu_torch.render.kernels.trace import trace_closest
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    host, cam = bathroom
    size, grid = MAIN.width, 4
    scene, view = host.sync(card), cam.get_view(card)
    cfg = RenderConfig(width=size, height=size)
    before = counts()
    heat = probe.bvh_heatmap(scene, view, cfg)
    assert deltas(before, counts()) == dict(trace_closest=1,
                                            trace_occluded=0)
    o, d = probe._pixel_rays(view, cfg)
    kst = trace_closest(o, d, BIG_T, scene.bvh, stats=True)[4]
    wst = wide_intersect(o, d, scene.bvh, stats=True)[4]
    steps = wst[0].cpu().numpy().astype(np.float32)
    assert (kst == wst).all()
    assert np.array_equal(heat, probe._colormap(
        steps / max(steps.max(), 1.0)).reshape(size, size, 3))

    nb = dataclasses.replace(cfg, use_bvh=False)
    rows = []
    before = counts()
    for y in np.linspace(size / 32, size - 1 - size / 32, grid).astype(int):
        for x in np.linspace(size / 32, size - 1 - size / 32,
                             grid).astype(int):
            k = probe.probe_pixel(scene, view, cfg, int(x), int(y))
            b = probe.probe_pixel(scene, view, nb, int(x), int(y))
            tie = (k["prim"] != b["prim"] and np.isfinite(k["distance"])
                   and abs(k["distance"] - b["distance"])
                   <= 1e-5 * k["distance"])
            rows.append((k["prim"], b["prim"], tie))
    assert deltas(before, counts()) == dict(trace_closest=len(rows),
                                            trace_occluded=0)
    bad = [r for r in rows if r[0] != r[1] and not r[2]]
    assert not bad and any(r[0] >= 0 for r in rows), rows

    mosaic = probe.gbuffer_views(scene, view, cfg)
    assert (mosaic.shape == (2 * size, 2 * size, 3) and mosaic.min() >= 0.0
            and mosaic.max() <= 1.0), (mosaic.shape, mosaic.min(),
                                       mosaic.max())
    tree = probe.bvh_print(scene)
    assert tree.startswith("BVH2") and "BVH4" in tree, tree

    # a small scene without a BVH, through RenderAPI, against the BVH one
    imgs = {}
    for use_bvh in (True, False):
        api = RenderAPI.create("wavefront", RenderConfig(
            width=64, height=64, spp_per_pass=1, max_path_length=4,
            use_bvh=use_bvh), device=card)
        api.scene, api.camera = cornell_box(64, 64)
        before = counts()
        for _ in range(2):
            api.render()
        imgs[use_bvh] = (api.get_image(), deltas(before, counts()))
    close = np.isclose(imgs[False][0], imgs[True][0], rtol=1e-3,
                       atol=1e-4).all(-1)
    assert close.mean() >= 0.99 and not any(imgs[False][1].values()), (
        close.mean(), imgs[False][1])


def _capture_traces(fn, keep):
    """Run fn with the trace wrappers that render/wavefront.py calls
    recording the rays of the calls numbered in keep ({"closest": set,
    "occluded": set}, 0-based call order). Returns ({(kind, i): (o, d,
    tmax)}, {kind: calls})."""
    from lighthouse2_tpu_torch.render import wavefront as wf
    real = dict(closest=wf.trace_closest, occluded=wf.trace_occluded)
    calls = dict(closest=0, occluded=0)
    got = {}

    def recorder(kind):
        def call(o, d, tmax, bvh, **kw):
            i = calls[kind]
            calls[kind] += 1
            if i in keep[kind]:
                tm = torch.broadcast_to(torch.as_tensor(
                    tmax, dtype=torch.float32, device=o.device),
                    (o.shape[0],))
                got[(kind, i)] = tuple(x.detach().clone().contiguous()
                                       for x in (o, d, tm))
            return real[kind](o, d, tmax, bvh, **kw)
        return call

    wf.trace_closest, wf.trace_occluded = recorder("closest"), recorder(
        "occluded")
    try:
        fn()
    finally:
        wf.trace_closest, wf.trace_occluded = real["closest"], real["occluded"]
    return got, calls


@pytest.mark.card
def test_bdpt_core(bathroom, card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.bdpt import EYE_DEPTH, LIGHT_DEPTH
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    host, cam = bathroom
    cfg = dataclasses.replace(MAIN, path_regen=False)
    s_e = min(EYE_DEPTH, cfg.max_path_length)
    s_l = min(LIGHT_DEPTH, cfg.max_path_length)
    # a closest launch a walk step, an any-hit launch a connection batch
    # and a lens batch
    want = dict(trace_closest=s_e + s_l - 1, trace_occluded=s_l * s_e + s_l)
    api = RenderAPI.create("bdpt", cfg, device=card)
    api.scene, api.camera = host, cam
    api.render()                                  # sync + warm-up pass
    per_pass = []
    for _ in range(BDPT_PASSES):
        before = counts()
        api.render()
        per_pass.append(deltas(before, counts()))
    img = api.get_image()
    api.render()
    # the kernels on BDPT's own batches: the first light-walk step (after
    # the eye walk's s_e closest calls), the (s=2, t=3) connection batch
    # and the s=2 lens batch (after the s_l * s_e connection batches)
    names = {("closest", s_e): "light_walk_1",
             ("occluded", s_e + 1): "connection_s2_t3",
             ("occluded", s_l * s_e + 1): "lens_s2"}
    got, calls = _capture_traces(
        api.render, dict(closest={s_e}, occluded={s_e + 1, s_l * s_e + 1}))
    batches = {names[k]: v for k, v in got.items()}
    bvh = api.device_scene().bvh
    lanes_equal = {}
    for name, (o, d, tmax) in batches.items():
        kc = trace_closest(o, d, tmax, bvh, stats=True)
        wc = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
        ko, kst = trace_occluded(o, d, tmax, bvh, stats=True)
        wo, wst = wide_occluded(o, d, tmax, bvh, stats=True)
        lanes = [g == w for g, w in zip(kc[:4], wc[:4])] + [
            ko == wo, (kc[4] == wc[4]).all(0), (kst == wst).all(0)]
        lanes_equal[name] = torch.stack(lanes).all(0).float().mean().item()

    dapi = RenderAPI.create("bdpt", dataclasses.replace(cfg, bsdf="disney"),
                            device=card)
    dapi.scene, dapi.camera = host, cam
    dapi.render()                                 # warm-up
    dapi.render()
    dimg = dapi.get_image()

    assert all(p == want for p in per_pass), (per_pass, want)
    assert {f"trace_{k}": v for k, v in calls.items()} == want, calls
    assert sorted(batches) == sorted(names.values()), sorted(batches)
    assert all(v == 1.0 for v in lanes_equal.values()), lanes_equal
    assert np.isfinite(img).all() and img.mean() > 0
    assert np.isfinite(dimg).all()


def _dimmed_cornell(size):
    """tests/test_bdpt.py:62-66: the Cornell box with every non-emissive
    material at 0.48 of its colour."""
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    scene, cam = cornell_box(size, size)
    for i, m in enumerate(scene.materials):
        if max(m.color) <= 1.0:
            scene.materials[i] = m.replace(
                color=tuple(0.48 * c for c in m.color))
    return scene, cam


@pytest.mark.card
def test_bdpt_card_matches_cpu_and_the_path_tracer(card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render.bdpt import render_pass_bdpt
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass)
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    cfg = RenderConfig(width=16, height=16, spp_per_pass=1, max_path_length=8)
    close = {}
    for bsdf in ("lambert", "disney"):
        imgs = []                              # card, then CPU
        for where in (card, torch.device("cpu")):
            api = RenderAPI.create("bdpt", dataclasses.replace(cfg, bsdf=bsdf),
                                   device=where)
            api.scene, api.camera = cornell_box(16, 16)
            for _ in range(2):
                api.render()
            imgs.append(api.get_image())
        close[bsdf] = float(np.isclose(imgs[0], imgs[1], rtol=1e-3,
                                       atol=1e-3).all(-1).mean())
    assert close["lambert"] >= 0.99, close
    assert close["disney"] >= BDPT_DISNEY_PIXELS_MIN, close
    assert np.isfinite(imgs[0]).all()          # the Disney card image

    scene, cam = _dimmed_cornell(16)
    ecfg = RenderConfig(width=16, height=16, spp_per_pass=8,
                        max_path_length=8, use_bvh=False,
                        clamp_fireflies=False)
    ds, view = scene.sync(card, rebuild_bvh=False), cam.get_view(card)
    out = {}
    for name, fn in (("pt", render_pass), ("bdpt", render_pass_bdpt)):
        st = AccumState.make(ecfg, card)
        for _ in range(BDPT_EST_PASSES):
            st, _ = fn(ds, view, st, ecfg)
        out[name] = finalize(st).cpu().numpy()
    pt, bd = out["pt"], out["bdpt"]
    mean_rel = float(abs(bd.mean() - pt.mean()) / pt.mean())
    abs_share = float(np.abs(bd - pt).mean() / (pt.mean() + 1e-9))
    assert np.isfinite(bd).all()
    assert mean_rel < 0.04 and abs_share < 0.25, (mean_rel, abs_share)
