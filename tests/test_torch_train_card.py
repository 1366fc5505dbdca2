"""The fwd+bwd step on the card (diff/render.py regen_value_and_grad).

- The headline (bench.py:291-297): the bathroom at 512x512, path 16,
  regen, remat, with material colours [12,3], area-light radiance [LT,3]
  and per-vertex offsets [129252,3,3] (zeros) as parameters and a zero
  target: 2 warm-ups (eager, capture), TRAIN_STEPS steps and one more
  under the profiler, all replays, pass the launch gates
  (tests/card_support.py: 16 launches of each trace kernel a warm-up
  step, both traces outside the recomputed region, and no shade kernel:
  a step shades composed); every gradient group finite and nonzero.
- The same with Disney and IBL under the golden 16x32 gradient sky,
  through RenderAPI (2 warm-ups, 2 replays).
- A 64x64 Cornell box, path 4, regen, remat on the card against the plain
  versions on the CPU, under Lambert and under Disney + IBL (test_sky):
  gradients per group within GRAD_RTOL (relative L2, the bounds of
  tests/test_torch_grad.py), the loss within 1e-4 on the pixels whose
  forward agrees. Lambert paths take the same choices on both sides, so
  every pixel must agree; Disney + IBL paths do not all (a rounding step
  can flip a lane's discrete choice and the regen pool then hands the
  later samples to other pixels), so >= DISNEY_PIXELS_MIN of the pixels
  must agree and the gradients are compared with the others given zero
  weight on both sides (their target set to their own value).
- The headline step on "cluster" (the cluster kernels, 16 + 16 a warm-up
  step) against the "auto" step from the same state: loss within
  LOSS_RTOL, each group within GRAD_RTOL (both paths take the same samples
  and hit the same triangles but for t-ties; the offsets' refine terms
  round differently).

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import dataclasses

import pytest
import torch

from card_support import bathroom, card  # noqa: F401 (fixtures)
from card_support import (MAIN, assert_grads_finite_nonzero, clear_graphs,
                          headline_params, profiled_replay, replay_gates,
                          tallied)

TRAIN_STEPS = 2            # replayed steps of the headline (bench.py:296)
# card-vs-CPU gradient bounds, relative L2 per group
# (tests/test_torch_grad.py), and the loss's relative bound
GRAD_RTOL = dict(color=1e-3, light=1e-3, offset=2e-2)
LOSS_RTOL = 1e-4
# share of the 64x64 Disney + IBL regen pixels whose forward value must
# agree between card and CPU: a CPU run with the vertices moved by 1e-7
# agrees with the unmoved one on 93.5% of them
DISNEY_PIXELS_MIN = 0.9


def _rel(a, b):
    return {k: ((a[k] - b[k]).norm() / b[k].norm()).item() for k in b}


def _step_replays(scene, view, cfg, dev, steps):
    """2 warm-up steps (eager, capture), `steps` steps and one profiled,
    from one state, under the launch gates; the last step's gradients."""
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, ensure_regen_state)
    params, target = headline_params(scene, cfg.width, dev)
    state = ensure_regen_state(view, AccumState.make(cfg, dev), cfg)
    step = lambda: regen_value_and_grad(scene, view, state, cfg, target,
                                        params)
    clear_graphs()
    per_call = []
    for _ in range(2 + steps):
        _, grads, state = tallied(step, per_call)
    prof = profiled_replay(step, dev, per_call)
    replay_gates(cfg, scene, per_call,
                 ("eager", "capture") + ("replay",) * (steps + 1), prof,
                 grad=True)
    return grads


@pytest.mark.card
def test_headline_step_replays_its_graph(bathroom, card):
    host, cam = bathroom
    grads = _step_replays(host.sync(card), cam.get_view(card),
                          dataclasses.replace(MAIN, remat=True), card,
                          TRAIN_STEPS)
    assert_grads_finite_nonzero(grads)


@pytest.mark.card
def test_disney_ibl_step_replays_its_graph(card):
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom as make
    from lighthouse2_tpu_torch.utils.golden import golden_sky
    api = RenderAPI.create("wavefront", dataclasses.replace(
        MAIN, bsdf="disney", sky_ibl=True), device=card)
    api.scene, api.camera = make(MAIN.width, MAIN.height)
    api.scene.set_sky(golden_sky())
    grads = _step_replays(api.device_scene(), api.camera.get_view(card),
                          dataclasses.replace(api.config, remat=True), card,
                          1)
    assert_grads_finite_nonzero(grads)


@pytest.mark.card
@pytest.mark.parametrize("bsdf", ["lambert", "disney"])
def test_card_gradients_match_cpu_on_a_cornell_box(card, bsdf):
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import AccumState
    from lighthouse2_tpu_torch.scene import presets
    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       path_regen=True, remat=True)
    host, cam = presets.cornell_box(64, 64)
    disney = bsdf == "disney"
    if disney:
        cfg = dataclasses.replace(cfg, bsdf="disney", sky_ibl=True)
        presets.test_sky(host)
    cpu = torch.device("cpu")
    synced = {w: (host.sync(w), cam.get_view(w)) for w in (card, cpu)}
    clear_graphs()

    def step(where, target):
        ds, view = synced[where]
        params, _ = headline_params(ds, 64, where)
        _, grads, st = regen_value_and_grad(
            ds, view, AccumState.make(cfg, where), cfg, target.to(where),
            params)
        img = st.accumulator[:, :3] / torch.clamp(st.pixel_count,
                                                  min=1.0)[:, None]
        return img.cpu(), {k: g.cpu() for k, g in grads.items()}

    target = torch.full((64 * 64, 3), 0.25)
    (gi, gg), (ci, cg) = step(card, target), step(cpu, target)
    agree = torch.isclose(gi, ci, rtol=1e-3, atol=1e-4).all(-1)
    loss = lambda img: ((img[agree] - 0.25) ** 2).mean().item()
    loss_rel = abs(loss(gi) - loss(ci)) / max(loss(ci), 1e-30)
    if disney:
        # the pixels that differ weigh nothing: target = their own value
        held = _rel(step(card, torch.where(agree[:, None], target, gi))[1],
                    step(cpu, torch.where(agree[:, None], target, ci))[1])
    else:
        held = _rel(gg, cg)
    pixels = agree.float().mean().item()
    assert pixels >= (DISNEY_PIXELS_MIN if disney else 1.0), pixels
    assert loss_rel <= 1e-4, loss_rel
    assert all(held[k] <= b for k, b in GRAD_RTOL.items()), held


@pytest.mark.card
def test_cluster_step_matches_the_auto_step(bathroom, card):
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, ensure_regen_state)
    host, cam = bathroom
    scene, view = host.sync(card, clusters=True), cam.get_view(card)
    acfg = dataclasses.replace(MAIN, remat=True)
    ccfg = dataclasses.replace(acfg, intersector="cluster")
    params, target = headline_params(scene, MAIN.width, card)
    state = ensure_regen_state(view, AccumState.make(acfg, card), acfg)
    step = lambda: regen_value_and_grad(scene, view, state, ccfg, target,
                                        params)
    clear_graphs()
    per_call = []
    for _ in range(2):      # eager, capture
        tallied(step, per_call)
    loss_c, g_c, _ = tallied(step, per_call)
    prof = profiled_replay(step, card, per_call)
    replay_gates(ccfg, scene, per_call, ("eager", "capture", "replay",
                                         "replay"), prof, grad=True)
    loss_a, g_a, _ = regen_value_and_grad(scene, view, state, acfg, target,
                                          params)
    loss_rel = abs(loss_c.item() - loss_a.item()) / max(abs(loss_a.item()),
                                                         1e-30)
    rel = _rel(g_c, g_a)
    assert loss_rel <= LOSS_RTOL, loss_rel
    assert all(rel[k] <= b for k, b in GRAD_RTOL.items()), rel
    assert_grads_finite_nonzero(g_c)
