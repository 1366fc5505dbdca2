"""The executors and their CUDA graphs on the card (render/wavefront.py,
render/graphs.py), on the bathroom at 512x512, spp 1, path 16 unless
named.

- The main path (render_pass_auto, regen) on the Lambert bathroom and on
  the benchmark's Disney materials (the Disney shade kernel): 2 warm-ups
  (eager, capture), 3 passes and one more under the profiler, all
  replays, pass the launch gates (tests/card_support.py): 16 closest-hit,
  16 any-hit and 16 shade kernels a replay by the profiler's count; the
  image finite and positive.
- A 64x64 Cornell box, path 4, regen, on the card against the plain
  versions on the CPU (>= 99% of pixels within rtol 1e-3 / atol 1e-4, the
  means within 1e-3), on "auto" and on "cluster" (the card launching that
  intersector's kernels).
- The JAX package's executor entry points (EXEC_FORMS), classic or regen,
  "auto": one pass from a fresh state equal on every pixel (pixel counts
  too for regen) and in its ray counts to its family's reference
  (render_pass, render_pass_regen), 16 + 16 launches, one a live bounce,
  the forms without readback under set_sync_debug_mode("error"); then one
  more pass, EXEC_PASSES passes and one profiled: a graph form captures
  and replays under the launch gates, an eager form replays nothing.
  render_pass_staged opens a profiler range for every stage.
- Each captured pass (regen on "auto", unrolled on "auto", regen on
  "cluster"): GRAPH_PASSES calls of the entry point (warm-up, capture,
  replays) equal bit for bit, result by result, to as many passes through
  its eager body from one state; GRAPH_REPLAYS replays more, one under
  set_sync_debug_mode("error"), one profiled, under the launch gates. On
  the live regen graph a moved camera and new material colours replay,
  each equal to its eager pass; a Cornell box (other shapes) takes a new
  key and runs eagerly.
- The fwd+bwd step (regen_value_and_grad, grads "all", remat) on "auto"
  and "cluster": GRAPH_PASSES eager steps (diff/render.py fb_pass) against
  GRAPH_PASSES calls, GRAPH_REPLAYS replays, one profiled, then
  GRAPH_OPT_STEPS replays between which torch.optim.Adam steps the
  parameter leaves in place, each against fb_pass on the same inputs: loss
  and state bit-equal, each gradient group equal or within the spread of
  eager steps from the same inputs (GRAPH_SPREAD_STEPS).
- The main path on "cluster": the launch gates with the cluster kernels,
  the image against as many "auto" passes (only t-ties may differ).

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from card_support import bathroom, card, scene  # noqa: F401 (fixtures)
from card_support import (MAIN, PATH, all_counts, assert_agrees, call_kind,
                          captured, clear_graphs, counts, deltas,
                          disney_bathroom, headline_params, profiled_replay,
                          replay_gates, tallied)
from lighthouse2_tpu_torch.render import wavefront as wf

CLASSIC = dataclasses.replace(MAIN, path_regen=False)
MAIN_PASSES = 3            # replayed passes of the main path
EXEC_PASSES = 3            # passes of each executor form after the first
# (label, render/wavefront.py entry point, classic or regen config,
# whether it reads back from the device: only render_pass and
# render_pass_jit do, one bool a bounce; whether it runs a captured graph
# from its second call)
EXEC_FORMS = (("render_pass", "render_pass", "classic", True, False),
              ("render_pass_jit", "render_pass_jit", "classic", True, False),
              ("render_pass_staged", "render_pass_staged", "classic", False,
               False),
              ("render_pass_unrolled", "render_pass_unrolled", "classic",
               False, True),
              ("render_pass_auto", "render_pass_auto", "classic", False,
               True),
              ("render_pass_regen", "render_pass_regen", "regen", False,
               True),
              ("render_pass_auto_regen", "render_pass_auto", "regen", False,
               True))
EXEC_STAGES = ("_stage_generate", "_stage_prepare", "_stage_trace",
               "_stage_shade", "_stage_occlude", "_stage_apply",
               "_stage_finish")
GRAPH_PASSES = 4           # passes (steps) held eager against graph
GRAPH_REPLAYS = 5          # replays more of each graph
GRAPH_MOVE = (0.05, 0.0, 0.02)   # the moved camera's translation (metres)
# Eager steps from each compared graph step's inputs, where its gradients
# are not bit-equal (the cluster path's re-attach backward sums with
# atomics, so two eager steps differ in the last bits): the graph step
# must lie no farther from the nearest of its eager steps than the
# farthest two eager steps from one input are apart, over every compared
# step's inputs (the spread). Were each graph step one more eager step,
# that gate fails in none of 300 simulated runs of 6 compared steps
# (independent Gaussian noise on 400,000 entries) with 5 eager steps an
# input, in 4 with 3. 3 are taken first and 5 only where 3 do not hold
# the graph step: more eager steps can only widen the spread and bring
# the nearest nearer, so the verdict is that of 5. Then the replays
# between which torch.optim.Adam steps the parameter leaves in place, and
# its learning rate
GRAPH_SPREAD_STEPS = (3, 5)
GRAPH_OPT_STEPS = 2
GRAPH_OPT_LR = 1e-3


@pytest.fixture(scope="module")
def cscene(bathroom, card):
    """The bathroom synced with its cluster tiles: (DeviceScene, view)."""
    host, cam = bathroom
    return host.sync(card, clusters=True), cam.get_view(card)


def no_sync(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any operation
    that synchronises the host with the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _unequal(got, want):
    """Indices of the tensors of `got` that differ from `want`'s bit for bit
    (NaN == NaN), in render/graphs.py's walk order; [-1] if the structures
    differ."""
    from lighthouse2_tpu_torch.render import graphs
    tg, tw = [], []
    if graphs._walk(got, tg) != graphs._walk(want, tw):
        return [-1]
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return [i for i, (a, b) in enumerate(zip(tg, tw))
            if not torch.equal(bits(a), bits(b))]


def _main_path(scene, view, cfg, dev):
    """The launch gates of the main path's calls, and its image."""
    state = wf.AccumState.make(cfg, dev)
    clear_graphs()
    per_call = []
    one = lambda: wf.render_pass_auto(scene, view, state, cfg)
    for _ in range(2 + MAIN_PASSES):       # eager, capture, replays
        state, _ = tallied(one, per_call)
    prof = profiled_replay(one, dev, per_call)
    replay_gates(cfg, scene, per_call,
                 ("eager", "capture") + ("replay",) * (MAIN_PASSES + 1), prof)
    return wf.finalize(state)


@pytest.mark.card
@pytest.mark.parametrize("bsdf", ["lambert", "disney"])
def test_main_path_replays_its_graph(scene, card, bsdf):
    if bsdf == "disney":
        sc, view, cfg = disney_bathroom(card)
    else:
        (sc, view), cfg = scene, MAIN
    img = _main_path(sc, view, cfg, card)
    assert torch.isfinite(img).all() and img.mean() > 0


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_card_matches_cpu_on_a_cornell_box(card, intersector):
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       path_regen=True, intersector=intersector)
    host, cam = cornell_box(64, 64)
    cluster = intersector == "cluster"
    clear_graphs()
    out = []                                   # card, then CPU
    for where in (card, torch.device("cpu")):
        ds = host.sync(where, clusters=cluster)
        view = cam.get_view(where)
        st = wf.AccumState.make(cfg, where)
        before = all_counts()
        for _ in range(2):
            st, _ = wf.render_pass_auto(ds, view, st, cfg)
        launched = deltas(before, all_counts())
        out.append((st.accumulator.cpu(), wf.finalize(st).cpu()))
        if where is card:
            assert all(n > 0 for k, n in launched.items()
                       if k.startswith("cluster") == cluster), launched
    (ga, gi), (ca, ci) = out
    close = torch.isclose(ga, ca, rtol=1e-3, atol=1e-4).all(-1)
    mean_rel = abs(gi.mean().item() - ci.mean().item()) / max(
        abs(ci.mean().item()), 1e-30)
    assert close.float().mean().item() >= 0.99 and mean_rel <= 1e-3, (
        close.float().mean().item(), mean_rel)


@pytest.fixture(scope="module")
def references(scene, card):
    """{family: (state, (extension rays, shadow rays, samples completed))}
    of one eager pass of render_pass (classic) and render_pass_regen
    (regen) from a fresh state."""
    sc, view = scene
    out = {}
    for family, fn, cfg in (("classic", wf.render_pass, CLASSIC),
                            ("regen", wf.render_pass_regen, MAIN)):
        clear_graphs()
        state, stats = fn(sc, view, wf.AccumState.make(cfg, card), cfg)
        out[family] = state, _ray_counts(stats, cfg)
    return out


def _ray_counts(stats, cfg):
    return (stats["extension_rays"].tolist(), stats["shadow_rays"].tolist(),
            int(stats["samples_completed"]) if cfg.path_regen else None)


@pytest.mark.card
@pytest.mark.parametrize("form", EXEC_FORMS, ids=[f[0] for f in EXEC_FORMS])
def test_executor_form_equals_its_family(scene, card, references, form):
    _, fn_name, family, readback, graph = form
    sc, view = scene
    fn = getattr(wf, fn_name)
    c = MAIN if family == "regen" else CLASSIC
    clear_graphs()                 # the first pass runs eagerly
    before = counts()
    one = lambda: fn(sc, view, wf.AccumState.make(c, card), c)
    state, stats = one() if readback else no_sync(one)
    launches = deltas(before, counts())
    ray_counts = _ray_counts(stats, c)
    ref, ref_counts = references[family]
    assert torch.equal(state.accumulator, ref.accumulator)
    if c.path_regen:
        assert torch.equal(state.pixel_count, ref.pixel_count)
    assert ray_counts == ref_counts
    live = int((np.asarray(ray_counts[0]) > 0).sum())
    assert launches == {k: PATH for k in launches} and live == PATH, (
        launches, live)
    per_call = []
    st, _ = tallied(lambda: fn(sc, view, state, c), per_call)
    for _ in range(EXEC_PASSES):
        st, _ = tallied(lambda: fn(sc, view, st, c), per_call)
    prof = profiled_replay(lambda: fn(sc, view, st, c), card, per_call)
    if graph:
        replay_gates(c, sc, per_call,
                     ("capture",) + ("replay",) * (EXEC_PASSES + 1), prof)
    else:
        assert not any(x["replays"] for x in per_call), per_call


@pytest.mark.card
def test_staged_pass_opens_a_range_for_every_stage(scene, card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sc, view = scene
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wf.render_pass_staged(sc, view, wf.AccumState.make(CLASSIC, card),
                              CLASSIC)
        torch.cuda.synchronize(card)
    ranges = {e.key for e in prof.key_averages()
              if e.device_type == DeviceType.CPU}
    assert not [s for s in EXEC_STAGES if s not in ranges]


def _graph_calls(name, scene, view, cfg, state0, per_call):
    """GRAPH_PASSES calls of a graph entry point from state0 (warm-up,
    capture, replays), each from the last's state, its graph freed first:
    the results."""
    entry_fn = getattr(wf, name)
    captured(name).clear()
    held, got = [state0], []
    for _ in range(GRAPH_PASSES):
        got.append(tallied(lambda: entry_fn(scene, view, held[-1], cfg),
                           per_call))
        held.append(got[-1][0])
    return got


@pytest.mark.card
@pytest.mark.parametrize("name,intersector,eager", [
    ("_render_pass_regen_jit", "auto", "_regen_pass"),
    ("render_pass_unrolled", "auto", "_unrolled_pass"),
    ("_render_pass_regen_jit", "cluster", "_regen_pass")])
def test_graph_pass_equals_its_eager_body(scene, cscene, card, name,
                                          intersector, eager):
    cfg = (MAIN if eager == "_regen_pass" else CLASSIC)
    cfg = dataclasses.replace(cfg, intersector=intersector)
    sc, view = cscene if intersector == "cluster" else scene
    eager = getattr(wf, eager)
    entry_fn = getattr(wf, name)
    state0 = wf.AccumState.make(cfg, card)
    if cfg.path_regen:
        state0 = wf.ensure_regen_state(view, state0, cfg)
    want, st = [], state0
    for _ in range(GRAPH_PASSES):
        st, stats = eager(sc, view, st, cfg)
        want.append((st, stats))
    per_call = []
    got = _graph_calls(name, sc, view, cfg, state0, per_call)
    unequal = [_unequal(g, w) for g, w in zip(got, want)]
    assert not any(unequal), unequal
    st = got[-1][0]
    replay = lambda: tallied(lambda: entry_fn(sc, view, st, cfg), per_call)
    for _ in range(GRAPH_REPLAYS):
        replay()
    no_sync(replay)
    prof = profiled_replay(lambda: entry_fn(sc, view, st, cfg), card,
                           per_call)
    replay_gates(cfg, sc, per_call, ("eager", "capture") + ("replay",) * (
        GRAPH_PASSES - 2 + GRAPH_REPLAYS + 2), prof)


@pytest.mark.card
def test_graph_replays_a_moved_camera_and_new_colours(bathroom, scene,
                                                      card):
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    name = "_render_pass_regen_jit"
    sc, view = scene
    cam = bathroom[1]
    state = wf.ensure_regen_state(view, wf.AccumState.make(MAIN, card), MAIN)
    state = _graph_calls(name, sc, view, MAIN, state, [])[-1][0]
    e = captured(name).entry
    moved = copy.deepcopy(cam)
    moved.position = moved.position + np.float32(GRAPH_MOVE)
    recoloured = set_material_fields(
        sc, color=sc.materials.color.flip(-1).contiguous())
    for tag, s, vw in (("moved camera", sc, moved.get_view(card)),
                       ("new colour", recoloured, view)):
        c = []
        got = tallied(lambda: wf._render_pass_regen_jit(s, vw, state, MAIN),
                      c)
        assert captured(name).entry is e, tag
        assert call_kind(c[0], MAIN, sc) == "replay", (tag, c)
        assert not _unequal(got, wf._regen_pass(s, vw, state, MAIN)), tag
    host_c, cam_c = cornell_box(MAIN.width, MAIN.height)
    s, vw = host_c.sync(card), cam_c.get_view(card)
    st = wf.ensure_regen_state(vw, wf.AccumState.make(MAIN, card), MAIN)
    got = wf._render_pass_regen_jit(s, vw, st, MAIN)
    e2 = captured(name).entry
    assert e2 is not e and e2.key != e.key and e2.graph is None
    assert not _unequal(got, wf._regen_pass(s, vw, st, MAIN))


def _grad_rel(a, b):
    return {k: ((a[k] - b[k]).norm() / b[k].norm().clamp(min=1e-30)).item()
            for k in b}


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_graph_step_equals_its_eager_body(scene, cscene, card, intersector):
    from lighthouse2_tpu_torch.diff.render import fb_pass, regen_value_and_grad
    cfg = dataclasses.replace(MAIN, remat=True, intersector=intersector)
    sc, view = cscene if intersector == "cluster" else scene
    name = "regen_value_and_grad"
    params, target = headline_params(sc, cfg.width, card)
    state0 = wf.ensure_regen_state(view, wf.AccumState.make(cfg, card), cfg)
    held, want = [state0], []
    for _ in range(GRAPH_PASSES):
        want.append(fb_pass(sc, view, held[-1], cfg, target, params))
        held.append(want[-1][2])
    captured(name).clear()
    held, per_call, got = [state0], [], []
    for _ in range(GRAPH_PASSES):
        got.append(tallied(lambda: regen_value_and_grad(
            sc, view, held[-1], cfg, target, params), per_call))
        held.append(got[-1][2])
    # (graph result, eager result, the inputs both started from)
    compared = [(g, w, (s, params))
                for g, w, s in zip(got, want, held[:GRAPH_PASSES])]
    st = got[-1][2]
    step = lambda: regen_value_and_grad(sc, view, st, cfg, target, params)
    for _ in range(GRAPH_REPLAYS):
        tallied(step, per_call)
    prof = profiled_replay(step, card, per_call)
    # an optimizer's in-place step between replays: the replay must copy
    # the stepped leaves (same storage, a new version) into the graph
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=GRAPH_OPT_LR)
    for _ in range(GRAPH_OPT_STEPS):
        snap = {k: v.detach().clone() for k, v in leaves.items()}
        out = tallied(lambda: regen_value_and_grad(sc, view, st, cfg, target,
                                                   leaves), per_call)
        compared.append((out, fb_pass(sc, view, st, cfg, target, snap),
                         (st, snap)))
        for k, g in out[1].items():
            leaves[k].grad = g
        opt.step()
        st = out[2]
    fwd = [_unequal((g[0], g[2]), (w[0], w[2])) for g, w, _ in compared]
    # eager steps from the inputs of each step whose gradients differ
    sets = {i: [w[1]] for i, (g, w, _) in enumerate(compared)
            if _unequal(g[1], w[1])}
    spread, nearest = None, {}
    for n in GRAPH_SPREAD_STEPS if sets else ():
        for i, es in sets.items():
            s, p = compared[i][2]
            es += [fb_pass(sc, view, s, cfg, target, p)[1]
                   for _ in range(n - len(es))]
        # per group, the largest distance of two eager steps from one input
        spread = {k: max(_grad_rel(a, b)[k] for es in sets.values()
                         for j, a in enumerate(es) for b in es[:j])
                  for k in compared[0][1][1]}
        # per group, the distance of the graph step to its nearest eager one
        nearest = {i: {k: min(_grad_rel(compared[i][0][1], e)[k] for e in es)
                       for k in compared[i][0][1]}
                   for i, es in sets.items()}
        if all(v == 0.0 or v <= spread[k]
               for near in nearest.values() for k, v in near.items()):
            break
    bad = [i for i, u in enumerate(fwd)
           if u or (i in nearest and not all(
               v == 0.0 or v <= spread[k] for k, v in nearest[i].items()))]
    assert not bad, (bad, fwd, nearest, spread)
    replay_gates(cfg, sc, per_call, ("eager", "capture") + ("replay",) * (
        GRAPH_PASSES - 2 + GRAPH_REPLAYS + 1 + GRAPH_OPT_STEPS), prof,
        grad=True)


@pytest.mark.card
def test_cluster_main_path_replays_and_matches_auto(cscene, card):
    sc, view = cscene
    ccfg = dataclasses.replace(MAIN, intersector="cluster")
    clear_graphs()
    st_auto = wf.AccumState.make(MAIN, card)
    for _ in range(MAIN_PASSES + 2):  # as many passes as the cluster run's
        st_auto, _ = wf.render_pass_auto(sc, view, st_auto, MAIN)
    img = _main_path(sc, view, ccfg, card)
    assert torch.isfinite(img).all()
    assert_agrees(img.cpu().numpy(), wf.finalize(st_auto).cpu().numpy())
