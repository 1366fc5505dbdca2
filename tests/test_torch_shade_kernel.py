"""The shade kernel (csrc/shade.cu via render/kernels/shade.py) and the rule
that picks it.

On the CPU (a few seconds, a Cornell box at 8x8): which path
render/wavefront.py shade_bounce takes by render/kernels/shade.py use_kernel:
the composed code on the CPU, under grad with a material parameter requiring
grad (a Lambert and a Disney one), and for the filter, IBL sky NEE (Disney
under it too) and scene sharding; a kernel for a forward Lambert or Disney
bounce on a CUDA device (a stand-in tensor on "cuda" for the lanes' device,
as this host has no card). And the wrapper's own
checks on the CPU: its plain branch is the composed code, and it refuses a
lane tensor of the wrong dtype; and the agreement rule that holds the
kernel to the composed code on the card counts the lanes off by output.

Marked `card` (they skip without one; run them on the card with
`python -m pytest tests/test_torch_shade_kernel.py --noconftest -m card`):
the kernel against the composed shade_bounce on one bounce of the bathroom
at 512x512 on both intersectors (gathers and payload), at bounce 0 of a
fresh regen pool and at a bounce of a pool one pass in, where the lanes
stand at many path depths; and a regen pass replayed from its CUDA graph
against the eager composed pass under the benchmark's tolerances. No JAX.
"""
import dataclasses

import pytest
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import wavefront as wf
from lighthouse2_tpu_torch.render.kernels import shade as shade_k
from lighthouse2_tpu_torch.scene import bench_scene, presets

SIZE = 8
# the benchmark's per-lane tolerances (benchmark/drivers/progressive.py)
RTOL, ATOL = 1e-3, 1e-4


class _OnCard:
    """A stand-in for a lane tensor on a CUDA device: all use_kernel reads
    of the lanes is their device."""
    device = torch.device("cuda", 0)
    requires_grad = False


@pytest.fixture(scope="module")
def cornell():
    host, cam = presets.cornell_box(SIZE, SIZE)
    presets.test_sky(host)
    scene, view = host.sync("cpu"), cam.get_view("cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=3)
    paths = wf.generate_eye_rays(view, cfg, 0)
    acc = torch.zeros((cfg.n_paths, 4))
    hit = wf._intersect(scene, paths["origin"], paths["dir"], paths["alive"],
                        cfg)[:4]
    return scene, view, cfg, paths, acc, hit


def _rule(scene, view, cfg, paths, acc, hit, on_card=True):
    if on_card:
        paths = dict(paths, origin=_OnCard())
    return shade_k.use_kernel(scene, view, cfg, paths, acc, hit)


def test_rule_picks_the_kernel_for_a_forward_lambert_bounce_on_a_card(
        cornell):
    scene, view, cfg, paths, acc, hit = cornell
    assert _rule(scene, view, cfg, paths, acc, hit)
    with torch.no_grad():
        assert _rule(scene, view, cfg, paths, acc, hit)
    # an IBL sky only matters with sky_ibl, and sky_ibl only with the tables
    assert _rule(scene, view, dataclasses.replace(cfg, sky_ibl=False),
                 paths, acc, hit)
    assert scene.sky.has_ibl
    no_tables = dataclasses.replace(
        scene, sky=dataclasses.replace(scene.sky, has_ibl=False))
    assert _rule(no_tables, view, dataclasses.replace(cfg, sky_ibl=True),
                 paths, acc, hit)


def test_rule_picks_the_kernel_for_a_forward_disney_bounce_on_a_card(
        cornell):
    scene, view, cfg, paths, acc, hit = cornell
    disney = dataclasses.replace(cfg, bsdf="disney")
    assert shade_k.config_takes_kernel(disney, scene)
    assert _rule(scene, view, disney, paths, acc, hit)
    with torch.no_grad():
        assert _rule(scene, view, disney, paths, acc, hit)
    assert not _rule(scene, view, disney, paths, acc, hit, on_card=False)


def test_rule_keeps_the_composed_code_on_the_cpu(cornell):
    scene, view, cfg, paths, acc, hit = cornell
    assert not _rule(scene, view, cfg, paths, acc, hit, on_card=False)
    before = shade_k.shade_kernel.launches
    got = wf.shade_bounce(scene, view, cfg, paths, acc, 7, 0, *hit)
    want = wf._shade_composed(scene, view, cfg, paths, acc, 7, 0, *hit)
    plain = shade_k.shade_kernel(scene, view, cfg, paths, acc, 7, 0, *hit)
    assert shade_k.shade_kernel.launches == before
    for res in (got, plain):
        p, a, seed, shadow = res
        assert seed == want[2]
        assert torch.equal(a, want[1])
        for k in want[0]:
            assert torch.equal(p[k], want[0][k]), k
        for k in want[3]:
            assert torch.equal(shadow[k], want[3][k]), k


def test_rule_keeps_the_composed_code_under_grad(cornell):
    scene, view, cfg, paths, acc, hit = cornell
    color = scene.materials.color.detach().clone().requires_grad_()
    graded = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, color=color))
    assert not _rule(graded, view, cfg, paths, acc, hit)
    with torch.no_grad():          # no gradient needed: the kernel
        assert _rule(graded, view, cfg, paths, acc, hit)
    # a lane tensor that carries a gradient (the refined hit's t)
    t = hit[0].detach().clone().requires_grad_()
    assert not _rule(scene, view, cfg, paths, acc, (t, *hit[1:]))
    # Disney under a parameter only its BSDF reads
    disney = dataclasses.replace(cfg, bsdf="disney")
    metallic = scene.materials.metallic.detach().clone().requires_grad_()
    graded = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials,
                                             metallic=metallic))
    assert _rule(scene, view, disney, paths, acc, hit)
    assert not _rule(graded, view, disney, paths, acc, hit)
    with torch.no_grad():
        assert _rule(graded, view, disney, paths, acc, hit)


@pytest.mark.parametrize("change", [
    dict(bsdf="disney", sky_ibl=True), dict(filter_enabled=True),
    dict(sky_ibl=True), dict(scene_sharded=True)])
def test_rule_keeps_the_composed_code_for_other_configurations(cornell,
                                                               change):
    scene, view, cfg, paths, acc, hit = cornell
    assert not _rule(scene, view, dataclasses.replace(cfg, **change), paths,
                     acc, hit)


def test_wrapper_refuses_a_lane_tensor_of_another_dtype(cornell):
    scene, view, cfg, paths, acc, hit = cornell
    bad = dict(paths, n_diffuse=paths["n_diffuse"].to(torch.int64))
    with pytest.raises(TypeError, match="n_diffuse"):
        shade_k._args(scene, view, cfg, bad, acc, 7, 0, *hit, None)
    args, out, keep = shade_k._args(scene, view, cfg, paths, acc, 7, 0, *hit,
                                    None)
    assert args.n == cfg.n_paths and args.lt == 2 and args.payload is None
    assert out["acc"].shape == acc.shape


def test_agreement_counts_the_lanes_off_by_output(cornell):
    scene, view, cfg, paths, acc, hit = cornell
    want = wf._shade_composed(scene, view, cfg, paths, acc, 7, 0, *hit)
    off, agree = shade_k.agreement(want, want)
    assert agree == 1.0 and not any(off.values())
    p, a, seed, shadow = want
    n = cfg.n_paths
    lane = int(torch.nonzero(p["alive"])[0])
    alive = p["alive"].clone()
    alive[lane] = False                      # a branch differs on one lane
    tp = p["throughput"].clone()
    tp[lane - 1] *= 1 + 1e-3                 # past 1e-5 of its row
    tp[lane + 1] *= 1 + 1e-7                 # within it
    got = (dict(p, alive=alive, throughput=tp), a, seed, shadow)
    off, agree = shade_k.agreement(want, got)
    assert agree == 1 - 1 / n
    assert off["paths.alive"] == 1 / n
    assert off["paths.throughput"] == (1 / n if tp[lane - 1].any() else 0)
    assert sum(v > 0 for v in off.values()) == 1 + bool(tp[lane - 1].any())
    with pytest.raises(AssertionError, match="cam_seed"):
        shade_k.agreement(want, (p, a, seed + 1, shadow))


# ------------------------------------------------------------ on the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bathroom(card):
    host, cam = bench_scene.bathroom(512, 512, detail=1)
    scenes = dict(auto=host.sync(card), cluster=host.sync(card, clusters=True))
    return scenes, cam.get_view(card)


def _config(intersector):
    return RenderConfig(width=512, height=512, max_path_length=16,
                        path_regen=True, intersector=intersector)


def _bounce_inputs(scene, view, cfg, state):
    """The shade stage's inputs at the next bounce of `state`'s pool: dead
    lanes regenerated (as trace_paths_regen does), traced and refined."""
    paths, depth, _ = wf.regenerate(view, cfg, *state.pool)
    pay_tiles = wf.prepare_cluster_pay(scene, cfg)
    *hit, payload = wf._intersect(scene, paths["origin"], paths["dir"],
                                  paths["alive"], cfg, pay_tiles)
    acc = torch.zeros((cfg.n_paths, 4), device=depth.device)
    return paths, acc, depth, hit, payload


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_kernel_matches_composed_on_a_bounce(bathroom, card, intersector):
    scenes, view = bathroom
    scene, cfg = scenes[intersector], _config(intersector)
    state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, card), cfg)
    mid = wf.trace_paths_regen(scene, view, cfg, state)[3]
    report = {}
    for name, pool in (("bounce 0", state.pool), ("one pass in", mid)):
        st = dataclasses.replace(state, pool=pool)
        paths, acc, depth, hit, payload = _bounce_inputs(scene, view, cfg, st)
        with torch.no_grad():
            assert shade_k.use_kernel(scene, view, cfg, paths, acc, hit,
                                      payload)
            args = (scene, view, cfg, paths, acc, state.cam_seed, depth,
                    *hit)
            want = wf._shade_composed(*args, payload=payload)
            before = shade_k.shade_kernel.launches
            got = wf.shade_bounce(*args, payload=payload)
            torch.cuda.synchronize(card)
        assert shade_k.shade_kernel.launches == before + 1
        off, agree = shade_k.agreement(want, got)
        report[name] = dict(agree=agree, depths=int(depth.max()), **off)
        print(f"[shade kernel] {intersector} {name}: {report[name]}")
        for k, share in off.items():
            assert share <= shade_k.OFF_MAX, (name, k, share)
        assert agree >= shade_k.AGREE_MIN, (name, agree)


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_graph_replay_matches_eager_composed_pass(bathroom, card,
                                                  intersector, monkeypatch):
    scenes, view = bathroom
    scene, cfg = scenes[intersector], _config(intersector)
    state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, card), cfg)
    wf._regen_graph.clear()
    with torch.no_grad():
        calls = [wf._render_pass_regen_jit(scene, view, state, cfg)
                 for _ in range(3)]     # eager, capture, replay
        assert wf._regen_graph.replays >= 1
        monkeypatch.setattr(shade_k, "use_kernel", lambda *a, **k: False)
        want, _ = wf._regen_pass(scene, view, state, cfg)
    wf._regen_graph.clear()
    got, _ = calls[-1]
    torch.cuda.synchronize(card)
    close = (torch.abs(got.accumulator - want.accumulator)
             <= ATOL + RTOL * torch.abs(want.accumulator)).all(1)
    pool_same = ((got.pool[2] == want.pool[2])
                 & (got.pool[0]["alive"] == want.pool[0]["alive"]))
    off = (~close).float().mean().item()
    print(f"[shade kernel] {intersector} replay vs eager composed: pixels "
          f"off {off:.5f}, pool lanes off "
          f"{(~pool_same).float().mean().item():.5f}")
    assert int(got.cam_seed) == int(want.cam_seed)
    assert torch.equal(got.sample_count, want.sample_count)
    assert off <= 0.015
    assert (~pool_same).float().mean().item() <= 0.015
