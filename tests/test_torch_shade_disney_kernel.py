"""The Disney shade kernel (csrc/shade.cu shade_disney_kernel via
render/kernels/shade.py) held to the composed Disney shade code.

On the CPU (under a second, a Disney Cornell box at 8x8, no JAX): the
wrapper's plain branch is render/wavefront.py _shade_composed bit for bit,
lobe picks included, and neither launch counter moves.

Marked `card` (they skip without one; run them on the card with
`python -m pytest tests/test_torch_shade_disney_kernel.py --noconftest -m
card -s`), on the bathroom under the benchmark's Disney materials
(configuration bathroom-512-disney) at 512x512: the kernel against the
composed shade_bounce by shade.agreement at bounce 0 of a fresh regen pool
and at a bounce one pass in, on both intersectors (gathers and payload); a
regen pass replayed from its CUDA graph against the eager composed pass,
under the benchmark's per-lane tolerances and its Disney cell's share of
lanes off; and the kernel's lobe picks against the composed code's on the
same bounces.
"""
import dataclasses
import json
import os

import pytest
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import wavefront as wf
from lighthouse2_tpu_torch.render.kernels import shade as shade_k
from lighthouse2_tpu_torch.scene import presets
from lighthouse2_tpu_torch.utils import telemetry

torch.set_num_threads(1)

SIZE = 8
# the benchmark's per-lane tolerances (benchmark/drivers/progressive.py)
# and its Disney cell's share of lanes off (benchmark/checks/
# bathroom_disney_fwd.json)
RTOL, ATOL, LANES_OFF = 1e-3, 1e-4, 0.03
CONFIG = "bathroom-512-disney"


def _same(a, b):
    p, acc, seed, shadow = a
    q, acc2, seed2, shadow2 = b
    assert seed == seed2
    assert torch.equal(acc, acc2)
    for k in p:
        assert torch.equal(p[k], q[k]), k
    for k in shadow:
        assert torch.equal(shadow[k], shadow2[k]), k


def test_plain_branch_is_the_composed_disney_code_on_a_cornell_bounce():
    host, cam = presets.cornell_box(SIZE, SIZE)
    scene, view = host.sync("cpu"), cam.get_view("cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=3,
                       bsdf="disney")
    assert shade_k.config_takes_kernel(cfg, scene)
    paths = wf.generate_eye_rays(view, cfg, 0)
    acc = torch.zeros((cfg.n_paths, 4))
    hit = wf._intersect(scene, paths["origin"], paths["dir"], paths["alive"],
                        cfg)[:4]
    counts = telemetry.lobe_counts("cpu")
    launches = shade_k.shade_kernel.launches
    disney = shade_k.shade_kernel.disney_launches
    picks = []
    results = []
    for fn in (wf._shade_composed, shade_k.shade_kernel):
        before = counts.clone()
        results.append(fn(scene, view, cfg, paths, acc, 7, 0, *hit,
                          marks=True))
        picks.append(counts - before)
    assert shade_k.shade_kernel.launches == launches
    assert shade_k.shade_kernel.disney_launches == disney
    _same(*results)
    assert torch.equal(picks[0], picks[1]) and int(picks[0].sum()) > 0


# ------------------------------------------------------------ on the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bathroom(card):
    from benchmark import harness
    with open(os.path.join(harness.ROOT, "benchmark", "configs",
                           CONFIG + ".json")) as fh:
        conf = json.load(fh)
    raw = harness.load("scenes", conf["scene"]).build(conf)
    out = {}
    for inter in ("auto", "cluster"):
        c = dict(conf, intersector=inter)
        scene, view, _ = harness.build_program_scene(raw, c, card)
        out[inter] = scene, view, harness.render_config(c)
    return out


def _bounces(scene, view, cfg, card):
    """The shade stage's inputs at bounce 0 of a fresh regen pool and at a
    bounce one pass in (lanes at many path depths): dead lanes
    regenerated, traced and refined, as trace_paths_regen does. Yields
    (name, shade_bounce's args, payload)."""
    state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, card), cfg)
    mid = wf.trace_paths_regen(scene, view, cfg, state)[3]
    for name, pool in (("bounce 0", state.pool), ("one pass in", mid)):
        paths, depth, _ = wf.regenerate(view, cfg, *pool)
        *hit, payload = wf._intersect(scene, paths["origin"], paths["dir"],
                                      paths["alive"], cfg,
                                      wf.prepare_cluster_pay(scene, cfg))
        acc = torch.zeros((cfg.n_paths, 4), device=card)
        yield name, (scene, view, cfg, paths, acc, state.cam_seed, depth,
                     *hit), payload


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_disney_kernel_matches_composed_on_a_bounce(bathroom, card,
                                                    intersector):
    scene, view, cfg = bathroom[intersector]
    with torch.no_grad():
        for name, args, payload in _bounces(scene, view, cfg, card):
            assert shade_k.use_kernel(*args[:5], args[7:], payload)
            want = wf._shade_composed(*args, payload=payload)
            before = shade_k.shade_kernel.disney_launches
            got = wf.shade_bounce(*args, payload=payload)
            torch.cuda.synchronize(card)
            assert shade_k.shade_kernel.disney_launches == before + 1
            off, agree = shade_k.agreement(want, got)
            print(f"[shade disney] {intersector} {name}: agree {agree}, "
                  f"depths {int(args[6].max())}, off {off}")
            for k, share in off.items():
                assert share <= shade_k.OFF_MAX, (name, k, share)
            assert agree >= shade_k.AGREE_MIN, (name, agree)


@pytest.mark.card
def test_disney_graph_replay_matches_eager_composed_pass(bathroom, card,
                                                         monkeypatch):
    scene, view, cfg = bathroom["auto"]
    state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, card), cfg)
    wf._regen_graph.clear()
    with torch.no_grad():
        before = shade_k.shade_kernel.disney_launches
        calls = [wf._render_pass_regen_jit(scene, view, state, cfg)
                 for _ in range(3)]     # eager, capture, replay
        assert wf._regen_graph.replays >= 1
        # the eager call and the capture launch it once a bounce each
        assert (shade_k.shade_kernel.disney_launches - before
                == 2 * cfg.max_path_length)
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
    pool_off = (~pool_same).float().mean().item()
    print(f"[shade disney] replay vs eager composed: pixels off {off:.5f}, "
          f"pool lanes off {pool_off:.5f}")
    assert int(got.cam_seed) == int(want.cam_seed)
    assert torch.equal(got.sample_count, want.sample_count)
    assert off <= LANES_OFF
    assert pool_off <= LANES_OFF


@pytest.mark.card
def test_disney_kernel_counts_the_composed_lobe_picks(bathroom, card):
    scene, view, cfg = bathroom["auto"]
    counts = telemetry.lobe_counts(card)
    with torch.no_grad():
        for name, args, payload in _bounces(scene, view, cfg, card):
            picks = []
            for fn in (wf._shade_composed, shade_k.shade_kernel):
                before = counts.clone()
                fn(*args, payload=payload, marks=True)
                picks.append((counts - before).cpu())
            want, got = picks
            gap = int((want - got).abs().sum())
            print(f"[shade disney] lobe picks {name}: composed "
                  f"{want.tolist()}, kernel {got.tolist()}, gap {gap}")
            # a lane whose branches split from the composed code's may pick
            # otherwise: at most the lanes agreement lets disagree
            assert gap <= (1 - shade_k.AGREE_MIN) * cfg.n_paths, name
            assert all(int(x) > 0 for x in want), want
