"""The shade kernels on the card (csrc/shade.cu shade_bounce_kernel and
shade_disney_kernel via render/kernels/shade.py) held to the composed shade
code.

On the bathroom at 512x512, path 16, regen, under the Lambert BSDF and
under the benchmark's Disney materials (configuration bathroom-512-disney):
each kernel against the composed shade_bounce by shade.agreement at bounce
0 of a fresh regen pool and at a bounce one pass in, where the lanes stand
at many path depths, on both intersectors (gathers and payload), one launch
a call; a regen pass replayed from its CUDA graph against the eager
composed pass under the benchmark's per-lane tolerances; and the Disney
kernel's lobe picks against the composed code's on the same bounces. The
CPU tests of the rule that picks a kernel are in test_torch_shade_kernel.py
and test_torch_shade_disney_kernel.py.

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import dataclasses

import pytest
import torch

from card_support import bathroom, card  # noqa: F401 (fixtures)
from card_support import MAIN, disney_bathroom
from lighthouse2_tpu_torch.render import wavefront as wf
from lighthouse2_tpu_torch.render.kernels import shade as shade_k
from lighthouse2_tpu_torch.utils import telemetry

# the benchmark's per-lane tolerances (benchmark/drivers/progressive.py)
# and its Disney cell's share of lanes off (benchmark/checks/
# bathroom_disney_fwd.json)
RTOL, ATOL, LANES_OFF = 1e-3, 1e-4, 0.03


@pytest.fixture(scope="module")
def lambert(bathroom, card):
    """{intersector: (scene, view, config)} of the Lambert bathroom."""
    host, cam = bathroom
    view = cam.get_view(card)
    return {inter: (host.sync(card, clusters=inter == "cluster"), view,
                    dataclasses.replace(MAIN, intersector=inter))
            for inter in ("auto", "cluster")}


@pytest.fixture(scope="module")
def disney(card):
    """{intersector: (scene, view, config)} of the Disney bathroom."""
    return {inter: disney_bathroom(card, inter)
            for inter in ("auto", "cluster")}


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


def _kernel_matches_composed(scene, view, cfg, card, counter):
    """On both bounces of _bounces: the rule picks the kernel, one call of
    shade_bounce launches it once (`counter` reads its launches), and it
    agrees with the composed code by shade.agreement."""
    with torch.no_grad():
        for name, args, payload in _bounces(scene, view, cfg, card):
            assert shade_k.use_kernel(*args[:5], args[7:], payload)
            want = wf._shade_composed(*args, payload=payload)
            before = counter()
            got = wf.shade_bounce(*args, payload=payload)
            torch.cuda.synchronize(card)
            assert counter() == before + 1
            off, agree = shade_k.agreement(want, got)
            print(f"[shade] {cfg.bsdf} {cfg.intersector} {name}: agree "
                  f"{agree}, depths {int(args[6].max())}, off {off}")
            for k, share in off.items():
                assert share <= shade_k.OFF_MAX, (name, k, share)
            assert agree >= shade_k.AGREE_MIN, (name, agree)


def _replay_matches_eager_composed(scene, view, cfg, card, monkeypatch,
                                   lanes_off):
    """A regen pass replayed from its CUDA graph (eager, capture, replay)
    against the eager composed pass: pixels and pool lanes off within
    `lanes_off`."""
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
    pool_off = (~pool_same).float().mean().item()
    print(f"[shade] {cfg.bsdf} {cfg.intersector} replay vs eager composed: "
          f"pixels off {off:.5f}, pool lanes off {pool_off:.5f}")
    assert int(got.cam_seed) == int(want.cam_seed)
    assert torch.equal(got.sample_count, want.sample_count)
    assert off <= lanes_off
    assert pool_off <= lanes_off


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_kernel_matches_composed_on_a_bounce(lambert, card, intersector):
    _kernel_matches_composed(*lambert[intersector], card,
                             lambda: shade_k.shade_kernel.launches)


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_graph_replay_matches_eager_composed_pass(lambert, card,
                                                  intersector, monkeypatch):
    _replay_matches_eager_composed(*lambert[intersector], card, monkeypatch,
                                   0.015)


@pytest.mark.card
@pytest.mark.parametrize("intersector", ["auto", "cluster"])
def test_disney_kernel_matches_composed_on_a_bounce(disney, card,
                                                    intersector):
    _kernel_matches_composed(*disney[intersector], card,
                             lambda: shade_k.shade_kernel.disney_launches)


@pytest.mark.card
def test_disney_graph_replay_matches_eager_composed_pass(disney, card,
                                                         monkeypatch):
    scene, view, cfg = disney["auto"]
    before = shade_k.shade_kernel.disney_launches
    _replay_matches_eager_composed(scene, view, cfg, card, monkeypatch,
                                   LANES_OFF)
    # the eager call and the capture launch it once a bounce each
    assert (shade_k.shade_kernel.disney_launches - before
            == 2 * cfg.max_path_length)


@pytest.mark.card
def test_disney_kernel_counts_the_composed_lobe_picks(disney, card):
    scene, view, cfg = disney["auto"]
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
            print(f"[shade] Disney lobe picks {name}: composed "
                  f"{want.tolist()}, kernel {got.tolist()}, gap {gap}")
            # a lane whose branches split from the composed code's may pick
            # otherwise: at most the lanes agreement lets disagree
            assert gap <= (1 - shade_k.AGREE_MIN) * cfg.n_paths, name
            assert all(int(x) > 0 for x in want), want
