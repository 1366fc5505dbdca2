"""The comparison that decides `correct`, driven through the harness at a
size the CPU holds (the bathroom at detail 0, 32x32, path 4): a sound run
passes; the control (the reference in bfloat16 in the program's place)
fails; and so does the run with the timed path broken underneath in each
way a progressive render can break, its camera seed can stop advancing or
its ray counts can change their meaning. The program runs on the CPU
through its plain kernels."""
import dataclasses
import time

import pytest
import torch

from benchmark import harness

SEED = 2**31 + 12345


def _spec():
    spec = harness.cell_spec("bathroom_auto_fwd")
    spec["config"] = dict(spec["config"], detail=0, width=32, height=32,
                          max_path_length=4)
    spec["traffic"] = dict(spec["traffic"], check_lanes=256)
    return spec


def _run(spec, fault=None, monkeypatch=None):
    """One run of the cell on the CPU, render_pass_auto wrapped by `fault`
    (the pass, its input state, its output) -> output. Returns (result,
    ctx, driver output)."""
    if fault is not None:
        from lighthouse2_tpu_torch.render import wavefront as wf
        real = wf.render_pass_auto
        calls = []

        def broken(scene, view, state, config):
            out = real(scene, view, state, config)
            calls.append(1)
            return fault(len(calls), state, out)
        monkeypatch.setattr(wf, "render_pass_auto", broken)
    dev = torch.device("cpu")
    ctx, out = harness.measure(spec, SEED, 0.2, False, dev, time.perf_counter())
    checks = ctx["driver"].check(ctx, out)
    return harness.result(spec, ctx, out, checks, dev), ctx, out


@pytest.fixture(scope="module")
def sound():
    return _run(_spec())


def test_sound_run_is_correct(sound):
    res, _, _ = sound
    assert res["correct"], res["checks"]
    assert res["checks"]["first_pass_lanes_off"]["value"] == 0.0
    assert res["checks"]["cam_seed_off"]["value"] == 0
    assert list(res)[-1] == "checks"


def test_control_is_not_correct(sound):
    res, ctx, out = sound
    control = ctx["driver"].check(ctx, out, dtype=torch.bfloat16)
    limits = res["checks"]
    assert any(control[k] > limits[k]["limit"] for k in limits), control
    assert control["first_pass_lanes_off"] > 0.5


def _unchanged(n, state_in, out):
    """From the second pass on, the pass hands its input state back."""
    return out if n == 1 else (state_in, out[1])


def _half_left_out(n, state_in, out):
    """Half of the lanes' samples (every odd pixel) left out of the pass:
    neither their radiance nor their completed samples are added."""
    state, stats = out
    keep = torch.zeros_like(state.pixel_count, dtype=torch.bool)
    keep[::2] = True
    acc0 = (state_in.accumulator if state_in.pixel_count is not None
            else torch.zeros_like(state.accumulator))
    cnt0 = (state_in.pixel_count if state_in.pixel_count is not None
            else torch.zeros_like(state.pixel_count))
    return dataclasses.replace(
        state, accumulator=torch.where(keep[:, None], state.accumulator, acc0),
        pixel_count=torch.where(keep, state.pixel_count, cnt0)), stats


def _altered(n, state_in, out):
    """Each pass's radiance altered by 1% where it is produced."""
    state, stats = out
    acc0 = (state_in.accumulator if state_in.pixel_count is not None
            else torch.zeros_like(state.accumulator))
    delta = state.accumulator - acc0
    delta[:, :3] *= 1.01
    return dataclasses.replace(state, accumulator=acc0 + delta), stats


def _seed_stuck(n, state_in, out):
    """From the second pass on, the camera seed is handed back unchanged:
    every pass draws the random numbers of the one before."""
    state, stats = out
    if n == 1:
        return out
    return dataclasses.replace(state, cam_seed=state_in.cam_seed), stats


def _shadow_uncounted(n, state_in, out):
    """The pass's stats count its extension rays alone."""
    state, stats = out
    return state, dict(stats, total_shadow=torch.zeros_like(
        stats["total_shadow"]))


@pytest.mark.parametrize(
    "fault", [_unchanged, _half_left_out, _altered, _seed_stuck,
              _shadow_uncounted],
    ids=["unchanged_state", "half_left_out", "altered", "seed_stuck",
         "shadow_uncounted"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    res, _, _ = _run(_spec(), fault, monkeypatch)
    assert not res["correct"], res["checks"]
