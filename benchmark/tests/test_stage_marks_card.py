"""The program's stage marks on the card, in replayed regen passes of the
bathroom (the benchmark's two configurations): the profiler shows each
lh2_mark_* kernel as often a pass as its stage runs; the program's own
readout (telemetry.stage_seconds) agrees with the profiler's mark-to-mark
walls by stage within 2% over 3 passes, and their sum with the passes'
first-mark-to-end walls within 1%; the device time outside the marks (the
replay's copies) is under 3% of the traced passes' device span. A trace
from which the profiler dropped records (the passes' op counts differ),
or whose clock ran at another rate than the device's (the readout's
total off the profiler's walls by over 1%: cluster windows have read
2.0% and 7.3% over, while untraced the readout matched CUDA events within
0.1%), is taken again, up to five windows. Prints each window's
completeness and clock ratio, each stage's wall ms, busy ms (what the
stage_*_ms.fwd metrics read), idle ms and device ops a pass, and the
readout's stage ms of the fastest and the slowest stretch of 10 untraced
passes beside their pace. Marked `card`: skipped where torch sees no CUDA
card. Run on the card with
`python -m pytest benchmark/tests/test_stage_marks_card.py -m card -s`."""
import bisect
import collections
import json
import os

import pytest

from benchmark import harness, profiling, stages

PASSES = 3
STRETCH = 10


def _passes(devops):
    """[(first mark's start, end mark's start)] of the traced passes."""
    marks = stages.marks(devops)
    if not marks:
        return []
    firsts = [marks[0][1]] + [t for (s, _), (_, t) in zip(marks, marks[1:])
                              if s == "end"]
    return list(zip(firsts, [t for s, t in marks if s == "end"]))


def _complete(devops):
    """Whether a trace holds every device op of its passes. The profiler
    drops records now and then; the passes, replays of one graph, then
    differ in the ops counted from their first mark to their end mark."""
    passes = _passes(devops)
    counts = {sum(f <= d[1] <= e for d in devops) for f, e in passes}
    return len(passes) == PASSES and len(counts) == 1


def _clock_ratio(devops, before, after):
    """The readout's total over the profiler's first-mark-to-end walls:
    the profiler maps device times onto the host's clock, and now and then
    a window comes out scaled."""
    walls = sum(e - f for f, e in _passes(devops))
    own = sum(after[s] - before[s] for s in before if s != "passes") * 1e6
    return own / walls


def _run(config, untraced=100, tries=5):
    """Replayed passes of the configuration after the eager call, the
    capture and one replay: first `untraced` passes with at most two in
    flight, as the benchmark's window runs them, read in stretches of
    STRETCH through the program's own readout and CUDA events between
    passes; then PASSES passes under torch.profiler, again (up to `tries`
    windows) until the profiler's trace is complete and on the device's
    clock. Returns (config, the
    stretches {pass_ms, stage_ms} from the fastest, the trace's device
    ops, stage_seconds before and after it, each window profiled: whether
    complete, and its clock ratio)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, render_pass_auto)
    from lighthouse2_tpu_torch.utils import telemetry

    dev = torch.device("cuda", 0)
    with open(os.path.join(harness.ROOT, "benchmark", "configs",
                           config + ".json")) as fh:
        conf = json.load(fh)
    raw = harness.load("scenes", conf["scene"]).build(conf)
    scene, view, _ = harness.build_program_scene(raw, conf, dev)
    rc = harness.render_config(conf)
    state = AccumState.make(rc, dev)
    for _ in range(3):
        state, _ = render_pass_auto(scene, view, state, rc)
    torch.cuda.synchronize(dev)

    stretches, events = [], []
    for k in range(untraced // STRETCH):
        before = telemetry.stage_seconds(dev)
        for i in range(k * STRETCH, (k + 1) * STRETCH):
            state, _ = render_pass_auto(scene, view, state, rc)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            if i >= 2:
                events[i - 2].synchronize()
        torch.cuda.synchronize(dev)
        after = telemetry.stage_seconds(dev)
        stretches.append(dict(
            pass_ms=events[k * STRETCH].elapsed_time(events[-1])
            / (STRETCH - 1),
            stage_ms={s: (after[s] - before[s]) * 1e3 / STRETCH
                      for s in telemetry.STAGES}))
    stretches.sort(key=lambda x: x["pass_ms"])

    windows = []
    for _ in range(tries):
        before = telemetry.stage_seconds(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(profiling.WINDOW):
                for _ in range(PASSES):
                    state, _ = render_pass_auto(scene, view, state, rc)
                torch.cuda.synchronize(dev)
        after = telemetry.stage_seconds(dev)
        devops, _, _ = profiling.timeline(prof.events())
        complete = _complete(devops)
        ratio = _clock_ratio(devops, before, after) if complete else None
        windows.append(dict(complete=complete, clock_ratio=ratio))
        if complete and abs(ratio - 1.0) <= 0.01:
            break
    return rc, stretches, devops, before, after, windows


@pytest.mark.card
@pytest.mark.parametrize("config", ["bathroom-512-auto",
                                    "bathroom-512-cluster"])
def test_stage_marks_of_replayed_passes(config):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from lighthouse2_tpu_torch.utils import telemetry

    rc, stretches, devops, before, after, windows = _run(config)
    marks = stages.marks(devops)
    got = collections.Counter(s for s, _ in marks)
    prof_us = stages.stage_us(devops)
    busy_us = stages.stage_us(devops, busy=True)
    lo, hi = profiling.steady_span(devops, None)
    own_us = {s: (after[s] - before[s]) * 1e6 for s in telemetry.STAGES}
    off = {s: own_us[s] / prof_us[s] - 1.0 for s in telemetry.STAGES}
    inside = _passes(devops)
    walls = sum(e - f for f, e in inside)
    # what lies outside the passes' first-mark-to-end intervals
    outside = [d for d in devops
               if not any(f <= d[1] < e for f, e in inside)
               and not profiling.kernel_name(d[0]).startswith(stages.MARK)]
    out_us = sum(e - s for _, s, e in outside)
    # each stage's device operations, its mark included
    ops = collections.Counter()
    times = [t for _, t in marks]
    for _, s, _ in devops:
        i = bisect.bisect_right(times, s) - 1
        if i >= 0 and marks[i][0] != "end":
            ops[marks[i][0]] += 1
    generate = [(b - a) / 1e3 for stage, a, b in stages.stage_spans(devops)
                if stage == "generate"][:rc.max_path_length]
    print(json.dumps(dict(
        config=config, card=torch.cuda.get_device_name(0),
        untraced_fastest=stretches[0], untraced_slowest=stretches[-1],
        traced_windows=windows,
        marks_a_pass=len(marks) / PASSES, ops_a_pass=len(devops) / PASSES,
        stage_ms={s: prof_us[s] / 1e3 / PASSES for s in telemetry.STAGES},
        stage_busy_ms={s: busy_us[s] / 1e3 / PASSES
                       for s in telemetry.STAGES},
        own_stage_ms={s: own_us[s] / 1e3 / PASSES for s in telemetry.STAGES},
        stage_ops={s: ops[s] / PASSES for s in telemetry.STAGES},
        stage_idle_ms={s: (prof_us[s] - busy_us[s]) / 1e3 / PASSES
                       for s in telemetry.STAGES},
        first_pass_generate_ms=generate,
        outside_ops=len(outside) / PASSES, outside_ms=out_us / 1e3 / PASSES,
        wall_ms=walls / 1e3 / PASSES, span_ms=(hi - lo) / 1e3 / PASSES,
        off=off)))

    lead = 1 if rc.intersector == "cluster" else 0
    want = dict(dict.fromkeys(telemetry.STAGES[:6], rc.max_path_length),
                finish=1, end=1)
    want["trace"] += lead
    assert {s: n / PASSES for s, n in got.items()} == want
    assert after["passes"] - before["passes"] == PASSES
    # the program's readout against the profiler's mark-to-mark walls
    assert all(abs(v) <= 0.02 for v in off.values()), off
    assert abs(sum(own_us.values()) / walls - 1.0) <= 0.01
    # every other device op inside a stage: the replay's copies outside
    assert out_us / (hi - lo) < 0.03
