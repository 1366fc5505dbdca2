"""The readers of the program's stage marks (benchmark/stages.py and the
five metrics on it), on synthetic traces: marks at known times with idle
device time inside the stages and between the passes, and traces without
marks, which read nothing."""
import pytest

from benchmark import harness, stages

STAGE_METRICS = ("stage_generate_ms.fwd", "stage_trace_ms.fwd",
                 "stage_refine_ms.fwd", "stage_shade_ms.fwd",
                 "stage_apply_ms.fwd")


def _mark(stage, t):
    return (f"lh2_mark_{stage}(long long*)", t, t + 2.0)


def _pass(t0, cluster=False):
    """One pass of two bounces from t0 (us): each stage 100 us but shade
    (300) and trace (200, with a trace kernel inside), finish 50; the pass
    lasts 1,850 us from its first mark to its end mark (1,950 with the
    cluster path's leading trace mark). Each stage leaves the device idle
    for 8 us (3 after its mark, 5 before the next one), trace for 58.
    Returns (device ops, the pass's end: its end mark's end)."""
    ops, t = [], t0
    if cluster:
        ops.append(_mark("trace", t))
        t += 100.0
    for _ in range(2):
        for stage, us in (("generate", 100.0), ("trace", 200.0),
                          ("refine", 100.0), ("shade", 300.0),
                          ("occlude", 100.0), ("apply", 100.0)):
            ops.append(_mark(stage, t))
            if stage == "trace":
                ops.append(("closest_kernel(float const*)", t + 10.0,
                            t + 150.0))
            else:
                ops.append(("void at::native::elementwise_kernel()", t + 5.0,
                            t + us - 5.0))
            t += us
    ops.append(_mark("finish", t))
    ops.append(("void at::native::reduce_kernel()", t + 5.0, t + 45.0))
    t += 50.0
    ops.append(_mark("end", t))
    return ops, t + 2.0


def _trace(cluster=False):
    """Two passes with a 500 us gap between them (the replay's copies run
    in the middle of it: a 100 us copy from 200 to 300 us into the gap)."""
    a, end_a = _pass(0.0, cluster)
    copy = ("Memcpy DtoD (Device -> Device)", end_a + 200.0, end_a + 300.0)
    b, end_b = _pass(end_a + 500.0, cluster)
    dev = sorted(a + [copy] + b, key=lambda d: d[1])
    return dict(dev=dev, host=[], span=(0.0, end_b), passes=2,
                live_closest=1, live_shadow=1, lanes=1, launches=1)


def _rec(tr):
    return dict(kind="progressive", trace=tr, window=dict(seconds=1.0),
                spans={}, peak_bytes=1, n_tris=1)


def _read(name, tr):
    return harness.metric_reader(name).read(_rec(tr))


@pytest.mark.parametrize("cluster", [False, True])
def test_stages_split_the_pass_at_the_marks(cluster):
    tr = _trace(cluster)
    # per pass, the device busy in each stage: 2 bounces of generate 92,
    # trace 142, refine 92, shade 292, occlude 92, apply 92; finish 42; the
    # cluster path's leading trace mark 2
    want = {"stage_generate_ms.fwd": 0.184,
            "stage_trace_ms.fwd": 0.468 + (0.002 if cluster else 0.0),
            "stage_refine_ms.fwd": 0.184, "stage_shade_ms.fwd": 0.584,
            "stage_apply_ms.fwd": 0.184 + 0.042}
    got = {m: _read(m, tr) for m in STAGE_METRICS}
    assert got == pytest.approx(want)
    # busy and idle inside the stages sum to a pass's first-mark-to-end
    # wall; the gap between the passes (the replay's copy) is in no stage
    walls = stages.stage_us(tr["dev"])
    busy = stages.stage_us(tr["dev"], busy=True)
    idle = 204.0 + (98.0 if cluster else 0.0)
    first, end = tr["dev"][0][1], [d for d in tr["dev"]
                                   if d[0].startswith("lh2_mark_end")][0][1]
    assert sum(walls.values()) / 2 == pytest.approx(end - first)
    assert (sum(busy.values()) / 2 + idle) == pytest.approx(end - first)
    assert sum(got.values()) == pytest.approx(sum(busy.values()) / 2e3)


def test_a_program_without_marks_reads_nothing():
    tr = _trace()
    tr["dev"] = [d for d in tr["dev"] if "lh2_mark_" not in d[0]]
    for m in STAGE_METRICS:
        assert _read(m, tr) is None, m
    assert _read("stage_shade_ms.fwd", None) is None
    rec = dict(_rec(_trace()), kind="step")
    for m in STAGE_METRICS:
        assert harness.metric_reader(m).read(rec) is None, m
