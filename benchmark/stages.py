"""Reading the program's own stage marks out of a traced run's record. The
marks are single-thread kernels named lh2_mark_<stage> (the program's
csrc/trace.cu), one at each stage boundary of a pass and lh2_mark_end at
its end, captured into the pass's CUDA graph. A stage runs from its mark's
start to the next mark's start. A trace of a program without marks holds
none, and every reader here then returns None."""
from __future__ import annotations

import bisect

from benchmark.profiling import busy_intervals, kernel_name

MARK = "lh2_mark_"
END = "end"


def marks(dev) -> list:
    """[(stage, start_us)] of the mark kernels among the device ops, in
    time order."""
    out = [(kernel_name(n)[len(MARK):], s) for n, s, _ in dev
           if kernel_name(n).startswith(MARK)]
    return sorted(out, key=lambda m: m[1])


def stage_spans(dev) -> list:
    """[(stage, start_us, end_us)] of every stage in the trace: from a
    mark's start to the next mark's (a mark lies in the stage it opens);
    the end mark opens none."""
    ms = marks(dev)
    return [(stage, s, nxt) for (stage, s), (_, nxt) in zip(ms, ms[1:])
            if stage != END]


def overlap(merged, starts, a, b) -> float:
    """us of the merged (sorted, disjoint) intervals, whose starts are
    `starts`, inside [a, b)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0.0
    while i < len(merged) and merged[i][0] < b:
        s, e = merged[i]
        tot += max(0.0, min(e, b) - max(s, a))
        i += 1
    return tot


def stage_us(dev, busy=False) -> dict | None:
    """{stage: us} summed over the trace: each stage's wall, or with
    `busy` the part of it in which the device ran an operation (the union
    of the ops' intervals clipped to the stage), which leaves out the idle
    a profiler adds between a replay's kernels. None where the trace holds
    no mark."""
    spans = stage_spans(dev)
    if not spans:
        return None
    if busy:
        merged = busy_intervals(sorted(dev, key=lambda d: d[1]),
                                (spans[0][1], spans[-1][2]))
        starts = [iv[0] for iv in merged]
    tot = {}
    for stage, a, b in spans:
        us = overlap(merged, starts, a, b) if busy else b - a
        tot[stage] = tot.get(stage, 0.0) + us
    return tot


def stage_ms(rec, stages) -> float | None:
    """Device-busy milliseconds a traced pass in the given stages, or
    None."""
    tr = rec["trace"]
    if rec["kind"] != "progressive" or tr is None:
        return None
    tot = stage_us(tr["dev"], busy=True)
    if tot is None:
        return None
    return sum(tot.get(s, 0.0) for s in stages) / 1e3 / tr["passes"]
