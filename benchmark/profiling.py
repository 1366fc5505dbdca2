"""Reading a torch.profiler trace: the device's intervals, its busy and idle
time, the operations that took most time and the longest idle gaps with
what the host was doing meanwhile. Frozen with the benchmark."""
from __future__ import annotations

WINDOW = "benchmark.trace_window"
# the program's trace kernels, by function name
TRACE_KERNELS = ("closest_kernel", "occluded_kernel", "cluster_closest_kernel",
                 "cluster_occluded_kernel")
# the profiler's own buffer handling on the host: a device gap under one of
# these is the measurement's, not the program's
PROFILER_OPS = ("Buffer Flush", "Activity Buffer Request")


def kernel_name(key: str) -> str:
    """The function name in a profiler key (a demangled signature), so that
    closest_kernel does not also match cluster_closest_kernel."""
    head = key.split("(")[0].split()
    return head[-1] if head else key


def timeline(events, window=WINDOW):
    """From profiler FunctionEvents: (device ops [(name, start_us, end_us)]
    inside the window, host ops [(name, start_us, end_us)], (start_us,
    end_us) of the host range named `window`)."""
    from torch.autograd import DeviceType
    span, dev, host = None, [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name == window:
                continue
            dev.append((e.name, tr.start, tr.end))
        elif e.name == window:
            span = (tr.start, tr.end)
        else:
            host.append((e.name, tr.start, tr.end))
    if span is None:
        raise RuntimeError(f"the profiler trace has no range {window!r}")
    dev = [d for d in dev if d[2] > span[0] and d[1] < span[1]]
    return sorted(dev, key=lambda d: d[1]), host, span


def steady_span(dev, span):
    """From the first device operation's start to the last one's end (the
    traced calls without the launch latency before the first of them and
    the host's tail after the last); `span` where there is none."""
    if not dev:
        return span
    return (min(d[1] for d in dev), max(d[2] for d in dev))


def busy_intervals(dev, span):
    """The union of the device ops' intervals, clipped to the span."""
    merged = []
    for _, s, e in dev:
        s, e = max(s, span[0]), min(e, span[1])
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(dev, span) -> float:
    return sum(e - s for s, e in busy_intervals(dev, span)) * 1e-6


def idle_percent(dev, span, host=()) -> float:
    """The share of the span in which the device ran nothing, in percent,
    leaving out of the span the gaps in which the host was inside the
    profiler's own buffer handling (PROFILER_OPS)."""
    own = sum(s for label, s in idle_gaps(dev, host, span, n=None)
              if label in PROFILER_OPS)
    window = (span[1] - span[0]) * 1e-6 - own
    return 100.0 * (1.0 - busy_seconds(dev, span) / window)


def top_ops(dev, n=10):
    """[(name, seconds)] of the device ops with the most time by name."""
    tot = {}
    for name, s, e in dev:
        tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def idle_gaps(dev, host, span, n=10):
    """[(what the host was doing, seconds)] of the `n` longest gaps (all
    with n None) in which the device ran nothing, labelled by the innermost
    host op that spans the gap's start (or "host" where none does)."""
    merged = busy_intervals(dev, span)
    edges = [span[0]] + [x for iv in merged for x in iv] + [span[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:n]:
        inner = [h for h in host if h[1] <= s < h[2]]
        label = min(inner, key=lambda h: h[2] - h[1])[0] if inner else "host"
        out.append((label, (e - s) * 1e-6))
    return out
