"""device_idle.fwd: the share of the traced forward passes' wall time in
which the device ran nothing: 1 - (union of the device operations'
intervals) / (the traced window), in percent; gaps in which the host was
inside the profiler's own buffer handling are left out of the window."""
from benchmark.profiling import idle_percent


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "progressive" or tr is None or not tr["dev"]:
        return None
    return idle_percent(tr["dev"], tr["span"], tr["host"])
