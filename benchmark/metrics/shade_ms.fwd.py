"""shade_ms.fwd: device milliseconds of one replayed forward pass in every
operation but the trace kernels (shading, NEE, regeneration, the ray sort,
the replay's copies)."""
from benchmark.profiling import TRACE_KERNELS, kernel_name


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "progressive" or tr is None or not tr["dev"]:
        return None
    us = sum(e - s for n, s, e in tr["dev"]
             if kernel_name(n) not in TRACE_KERNELS)
    return us / 1e3 / tr["passes"]
