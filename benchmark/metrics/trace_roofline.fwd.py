"""trace_roofline.fwd: the least time of the passes' closest-hit and
any-hit work (benchmark/roofline.py: the larger of its bytes over the HBM
peak and its FP32 operations over the FP32 peak) over the device time of
the trace kernels in the traced passes, in percent. Nothing where the
trace holds no trace kernel by these names."""
from benchmark import roofline
from benchmark.profiling import TRACE_KERNELS, kernel_name


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "progressive" or tr is None:
        return None
    us = sum(e - s for n, s, e in tr["dev"] if kernel_name(n) in TRACE_KERNELS)
    if us <= 0:
        return None
    n_bytes, n_ops = roofline.trace_work(rec["n_tris"], tr["lanes"],
                                         tr["launches"], tr["live_closest"],
                                         tr["live_shadow"])
    least, _ = roofline.least_seconds(n_bytes, n_ops)
    return 100.0 * least / (us * 1e-6)
