"""stage_trace_ms.fwd: device-busy milliseconds a traced forward pass in the
program's trace and occlude stages (the closest-hit and any-hit kernels;
on the cluster path also the ray sorts and the payload pack and fetch),
read from its stage marks (benchmark/stages.py)."""
from benchmark.stages import stage_ms


def read(rec):
    return stage_ms(rec, ("trace", "occlude"))
