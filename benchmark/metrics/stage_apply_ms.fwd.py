"""stage_apply_ms.fwd: device-busy milliseconds a traced forward pass in the
program's apply and finish stages (the shadow rays' contribution and the
bounce's counters; untile, accumulate, stats), read from its stage marks
(benchmark/stages.py)."""
from benchmark.stages import stage_ms


def read(rec):
    return stage_ms(rec, ("apply", "finish"))
