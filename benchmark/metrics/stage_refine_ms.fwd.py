"""stage_refine_ms.fwd: device-busy milliseconds a traced forward pass in the
program's refine stage (the differentiable re-test of each hit), read
from its stage marks (benchmark/stages.py)."""
from benchmark.stages import stage_ms


def read(rec):
    return stage_ms(rec, ("refine",))
