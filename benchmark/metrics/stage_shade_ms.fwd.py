"""stage_shade_ms.fwd: device-busy milliseconds a traced forward pass in the
program's shade stage (shading data, BSDF, next-event estimation), read
from its stage marks (benchmark/stages.py)."""
from benchmark.stages import stage_ms


def read(rec):
    return stage_ms(rec, ("shade",))
