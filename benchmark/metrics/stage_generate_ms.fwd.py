"""stage_generate_ms.fwd: device-busy milliseconds a traced forward pass in the
program's generate stage (path regeneration: dead-lane restart, eye rays,
the merge), read from its stage marks (benchmark/stages.py)."""
from benchmark.stages import stage_ms


def read(rec):
    return stage_ms(rec, ("generate",))
