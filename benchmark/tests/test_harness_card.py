"""One short run of every cell on the card, through the benchmark's
command. Marked `card`: skipped where torch sees no CUDA card. Run on the card
with `python -m pytest benchmark/tests -m card`."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

MAN = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["metrics"]
