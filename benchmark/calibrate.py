"""Readings that the correctness limits are set from, in one process.

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 2 [--control N]

For each seed: a short window of the cell's traffic through the program
(after one set-up shared by all seeds) and the numbers the run compares;
for the first N seeds of --control, the same numbers with the reference
computed in bfloat16 put in the program's place (the control, which has to
come out not correct), and with a planted fault: the ray counts of the
checked passes without their shadow rays (`stats_without_shadow`, what a
counter that changed its meaning would read). One JSON line per seed on
standard output. The benchmark's own runs never run this. Needs an NVIDIA
card.
"""
import argparse
import copy
import json
import os
import sys
import time

# the checkout, in place of this script's directory (whose module
# names are the benchmark's own)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def without_shadow(out):
    """The driver's output with each checked pass's rays counted without
    their shadow rays."""
    out = dict(out, checked=copy.copy(out["checked"]))
    for k in ("first", "last"):
        out["checked"][k] = dict(out["checked"][k],
                                 rays=out["checked"][k]["extension"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.cell_spec(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctx = harness.prepare(spec, seeds[0], args.seconds, False, dev,
                          time.perf_counter())
    drv = ctx["driver"]
    for i, seed in enumerate(seeds):
        drv.inputs(ctx, seed)
        ctx["t_start"] = time.perf_counter()
        out = drv.drive(ctx)
        t0 = time.perf_counter()
        line = dict(seed=seed, window=out["window"],
                    program=drv.check(ctx, out))
        line["check_s"] = time.perf_counter() - t0
        if i < args.control:
            t0 = time.perf_counter()
            line["control"] = drv.check(ctx, out, dtype=torch.bfloat16)
            line["control_s"] = time.perf_counter() - t0
            line["stats_without_shadow"] = drv.check(ctx, without_shadow(out))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
