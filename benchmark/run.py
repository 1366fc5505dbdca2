"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device (and with --trace 1 busy_s, window_s and a
breakdown), and last the checks: each number compared with its limit, also
printed as the last lines of standard error. The run needs an NVIDIA card;
without one, or with fewer cards than the cell asks for, it exits with 2
and prints no result. It exits with 3 and prints no result if JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout, in place of this script's directory (whose module
# names are the benchmark's own)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    spec = harness.cell_spec(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec["cell"]["chips"]:
        print("no CUDA card, or fewer than the cell asks for: no result",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    ctx, out = harness.measure(spec, args.seed, args.seconds, bool(args.trace),
                               dev, T_START)
    torch.cuda.empty_cache()
    checks = ctx["driver"].check(ctx, out)
    res = harness.result(spec, ctx, out, checks, dev)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
