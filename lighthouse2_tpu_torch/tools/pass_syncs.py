"""Wall, device time and host synchronisations of the regen pass, for
comparing checkouts on one card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 lighthouse2_tpu_torch/tools/pass_syncs.py [ROOT ...]

Each ROOT is a checkout (default: this one; an earlier commit unpacked with
`git archive <commit> | tar -x -C DIR`). For each, in the order given, a
process of its own imports that checkout's lighthouse2_tpu_torch and
renders the bathroom 512x512, spp 1, path 16, Lambert, regen, as
chip_smoke.py's main path does (render_pass_regen where the checkout has
it, else render_pass, which ran the regen executor under path_regen
before the executors had names of their own): 2 warm-up passes, PASSES
timed passes each closed by a synchronize, the host synchronisations of
one more pass (torch.cuda.set_sync_debug_mode("warn")) and the device ms
of one more under torch.profiler (device activity only). In a checkout
that captures the regen pass as a CUDA graph (render/graphs.py), the
second warm-up pass captures it and every later pass replays the graph.
Give the roots in turns (parent, change, change, parent) to compare two
commits. Prints one JSON line per root, with the card's name and power
limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

PASSES = 5


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render import wavefront as wf
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom

    dev = torch.device("cuda", 0)
    host, cam = bathroom(512, 512)
    scene, view = host.sync(dev), cam.get_view(dev)
    cfg = RenderConfig(width=512, height=512, spp_per_pass=1,
                       max_path_length=16, path_regen=True)
    run = getattr(wf, "render_pass_regen", wf.render_pass)
    state = wf.AccumState.make(cfg, dev)

    def one():
        nonlocal state
        t0 = time.perf_counter()
        state, _ = run(scene, view, state, cfg)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    for _ in range(2):
        one()
    wall = [one() for _ in range(PASSES)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall = one()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    return dict(root=root, entry=run.__name__, wall_ms=wall,
                host_syncs=syncs, device_ms=device_us / 1e3,
                profiled_wall_ms=prof_wall,
                device_busy_share=device_us / 1e3 / prof_wall)


def main(roots) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root], capture_output=True,
                             text=True, check=True, timeout=600).stdout
        row = dict(json.loads(out.strip().splitlines()[-1]), card=card)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or ["."]))
