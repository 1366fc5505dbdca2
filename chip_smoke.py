#!/usr/bin/env python3
"""The port's check on one NVIDIA card: every card test, then the kernel
table.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA card and the CUDA
toolkit. It sets the kernel wrappers' launch counters to 0 and runs the
card tests, tests/test_torch_*_card.py with `-m card`, in this process:
each kernel against its plain version at the main path's shapes, each
path's launch gates, the card against the CPU (tests/card_support.py says
what they share). It exits non-zero when one fails. Then it times each
hand-written kernel alone, on the bathroom at 512x512, path 16 (the main
path), with CUDA events over KERNEL_ITERS launches of one set of arguments
after one warm-up launch, beside its plain version's time and its bound
(benchmark/roofline.py least_seconds: bytes over HBM bandwidth or
operations over the FP32 peak, whichever is longer):

- the trace kernels, csrc/trace.cu closest_kernel and occluded_kernel on
  the BVH4 and csrc/cluster_trace.cu cluster_closest_kernel and
  cluster_occluded_kernel on the cluster tiles, on card_support's three
  batches of 262,144 rays (trace_batches; the cluster kernels take them as
  the cluster path's ray tile in the executor's order, cluster_batches).
  The bound is the same work for all four: the BVH2 walk's counted
  operations (bvh/traverse.py stats), and the rays and the BVH2 arrays
  read once and the kernel's outputs written once. The plain versions are
  bvh/wide.py's walk and render/kernels/cluster.py's lockstep walk (timed
  once: it takes seconds a batch);
- the shade kernels, csrc/shade.cu shade_bounce_kernel (Lambert) and
  shade_disney_kernel (the benchmark's Disney materials), at the first
  bounce of a fresh regen pool, on the triangle gathers ("auto") and on the
  cluster payload, launched through the library with the wrapper's
  prepared arguments, so that its host time is not counted. The bound is
  the bytes of _shade_bytes; the plain version is the composed shade code,
  eager.

It prints the card's name and power limit, one JSON line {"kernels": rows}
(each kernel's ms, plain_ms, bound_ms, bound_by and share_of_bound by
batch, and `launches`: its launches through its wrapper in each card test
that launched it, read from that test's own run), and last the result line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import ctypes
import dataclasses
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import card_support  # noqa: E402

from benchmark.roofline import (  # noqa: E402
    BOX_PAIR_OPS, TRI_TEST_OPS, least_seconds)

KERNEL_ITERS = 20          # timed launches of a kernel on one batch
PLAIN_ITERS = 3            # timed calls of a plain version on one batch
# the triangle rows the shade kernel gathers (scene.tris, by the hit prim)
# and the payload rows it reads (csrc/shade.cu shading_data): of the 38
# geometry rows all but v0, prim, mat and valid; of the 28 material rows
# colour, absorption, roughness, transmission, eta, flags and the texture
# ids. The Disney kernel reads every material row of the payload; on the
# gathers its twelve more fields come from the material table, which
# neither bound counts
SHADE_TRI_ROWS = ("n0", "n1", "n2", "face_n", "uv0", "uv1", "uv2", "alpha",
                  "area", "lod", "tangent", "bitangent", "mat", "ltri")
SHADE_PAY_ROWS = 38 - 6 + 15
SHADE_PAY_ROWS_DISNEY = 38 - 6 + 28
# each kernel's source and its launch counter's key in card_support.tally
KERNELS = dict(
    closest_kernel=("csrc/trace.cu", "trace_closest"),
    occluded_kernel=("csrc/trace.cu", "trace_occluded"),
    cluster_closest_kernel=("csrc/cluster_trace.cu", "cluster_closest"),
    cluster_occluded_kernel=("csrc/cluster_trace.cu", "cluster_occluded"),
    shade_bounce_kernel=("csrc/shade.cu", "shade_kernel"),
    shade_disney_kernel=("csrc/shade.cu", "shade_disney"))


class _Launches:
    """pytest plugin: each test's launches of each kernel through its
    wrapper, the counters' move over the test's setup, call and teardown
    (as if set to 0 at its start)."""

    def __init__(self):
        self.by_test = {}

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_protocol(self, item, nextitem):
        before = card_support.tally()
        yield
        self.by_test[item.nodeid] = card_support.deltas(
            before, card_support.tally())


def _zero_counters():
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        cluster_closest, cluster_occluded)
    from lighthouse2_tpu_torch.render.kernels.shade import shade_kernel
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    for fn in (trace_closest, trace_occluded, cluster_closest,
               cluster_occluded, shade_kernel):
        fn.launches = 0
    shade_kernel.disney_launches = 0


def _time_ms(fn, iters):
    """Mean device milliseconds a call of fn over `iters` calls after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _row(kernel, plain, plain_iters, n_bytes, n_ops):
    ms = _time_ms(kernel, KERNEL_ITERS)
    bound_s, by = least_seconds(n_bytes, n_ops)
    return dict(ms=ms, plain_ms=_time_ms(plain, plain_iters),
                bound_ms=bound_s * 1e3, bound_by=by,
                share_of_bound=bound_s * 1e3 / ms)


def trace_rows(scene, cscene, view, cfg, dev):
    """{kernel: {batch: numbers}} of the four trace kernels; `cscene` is
    the scene synced with its cluster tiles."""
    from lighthouse2_tpu_torch.bvh.traverse import bvh_intersect, bvh_occluded
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        cluster_closest, cluster_closest_plain, cluster_occluded,
        cluster_occluded_plain)
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)

    bvh = scene.bvh
    # the bound reads the BVH2 arrays once, whatever layout a kernel walks
    scene_bytes = sum(x.numel() * x.element_size() for x in (
        bvh.nbox, bvh.left, bvh.right, bvh.count, bvh.prim, bvh.tri9))
    out = {k: {} for k in ("closest_kernel", "cluster_closest_kernel",
                           "occluded_kernel", "cluster_occluded_kernel")}
    ops = {}
    for name, (o, d, tmax) in card_support.trace_batches(
            scene, view, cfg, dev).items():
        n = o.shape[0]
        bst = bvh_intersect(o, d, bvh, t_max=tmax, stats=True)[4]
        bost = bvh_occluded(o, d, tmax, bvh, stats=True)[1]
        ops[name] = [int(s[1].sum()) * BOX_PAIR_OPS
                     + int(s[2].sum()) * TRI_TEST_OPS for s in (bst, bost)]
        rays = n * (12 + 12 + 4) + scene_bytes
        out["closest_kernel"][name] = _row(
            lambda: trace_closest(o, d, tmax, bvh),
            lambda: wide_intersect(o, d, bvh, t_max=tmax), PLAIN_ITERS,
            rays + n * 16, ops[name][0])
        out["occluded_kernel"][name] = _row(
            lambda: trace_occluded(o, d, tmax, bvh),
            lambda: wide_occluded(o, d, tmax, bvh), PLAIN_ITERS, rays + n,
            ops[name][1])
    cb = cscene.cbvh
    for name, (o, _, _, x, _) in card_support.cluster_batches(
            cscene, view, cfg, dev).items():
        n = o.shape[0]
        rays = n * (12 + 12 + 4) + scene_bytes
        out["cluster_closest_kernel"][name] = _row(
            lambda: cluster_closest(x, cb),
            lambda: cluster_closest_plain(x, cb), 1, rays + n * 8,
            ops[name][0])
        out["cluster_occluded_kernel"][name] = _row(
            lambda: cluster_occluded(x, cb),
            lambda: cluster_occluded_plain(x, cb), 1, rays + n, ops[name][1])
    return out


def _shade_bytes(args, out, payload):
    """The bytes the shade kernel must move at the least for the lanes of
    `args` (shade_kernel's arguments; `out` the outputs _args allocated):
    each lane's state, hit and depth in, its new state and shadow ray out,
    and its triangle's rows (gathers) or the payload rows it reads. Not
    counted: texels, lights, the material table (a few KB, gathered by the
    triangle's material id)."""
    scene, _, cfg, paths, acc, _, depth, t, prim, u, v = args
    pay_rows = (SHADE_PAY_ROWS_DISNEY if cfg.bsdf == "disney"
                else SHADE_PAY_ROWS)
    lane = lambda x: x.element_size() * (x[0].numel() if x.dim() > 1 else 1)
    lane_in = sum(lane(paths[k]) for k in (
        "origin", "dir", "throughput", "bsdf_pdf", "last_n", "prev_specular",
        "n_diffuse", "alive", "pixel", "sample", "path_idx"))
    lane_in += sum(lane(x) for x in (acc, t, u, v, depth)) + 4  # prim, int32
    lane_out = sum(lane(x) for x in out.values() if x.dim())
    rows = (pay_rows * payload.element_size() if payload is not None
            else sum(lane(getattr(scene.tris, k)) for k in SHADE_TRI_ROWS))
    return cfg.n_paths * (lane_in + lane_out + rows)


def shade_row(scene, view, cfg, dev):
    """The numbers of cfg.bsdf's shade kernel on cfg's intersector (the
    gathers on "auto", the payload on "cluster") at the first bounce of a
    fresh regen pool."""
    from lighthouse2_tpu_torch.render import wavefront as wf
    from lighthouse2_tpu_torch.render.kernels import shade as shade_k

    with torch.no_grad():
        state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, dev),
                                      cfg)
        paths, depth, _ = wf.regenerate(view, cfg, *state.pool)
        *hit, payload = wf._intersect(scene, paths["origin"], paths["dir"],
                                      paths["alive"], cfg,
                                      wf.prepare_cluster_pay(scene, cfg))
        acc = torch.zeros((cfg.n_paths, 4), device=dev)
        args = (scene, view, cfg, paths, acc, state.cam_seed, depth, *hit)
        # `keep` holds the buffers the launch arguments point into
        launch_args, out, keep = shade_k._args(*args, payload)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = shade_k._load()
        launch = (lib.lh2_shade_disney if cfg.bsdf == "disney"
                  else lib.lh2_shade_bounce)
        ms = _time_ms(lambda: shade_k._check_rc(launch(
            ctypes.byref(launch_args), stream), "shade_kernel"), KERNEL_ITERS)
        plain = _time_ms(lambda: wf._shade_composed(*args, payload=payload),
                         PLAIN_ITERS)
        bound_s, by = least_seconds(_shade_bytes(args, out, payload), 0)
    return dict(ms=ms, plain_ms=plain, bound_ms=bound_s * 1e3, bound_by=by,
                share_of_bound=bound_s * 1e3 / ms)


def kernel_rows(dev):
    """{kernel: {batch or rows: numbers}} of the six hand-written kernels."""
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom

    cfg = card_support.MAIN
    host, cam = bathroom(cfg.width, cfg.height)
    view = cam.get_view(dev)
    scene, cscene = host.sync(dev), host.sync(dev, clusters=True)
    out = trace_rows(scene, cscene, view, cfg, dev)
    out.update(shade_bounce_kernel={}, shade_disney_kernel={})
    for rows, sc, inter in (("gathers", scene, "auto"),
                            ("payload", cscene, "cluster")):
        out["shade_bounce_kernel"][rows] = shade_row(
            sc, view, dataclasses.replace(cfg, intersector=inter), dev)
        d_scene, d_view, d_cfg = card_support.disney_bathroom(dev, inter)
        out["shade_disney_kernel"][rows] = shade_row(d_scene, d_view, d_cfg,
                                                     dev)
        del d_scene
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    _zero_counters()
    launches = _Launches()
    rc = pytest.main(
        sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*_card.py")))
        + ["--noconftest", "-m", "card", "-p", "no:cacheprovider", "-q",
           "--rootdir", ROOT], plugins=[launches])
    if rc != 0:
        return int(rc)
    rows = []
    for kernel, numbers in kernel_rows(dev).items():
        source, key = KERNELS[kernel]
        rows.append(dict(
            name=kernel, source=f"lighthouse2_tpu_torch/{source}",
            launches={t: c[key] for t, c in launches.by_test.items()
                      if c[key]},
            **{k: {b: r[k] for b, r in numbers.items()}
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "share_of_bound")}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
