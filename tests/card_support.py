"""What the port's card tests (tests/test_torch_*_card.py) share.

The card tests run on a machine with an NVIDIA card, which has no JAX:

    python -m pytest tests/test_torch_*_card.py --noconftest -m card \
        -p no:cacheprovider

`--noconftest` loads no conftest.py, so the fixtures live here and each
file imports those it uses. Every fixture that touches the card depends on
`card`, which skips without one before a scene is built or a kernel
compiled: on the CPU the card tests only skip.

The launch gates. A kernel's wrapper counts its launches in an eager call
and in a CUDA graph's capture, never in a replay, which runs the graph's
kernels without it (render/graphs.py). So a call of a graph entry point is
"eager" (each of the path's kernels launched max_path_length times through
its wrapper, no replay), "capture" (those launches, then one replay) or
"replay" (no launch through a wrapper, one replay), read from the wrappers'
counters and CapturedCall.replays (call_kind); the profiler counts a
replay's kernels by name (kernel_counts).
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig

SIZE, PATH = 512, 16
# the main path: the bathroom at 512x512, spp 1, path 16, regen
# (bench.py:291-297)
MAIN = RenderConfig(width=SIZE, height=SIZE, spp_per_pass=1,
                    max_path_length=PATH, use_bvh=True, path_regen=True)
# __graft_entry__.py:118: two renders that walk different structures
# differ only in exact t-ties: the share of pixels off, the mean relative
# error
FRAC_BAD_MAX = 5e-3
MEAN_REL_MAX = 1e-4
SHADE_KERNEL = "shade_bounce_kernel"          # csrc/shade.cu, by name
SHADE_DISNEY_KERNEL = "shade_disney_kernel"
KERNELS = ("closest_kernel", "occluded_kernel", "cluster_closest_kernel",
           "cluster_occluded_kernel", SHADE_KERNEL, SHADE_DISNEY_KERNEL)
# the entry points render/graphs.py captures
GRAPH_ENTRIES = ("render_pass_unrolled", "_render_pass_regen_jit",
                 "regen_value_and_grad")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bathroom(card):
    """The benchmark interior at 512x512 (129,252 triangles): (host scene,
    camera)."""
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom as make
    return make(SIZE, SIZE)


@pytest.fixture(scope="module")
def scene(bathroom, card):
    """The bathroom synced by default (two-level tree, no cluster tiles):
    (DeviceScene, view)."""
    host, cam = bathroom
    return host.sync(card), cam.get_view(card)


# ------------------------------------------------------------- the batches
def trace_batches(scene, view, cfg, dev):
    """The three ray batches {name: (o, d, tmax)}: the regen pool's
    primary rays, the bounce-1 rays of one shade_bounce and that bounce's
    NEE shadow rays. The trace card tests and chip_smoke.py's kernel table
    use these."""
    from lighthouse2_tpu_torch.core.geometry import BIG_T
    from lighthouse2_tpu_torch.core.rng import CAM_RNG_SEED
    from lighthouse2_tpu_torch.render import wavefront as wf

    paths, depth, _ = wf.make_regen_pool(view, cfg)
    n = depth.shape[0]
    t, prim, u, v, _ = wf._intersect(scene, paths["origin"], paths["dir"],
                                     paths["alive"], cfg)
    acc = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    paths1, _, _, shadow = wf.shade_bounce(scene, view, cfg, paths, acc,
                                           CAM_RNG_SEED, depth, t, prim, u, v)
    batches = dict(
        primary=(paths["origin"], paths["dir"],
                 torch.full((n,), BIG_T, device=dev)),
        bounce1=(paths1["origin"], paths1["dir"],
                 torch.where(paths1["alive"], BIG_T, 0.0)),
        shadow=(shadow["o"], shadow["d"], shadow["tmax"]))
    return {k: tuple(x.contiguous() for x in b) for k, b in batches.items()}


def cluster_batches(scene, view, cfg, dev):
    """trace_batches of a scene synced with its cluster tiles, each also
    as the cluster path's ray tile in the executor's order (primaries as
    they come, bounce rays sorted by "dir", shadow rays by
    "origin_octant"): {name: (o, d, tmax, ray tile, inverse permutation or
    None)}."""
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        ray_sort_perm, ray_tile)
    keys = dict(primary=None, bounce1="dir", shadow="origin_octant")
    out = {}
    for name, (o, d, tmax) in trace_batches(scene, view, cfg, dev).items():
        perm = inv = None
        if keys[name] is not None and scene.cbvh.n_clusters >= 16:
            perm, inv = ray_sort_perm(o, d, tmax, scene.cbvh, key=keys[name])
        out[name] = (o, d, tmax, ray_tile(o, d, tmax, perm), inv)
    return out


def disney_bathroom(dev, intersector="auto"):
    """The bathroom under the benchmark's Disney materials (configuration
    bathroom-512-disney) synced to `dev`: (scene, view, its config)."""
    from benchmark import harness
    with open(os.path.join(harness.ROOT, "benchmark", "configs",
                           "bathroom-512-disney.json")) as fh:
        conf = dict(json.load(fh), intersector=intersector)
    raw = harness.load("scenes", conf["scene"]).build(conf)
    scene, view, _ = harness.build_program_scene(raw, conf, dev)
    return scene, view, harness.render_config(conf)


# ------------------------------------------------------------ launch counts
def counts():
    """The BVH4 kernels' launches through their wrappers so far."""
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    return dict(trace_closest=trace_closest.launches,
                trace_occluded=trace_occluded.launches)


def all_counts():
    """The BVH4 and the cluster kernels' launches so far."""
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        cluster_closest, cluster_occluded)
    return dict(counts(), cluster_closest=cluster_closest.launches,
                cluster_occluded=cluster_occluded.launches)


def deltas(before, after):
    return {k: after[k] - before[k] for k in after}


def captured(name):
    """The CapturedCall (render/graphs.py) of a graph entry point."""
    from lighthouse2_tpu_torch.diff import render as diff_render
    from lighthouse2_tpu_torch.render import wavefront as wf
    return dict(render_pass_unrolled=wf._unrolled_graph,
                _render_pass_regen_jit=wf._regen_graph,
                regen_value_and_grad=diff_render._step_graph)[name]


def clear_graphs():
    """Every graph entry point without a graph: its next call is eager."""
    for name in GRAPH_ENTRIES:
        captured(name).clear()


def tally():
    """Every kernel's launches and every entry point's graph replays so
    far."""
    from lighthouse2_tpu_torch.render.kernels.shade import shade_kernel
    return dict(all_counts(), shade_kernel=shade_kernel.launches,
                shade_disney=shade_kernel.disney_launches,
                replays=sum(captured(n).replays for n in GRAPH_ENTRIES))


def tallied(fn, per_call):
    """fn(), its tally deltas appended to `per_call`; fn's result."""
    before = tally()
    out = fn()
    per_call.append(deltas(before, tally()))
    return out


def kernel_syms(cfg, scene, grad=False):
    """(wrapper counts, profiler kernel names) of the config's kernels: its
    intersector's trace kernels, and the shade kernel where the config and
    scene take it and no gradient is needed (render/kernels/shade.py
    config_takes_kernel; `grad`: a call that needs gradients, which shades
    composed)."""
    from lighthouse2_tpu_torch.render.kernels.shade import (
        config_takes_kernel)
    if cfg.intersector == "cluster":
        names = ("cluster_closest", "cluster_occluded")
        syms = ("cluster_closest_kernel", "cluster_occluded_kernel")
    else:
        names = ("trace_closest", "trace_occluded")
        syms = ("closest_kernel", "occluded_kernel")
    if not grad and config_takes_kernel(cfg, scene):
        shade = (("shade_disney", SHADE_DISNEY_KERNEL) if cfg.bsdf == "disney"
                 else ("shade_kernel", SHADE_KERNEL))
        names, syms = names + shade[:1], syms + shade[1:]
    return names, syms


def call_kind(c, cfg, scene, grad=False):
    """What a call of a graph entry point was, from its tally deltas `c`:
    "eager", "capture", "replay" or "unexpected" (module docstring)."""
    names, _ = kernel_syms(cfg, scene, grad)
    launched = {k: c[k] for k in c if k != "replays"}
    run = {k: (cfg.max_path_length if k in names else 0) for k in launched}
    if launched == run and c["replays"] in (0, 1):
        return ("eager", "capture")[c["replays"]]
    if not any(launched.values()) and c["replays"] == 1:
        return "replay"
    return "unexpected"


def kernel_counts(fn, dev):
    """fn() once under the profiler: the launches of each of KERNELS by
    name (no device time is read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    out = dict.fromkeys(KERNELS, 0)
    for e in prof.key_averages():
        # the function name of a demangled signature, so that
        # closest_kernel does not also match cluster_closest_kernel
        head = e.key.split("(")[0].split()
        name = head[-1] if head else e.key
        if e.device_type == DeviceType.CUDA and name in out:
            out[name] += e.count
    return out


def profiled_replay(fn, dev, per_call):
    """kernel_counts of one call of fn (a replay), its tally deltas
    appended to `per_call`."""
    return tallied(lambda: kernel_counts(fn, dev), per_call)


def replay_gates(cfg, scene, per_call, kinds, prof, grad=False):
    """The launch gates of the calls of a graph entry point: their kinds
    (call_kind) are `kinds`, and `prof`, the kernel counts of one of those
    replays, holds max_path_length of each of the path's kernels
    (kernel_syms) and none of the others."""
    _, syms = kernel_syms(cfg, scene, grad)
    got = [call_kind(c, cfg, scene, grad) for c in per_call]
    want = {k: (cfg.max_path_length if k in syms else 0) for k in prof}
    assert got == list(kinds), (got, per_call)
    assert prof == want, prof


# --------------------------------------------------------------- the rest
def assert_agrees(got, want):
    """Two accumulators agree by __graft_entry__.py:108-119's measure: the
    share of pixels off by more than 1e-3 of the largest value below
    FRAC_BAD_MAX, and the mean absolute difference over that value below
    MEAN_REL_MAX."""
    scale = max(float(np.abs(want).max()), 1e-6)
    diff = np.abs(got - want)
    frac_bad = float((diff.max(-1) > 1e-3 * scale).mean())
    mean_rel = float(diff.mean() / scale)
    assert frac_bad < FRAC_BAD_MAX and mean_rel < MEAN_REL_MAX, (frac_bad,
                                                                 mean_rel)


def headline_params(scene, size, dev):
    """bench.py:114-118: colours, light radiance, zero vertex offsets; a
    zero target image."""
    params = dict(color=scene.materials.color,
                  light=scene.lights.tri_radiance,
                  offset=torch.zeros((scene.tris.count, 3, 3), device=dev))
    return params, torch.zeros((size * size, 3), device=dev)


def assert_grads_finite_nonzero(grads):
    bad = {k: (bool(torch.isfinite(g).all()), int((g != 0).sum()))
           for k, g in grads.items()
           if not (torch.isfinite(g).all() and (g != 0).any())}
    assert not bad, f"gradients not finite or all zero: {bad}"
