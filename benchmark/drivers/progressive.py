"""The progressive-render driver: closed-loop regen passes through
render_pass_auto at the configuration's fixed camera, accumulating, with at
most `in_flight` passes queued on the device and nothing read back until
the window closes. When the window's time is up nothing more is sent; the
window ends once all that was sent has run, and all of it counts.

Its mix parameters (benchmark/traffic/<mix>.json): in_flight,
trace_passes (the passes a traced run profiles after the window) and
check_lanes (the lanes drawn from the seed that are held against the
reference).

Its reference is the plain regen pass of benchmark/reference/ (the Lambert
BSDF, path regeneration and blue noise); a configuration outside that
takes a driver of its own.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import bluenoise
from benchmark.reference import pathtracer as pt
from benchmark.reference.scene import RefScene

# a lane agrees when every accumulated channel (RGB and primary depth)
# lies within ATOL + RTOL |reference| and its completed samples and next
# sample number are equal. float32 rounding moves a pass's values by ~1e-6
# relative, the accumulator's subtraction of two running sums (the last
# pass's delta after some hundred passes) by ~1e-5; a path that takes
# another branch (a light pick, a roulette draw, an edge hit) moves them by
# far more than either bound.
RTOL = 1e-3
ATOL = 1e-4


def inputs(ctx, seed):
    """The run's inputs from its seed: the render's camera seed, and the
    lanes held against the reference with their pixels."""
    conf = ctx["config"]
    total = conf["width"] * conf["height"] * conf["spp_per_pass"]
    rng = np.random.default_rng(seed)
    lanes = np.sort(rng.choice(total, size=min(ctx["traffic"]["check_lanes"],
                                               total), replace=False))
    ctx.update(cam_seed=harness.mix32(seed), lanes=lanes,
               pixels=pt.lane_pixel(lanes.astype(np.int64), conf["width"],
                                    conf["height"]))


def _rays(stats):
    return stats["total_extension"].long() + stats["total_shadow"].long()


def _lane_view(state, lanes, pixels):
    """What a pass's state says of the chosen lanes: accumulator and
    completed samples at their pixels, and each lane's next sample."""
    return dict(acc=state.accumulator[pixels].float(),
                count=state.pixel_count[pixels].float(),
                sample_k=state.pool[2][lanes].clone())


def _pool_of(state, lanes):
    """The chosen lanes' pool state, in the reference's names."""
    paths, depth, sample_k = state.pool
    names = dict(prev_spec="prev_specular")
    keys = ("origin", "dir", "throughput", "bsdf_pdf", "last_n", "prev_spec",
            "n_diffuse", "alive", "pixel", "sample")
    pool = {k: paths[names.get(k, k)][lanes].clone() for k in keys}
    pool["n_diffuse"] = pool["n_diffuse"].long()
    pool["depth"] = depth[lanes].clone()
    pool["sample_k"] = sample_k[lanes].clone()
    return pool


def drive(ctx) -> dict:
    """Warm-up (the eager call, the capture, one replay), the window, and
    with ctx["trace"] `trace_passes` more passes under torch.profiler."""
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, render_pass_auto)

    conf, mix, dev = ctx["config"], ctx["traffic"], ctx["device"]
    rc = harness.render_config(conf)
    state = dataclasses.replace(
        AccumState.make(rc, dev),
        cam_seed=torch.full((), ctx["cam_seed"], dtype=torch.int64, device=dev))
    lanes = torch.as_tensor(ctx["lanes"], device=dev)
    pixels = torch.as_tensor(ctx["pixels"], device=dev)
    scene, view = ctx["scene"], ctx["view"]

    def step(s):
        return render_pass_auto(scene, view, s, rc)

    t0 = time.perf_counter()
    state, stats = step(state)                   # eager
    first = dict(_lane_view(state, lanes, pixels),
                 cam_seed=int(state.cam_seed.item()),
                 rays=int(_rays(stats).item()),
                 extension=int(stats["total_extension"].item()))
    for _ in range(2):                           # capture, then a replay
        state, _ = step(state)
    harness.sync(dev)
    ctx["spans"]["warmup_s"] = time.perf_counter() - t0
    passes = 3

    rays = torch.zeros((), dtype=torch.int64, device=dev)
    queue = collections.deque()
    marks = []
    n, host_s = 0, 0.0
    t0 = time.perf_counter()
    ctx["spans"]["setup_s"] = t0 - ctx["t_start"]
    while True:
        prev = state
        t1 = time.perf_counter()
        state, stats = step(state)
        host_s += time.perf_counter() - t1
        rays += _rays(stats)
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            queue.append(ev)
            marks.append(ev)
            if len(queue) > mix["in_flight"]:
                queue.popleft().synchronize()
        n += 1
        if time.perf_counter() - t0 >= ctx["seconds"]:
            break
    harness.sync(dev)
    seconds = time.perf_counter() - t0
    passes += n
    pass_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    window = dict(seconds=seconds, passes=n, rays=int(rays.item()),
                  host_ms=1e3 * host_s / n, pass_ms=pass_ms)
    _report(window)

    trace = None
    if ctx["trace"]:
        from torch.profiler import ProfilerActivity, profile, record_function
        from benchmark import profiling
        k = mix["trace_passes"]
        live_c = torch.zeros((), dtype=torch.int64, device=dev)
        live_s = torch.zeros((), dtype=torch.int64, device=dev)
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with record_function(profiling.WINDOW):
                for _ in range(k):
                    prev = state
                    state, stats = step(state)
                    live_c += stats["total_extension"].long()
                    live_s += stats["total_shadow"].long()
                harness.sync(dev)
        passes += k
        devops, hostops, span = profiling.timeline(prof.events())
        trace = dict(dev=devops, host=hostops,
                     span=profiling.steady_span(devops, span), passes=k,
                     live_closest=int(live_c.item()),
                     live_shadow=int(live_s.item()),
                     lanes=rc.n_paths, launches=k * rc.max_path_length)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    checked = dict(
        first=first, last=dict(
            acc=state.accumulator[pixels].float() - prev.accumulator[pixels].float(),
            count=state.pixel_count[pixels].float() - prev.pixel_count[pixels].float(),
            sample_k=state.pool[2][lanes].clone(),
            cam_seed=int(state.cam_seed.item()),
            rays=int(_rays(stats).item()),
            extension=int(stats["total_extension"].item())),
        last_pool=_pool_of(prev, lanes), last_cam_seed=int(prev.cam_seed.item()),
        lanes_in_pool=rc.n_paths,
        passes_missing=abs(int(state.sample_count.item())
                           - passes * rc.spp_per_pass),
        nonfinite=int((~torch.isfinite(state.accumulator)).sum().item()))
    return dict(kind="progressive", window=window, trace=trace,
                peak_bytes=peak, attempted=passes, checked=checked)


def _report(w):
    """The window's pace on standard error: the host's ms a pass inside the
    entry point, and the device's ms from one pass's end to the next over
    the window's first 15 seconds and the rest, and the share of passes
    over 1.08 times the fastest (a replayed pass runs in one of two device
    states, ~105 or ~122.5 ms on an H100; PERF.md)."""
    ms = w["pass_ms"]
    if not ms:
        return
    cut, t = 0, 0.0
    while cut < len(ms) and t < 15e3:
        t += ms[cut]
        cut += 1
    parts = [ms[:cut], ms[cut:]]
    med = " / ".join(f"{statistics.median(p):.3f}" if p else "-"
                     for p in parts)
    slow = sum(m > 1.08 * min(ms) for m in ms) / len(ms)
    print(f"window host_ms {w['host_ms']:.3f} pass_ms median (first 15 s / "
          f"rest) {med} min {min(ms):.3f} max {max(ms):.3f} over 1.08 min "
          f"{slow:.3f}", file=sys.stderr)


# ------------------------------------------------------------ correctness
class Reference:
    """The plain reference's regen pass of a configuration, in `dtype`."""

    def __init__(self, raw, conf, device, dtype=torch.float32):
        if conf["bsdf"] != "lambert" or not conf["path_regen"] \
                or not conf["blue_noise"]:
            raise ValueError("the reference renders the regen pass with the "
                             "Lambert BSDF and blue noise")
        self.dtype, self.device = dtype, device
        self.sc = RefScene(raw, conf["width"], conf["height"], device, dtype)
        self.st = pt.Settings(conf["width"], conf["height"],
                              spp=conf["spp_per_pass"],
                              max_path=conf["max_path_length"])
        self.mask = torch.as_tensor(bluenoise.mask(), device=device)

    def _run(self, lanes, pool, cam_seed):
        acc, count, pool, cs, rays = pt.regen_pass(self.sc, self.st, pool,
                                                   lanes, cam_seed, self.mask)
        return dict(acc=acc, count=count, sample_k=pool["sample_k"],
                    cam_seed=cs, rays_a_lane=float(rays.double().mean()))

    @torch.no_grad()
    def first_pass(self, lanes, cam_seed):
        """The first pass of `lanes` from a fresh pool."""
        return self._run(lanes, pt.fresh_pool(self.sc, self.st, lanes,
                                              self.mask), cam_seed)

    @torch.no_grad()
    def pass_from(self, lanes, pool, cam_seed):
        """One pass of `lanes` from a given pool state (cast to dtype)."""
        p = {k: (v.to(self.dtype) if v.is_floating_point() else v)
             for k, v in pool.items()}
        return self._run(lanes, p, cam_seed)


def lanes_off(got: dict, ref: dict) -> float:
    """The share of lanes on which `got` and `ref` disagree."""
    acc_g, acc_r = got["acc"].float(), ref["acc"].float()
    close = (torch.abs(acc_g - acc_r) <= ATOL + RTOL * torch.abs(acc_r)).all(1)
    same = ((got["count"].float() == ref["count"].float())
            & (got["sample_k"].long() == ref["sample_k"].long()))
    return float((~(close & same)).float().mean().item())


def rays_gap(rays_a_lane: float, ref: dict) -> float:
    """The gap between a pass's rays a lane (the program's stats over the
    whole pool) and the reference's mean over the drawn lanes, relative to
    the latter: the drawn lanes' sampling error, unless the stats count
    other rays than the pass traced."""
    return abs(rays_a_lane - ref["rays_a_lane"]) / ref["rays_a_lane"]


def check(ctx, out, dtype=None) -> dict:
    """The numbers compared for a progressive run: the share of the drawn
    lanes on which the first pass (from a fresh pool) and the last timed
    pass (from the program's pool before it) disagree with the reference;
    passes whose camera seed did not advance as the reference's; the gap of
    those passes' ray counts (fwd_mrays's numerator); passes lost;
    non-finite accumulator values. With `dtype` the reference in that
    precision stands in the program's place (the control)."""
    conf, dev = ctx["config"], ctx["device"]
    lanes = torch.as_tensor(ctx["lanes"], device=dev)
    got = out["checked"]
    ref = Reference(ctx["raw"], conf, dev)
    first_ref = ref.first_pass(lanes, ctx["cam_seed"])
    last_ref = ref.pass_from(lanes, got["last_pool"], got["last_cam_seed"])
    n = got["lanes_in_pool"]
    if dtype is None:
        first, last = got["first"], got["last"]
        first_rays, last_rays = first["rays"] / n, last["rays"] / n
    else:
        low = Reference(ctx["raw"], conf, dev, dtype=dtype)
        first = low.first_pass(lanes, ctx["cam_seed"])
        last = low.pass_from(lanes, got["last_pool"], got["last_cam_seed"])
        first_rays, last_rays = first["rays_a_lane"], last["rays_a_lane"]
    seed_off = sum(int((g["cam_seed"] & harness.M32)
                       != (r["cam_seed"] & harness.M32))
                   for g, r in ((first, first_ref), (last, last_ref)))
    return dict(first_pass_lanes_off=lanes_off(first, first_ref),
                last_pass_lanes_off=lanes_off(last, last_ref),
                cam_seed_off=seed_off,
                rays_gap=max(rays_gap(first_rays, first_ref),
                             rays_gap(last_rays, last_ref)),
                passes_missing=got["passes_missing"],
                nonfinite=got["nonfinite"])
