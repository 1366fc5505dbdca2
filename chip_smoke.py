#!/usr/bin/env python3
"""Smoke run of lighthouse2_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (nvcc on PATH or under /usr/local/cuda):

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:
  1. the card, torch / CUDA / nvcc versions; build csrc/trace.cu with nvcc
     for sm_90a and print its -Xptxas -v report;
  2. [scene] the full bathroom (129,252 triangles, 21 instances of 20
     meshes) synced three ways: single-level over all world triangles with
     the numpy builder (the port's tree before the two-level default)
     and with the native one,
     then the default HostScene.sync, the two-level tree (a TLAS over
     native per-mesh BLASes); for each, BVH2 and BVH4 nodes, depths and MB,
     and the host seconds by step (pose, BLAS builds, compose, tables,
     textures, BVH4 pack, upload). Every later phase runs on the default
     tree. [kernels] both trace kernels on the default tree for the 512x512
     primary rays, the bounce-1 rays of one shade_bounce and that bounce's
     NEE shadow batch, against two references: their plain version, the
     BVH4 walk of bvh/wide.py (t, prim, u, v, occlusion and the per-ray
     counts equal on every lane), and the BVH2 walk of bvh/traverse.py (prim
     and occlusion on >= 99.99% of lanes); CUDA-event times of kernel and
     plain version, Grays/s, and the bound computed from the BVH2 walk's
     counts; then both kernels' times on the numpy single-level tree for
     the same three batches;
  3. the main path: bathroom 512x512, path 16, path regeneration, through
     render_pass — 1 warm-up and 3 timed passes; Mrays/s (extension +
     shadow rays), per-bounce ray counts, peak memory, the image; each
     kernel must launch exactly 16 times a pass; then one profiled pass;
  4. a 64x64 Cornell box rendered on the card and on the CPU (plain
     versions), compared per pixel;
  5. [train] the fwd+bwd headline (bench.py:291-297): bathroom 512x512,
     path 16, regen, remat, through diff.render.regen_value_and_grad with
     material colours [12,3], area-light radiance [LT,3] and per-vertex
     offsets [129252,3,3] (zeros) as parameters and a zero target;
     1 warm-up and 2 timed steps; fwd+bwd Mrays/s (rays of one forward
     stats pass, bench.py:129-134), ms per step, peak memory, kernel
     launches per step (each kernel must launch 16 times a step: both
     traces stay outside the recomputed region), each gradient group's
     norm (all finite, each group nonzero); one step without remat for its
     peak memory; one profiled step (device ms, busy share, top device
     ops); then a 64x64 Cornell box, path 4, regen, fwd+bwd on the card and
     on the CPU, gradients compared per group by relative L2 error
     (GRAD_RTOL, the bounds of tests/test_torch_grad.py);
  6. [disney] the bathroom 512x512 (129,252 triangles) with the golden
     16x32 gradient sky, bsdf="disney", sky_ibl=True, path 16, regen,
     created and driven through RenderAPI.create("wavefront", ...,
     device=card): 1 warm-up and 3 timed api.render() calls; Mrays/s, ms
     per pass (core.stats["render_time"]), peak memory, the launches of
     each kernel per pass (must be 16 and 16), the image (finite, mean > 0)
     and get_ldr_image (finite, in [0, 1]); the Lambert scene of phase 3
     driven the same way through RenderAPI, so both ms per pass have one
     definition; one profiled pass printed beside the Lambert pass of
     phase 3; then one warm-up and one timed fwd+bwd step of
     regen_value_and_grad with remat and the parameter groups of [train]
     (each gradient group finite and nonzero), and the 64x64 Cornell
     fwd+bwd of phase 5 with test_sky, Disney and IBL on the card and on
     the CPU (GRAD_RTOL);
  7. [golden] utils/golden.py render_golden on the card and on the CPU:
     >= 99% of pixels within rtol 1e-3 / atol 1e-4 of each other, and both
     means and population stds within 1e-3 of ANCHOR_MEAN / ANCHOR_STD;
  8. [anim] tools/anim_gltf.py writes an animated glTF into a temporary
     directory under build/ (a tube of 65,536 triangles skinned to three
     joints with a LINEAR and a CUBICSPLINE rotation channel, a sphere of
     16,384 triangles with a morph target and a weights channel, a rigid
     box with a translation channel and a PNG texture); HostScene.load_gltf
     places it in the bathroom (211,184 triangles), rendered at 512x512,
     path 16, regen, Lambert through RenderAPI on the card: 1 warm-up and
     ANIM_FRAMES frames of anim.update(scene, 1/30) + api.render(
     converge=False). Per frame: host seconds of the update and of the sync
     by step, render ms, Mrays/s, the build_stats deltas (2 BLAS builds,
     the two posed meshes, and 1 compose) and 16 + 16 kernel launches; on
     the last frame both kernels equal their plain BVH4 walk on every lane
     of its three batches; the image finite with mean > 0;
  9. [cli] apps/render_cli.main on that glTF at 256x256, 2 spp, on the
     card: returns 0 and writes a PNG that reads back at (256, 256, 3);
 10. [filter] the bathroom 512x512 through RenderAPI.create(
     "wavefront_filter") (classic executor, spp 1, path 16, Lambert, TAA):
     1 warm-up and FILTER_FRAMES frames, the camera moving FILTER_MOVE and
     turning FILTER_TURN a frame; per frame the ms of render_pass and of
     the filter (SVGF + TAA + unsharpen), each closed by a synchronize, the
     launches of each kernel (must equal the bounces with a live lane), the
     share of pixels whose history survived reprojection (must be > 0),
     the image (finite); peak memory; a profiled frame; the filter alone on
     one pass's G-buffers (ms, device ms and launches); the last filtered
     frame must be smoother than a raw 1-spp frame of the same view
     (variance of neighbour differences);
 11. [filter reference] a 64x64 Cornell box through "wavefront_filter", 4
     frames with a moving camera, on the card and on the CPU: >= 99% of
     pixels within rtol / atol 1e-3 every frame;
 12. [probe] on the bathroom at 512x512: bvh_heatmap (one closest launch;
     its counts equal the plain BVH4 walk's on every lane), probe_pixel on
     a 4x4 grid through the kernel (one launch a pixel) and by brute force
     (the same prim but for t-ties within 1e-5), gbuffer_views (a
     [1024, 1024, 3] mosaic in [0, 1]), bvh_print, and a 64x64 Cornell
     render through RenderAPI with use_bvh=False (no kernel launch) against
     the BVH render (>= 99% of pixels within rtol 1e-3);
 13. [viewer] a ViewerSession on the bathroom at 256x256 running
     VIEWER_SCRIPT (frames, probe, mat, snap, move, turn, the three debug
     views, camera save / load, materials save): every frame and debug
     file written, and the FrameServer on 127.0.0.1 returns the last
     frame's PNG bytes and the stats, fetched with urllib;
 14. [ai] apps/ai_debugger_cli.main with its Cornell defaults on the card:
     returns 0, writes a 256x256 PNG; its navmesh arrays and its navmesh,
     path and agent lines equal a CPU run's;
 15. [bdpt] the bathroom 512x512, spp 1, path 16 (5 + 5 vertices a side),
     Lambert, through RenderAPI.create("bdpt") on the card: 1 warm-up and
     BDPT_PASSES timed api.render() calls; ms per pass (render_time, closed
     by a synchronize), Mrays/s ((extension + connection rays) / wall, the
     stats' own totals: every lane of every walk step, dead or not, and
     the unoccluded connections, so not comparable with the path tracer's
     rate), the rays the kernels traced on live lanes (tmax > 0) in one
     pass and their rate at the mean ms a pass, peak memory, the launches
     of each kernel per pass
     (must be 9 closest = 5 + 4 walk steps and 30 any-hit = 5 x 5
     connections + 5 lens connections), the image (finite); one profiled
     pass; both kernels against their plain BVH4 walk on every lane (t,
     prim, u, v, occlusion and the counts) of three batches captured from
     one pass: the first light-walk segment, the (s=2, t=3) connection
     batch and the s=2 lens batch; then one Disney pass through a "bdpt"
     core on the same scene (finite, its ms);
 16. [bdpt reference] (a) two "bdpt" passes of a 16x16 Cornell box, path 8,
     on the card and on the CPU: Lambert must agree on >= 99% of pixels
     within rtol / atol 1e-3; Disney on >= BDPT_DISNEY_PIXELS_MIN of them
     (the Disney lobes are chaotic in float32: a CPU run with the vertices
     moved by 1e-7 agrees with the unmoved one on only part of the pixels,
     see the constant); (b) the estimator check of tests/test_bdpt.py:52-84
     on the card: the Cornell box with its walls dimmed to 0.48 of their
     colour, 16x16, spp 8, path 8, no BVH, clamp off, BDPT_EST_PASSES
     passes of BDPT and of the classic path tracer: relative difference of
     the means < 0.04 and mean |BDPT - PT| < 0.25 of the PT mean (that
     test's bounds: a wrong MIS weight biases the estimator);
 17. [parallel] init_distributed with NCCL, world size 1, a file:// store
     under build/: render_pass_sharded of the bathroom 512x512, classic,
     spp 1, path 16 (one untimed pass sets up the communicator), against
     the unsharded classic render_pass, timed in the order sharded,
     unsharded, unsharded, sharded: every pixel within
     rtol 1e-6, the stats totals equal, the launches of each kernel per
     sharded pass; train_step_sharded on a 64x64 Cornell box (material
     colours) against the single-process gradient, loss and gradients
     within rtol 1e-5; measure_scaling's row and collective_bytes_per_pass;
     the group destroyed at the end.
It then prints one JSON line of per-kernel numbers, the card's name and
power limit, and last the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

KERNEL_ITERS = 20          # timed launches per kernel and batch
PLAIN_ITERS = 3            # timed calls per plain version and batch
AGREE_MIN = 0.9999         # fraction of lanes that must agree
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# floating-point operations of one BVH2 interior step (two child slab tests)
# and of one Moller-Trumbore test, counted from the BVH2 walk: the bound
# counts the BVH2 walk's work, whatever walks it, so shares compare across
# layouts
SLAB_PAIR_OPS = 50
MT_OPS = 54
TRAIN_STEPS = 2            # timed fwd+bwd steps (bench.py:296)
DISNEY_PASSES = 3          # timed api.render() calls of [disney]
ANCHOR_TOL = 1e-3          # golden mean / std against the anchor
# card-vs-CPU gradient bounds, relative L2 per group (tests/test_torch_grad.py)
GRAD_RTOL = dict(color=1e-3, light=1e-3, offset=2e-2)
# share of the 64x64 Disney + IBL regen pixels whose forward value must agree
# between card and CPU; a CPU run with the vertices moved by 1e-7 agrees with
# the unmoved one on 93.5% of them (cpu_jitter_pixels_agree)
DISNEY_PIXELS_MIN = 0.9
ANIM_FRAMES = 8            # timed frames of [anim]
ANIM_DT = 1.0 / 30.0       # seconds of animation a frame
# where [anim] places the glTF in the bathroom: on the floor, in view
ANIM_XF = ((1.0, 0.0, 0.0, -0.3), (0.0, 1.0, 0.0, 0.0),
           (0.0, 0.0, 1.0, -0.2), (0.0, 0.0, 0.0, 1.0))
FILTER_FRAMES = 8          # timed frames of [filter]
FILTER_MOVE = (0.01, 0.0, 0.005)   # camera translation a frame (metres)
FILTER_TURN = 0.5          # camera yaw a frame (degrees)
# share of the 64x64 filtered Cornell pixels within rtol / atol 1e-3 of the
# CPU's, every frame (as [reference])
FILTER_PIXELS_MIN = 0.99
BDPT_PASSES = 3            # timed api.render() calls of [bdpt]
BDPT_EST_PASSES = 24       # passes of each estimator (tests/test_bdpt.py:73-74)
BDPT_DISNEY_PIXELS_MIN = 0.95


def _sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=120).stdout.strip()


def _time_ms(fn, iters, dev):
    """Mean milliseconds per call over `iters` calls after one warm-up call;
    CUDA events on the card, the host clock on the CPU."""
    import torch
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trace_batches(scene, view, cfg, dev):
    """The three fixed ray batches {name: (o, d, tmax)}: the regen pool's
    primary rays, the bounce-1 rays of one shade_bounce and that bounce's
    NEE shadow rays."""
    import torch
    from lighthouse2_tpu_torch.core.geometry import BIG_T
    from lighthouse2_tpu_torch.core.rng import CAM_RNG_SEED
    from lighthouse2_tpu_torch.render import wavefront as wf

    paths, depth, _ = wf.make_regen_pool(view, cfg)
    n = depth.shape[0]
    t, prim, u, v = wf._intersect(scene, paths["origin"], paths["dir"],
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


def check_kernels(scene, view, cfg, dev, iters, plain_iters):
    """Phase 2. Returns {kernel name: {batch: numbers}}."""
    from lighthouse2_tpu_torch.bvh.traverse import bvh_intersect, bvh_occluded
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)

    bvh = scene.bvh
    batches = trace_batches(scene, view, cfg, dev)
    n = batches["primary"][0].shape[0]
    # the bound reads the BVH2 arrays once, whatever layout the kernel walks
    scene_bytes = sum(x.numel() * x.element_size() for x in (
        bvh.nbox, bvh.left, bvh.right, bvh.count, bvh.prim, bvh.tri9))
    out = {"trace_closest": {}, "trace_occluded": {}}
    for name, (o, d, tmax) in batches.items():
        kt, kp, ku, kv, kst = trace_closest(o, d, tmax, bvh, stats=True)
        wt, wp, wu, wv, wst = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
        ko, kost = trace_occluded(o, d, tmax, bvh, stats=True)
        wo, wost = wide_occluded(o, d, tmax, bvh, stats=True)
        _, bp, _, _, bst = bvh_intersect(o, d, bvh, t_max=tmax, stats=True)
        bo, bost = bvh_occluded(o, d, tmax, bvh, stats=True)
        eq = lambda a, b: (a == b).float().mean().item()
        hits = kp >= 0
        dt = (kt - wt).abs()
        c = dict(
            rays=n, live=int((tmax > 0).sum()), hits=int(hits.sum()),
            # against the plain BVH4 walk: every lane, bit for bit
            t_match=eq(kt, wt), prim_match=eq(kp, wp), u_match=eq(ku, wu),
            v_match=eq(kv, wv), occ_match=eq(ko, wo),
            counts_match=(kst == wst).all(0).float().mean().item(),
            occ_counts_match=(kost == wost).all(0).float().mean().item(),
            t_max_abs_err=dt.max().item(),
            # against the BVH2 walk: the same hits, up to exact t-ties
            bvh2_prim_match=eq(kp, bp), bvh2_occ_match=eq(ko, bo),
            occluded=int(ko.sum()),
            mean_steps=kst[0].float().mean().item(),
            mean_boxes=kst[1].float().mean().item(),
            mean_tri_tests=kst[2].float().mean().item(),
            bvh2_mean_steps=bst[0].float().mean().item(),
            bvh2_mean_boxes=2 * bst[1].float().mean().item(),
            bvh2_mean_tri_tests=bst[2].float().mean().item(),
            occ_mean_steps=kost[0].float().mean().item())
        print(f"[kernels] {name}: " + json.dumps(c), flush=True)
        exact = ("t_match", "prim_match", "u_match", "v_match", "occ_match",
                 "counts_match", "occ_counts_match")
        if any(c[k] != 1.0 for k in exact):
            raise AssertionError(f"kernel and plain BVH4 walk differ on {name}: "
                                 + str({k: c[k] for k in exact}))
        if c["bvh2_prim_match"] < AGREE_MIN or c["bvh2_occ_match"] < AGREE_MIN:
            raise AssertionError(f"kernel/BVH2 agreement below {AGREE_MIN} on "
                                 f"{name}: prim {c['bvh2_prim_match']}, "
                                 f"occ {c['bvh2_occ_match']}")
        ck = _time_ms(lambda: trace_closest(o, d, tmax, bvh), iters, dev)
        cp = _time_ms(lambda: wide_intersect(o, d, bvh, t_max=tmax),
                      plain_iters, dev)
        ok_ = _time_ms(lambda: trace_occluded(o, d, tmax, bvh), iters, dev)
        op = _time_ms(lambda: wide_occluded(o, d, tmax, bvh), plain_iters, dev)
        ray_bytes = n * (12 + 12 + 4)
        c_ops = int(bst[1].sum()) * SLAB_PAIR_OPS + int(bst[2].sum()) * MT_OPS
        o_ops = int(bost[1].sum()) * SLAB_PAIR_OPS + int(bost[2].sum()) * MT_OPS
        cb, cbb = _bound(ray_bytes + n * 16 + scene_bytes, c_ops)
        ob, obb = _bound(ray_bytes + n + scene_bytes, o_ops)
        out["trace_closest"][name] = dict(
            ms=ck, plain_ms=cp, bound_ms=cb, bound_by=cbb,
            max_abs_err=c["t_max_abs_err"], ops=c_ops,
            grays_per_s=n / ck / 1e6)
        out["trace_occluded"][name] = dict(
            ms=ok_, plain_ms=op, bound_ms=ob, bound_by=obb,
            max_abs_err=float((ko != wo).any()), ops=o_ops,
            grays_per_s=n / ok_ / 1e6)
        print(f"[kernels] {name}: closest {ck:.4f} ms = {n / ck / 1e6:.3f} "
              f"Grays/s (plain {cp:.2f} ms, bound {cb:.4f} ms by {cbb}, "
              f"{cb / ck:.1%} of it); occluded {ok_:.4f} ms = "
              f"{n / ok_ / 1e6:.3f} Grays/s (plain {op:.2f} ms, bound "
              f"{ob:.4f} ms by {obb}, {ob / ok_:.1%} of it)", flush=True)
    return out


def _counts():
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    return dict(trace_closest=trace_closest.launches,
                trace_occluded=trace_occluded.launches)


def _zero_counts():
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    trace_closest.launches = 0
    trace_occluded.launches = 0


def main_path(scene, view, cfg, dev, passes):
    """Phase 3. Returns the numbers of the timed passes."""
    import torch
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass)

    state = AccumState.make(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    counts = [(0, 0)]
    t0 = time.perf_counter()
    state, stats = render_pass(scene, view, state, cfg)      # warm-up
    counts.append(tuple(_counts().values()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    all_stats = []
    t0 = time.perf_counter()
    for _ in range(passes):
        state, stats = render_pass(scene, view, state, cfg)
        all_stats.append(stats)
        counts.append(tuple(_counts().values()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = _counts()
    per_pass = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(counts, counts[1:])]
    rays = sum(int(s["total_extension"]) + int(s["total_shadow"])
               for s in all_stats)
    img = finalize(state)
    res = dict(
        passes=passes, seconds=dt, warmup_seconds=warm_s,
        mrays_per_s=rays / dt / 1e6, rays=rays,
        ms_per_pass=dt * 1e3 / passes,
        extension_rays=all_stats[-1]["extension_rays"].tolist(),
        shadow_rays=all_stats[-1]["shadow_rays"].tolist(),
        samples_completed=int(all_stats[-1]["samples_completed"]),
        launches=launches, launches_per_pass=per_pass,
        image_mean=img.mean().item(),
        image_finite=bool(torch.isfinite(img).all()),
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None))
    print("[main] " + json.dumps(res), flush=True)
    want = cfg.max_path_length
    if any(p != (want, want) for p in per_pass):
        raise AssertionError(f"each kernel must launch {want} times a pass, "
                             f"got {per_pass}")
    if not (res["image_finite"] and res["image_mean"] > 0):
        raise AssertionError("the rendered image is not finite and positive")
    return res, state


def _profile(fn, dev, tag):
    """Run fn once under torch.profiler: device time by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = []      # device-side events only (kernels, copies, memsets)
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    kernels = ("closest_kernel", "occluded_kernel")
    share = {k: sum(r[0] for r in rows if k in r[1]) / max(total, 1e-9)
             for k in kernels}
    per_launch = {k: sum(r[0] for r in rows if k in r[1]) / 1e3
                  / max(sum(r[2] for r in rows if k in r[1]), 1)
                  for k in kernels}
    res = dict(wall_ms=wall * 1e3, device_ms=total / 1e3,
               device_launches=sum(r[2] for r in rows),
               device_busy_share=total / 1e3 / (wall * 1e3),
               kernel_share_of_device=share,
               kernel_ms_per_launch=per_launch,
               top=[dict(name=k[:60], ms=us / 1e3, calls=c)
                    for us, k, c in rows[:12]])
    print(tag + json.dumps(res), flush=True)
    return res


def profile_pass(scene, view, cfg, state, dev):
    """One more forward pass under torch.profiler."""
    from lighthouse2_tpu_torch.render.wavefront import render_pass
    return _profile(lambda: render_pass(scene, view, state, cfg), dev,
                    "[profile] ")


def reference_check(dev):
    """Phase 4: a small render on the card against the same render through
    the plain versions on the CPU."""
    import torch
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass)
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       path_regen=True)
    scene, cam = cornell_box(64, 64)
    out = {}
    for where in (dev, torch.device("cpu")):
        ds, view = scene.sync(where), cam.get_view(where)
        st = AccumState.make(cfg, where)
        for _ in range(2):
            st, _ = render_pass(ds, view, st, cfg)
        out[where.type] = (st.accumulator.cpu(), finalize(st).cpu())
    (ga, gi), (ca, ci) = out[dev.type], out["cpu"]
    close = torch.isclose(ga, ca, rtol=1e-3, atol=1e-4).all(-1)
    res = dict(pixels_close=close.float().mean().item(),
               mean_card=gi.mean().item(), mean_cpu=ci.mean().item(),
               mean_rel_diff=abs(gi.mean().item() - ci.mean().item())
               / max(abs(ci.mean().item()), 1e-30))
    print("[reference] " + json.dumps(res), flush=True)
    if res["pixels_close"] < 0.99 or res["mean_rel_diff"] > 1e-3:
        raise AssertionError("card and CPU renders disagree")
    return res


def _headline_params(scene, size, dev):
    """bench.py:114-118: colours, light radiance, zero vertex offsets; a
    zero target image."""
    import torch
    params = dict(color=scene.materials.color,
                  light=scene.lights.tri_radiance,
                  offset=torch.zeros((scene.tris.count, 3, 3), device=dev))
    return params, torch.zeros((size * size, 3), device=dev)


def _grad_summary(grads):
    import torch
    return {k: dict(norm=g.norm().item(), finite=bool(torch.isfinite(g).all()),
                    nonzero=int((g != 0).sum())) for k, g in grads.items()}


def train_path(scene, view, cfg, dev, steps):
    """Phase 5: the fwd+bwd headline. Returns its numbers and the state."""
    import torch
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, ensure_regen_state, render_pass)

    cfg = dataclasses.replace(cfg, remat=True)
    size = cfg.width
    params, target = _headline_params(scene, size, dev)
    # ray count from one forward stats pass (bench.py:129-134)
    _, stats0 = render_pass(scene, view, AccumState.make(cfg, dev), cfg)
    fixed_rays = int(stats0["total_extension"]) + int(stats0["total_shadow"])
    state = ensure_regen_state(view, AccumState.make(cfg, dev), cfg)
    t0 = time.perf_counter()
    loss, grads, state = regen_value_and_grad(scene, view, state, cfg,
                                              target, params)    # warm-up
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, grads, state = regen_value_and_grad(scene, view, state, cfg,
                                                  target, params)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    summary = _grad_summary(grads)
    res = dict(steps=steps, seconds=dt, warmup_seconds=warm_s,
               rays_per_step=fixed_rays,
               mrays_per_s=fixed_rays * steps / dt / 1e6,
               ms_per_step=dt * 1e3 / steps, loss=loss.item(),
               launches=launches,
               launches_per_step={k: v / steps for k, v in launches.items()},
               max_memory_allocated=peak, grads=summary)
    print("[train] " + json.dumps(res), flush=True)

    # one step without remat, for its peak memory
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    regen_value_and_grad(scene, view, state,
                         dataclasses.replace(cfg, remat=False), target,
                         params)
    torch.cuda.synchronize(dev)
    res["no_remat"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                           max_memory_allocated=torch.cuda.max_memory_allocated(
                               dev))
    print("[train] no remat: " + json.dumps(res["no_remat"]), flush=True)
    print(f"[train] {res['mrays_per_s']:.3f} Mrays/s fwd+bwd, "
          f"{res['ms_per_step']:.1f} ms/step, peak {peak / 1e9:.2f} GB with "
          f"remat, {res['no_remat']['max_memory_allocated'] / 1e9:.2f} GB "
          f"without", flush=True)

    want = cfg.max_path_length * steps
    if launches != dict(trace_closest=want, trace_occluded=want):
        raise AssertionError(f"each kernel must launch {cfg.max_path_length} "
                             f"times a fwd+bwd step, got {launches} over "
                             f"{steps} steps")
    bad = {k: v for k, v in summary.items()
           if not (v["finite"] and v["nonzero"] > 0)}
    if bad:
        raise AssertionError(f"gradients not finite or all zero: {bad}")
    return res, state


def profile_train_step(scene, view, cfg, state, dev):
    """One fwd+bwd step under torch.profiler: device time by kernel name."""
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad

    cfg = dataclasses.replace(cfg, remat=True)
    params, target = _headline_params(scene, cfg.width, dev)
    return _profile(lambda: regen_value_and_grad(scene, view, state, cfg,
                                                 target, params),
                    dev, "[train profile] ")


def grad_reference_check(dev, disney=False):
    """Phase 5, last (and phase 6 with disney=True: test_sky, Disney and
    IBL): fwd+bwd of a small regen render on the card against the same step
    through the plain versions on the CPU.

    Lambert paths take the same choices on both sides, so the whole image
    and every gradient group must agree. Disney + IBL paths do not all: a
    rounding step can flip a discrete choice of a lane, and the regen pool
    then hands the later samples to other pixels. So the pixels are split
    by their forward value: >= DISNEY_PIXELS_MIN of them must agree, and
    the gradients are compared a second time with the pixels that differ
    given zero weight on both sides (their target set to their own value);
    those must agree within GRAD_RTOL. The unweighted comparison is
    printed beside a CPU run whose vertices moved by ~1e-7, the size of the
    choices' own noise."""
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import AccumState
    from lighthouse2_tpu_torch.scene import presets

    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       path_regen=True, remat=True)
    scene, cam = presets.cornell_box(64, 64)
    if disney:
        cfg = dataclasses.replace(cfg, bsdf="disney", sky_ibl=True)
        presets.test_sky(scene)
    tag = "[disney train reference] " if disney else "[train reference] "
    cpu = torch.device("cpu")
    synced = {w.type: (scene.sync(w), cam.get_view(w)) for w in (dev, cpu)}

    def step(where, target, jitter=0.0):
        ds, view = synced[where.type]
        params, _ = _headline_params(ds, 64, where)
        if jitter:
            params["offset"] = jitter * torch.from_numpy(
                np.random.default_rng(0).standard_normal(
                    tuple(params["offset"].shape)).astype(np.float32))
        _, grads, st = regen_value_and_grad(
            ds, view, AccumState.make(cfg, where), cfg, target.to(where),
            params)
        img = st.accumulator[:, :3] / torch.clamp(st.pixel_count,
                                                  min=1.0)[:, None]
        return img.cpu(), {k: g.cpu() for k, g in grads.items()}

    rel = lambda a, b: {k: ((a[k] - b[k]).norm() / b[k].norm()).item()
                        for k in b}
    target = torch.full((64 * 64, 3), 0.25)
    (gi, gg), (ci, cg) = step(dev, target), step(cpu, target)
    agree = torch.isclose(gi, ci, rtol=1e-3, atol=1e-4).all(-1)
    loss = lambda img: ((img[agree] - 0.25) ** 2).mean().item()
    res = dict(pixels_agree=agree.float().mean().item(),
               loss_rel_diff=abs(loss(gi) - loss(ci)) / max(loss(ci), 1e-30),
               grad_rel_l2=rel(gg, cg), bounds=GRAD_RTOL)
    if disney:
        # the pixels that differ weigh nothing: target = their own value
        res["grad_rel_l2_agreeing_pixels"] = rel(
            step(dev, torch.where(agree[:, None], target, gi))[1],
            step(cpu, torch.where(agree[:, None], target, ci))[1])
        ji, jg = step(cpu, target, 1e-7)
        res["cpu_jitter_pixels_agree"] = torch.isclose(
            ji, ci, rtol=1e-3, atol=1e-4).all(-1).float().mean().item()
        res["cpu_jitter_grad_rel_l2"] = rel(jg, cg)
        held, pixels_min = res["grad_rel_l2_agreeing_pixels"], \
            DISNEY_PIXELS_MIN
    else:
        held, pixels_min = res["grad_rel_l2"], 1.0
    print(tag + json.dumps(res), flush=True)
    if (res["pixels_agree"] < pixels_min or res["loss_rel_diff"] > 1e-4
            or any(held[k] > b for k, b in GRAD_RTOL.items())):
        raise AssertionError("card and CPU gradients disagree")
    return res


def api_passes(api, dev, passes, tag):
    """One warm-up (with the scene's sync) and `passes` timed api.render()
    calls; checks the launches of each kernel per pass and the images.
    Returns the numbers."""
    import numpy as np
    import torch

    cfg = api.config
    t0 = time.perf_counter()
    api.render()                                    # sync + warm-up pass
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    per_pass, stats = [], []
    for _ in range(passes):
        before = _counts()
        stats.append(dict(api.render()))
        after = _counts()
        per_pass.append({k: after[k] - before[k] for k in after})
    launches = _counts()
    render_s = sum(st["render_time"] for st in stats)
    rays = sum(st["total_rays"] for st in stats)
    img = api.get_image()
    ldr = api.get_ldr_image()
    res = dict(
        passes=passes, warmup_seconds=warm_s, render_seconds=render_s,
        mrays_per_s=rays / render_s / 1e6, rays=rays,
        ms_per_pass=[st["render_time"] * 1e3 for st in stats],
        mean_ms_per_pass=render_s * 1e3 / passes,
        extension_rays=stats[-1]["extension_per_bounce"].tolist(),
        shadow_rays=stats[-1]["shadow_per_bounce"].tolist(),
        spp=api.core.stats["spp"], launches=launches,
        launches_per_pass=per_pass,
        image_mean=float(img.mean()),
        image_finite=bool(np.isfinite(img).all()),
        ldr_finite=bool(np.isfinite(ldr).all()),
        ldr_min=float(ldr.min()), ldr_max=float(ldr.max()),
        max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    print(tag + json.dumps(res), flush=True)
    want = {k: cfg.max_path_length for k in launches}
    if any(p != want for p in per_pass):
        raise AssertionError(f"each kernel must launch {cfg.max_path_length} "
                             f"times a pass, got {per_pass}")
    if not (res["image_finite"] and res["image_mean"] > 0):
        raise AssertionError("the image is not finite and positive")
    if not (res["ldr_finite"] and res["ldr_min"] >= 0.0
            and res["ldr_max"] <= 1.0):
        raise AssertionError("get_ldr_image is not finite in [0, 1]")
    return res


def disney_path(cfg, dev, passes):
    """Phase 6, forward: the bathroom with the golden sky, Disney and IBL,
    through RenderAPI. Returns (numbers, api)."""
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    from lighthouse2_tpu_torch.utils.golden import golden_sky

    cfg = dataclasses.replace(cfg, bsdf="disney", sky_ibl=True)
    api = RenderAPI.create("wavefront", cfg, device=dev)
    api.scene, api.camera = bathroom(cfg.width, cfg.height)
    api.scene.set_sky(golden_sky())
    res = api_passes(api, dev, passes, "[disney] ")
    if not api.device_scene().sky.has_ibl:
        raise AssertionError("the Disney scene's sky has no IBL tables")
    return res, api


def lambert_api_path(host, cam, cfg, dev, passes):
    """Phase 6: the Lambert scene of phase 3 (already synced to the card)
    through RenderAPI, timed as the Disney passes are. Then the two timers
    alternate, twice: `passes` render_pass calls with one synchronize at the
    end (phase 3's) and `passes` api.render() calls (ms per pass each)."""
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass

    api = RenderAPI.create("wavefront", cfg, device=dev)
    api.scene, api.camera = host, cam
    res = api_passes(api, dev, passes, "[disney] Lambert through RenderAPI: ")
    scene, view = host.sync(dev), cam.get_view(dev)
    state, _ = render_pass(scene, view, AccumState.make(cfg, dev), cfg)
    alt = dict(render_pass_ms=[], api_ms=[])
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(passes):
            state, _ = render_pass(scene, view, state, cfg)
        torch.cuda.synchronize(dev)
        alt["render_pass_ms"].append((time.perf_counter() - t0) * 1e3 / passes)
        alt["api_ms"].append(sum(api.render()["render_time"]
                                 for _ in range(passes)) * 1e3 / passes)
    print("[disney] Lambert, the two timers alternated: " + json.dumps(alt),
          flush=True)
    res["alternated"] = alt
    return res


def disney_train_step(api, dev):
    """Phase 6: fwd+bwd of the Disney + IBL path with remat and the
    parameter groups of [train]; one warm-up step and one timed."""
    import torch
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, ensure_regen_state)

    cfg = dataclasses.replace(api.config, remat=True)
    scene = api.device_scene()
    view = api.camera.get_view(dev)
    params, target = _headline_params(scene, cfg.width, dev)
    state = ensure_regen_state(view, AccumState.make(cfg, dev), cfg)
    t0 = time.perf_counter()
    _, _, state = regen_value_and_grad(scene, view, state, cfg, target,
                                       params)              # warm-up
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    loss, grads, _ = regen_value_and_grad(scene, view, state, cfg, target,
                                          params)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    launches = _counts()
    summary = _grad_summary(grads)
    res = dict(ms_per_step=dt * 1e3, warmup_seconds=warm_s, loss=loss.item(),
               launches=launches,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               grads=summary)
    print("[disney train] " + json.dumps(res), flush=True)
    want = {k: cfg.max_path_length for k in launches}
    if launches != want:
        raise AssertionError(f"each kernel must launch {cfg.max_path_length} "
                             f"times a Disney fwd+bwd step, got {launches}")
    bad = {k: v for k, v in summary.items()
           if not (v["finite"] and v["nonzero"] > 0)}
    if bad:
        raise AssertionError(f"Disney gradients not finite or all zero: {bad}")
    return res


def golden_check(dev):
    """Phase 7: the golden frame on the card and on the CPU, against each
    other and against the JAX package's anchor."""
    import torch
    from lighthouse2_tpu_torch.utils import golden

    out = {}
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        a = golden.render_golden(where).cpu()
        out[where.type] = (a, time.perf_counter() - t0)
    (ga, g_s), (ca, c_s) = out[dev.type], out["cpu"]
    close = torch.isclose(ga, ca, rtol=1e-3, atol=1e-4).all(-1)
    stat = lambda a: dict(mean=a.mean().item(),
                          std=a.std(correction=0).item(),
                          finite=bool(torch.isfinite(a).all()))
    res = dict(pixels_close=close.float().mean().item(), card=stat(ga),
               cpu=stat(ca), anchor_mean=golden.ANCHOR_MEAN,
               anchor_std=golden.ANCHOR_STD, card_seconds=g_s,
               cpu_seconds=c_s)
    print("[golden] " + json.dumps(res), flush=True)
    if res["pixels_close"] < 0.99:
        raise AssertionError("golden frame: card and CPU disagree")
    for side in ("card", "cpu"):
        st = res[side]
        if not (st["finite"]
                and abs(st["mean"] - golden.ANCHOR_MEAN) < ANCHOR_TOL
                and abs(st["std"] - golden.ANCHOR_STD) < ANCHOR_TOL):
            raise AssertionError(f"golden frame on the {side} misses the "
                                 f"anchor: {st}")
    return res


def scene_trees(host, dev):
    """Phase 2, [scene]: the bathroom synced single-level (numpy, native)
    and then by default (two-level). Returns {tree: DeviceScene}; the
    default sync is last, so the host's cached scene is the default."""
    from lighthouse2_tpu_torch.bvh.wide import check_depth4

    out = {}
    for name, kw in (("single_level_numpy", dict(two_level=False,
                                                 native=False)),
                     ("single_level_native", dict(two_level=False)),
                     ("two_level", {})):
        before = dict(host.build_stats)
        t0 = time.perf_counter()
        ds = host.sync(dev, **kw)
        wall = time.perf_counter() - t0
        b = ds.bvh
        mb = lambda *xs: sum(x.numel() * x.element_size() for x in xs) / 1e6
        res = dict(
            triangles=ds.tris.count, nodes=int(b.nbox.shape[1]),
            depth=b.depth, nodes4=int(b.node4.shape[0]), depth4=b.depth4,
            bvh2_mb=mb(b.nbox, b.left, b.right, b.count, b.prim),
            node4_mb=mb(b.node4), tri4_mb=mb(b.tri4), sync_seconds=wall,
            host_seconds=dict(host.sync_seconds),
            build_stats={k: host.build_stats[k] - before[k] for k in before})
        print(f"[scene] {name}: " + json.dumps(res), flush=True)
        check_depth4(b.depth4)
        out[name] = ds
    return out


def time_kernels(scene, ref_scene, view, cfg, dev, iters):
    """CUDA-event ms of both kernels on `scene`'s tree for the three
    batches of `ref_scene` (the same triangles), and the share of lanes
    whose closest t equals the kernel's on `ref_scene`'s tree."""
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)

    out = {}
    for name, (o, d, tmax) in trace_batches(ref_scene, view, cfg, dev).items():
        t = trace_closest(o, d, tmax, scene.bvh)[0]
        t_ref = trace_closest(o, d, tmax, ref_scene.bvh)[0]
        out[name] = dict(
            closest_ms=_time_ms(lambda: trace_closest(o, d, tmax, scene.bvh),
                                iters, dev),
            occluded_ms=_time_ms(
                lambda: trace_occluded(o, d, tmax, scene.bvh), iters, dev),
            t_match=(t == t_ref).float().mean().item())
    return out


def kernels_equal_plain(scene, view, cfg, dev):
    """Both kernels against their plain BVH4 walk on the three batches of
    this scene: t, prim, u, v and occlusion equal on every lane."""
    import torch
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)

    res = {}
    for name, (o, d, tmax) in trace_batches(scene, view, cfg, dev).items():
        got = trace_closest(o, d, tmax, scene.bvh)
        want = wide_intersect(o, d, scene.bvh, t_max=tmax)
        lanes = [g == w for g, w in zip(got, want)] + [
            trace_occluded(o, d, tmax, scene.bvh)
            == wide_occluded(o, d, tmax, scene.bvh)]
        res[name] = torch.stack(lanes).all(0).float().mean().item()
    if any(v != 1.0 for v in res.values()):
        raise AssertionError(f"kernel and plain BVH4 walk differ: {res}")
    return res


def anim_path(cfg, dev, frames, directory, sizes=()):
    """Phase 8: the animated glTF in the bathroom through RenderAPI.
    `sizes` are write_anim_gltf's size arguments (default: full size).
    Returns the numbers."""
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    from lighthouse2_tpu_torch.tools.anim_gltf import write_anim_gltf

    t0 = time.perf_counter()
    path = write_anim_gltf(directory, *sizes)
    write_s = time.perf_counter() - t0
    api = RenderAPI.create("wavefront", cfg, device=dev)
    api.scene, api.camera = bathroom(cfg.width, cfg.height)
    t0 = time.perf_counter()
    api.scene.load_gltf(path, transform=np.asarray(ANIM_XF, np.float32))
    load_s = time.perf_counter() - t0
    scene = api.scene
    anim = scene.animations[0]
    out = dict(write_seconds=write_s, load_seconds=load_s, frames=[])
    for i in range(frames + 1):                  # frame 0 is the warm-up
        stats0, counts0 = dict(scene.build_stats), _counts()
        t0 = time.perf_counter()
        anim.update(scene, ANIM_DT)
        t1 = time.perf_counter()
        st = api.render(converge=False)
        t2 = time.perf_counter()
        counts = _counts()
        fr = dict(
            frame=i, anim_time=anim.time, update_seconds=t1 - t0,
            sync_seconds=dict(scene.sync_seconds),
            sync_total_seconds=sum(scene.sync_seconds.values()),
            render_ms=st["render_time"] * 1e3, wall_ms=(t2 - t0) * 1e3,
            mrays_per_s=st["mrays_per_s"], rays=st["total_rays"],
            build_stats={k: scene.build_stats[k] - stats0[k]
                         for k in stats0},
            launches={k: counts[k] - counts0[k] for k in counts})
        print("[anim] " + json.dumps(fr), flush=True)
        if i:
            out["frames"].append(fr)
    # the posing functions alone, on the frame's pose (host seconds)
    from lighthouse2_tpu_torch.scene.host_scene import _apply_morph, _apply_skin
    for mesh_id, _, node in scene.flatten_instances():
        mesh = scene.meshes[mesh_id]
        if node.skin_id >= 0:
            t0 = time.perf_counter()
            _apply_skin(mesh, scene, node)
            out["skin_seconds"] = time.perf_counter() - t0
            out["skin_vertices"] = int(mesh.base_vertices.shape[0])
        elif node.morph_weights is not None and mesh.morph_targets:
            t0 = time.perf_counter()
            _apply_morph(mesh, np.asarray(node.morph_weights, np.float32))
            out["morph_seconds"] = time.perf_counter() - t0
            out["morph_vertices"] = int(mesh.base_vertices.shape[0])
    ds = api.device_scene()
    img = api.get_image()
    out.update(
        triangles=ds.tris.count, nodes=int(ds.bvh.nbox.shape[1]),
        depth=ds.bvh.depth, depth4=ds.bvh.depth4,
        lanes_equal_plain=kernels_equal_plain(
            ds, api.camera.get_view(dev), cfg, dev),
        image_mean=float(img.mean()), image_finite=bool(np.isfinite(img).all()))
    fs = out["frames"]
    mean = lambda k: sum(f[k] for f in fs) / len(fs)
    out.update(mean_render_ms=mean("render_ms"), mean_wall_ms=mean("wall_ms"),
               mean_sync_seconds=mean("sync_total_seconds"),
               mean_mrays_per_s=mean("mrays_per_s"),
               mean_sync_split={k: sum(f["sync_seconds"][k] for f in fs)
                                / len(fs) for k in fs[0]["sync_seconds"]})
    print("[anim] " + json.dumps({k: v for k, v in out.items()
                                  if k != "frames"}), flush=True)
    want_launch = {k: cfg.max_path_length for k in _counts()}
    for f in fs:
        if f["launches"] != want_launch:
            raise AssertionError(f"each kernel must launch "
                                 f"{cfg.max_path_length} times a frame: {f}")
        if f["build_stats"] != dict(blas_builds=2, tlas_composes=1):
            raise AssertionError("an animated frame must rebuild the two "
                                 f"posed BLASes and compose once: {f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if not (out["image_finite"] and out["image_mean"] > 0):
        raise AssertionError("the animated frame is not finite and positive")
    return out


def cli_check(gltf, out_png, size=256):
    """Phase 9: the render CLI on the card; returns its numbers."""
    from lighthouse2_tpu_torch.apps import render_cli
    from lighthouse2_tpu_torch.utils.image import read_png

    t0 = time.perf_counter()
    rc = render_cli.main([gltf, "-o", out_png, "--size", str(size), "--spp",
                          "2", "--spp-per-pass", "1", "--sky", "0.8,0.8,0.8"])
    res = dict(rc=rc, seconds=time.perf_counter() - t0)
    if rc != 0:
        raise AssertionError(f"render_cli returned {rc}")
    img = read_png(out_png)
    res.update(shape=list(img.shape), mean=float(img.mean()))
    print("[cli] " + json.dumps(res), flush=True)
    if img.shape != (size, size, 3) or not img.max() > 0:
        raise AssertionError(f"render_cli wrote {img.shape}, max {img.max()}")
    return res


def _live_bounces(stats):
    """Bounces of a classic pass that still had a live lane: each launches
    each trace kernel once."""
    import numpy as np
    return int((np.asarray(stats["extension_per_bounce"]) > 0).sum())


def _neighbour_var(img):
    """Variance of vertical neighbour differences (tests/test_filter.py
    :118-123): the noise measure a filtered frame must lower."""
    import numpy as np
    return float(np.var(np.diff(img, axis=0)))


def filter_path(host, cam, dev, frames, size=512):
    """Phase 10, [filter]: the bathroom through "wavefront_filter" (classic
    executor, spp 1, path 16, Lambert, TAA) with the camera moving and
    turning a little each frame; 1 warm-up + `frames` timed frames, one
    profiled frame, the filter alone profiled and timed on one frame's
    G-buffers, and a raw 1-spp frame of the last view. Returns the
    numbers."""
    import copy
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.apps.viewer_cli import _rotate
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render.filter import svgf_filter, taa, unsharpen
    from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass

    cfg = RenderConfig(width=size, height=size, spp_per_pass=1,
                       max_path_length=16, taa_enabled=True)
    api = RenderAPI.create("wavefront_filter", cfg, device=dev)
    api.scene, api.camera = host, copy.deepcopy(cam)

    def move():
        c = api.camera
        c.position = (np.asarray(c.position, np.float32)
                      + np.float32(FILTER_MOVE))
        c.direction = _rotate(c.direction, FILTER_TURN, 0.0)

    t0 = time.perf_counter()
    api.render()                                  # sync + warm-up frame
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    out = dict(warmup_seconds=warm_s, frames=[])
    for i in range(frames):
        move()
        before = _counts()
        st = dict(api.render())
        after = _counts()
        img = api.get_image()
        fr = dict(
            frame=i + 1, pass_ms=st["pass_time"] * 1e3,
            filter_ms=st["filter_time"] * 1e3, frame_ms=st["render_time"] * 1e3,
            mrays_per_s=st["mrays_per_s"], live_bounces=_live_bounces(st),
            launches={k: after[k] - before[k] for k in after},
            history_share=(api.core.filter_state.history > 0).float()
            .mean().item(),
            image_finite=bool(np.isfinite(img).all()),
            image_mean=float(img.mean()))
        print("[filter] " + json.dumps(fr), flush=True)
        out["frames"].append(fr)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    fs = out["frames"]
    mean = lambda k: sum(f[k] for f in fs) / len(fs)
    out.update(mean_pass_ms=mean("pass_ms"), mean_filter_ms=mean("filter_ms"),
               mean_frame_ms=mean("frame_ms"),
               min_history_share=min(f["history_share"] for f in fs))
    filtered = api.get_image()

    # the raw 1-spp frame of the same (unjittered) view
    raw_api = RenderAPI.create("wavefront", dataclasses.replace(
        cfg, taa_enabled=False), device=dev)
    raw_api.scene, raw_api.camera = host, api.camera
    raw_api.render()
    out.update(filtered_neighbour_var=_neighbour_var(filtered),
               raw_neighbour_var=_neighbour_var(raw_api.get_image()))

    out["profile"] = _profile(lambda: (move(), api.render()), dev,
                              "[filter profile] ")

    # the filter alone, on one pass's G-buffers and the core's state
    core = api.core
    h, w = cfg.height, cfg.width
    state, stats = render_pass(api.device_scene(), api.camera.get_view(dev),
                               AccumState.make(core.config, dev), core.config)
    aux = stats["filter_aux"]
    im = lambda x: x.reshape(h, w, *x.shape[1:])
    wp = im(aux["world_pos"])
    args = (im(state.accumulator[:, :3]), im(aux["indirect"]),
            im(aux["albedo"]), im(aux["normal"]), im(aux["depth"]), wp,
            core.filter_state)

    def run_filter():
        c, _ = svgf_filter(*args, direct_clamp=cfg.clamp_direct,
                           indirect_clamp=cfg.clamp_indirect,
                           prev_view=core.prev_view)
        c, _ = taa(c, core.taa_state, world_pos=wp, prev_view=core.prev_view)
        return unsharpen(c)

    prof = _profile(run_filter, dev, "[filter alone profile] ")
    out["filter_alone"] = dict(
        ms=_time_ms(run_filter, 5, dev), device_ms=prof["device_ms"],
        device_launches=prof["device_launches"], wall_ms=prof["wall_ms"])
    print("[filter] " + json.dumps({k: v for k, v in out.items()
                                    if k not in ("frames", "profile")}),
          flush=True)
    for f in fs:
        want = {k: f["live_bounces"] for k in f["launches"]}
        if f["launches"] != want:
            raise AssertionError("each kernel must launch once per bounce "
                                 f"with a live lane: {f}")
        if not f["image_finite"]:
            raise AssertionError(f"filtered frame not finite: {f}")
        if f["history_share"] <= 0.0:
            raise AssertionError(f"no history survived reprojection: {f}")
    if not out["filtered_neighbour_var"] < out["raw_neighbour_var"]:
        raise AssertionError("the filtered frame is not smoother than the "
                             "raw 1-spp frame: " + json.dumps(out))
    return out


def filter_reference(dev, frames=4):
    """Phase 11, [filter reference]: "wavefront_filter" on a 64x64 Cornell
    box with a moving camera, on the card and on the CPU."""
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       taa_enabled=True)
    out = {}
    for where in (dev, torch.device("cpu")):
        api = RenderAPI.create("wavefront_filter", cfg, device=where)
        api.scene, api.camera = cornell_box(64, 64)
        imgs, hist = [], []
        for _ in range(frames):
            api.camera.position = (api.camera.position
                                   + np.float32([0.02, 0.01, 0.0]))
            api.render()
            imgs.append(api.get_image())
            hist.append(api.core.filter_state.history.cpu().numpy())
        out[where.type] = (imgs, hist)
    (gi, gh), (ci, ch) = out[dev.type], out["cpu"]
    res = dict(
        pixels_close=[float(np.isclose(g, c, rtol=1e-3, atol=1e-3).all(-1)
                            .mean()) for g, c in zip(gi, ci)],
        history_equal=[float((g == c).mean()) for g, c in zip(gh, ch)],
        mean_card=float(gi[-1].mean()), mean_cpu=float(ci[-1].mean()))
    print("[filter reference] " + json.dumps(res), flush=True)
    if min(res["pixels_close"]) < FILTER_PIXELS_MIN:
        raise AssertionError("filtered frames: card and CPU disagree")
    return res


def probe_path(scene, cam, dev, size=512, grid=4):
    """Phase 12, [probe] on the bathroom at 512x512: the heatmap (one
    closest launch, its counts equal to the plain BVH4 walk's on every
    lane), probe_pixel on a grid through the kernel and by brute force,
    the G-buffer mosaic, bvh_print, and a 64x64 Cornell render without a
    BVH against the BVH render."""
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect
    from lighthouse2_tpu_torch.core.geometry import BIG_T
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render import probe
    from lighthouse2_tpu_torch.render.kernels.trace import trace_closest
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    cfg = RenderConfig(width=size, height=size)
    view = cam.get_view(dev)
    res = {}
    _zero_counts()
    t0 = time.perf_counter()
    heat = probe.bvh_heatmap(scene, view, cfg)
    res["heatmap_seconds"] = time.perf_counter() - t0
    res["launches_heatmap"] = _counts()
    o, d = probe._pixel_rays(view, cfg)
    kst = trace_closest(o, d, BIG_T, scene.bvh, stats=True)[4]
    wst = wide_intersect(o, d, scene.bvh, stats=True)[4]
    steps = wst[0].cpu().numpy().astype(np.float32)
    res["heatmap_counts_equal"] = (kst == wst).all(0).float().mean().item()
    res["heatmap_equal"] = bool(np.array_equal(
        heat, probe._colormap(steps / max(steps.max(), 1.0)).reshape(
            size, size, 3)))
    res["mean_steps"] = float(steps.mean())

    nb = dataclasses.replace(cfg, use_bvh=False)
    rows, t_kernel, t_brute = [], 0.0, 0.0
    _zero_counts()
    for y in np.linspace(size / 32, size - 1 - size / 32, grid).astype(int):
        for x in np.linspace(size / 32, size - 1 - size / 32,
                             grid).astype(int):
            t0 = time.perf_counter()
            k = probe.probe_pixel(scene, view, cfg, int(x), int(y))
            t1 = time.perf_counter()
            b = probe.probe_pixel(scene, view, nb, int(x), int(y))
            t2 = time.perf_counter()
            t_kernel += t1 - t0
            t_brute += t2 - t1
            tie = (k["prim"] != b["prim"] and np.isfinite(k["distance"])
                   and abs(k["distance"] - b["distance"])
                   <= 1e-5 * k["distance"])
            rows.append(dict(x=int(x), y=int(y), kernel=k["prim"],
                             brute=b["prim"], t=k["distance"],
                             t_brute=b["distance"], tie=bool(tie)))
    res.update(launches_probe_grid=_counts(), probe_kernel_ms=t_kernel * 1e3
               / len(rows), probe_brute_ms=t_brute * 1e3 / len(rows),
               probe_hits=sum(r["kernel"] >= 0 for r in rows),
               probe_ties=sum(r["tie"] for r in rows))
    bad = [r for r in rows if r["kernel"] != r["brute"] and not r["tie"]]

    _zero_counts()
    t0 = time.perf_counter()
    mosaic = probe.gbuffer_views(scene, view, cfg)
    res.update(gbuffer_seconds=time.perf_counter() - t0,
               gbuffer_shape=list(mosaic.shape),
               gbuffer_min=float(mosaic.min()),
               gbuffer_max=float(mosaic.max()),
               launches_gbuffer=_counts())
    tree = probe.bvh_print(scene)
    print("[probe] " + tree.replace("\n", "\n[probe] "), flush=True)

    # a small scene without a BVH, through RenderAPI, against the BVH one
    imgs = {}
    for use_bvh in (True, False):
        api = RenderAPI.create("wavefront", RenderConfig(
            width=64, height=64, spp_per_pass=1, max_path_length=4,
            use_bvh=use_bvh), device=dev)
        api.scene, api.camera = cornell_box(64, 64)
        _zero_counts()
        for _ in range(2):
            api.render()
        imgs[use_bvh] = (api.get_image(), _counts())
    close = np.isclose(imgs[False][0], imgs[True][0], rtol=1e-3,
                       atol=1e-4).all(-1)
    res.update(no_bvh_pixels_close=float(close.mean()),
               no_bvh_launches=imgs[False][1], bvh_launches=imgs[True][1])
    print("[probe] " + json.dumps(dict(res, grid=rows)), flush=True)
    if res["launches_heatmap"] != dict(trace_closest=1, trace_occluded=0):
        raise AssertionError(f"the heatmap must launch the closest kernel "
                             f"once: {res['launches_heatmap']}")
    if res["heatmap_counts_equal"] != 1.0 or not res["heatmap_equal"]:
        raise AssertionError("heatmap counts differ from the plain walk's")
    if res["launches_probe_grid"] != dict(trace_closest=len(rows),
                                          trace_occluded=0):
        raise AssertionError("probe_pixel must launch the closest kernel "
                             f"once a pixel: {res['launches_probe_grid']}")
    if bad or res["probe_hits"] == 0:
        raise AssertionError(f"kernel and brute-force probes differ: {bad}")
    if (mosaic.shape != (2 * size, 2 * size, 3) or res["gbuffer_min"] < 0.0
            or res["gbuffer_max"] > 1.0):
        raise AssertionError(f"gbuffer_views: {mosaic.shape}, "
                             f"[{res['gbuffer_min']}, {res['gbuffer_max']}]")
    if not tree.startswith("BVH2") or "BVH4" not in tree:
        raise AssertionError(f"bvh_print: {tree!r}")
    if res["no_bvh_pixels_close"] < 0.99 or any(
            imgs[False][1].values()):
        raise AssertionError("the render without a BVH differs from the "
                             "BVH render or launched a kernel")
    return res


VIEWER_SCRIPT = """\
frames 2
probe 128 160
mat color 0.9 0.2 0.2
snap
move 0.05 0 0.05
turn 3 1
frames 1
debug bvh
debug gbuffer
debug tree
camera save {d}/cam.json
camera load {d}/cam.json
materials save {d}/mats.json
snap
"""


def viewer_check(dev, directory, size=256):
    """Phase 13, [viewer]: a ViewerSession on the bathroom at size^2 on the
    card, with the FrameServer on 127.0.0.1 fetched by urllib."""
    import urllib.request
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.apps.viewer_cli import FrameServer, ViewerSession
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom

    api = RenderAPI.create("wavefront", RenderConfig(
        width=size, height=size, spp_per_pass=2, max_path_length=6),
        device=dev)
    api.scene, api.camera = bathroom(size, size)
    server = FrameServer(0)
    try:
        session = ViewerSession(api, os.path.join(directory, "frames"),
                                server=server)
        _zero_counts()
        t0 = time.perf_counter()
        session.run_script(VIEWER_SCRIPT.format(d=directory))
        secs = time.perf_counter() - t0
        launches = _counts()
        url = f"http://127.0.0.1:{server.port}"
        png = urllib.request.urlopen(url + "/frame.png", timeout=30).read()
        stats = urllib.request.urlopen(url + "/stats", timeout=30).read()
    finally:
        server.close()
    files = sorted(os.listdir(session.out_dir))
    want = [f"frame_{i:04d}.png" for i in range(5)] + [
        "debug_bvh_0004.png", "debug_gbuffer_0004.png"]
    with open(os.path.join(session.out_dir, "frame_0004.png"), "rb") as fh:
        last = fh.read()
    res = dict(seconds=secs, files=files, launches=launches,
               selected_material=session.selected_mat,
               png_is_last_frame=png == last, stats_bytes=len(stats),
               log=session.log)
    print("[viewer] " + json.dumps(res), flush=True)
    missing = [f for f in want if f not in files] + [
        f for f in ("cam.json", "mats.json")
        if not os.path.exists(os.path.join(directory, f))]
    if missing:
        raise AssertionError(f"viewer files missing: {missing}")
    if session.selected_mat < 0 or not res["png_is_last_frame"] \
            or b"render_time" not in stats:
        raise AssertionError("viewer: probe or FrameServer failed: "
                             + json.dumps(res))
    return res


def ai_check(dev, directory):
    """Phase 14, [ai]: ai_debugger_cli with its Cornell defaults on `dev`
    (the card), and on the CPU (16x16, 1 spp: the navmesh does not depend on the
    render) for the navmesh and the path."""
    import contextlib
    import io
    import numpy as np
    from lighthouse2_tpu_torch.apps import ai_debugger_cli
    from lighthouse2_tpu_torch.pathfinding.io import load_navmesh
    from lighthouse2_tpu_torch.utils.image import read_png

    out = {}
    for where, extra in (("card", ["--device", str(dev)]),
                         ("cpu", ["--device", "cpu", "--size", "16", "--spp",
                                  "1"])):
        png = os.path.join(directory, f"ai_{where}.png")
        nav = os.path.join(directory, f"ai_{where}.npz")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = ai_debugger_cli.main(["cornell", "-o", png,
                                       "--save-navmesh", nav] + extra)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(("navmesh:", "path:", "agent at"))]
        out[where] = dict(rc=rc, seconds=time.perf_counter() - t0,
                          lines=lines, png=png, nav=load_navmesh(nav))
    card, cpu = out["card"], out["cpu"]
    img = read_png(card["png"])
    same_mesh = all(np.array_equal(getattr(card["nav"], f),
                                   getattr(cpu["nav"], f))
                    for f in ("walkable", "region", "floor", "origin"))
    res = dict(rc=card["rc"], seconds=card["seconds"], lines=card["lines"],
               cpu_lines=cpu["lines"], png_shape=list(img.shape),
               navmesh_equal=same_mesh)
    print("[ai] " + json.dumps(res), flush=True)
    if card["rc"] != 0 or cpu["rc"] != 0 or img.shape != (256, 256, 3):
        raise AssertionError(f"ai_debugger_cli: {res}")
    if not same_mesh or card["lines"] != cpu["lines"] or len(
            card["lines"]) != 3:
        raise AssertionError("ai_debugger_cli: card and CPU navmesh or path "
                             f"differ: {res}")
    return res


def _bdpt_depths(cfg):
    """(eye, light) vertices a side of a BDPT pass (render/bdpt.py)."""
    from lighthouse2_tpu_torch.render.bdpt import EYE_DEPTH, LIGHT_DEPTH
    return (min(EYE_DEPTH, cfg.max_path_length),
            min(LIGHT_DEPTH, cfg.max_path_length))


def _bdpt_launches(cfg):
    """Kernel launches of one BDPT pass: a closest launch per walk step,
    an any-hit launch per connection batch and per lens batch."""
    s_e, s_l = _bdpt_depths(cfg)
    return dict(trace_closest=s_e + s_l - 1, trace_occluded=s_l * s_e + s_l)


def _capture_traces(fn, keep):
    """Run fn with the trace wrappers that render/wavefront.py calls
    recording the rays of the calls numbered in keep ({"closest": set,
    "occluded": set}, 0-based call order) and counting every call's live
    lanes (tmax > 0). Returns ({(kind, i): (o, d, tmax)}, {kind: calls},
    {kind: live lanes})."""
    import torch
    from lighthouse2_tpu_torch.render import wavefront as wf
    real = dict(closest=wf.trace_closest, occluded=wf.trace_occluded)
    calls = dict(closest=0, occluded=0)
    live = dict(closest=0, occluded=0)
    got = {}

    def recorder(kind):
        def call(o, d, tmax, bvh, **kw):
            i = calls[kind]
            calls[kind] += 1
            tm = torch.broadcast_to(torch.as_tensor(
                tmax, dtype=torch.float32, device=o.device), (o.shape[0],))
            live[kind] += int((tm > 0).sum())
            if i in keep[kind]:
                got[(kind, i)] = tuple(x.detach().clone().contiguous()
                                       for x in (o, d, tm))
            return real[kind](o, d, tmax, bvh, **kw)
        return call

    wf.trace_closest, wf.trace_occluded = recorder("closest"), recorder(
        "occluded")
    try:
        fn()
    finally:
        wf.trace_closest, wf.trace_occluded = real["closest"], real["occluded"]
    return got, calls, live


def kernels_on_batches(batches, bvh, dev, iters):
    """Both kernels against their plain BVH4 walk on every lane of each
    batch {name: (o, d, tmax)} (t, prim, u, v, occlusion and the per-ray
    counts), and their CUDA-event ms. Returns {name: numbers}."""
    import torch
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)

    out = {}
    for name, (o, d, tmax) in batches.items():
        got = trace_closest(o, d, tmax, bvh, stats=True)
        want = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
        ko, kst = trace_occluded(o, d, tmax, bvh, stats=True)
        wo, wst = wide_occluded(o, d, tmax, bvh, stats=True)
        lanes = [g == w for g, w in zip(got[:4], want[:4])] + [
            ko == wo, (got[4] == want[4]).all(0), (kst == wst).all(0)]
        out[name] = dict(
            rays=int(o.shape[0]), live=int((tmax > 0).sum()),
            hits=int((got[1] >= 0).sum()), occluded=int(ko.sum()),
            lanes_equal=torch.stack(lanes).all(0).float().mean().item(),
            closest_ms=_time_ms(lambda: trace_closest(o, d, tmax, bvh),
                                iters, dev),
            occluded_ms=_time_ms(lambda: trace_occluded(o, d, tmax, bvh),
                                 iters, dev))
    return out


def bdpt_path(host, cam, cfg, dev, passes):
    """Phase 15, [bdpt]: the bathroom through RenderAPI.create("bdpt") on
    the card; BDPT's own ray batches against the plain walk; one Disney
    pass. Returns the numbers."""
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI

    api = RenderAPI.create("bdpt", cfg, device=dev)
    api.scene, api.camera = host, cam
    t0 = time.perf_counter()
    api.render()                                  # sync + warm-up pass
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    per_pass, stats = [], []
    for _ in range(passes):
        before = _counts()
        stats.append(dict(api.render()))
        after = _counts()
        per_pass.append({k: after[k] - before[k] for k in after})
    peak = torch.cuda.max_memory_allocated(dev)
    img = api.get_image()
    render_s = sum(st["render_time"] for st in stats)
    rays = sum(st["total_rays"] for st in stats)
    res = dict(
        passes=passes, warmup_seconds=warm_s, render_seconds=render_s,
        ms_per_pass=[st["render_time"] * 1e3 for st in stats],
        mean_ms_per_pass=render_s * 1e3 / passes,
        mrays_per_s=rays / render_s / 1e6, rays=rays,
        extension_rays=stats[-1]["extension_rays"],
        connection_rays=stats[-1]["shadow_rays"],
        launches_per_pass=per_pass, want_launches=_bdpt_launches(cfg),
        max_memory_allocated=peak, image_mean=float(img.mean()),
        image_finite=bool(np.isfinite(img).all()))
    print("[bdpt] " + json.dumps(res), flush=True)
    res["profile"] = _profile(lambda: api.render(), dev, "[bdpt profile] ")

    # the kernels on BDPT's own batches: the first light-walk step (after
    # the eye walk's s_e closest calls), the (s=2, t=3) connection batch
    # and the s=2 lens batch (after the s_l * s_e connection batches)
    s_e, s_l = _bdpt_depths(cfg)
    names = {("closest", s_e): "light_walk_1",
             ("occluded", s_e + 1): "connection_s2_t3",
             ("occluded", s_l * s_e + 1): "lens_s2"}
    keep = dict(closest={s_e}, occluded={s_e + 1, s_l * s_e + 1})
    got, calls, live = _capture_traces(lambda: api.render(), keep)
    # the stats count every lane of every walk step (as JAX's do), dead or
    # not, and the unoccluded connections; these are the rays the kernels
    # traced on live lanes in this one pass
    res["live_rays"] = dict(live, total=sum(live.values()))
    res["live_mrays_per_s"] = (res["live_rays"]["total"]
                               / (res["mean_ms_per_pass"] * 1e3))
    print("[bdpt] live-lane rays of one pass: " + json.dumps(
        res["live_rays"]) + f", {res['live_mrays_per_s']:.3f} Mrays/s at the "
          "mean ms a pass", flush=True)
    batches = {names[k]: v for k, v in got.items()}
    res["batches"] = kernels_on_batches(batches, api.device_scene().bvh, dev,
                                        KERNEL_ITERS)
    res["captured_calls"] = calls
    print("[bdpt] BDPT's own batches: " + json.dumps(res["batches"]),
          flush=True)

    dapi = RenderAPI.create("bdpt", dataclasses.replace(cfg, bsdf="disney"),
                            device=dev)
    dapi.scene, dapi.camera = host, cam
    dapi.render()                                 # warm-up
    dst = dapi.render()
    dimg = dapi.get_image()
    res["disney"] = dict(ms=dst["render_time"] * 1e3,
                         mrays_per_s=dst["mrays_per_s"],
                         image_mean=float(dimg.mean()),
                         image_finite=bool(np.isfinite(dimg).all()))
    print("[bdpt] Disney: " + json.dumps(res["disney"]), flush=True)

    want = res["want_launches"]
    if any(p != want for p in per_pass) or {
            f"trace_{k}": v for k, v in calls.items()} != want:
        raise AssertionError(f"a BDPT pass must launch {want}, got "
                             f"{per_pass} and {calls}")
    if sorted(batches) != sorted(names.values()) or any(
            b["lanes_equal"] != 1.0 for b in res["batches"].values()):
        raise AssertionError("kernel and plain BVH4 walk differ on BDPT's "
                             "batches: " + json.dumps(res["batches"]))
    if not (res["image_finite"] and res["image_mean"] > 0):
        raise AssertionError("the BDPT image is not finite and positive")
    if not res["disney"]["image_finite"]:
        raise AssertionError("the Disney BDPT image is not finite")
    return res


def _dimmed_cornell(size):
    """tests/test_bdpt.py:62-66: the Cornell box with every non-emissive
    material at 0.48 of its colour."""
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    scene, cam = cornell_box(size, size)
    for i, m in enumerate(scene.materials):
        if max(m.color) <= 1.0:
            scene.materials[i] = m.replace(
                color=tuple(0.48 * c for c in m.color))
    return scene, cam


def bdpt_reference(dev, est_passes=BDPT_EST_PASSES):
    """Phase 16, [bdpt reference]: "bdpt" on the card against the CPU, and
    BDPT against the path tracer on the card (the end-to-end MIS check)."""
    import numpy as np
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render.bdpt import render_pass_bdpt
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass)
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    res = {}
    cfg = RenderConfig(width=16, height=16, spp_per_pass=1, max_path_length=8)
    for bsdf in ("lambert", "disney"):
        imgs = {}
        for where in (dev, torch.device("cpu")):
            api = RenderAPI.create("bdpt", dataclasses.replace(cfg, bsdf=bsdf),
                                   device=where)
            api.scene, api.camera = cornell_box(16, 16)
            for _ in range(2):
                api.render()
            imgs[where.type] = api.get_image()
        card, cpu = imgs[dev.type], imgs["cpu"]
        res[bsdf] = dict(
            pixels_close=float(np.isclose(card, cpu, rtol=1e-3, atol=1e-3)
                               .all(-1).mean()),
            mean_card=float(card.mean()), mean_cpu=float(cpu.mean()),
            finite=bool(np.isfinite(card).all()))

    scene, cam = _dimmed_cornell(16)
    ecfg = RenderConfig(width=16, height=16, spp_per_pass=8,
                        max_path_length=8, use_bvh=False,
                        clamp_fireflies=False)
    ds, view = scene.sync(dev, rebuild_bvh=False), cam.get_view(dev)
    out = {}
    for name, fn in (("pt", render_pass), ("bdpt", render_pass_bdpt)):
        t0 = time.perf_counter()
        st = AccumState.make(ecfg, dev)
        for _ in range(est_passes):
            st, _ = fn(ds, view, st, ecfg)
        out[name] = finalize(st).cpu().numpy()
        res[f"{name}_seconds"] = time.perf_counter() - t0
    pt, bd = out["pt"], out["bdpt"]
    res.update(mean_pt=float(pt.mean()), mean_bdpt=float(bd.mean()),
               mean_rel_diff=float(abs(bd.mean() - pt.mean()) / pt.mean()),
               mean_abs_diff_share=float(np.abs(bd - pt).mean()
                                         / (pt.mean() + 1e-9)),
               estimator_finite=bool(np.isfinite(bd).all()))
    print("[bdpt reference] " + json.dumps(res), flush=True)
    if res["lambert"]["pixels_close"] < 0.99:
        raise AssertionError("BDPT Lambert: card and CPU disagree")
    if (res["disney"]["pixels_close"] < BDPT_DISNEY_PIXELS_MIN
            or not res["disney"]["finite"]):
        raise AssertionError("BDPT Disney: card and CPU disagree")
    if not (res["estimator_finite"] and res["mean_rel_diff"] < 0.04
            and res["mean_abs_diff_share"] < 0.25):
        raise AssertionError("BDPT and the path tracer disagree: "
                             + json.dumps(res))
    return res


def parallel_path(host, cam, dev, size=512, path_len=16):
    """Phase 17, [parallel]: ray-data-parallel rendering with NCCL and one
    rank, against the unsharded classic pass and the single-process
    gradient. Returns the numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    from lighthouse2_tpu_torch.parallel.distributed import (
        collective_bytes_per_pass, global_mesh, init_distributed,
        measure_scaling)
    from lighthouse2_tpu_torch.parallel.mesh import (
        render_pass_sharded, train_step_sharded)
    from lighthouse2_tpu_torch.render.kernels.trace import BUILD_DIR
    from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    store = tempfile.mkdtemp(prefix="chip_smoke_dist_", dir=BUILD_DIR)
    try:
        world = init_distributed(f"file://{store}/store", world_size=1,
                                 rank=0, device=dev)
        res = dict(world_size=world, backend=dist.get_backend())
        if res["backend"] != "nccl":
            raise AssertionError(f"the card's group must be NCCL: {res}")
        mesh = global_mesh()
        cfg = RenderConfig(width=size, height=size, spp_per_pass=1,
                           max_path_length=path_len)
        scene, view = host.sync(dev), cam.get_view(dev)
        # the first collective sets up the NCCL communicator: untimed
        t0 = time.perf_counter()
        render_pass_sharded(scene, view, AccumState.make(cfg, dev), cfg, mesh)
        torch.cuda.synchronize(dev)
        res["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        runs = dict(sharded=[], unsharded=[])
        for kind in ("sharded", "unsharded", "unsharded", "sharded"):
            st = AccumState.make(cfg, dev)
            before = _counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if kind == "sharded":
                st, stats = render_pass_sharded(scene, view, st, cfg, mesh)
            else:
                st, stats = render_pass(scene, view, st, cfg)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            after = _counts()
            runs[kind].append(dict(
                ms=ms, acc=st.accumulator.cpu().numpy(),
                totals=[int(stats["total_extension"]),
                        int(stats["total_shadow"])],
                launches={k: after[k] - before[k] for k in after}))
        sh, un = runs["sharded"][0], runs["unsharded"][0]
        res.update(
            sharded_ms=[r["ms"] for r in runs["sharded"]],
            unsharded_ms=[r["ms"] for r in runs["unsharded"]],
            pixels_equal=float(np.isclose(sh["acc"], un["acc"], rtol=1e-6,
                                          atol=0.0).all(-1).mean()),
            totals=dict(sharded=sh["totals"], unsharded=un["totals"]),
            launches_per_sharded_pass=[r["launches"]
                                       for r in runs["sharded"]])

        # the gradient of the material colours on a 64x64 Cornell box
        tcfg = RenderConfig(width=64, height=64, spp_per_pass=1,
                            max_path_length=4)
        host_c, cam_c = cornell_box(64, 64)
        ds, cview = host_c.sync(dev), cam_c.get_view(dev)
        target = torch.zeros((64 * 64, 3), device=dev)
        insert = lambda s, c: set_material_fields(s, color=c)
        color = ds.materials.color.detach().clone().requires_grad_()
        st, _ = render_pass(insert(ds, color), cview,
                            AccumState.make(tcfg, dev), tcfg)
        loss1 = torch.mean((st.accumulator[:, :3] / float(tcfg.spp_per_pass)
                            - target) ** 2)
        (g1,) = torch.autograd.grad(loss1, color)
        loss_s, g_s = train_step_sharded(ds, cview, target, tcfg, mesh,
                                         insert, ds.materials.color)
        g1, g_s = g1.cpu().numpy(), g_s.cpu().numpy()
        res.update(loss=loss_s.item(), loss_single=loss1.item(),
                   grad_close=float(np.isclose(g_s, g1, rtol=1e-5,
                                               atol=1e-9).mean()),
                   grad_norm=float(np.linalg.norm(g1)))
        res["scaling"] = measure_scaling(scene, view, cfg, passes=2, warmup=1)
        res["collective_bytes"] = collective_bytes_per_pass(scene, view, cfg,
                                                            mesh)
        print("[parallel] " + json.dumps(res), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    if res["pixels_equal"] != 1.0 or sh["totals"] != un["totals"]:
        raise AssertionError("the sharded pass differs from the unsharded "
                             f"one: {res}")
    if (abs(res["loss"] - res["loss_single"]) > 1e-5 * abs(res["loss_single"])
            or res["grad_close"] != 1.0 or not res["grad_norm"] > 0):
        raise AssertionError(f"sharded gradients differ: {res}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from lighthouse2_tpu_torch.core.types import RenderConfig
        from lighthouse2_tpu_torch.render.kernels.trace import (
            BUILD_DIR, build_library)
        from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = _sh(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(f"[env] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    nvcc = os.environ.get("NVCC", "nvcc")
    try:
        print("[env] " + _sh([nvcc, "--version"]).splitlines()[-1], flush=True)
    except FileNotFoundError:
        print("[env] " + _sh(["/usr/local/cuda/bin/nvcc", "--version"])
              .splitlines()[-1], flush=True)

    t0 = time.perf_counter()
    so, log = build_library()
    print(f"[build] {so} in {time.perf_counter() - t0:.1f} s\n{log.strip()}",
          flush=True)

    size, path_len = 512, 16
    cfg = RenderConfig(width=size, height=size, spp_per_pass=1,
                       max_path_length=path_len, use_bvh=True, path_regen=True)
    host, cam = bathroom(size, size)
    trees = scene_trees(host, dev)
    scene = trees["two_level"]
    view = cam.get_view(dev)
    b, single = scene.bvh, trees["single_level_numpy"].bvh
    print(f"[scene] bathroom: {scene.tris.count} triangles, "
          f"{scene.materials.count} materials; default two-level tree "
          f"{b.nbox.shape[1]} BVH2 nodes (depth {b.depth}) in "
          f"{b.node4.shape[0]} BVH4 nodes (depth {b.depth4}); single-level "
          f"numpy tree {single.nbox.shape[1]} (depth {single.depth}) in "
          f"{single.node4.shape[0]} (depth {single.depth4})", flush=True)

    kern = check_kernels(scene, view, cfg, dev, KERNEL_ITERS, PLAIN_ITERS)
    single_ms = time_kernels(trees["single_level_numpy"], scene, view, cfg,
                             dev, KERNEL_ITERS)
    del trees
    print("[kernels] single-level numpy tree, same batches: "
          + json.dumps(single_ms), flush=True)
    main_res, state = main_path(scene, view, cfg, dev, passes=3)
    print(f"[main] {main_res['mrays_per_s']:.3f} Mrays/s on {card} "
          f"(bathroom {size}x{size}, path {path_len}, regen)", flush=True)
    lambert_prof = profile_pass(scene, view, cfg, state, dev)
    reference_check(dev)
    train_res, train_state = train_path(scene, view, cfg, dev, TRAIN_STEPS)
    profile_train_step(scene, view, cfg, train_state, dev)
    grad_reference_check(dev)

    disney_res, api = disney_path(cfg, dev, DISNEY_PASSES)
    lambert_api = lambert_api_path(host, cam, cfg, dev, DISNEY_PASSES)
    print(f"[disney] {disney_res['mrays_per_s']:.3f} Mrays/s, "
          f"{disney_res['mean_ms_per_pass']:.1f} ms/pass on {card} (bathroom "
          f"{size}x{size}, path {path_len}, regen, Disney, IBL; Lambert "
          f"through RenderAPI {lambert_api['mrays_per_s']:.3f} Mrays/s, "
          f"{lambert_api['mean_ms_per_pass']:.1f} ms/pass; wall ratio "
          f"{disney_res['mean_ms_per_pass'] / lambert_api['mean_ms_per_pass']:.3f}"
          f")", flush=True)
    disney_prof = _profile(lambda: api.render(), dev, "[disney profile] ")
    print("[disney profile] beside Lambert: " + json.dumps(dict(
        device_ms=dict(disney=disney_prof["device_ms"],
                       lambert=lambert_prof["device_ms"]),
        wall_ms=dict(disney=disney_prof["wall_ms"],
                     lambert=lambert_prof["wall_ms"]),
        device_busy_share=dict(disney=disney_prof["device_busy_share"],
                               lambert=lambert_prof["device_busy_share"]),
        kernel_ms_per_launch=dict(
            disney=disney_prof["kernel_ms_per_launch"],
            lambert=lambert_prof["kernel_ms_per_launch"]))), flush=True)
    disney_train = disney_train_step(api, dev)
    grad_reference_check(dev, disney=True)
    golden_check(dev)

    anim_dir = tempfile.mkdtemp(prefix="chip_smoke_anim_", dir=BUILD_DIR)
    try:
        anim = anim_path(cfg, dev, ANIM_FRAMES, anim_dir)
        print(f"[anim] {anim['triangles']} triangles, {ANIM_FRAMES} frames: "
              f"{anim['mean_render_ms']:.1f} ms render + "
              f"{anim['mean_sync_seconds'] * 1e3:.1f} ms host sync a frame, "
              f"{anim['mean_mrays_per_s']:.3f} Mrays/s in the render on "
              f"{card}", flush=True)
        cli_check(os.path.join(anim_dir, "anim.gltf"),
                  os.path.join(anim_dir, "cli.png"))
    finally:
        shutil.rmtree(anim_dir, ignore_errors=True)

    filt = filter_path(host, cam, dev, FILTER_FRAMES)
    print(f"[filter] {filt['mean_frame_ms']:.1f} ms a frame = "
          f"{filt['mean_pass_ms']:.1f} ms render_pass + "
          f"{filt['mean_filter_ms']:.1f} ms filter on {card} (bathroom "
          f"{size}x{size}, spp 1, path {path_len}, classic, TAA); filter "
          f"alone {filt['filter_alone']['ms']:.2f} ms, "
          f"{filt['filter_alone']['device_launches']} device launches; "
          f"history kept on >= {filt['min_history_share']:.1%} of pixels",
          flush=True)
    filter_reference(dev)
    probe_res = probe_path(scene, cam, dev)
    app_dir = tempfile.mkdtemp(prefix="chip_smoke_apps_", dir=BUILD_DIR)
    try:
        viewer = viewer_check(dev, app_dir)
        ai_check(dev, app_dir)
    finally:
        shutil.rmtree(app_dir, ignore_errors=True)

    bcfg = dataclasses.replace(cfg, path_regen=False)
    bdpt = bdpt_path(host, cam, bcfg, dev, BDPT_PASSES)
    print(f"[bdpt] {bdpt['mean_ms_per_pass']:.1f} ms a pass, "
          f"{bdpt['mrays_per_s']:.3f} Mrays/s by the stats (every walk "
          f"lane, dead or not), {bdpt['live_mrays_per_s']:.3f} Mrays/s of "
          f"live-lane rays, peak "
          f"{bdpt['max_memory_allocated'] / 1e9:.3f} GB on {card} (bathroom "
          f"{size}x{size}, spp 1, path {path_len}, Lambert); "
          f"{bdpt['profile']['device_ms']:.1f} ms of device time, "
          f"{bdpt['profile']['device_launches']} device launches; Disney "
          f"{bdpt['disney']['ms']:.1f} ms", flush=True)
    bdpt_reference(dev)
    par = parallel_path(host, cam, dev, size, path_len)
    print(f"[parallel] sharded {min(par['sharded_ms']):.1f} ms, unsharded "
          f"{min(par['unsharded_ms']):.1f} ms a pass on {card} (one NCCL "
          f"rank, bathroom {size}x{size}, classic, path {path_len}); "
          f"{par['collective_bytes']['total_bytes']} bytes all-reduced a "
          "pass", flush=True)

    rows = []
    for name, batch, line, sym, key in (
            ("trace_closest", "bounce1", 229, "closest_kernel", "closest_ms"),
            ("trace_occluded", "shadow", 414, "occluded_kernel",
             "occluded_ms")):
        k = kern[name][batch]
        rows.append(dict(
            name=name, route="cuda", source="lighthouse2_tpu_torch/csrc/trace.cu",
            replaces=f"lighthouse2_tpu/render/kernels/trace.py:{line}",
            launches=main_res["launches"][name],
            launches_fwd_bwd_per_step=train_res["launches_per_step"][name],
            launches_disney_per_pass=disney_res["launches"][name]
            // DISNEY_PASSES,
            launches_disney_fwd_bwd_step=disney_train["launches"][name],
            launches_anim_per_frame=[f["launches"][name]
                                     for f in anim["frames"]],
            launches_filter_per_frame=[f["launches"][name]
                                       for f in filt["frames"]],
            launches_probe=dict(
                heatmap=probe_res["launches_heatmap"][name],
                probe_pixel_grid=probe_res["launches_probe_grid"][name],
                gbuffer_views=probe_res["launches_gbuffer"][name],
                viewer_session=viewer["launches"][name]),
            launches_bdpt_per_pass=bdpt["launches_per_pass"][-1][name],
            launches_sharded_per_pass=par["launches_per_sharded_pass"][-1][
                name],
            bdpt_batch_ms={bt: b[key] for bt, b in bdpt["batches"].items()},
            main_path_ms_per_launch=dict(
                lambert=lambert_prof["kernel_ms_per_launch"][sym],
                disney=disney_prof["kernel_ms_per_launch"][sym],
                bdpt=bdpt["profile"]["kernel_ms_per_launch"][sym]),
            max_abs_err=k["max_abs_err"],
            ms_by_batch={bt: kern[name][bt]["ms"] for bt in kern[name]},
            single_level_ms={bt: single_ms[bt][key]
                             for bt in single_ms},
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
