#!/usr/bin/env python3
"""Smoke run of lighthouse2_tpu_torch, the PyTorch + CUDA port, on one GPU.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (nvcc on PATH or under /usr/local/cuda):

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:
  1. the card, torch / CUDA / nvcc versions; build csrc/trace.cu,
     csrc/cluster_trace.cu and csrc/shade.cu with nvcc for sm_90a, one
     nvcc each, started together, and print their -Xptxas -v reports;
  2. [scene] the full bathroom (129,252 triangles, 21 instances of 20
     meshes) synced three ways: single-level over all world triangles with
     the numpy builder (the port's tree before the two-level default)
     and with the native one,
     then the two-level tree (a TLAS over native per-mesh BLASes) with
     the cluster tiles of phase 19 (sync(clusters=True)) and last without
     them, the default HostScene.sync; for each, BVH2 and BVH4 nodes,
     depths and MB, and the host seconds by step (pose, BLAS builds,
     compose, tables, textures, BVH4 pack, cluster cut, upload). Every
     later phase runs on the default tree. [kernels] both trace kernels on the default tree for the 512x512
     primary rays, the bounce-1 rays of one shade_bounce and that bounce's
     NEE shadow batch, against two references: their plain version, the
     BVH4 walk of bvh/wide.py (t, prim, u, v, occlusion and the per-ray
     counts equal on every lane), and the BVH2 walk of bvh/traverse.py (prim
     and occlusion on >= 99.99% of lanes); CUDA-event times of kernel and
     plain version, Grays/s, and the bound computed from the BVH2 walk's
     counts; then both kernels' times on the numpy single-level tree for
     the same three batches; [shade kernel] the Lambert shade kernel
     (262,144 lanes, the triangle gathers) against the composed code at the
     pass's first bounce and at a bounce one pass in (render/kernels/
     shade.py agreement: each output's share of lanes off), and its ms at
     the first bounce (CUDA events over SHADE_ITERS launches) beside its
     byte bound (_shade_bytes) and the composed code's eager ms; then the
     Disney shade kernel the same way on the bathroom under the benchmark's
     Disney materials (disney_bathroom), and [disney kernel] that
     scene's forward passes as phase 3 runs them, under its launch gates
     (16 Disney shade kernels a replay);
  3. the main path: bathroom 512x512, path 16, path regeneration, through
     render_pass_auto (the regen executor), every graph entry point's
     graph freed first — 2 warm-ups (eager, then the CUDA graph's
     capture), 3 timed passes and one profiled; Mrays/s (extension +
     shadow rays), per-bounce ray counts, peak memory, the image; the
     launch gates of _replay_gates: each warm-up launches each kernel 16
     times through its wrapper, every later pass replays the graph and
     launches none through them, and the profiled replay runs 16
     closest-hit, 16 any-hit and 16 shade kernels by the profiler's count
     (a call that needs gradients, the filter or IBL sky NEE, as the
     [disney] phase's, runs no shade kernel: their gates want 0; a forward
     Disney pass would run 16 of the Disney kernel);
  4. a 64x64 Cornell box rendered on the card and on the CPU (plain
     versions), compared per pixel;
  5. [train] the fwd+bwd headline (bench.py:291-297): bathroom 512x512,
     path 16, regen, remat, through diff.render.regen_value_and_grad with
     material colours [12,3], area-light radiance [LT,3] and per-vertex
     offsets [129252,3,3] (zeros) as parameters and a zero target;
     2 warm-ups, 2 timed steps and one profiled (device ms, busy share,
     top device ops); fwd+bwd Mrays/s (rays of one forward stats pass,
     bench.py:129-134), ms per step, peak memory, the launch gates of
     phase 3 (16 launches of each kernel a warm-up step: both traces stay
     outside the recomputed region), each gradient group's norm (all
     finite, each group nonzero); one step without remat for its peak
     memory; then a 64x64 Cornell box, path 4, regen, fwd+bwd on the card and
     on the CPU, gradients compared per group by relative L2 error
     (GRAD_RTOL, the bounds of tests/test_torch_grad.py);
  6. [disney] the bathroom 512x512 (129,252 triangles) with the golden
     16x32 gradient sky, bsdf="disney", sky_ibl=True, path 16, regen,
     created and driven through RenderAPI.create("wavefront", ...,
     device=card): 2 warm-ups, 3 timed api.render() calls and one
     profiled (printed beside the Lambert pass of phase 3); Mrays/s, ms
     per pass (core.stats["render_time"]), peak memory, the launch gates
     of phase 3, the image (finite, mean > 0) and get_ldr_image (finite,
     in [0, 1]); the Lambert scene of phase 3 driven the same way through
     RenderAPI, so both ms per pass have one definition; then two
     warm-ups, one timed and one profiled fwd+bwd step of
     regen_value_and_grad with remat and the parameter groups of [train]
     (the launch gates of phase 3; each gradient group finite and
     nonzero), and the 64x64 Cornell
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
     the two posed meshes, and 1 compose) and 16 + 16 kernel launches
     through the wrappers (a re-synced frame's tree has new shapes, so the
     pass runs eagerly and replays no graph); on
     the last frame both kernels equal their plain BVH4 walk on every lane
     of its three batches; the image finite with mean > 0;
  9. [cli] apps/render_cli.main on that glTF at 256x256, 2 spp, on the
     card: returns 0 and writes a PNG that reads back at (256, 256, 3);
 10. [filter] the bathroom 512x512 through RenderAPI.create(
     "wavefront_filter") (classic executor, spp 1, path 16, Lambert, TAA):
     2 warm-ups and FILTER_FRAMES frames, the camera moving FILTER_MOVE and
     turning FILTER_TURN a frame; per frame the ms of the pass and of
     the filter (SVGF + TAA + unsharpen), each closed by a synchronize, the
     share of pixels whose history survived reprojection (must be > 0),
     the image (finite); peak memory; a profiled frame; the launch gates
     of phase 3 (the core's render_pass_auto runs render_pass_unrolled on
     the card: each kernel once a bounce, live or not); the filter alone on
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
     the group destroyed at the end;
 18. [scene shard] scene-sharded rendering (parallel/scene_shard.py).
     (a) init_distributed with NCCL, world size 1, a 1x1 mesh: the bathroom
     512x512, classic, spp 1, path 16 through render_pass_scene_sharded
     (its one shard's numpy tree built first, timed) against the unsharded
     classic render_pass, one untimed pass, then sharded, unsharded,
     unsharded, sharded: pixels off < FRAC_BAD_MAX and mean relative error
     < MEAN_REL_MAX (__graft_entry__.py:108-119: the two passes walk
     different trees, so only t-ties may differ), stats totals within
     TIE_SHARE, 16 + 16 kernel launches a sharded pass; peak memory, the
     shard's bytes against the replicated triangles and tree, the bytes the
     collectives take a pass by axis, one profiled pass; both kernels on an
     empty shard's one-leaf tree (every primary ray a miss, as in the plain
     walk); the 1x1 gradient
     step of a SHARD_GRAD_SIZE^2 Cornell box (material colours, per-vertex
     offsets). (b) this script started SHARD_MESH[0] * SHARD_MESH[1] times
     as the gloo ranks of a SHARD_MESH mesh whose tensors all lie on
     cuda:0 (NCCL refuses two ranks on one card; gloo stages each
     collective through the host, so its time is not NCCL's cost), a
     file:// store under build/, joined within SHARD_JOIN_TIMEOUT: each
     rank cuts its shard and builds its tree from the bathroom on the
     host, one untimed and SHARD_PASSES timed passes (ms the slowest
     rank's), 16 + 16 launches a pass on every rank, per-rank peak memory
     and shard bytes; the image within the bounds of (a) against the
     unsharded pass, and the Cornell step's loss within rtol 1e-5 and
     gradients (the per-shard vertex gradients mapped back through gid)
     within rtol 1e-4 / atol 1e-6 of the largest of (a)'s 1x1 step, both
     shards' vertex gradients nonzero.
 19. [cluster] intersector="cluster": the ClusterBVH (cut from the default
     tree by a sync asked for it, here and nowhere earlier) traced by csrc/cluster_trace.cu's two kernels.
     (a) both kernels on [kernels]' three batches, each in the executor's
     order (primaries as they come, bounce-1 rays sorted by ray_sort_perm
     "dir", shadow rays by "origin_octant"), against their plain versions
     on every lane of every block (the kernels' forms are 3xTF32 tensor-
     core products, the plain versions' FP32 terms: code and occlusion
     equal on >= AGREE_MIN of the lanes, t's mean relative error on the
     agreeing hits <= T_MEAN_REL_MAX, the per-block visit and sub-packet
     counters equal on >= COUNTERS_MIN of the live blocks; the plain walk
     takes 2-13 s a batch on the card) and against the BVH4 kernels (prim
     and occlusion on >= AGREE_MIN of the lanes); CUDA-event ms over
     KERNEL_ITERS launches, the plain version's wall ms, and the bound of
     the same work as the BVH4 rows (the BVH2 walk's counted operations,
     the BVH2 arrays and rays read once, the kernel's outputs written
     once); both kernels must hold two CTAs (1024-ray blocks) an SM; from
     one more launch with the kernels' statistics, the tile
     bytes copied and the share of them copied for leaves with no marked
     sub-packet, the marked (sub-packet, tile) pairs, the evaluated
     (sub-packet, 16-ray row group, tile) units (their mean and largest
     count a block, as the leaves': a launch lasts as long as its slowest
     block), and the design's own floor: its evaluated (ray, triangle) pairs' FORM_TF32_OPS over the
     TF32 peak and EPILOGUE_FP32_OPS over the FP32 peak, printed beside
     the common bound. (a') the same gates on a tiles_per_cluster 2 cut of
     the tree (cut_clusters(min_tpc=2)), the first TPC2_BLOCKS blocks of
     each batch: the kernels' path for clusters of several tiles; [shade
     kernel] as in phase 2, on the cluster payload. (b) the bathroom 512x512,
     path 16, regen through render_pass_auto: 2 warm-ups, CLUSTER_PASSES
     timed passes and one profiled, the launch gates of phase 3 with the
     cluster kernels (the BVH4 kernels never launch); Mrays/s, ms a pass,
     peak memory; the image against the "auto" passes of the same run
     (FRAC_BAD_MAX, MEAN_REL_MAX: the two structures differ only in exact
     t-ties). (c) two warm-ups, one timed and one profiled fwd+bwd step of
     regen_value_and_grad (grads "all", remat) on the cluster path: ms,
     peak memory, the launch gates of (b); loss within LOSS_RTOL and each
     gradient group within
     GRAD_RTOL (relative L2, tests/test_torch_grad.py's bounds) of the
     "auto" step from the same state; the device-time share of the
     re-attach backward (index_add_) beside the gather backward's share of
     [train profile]'s "auto" step. (d) the 64x64 Cornell box of phase 4
     on the card and on the CPU under "cluster", every pixel compared.
     (e) one BDPT pass of the bathroom (classic, spp 1, path 16) and one
     scene-sharded pass on a 1x1 NCCL mesh (path CLUSTER_SHARD_PATH)
     under "cluster", each against its "auto" counterpart (FRAC_BAD_MAX,
     MEAN_REL_MAX), launching only the cluster kernels.
 20. [executors] the JAX package's executor entry points on the default
     tree: the bathroom 512x512, spp 1, path 16, Lambert, "auto" (BVH4).
     (a) one pass from a fresh state through each of EXEC_FORMS
     (render_pass, render_pass_jit, render_pass_staged,
     render_pass_unrolled and render_pass_auto with a classic config,
     render_pass_regen and render_pass_auto with path_regen=True), every
     graph freed and the launch counts set to 0 before each and read
     after; the forms that
     read nothing back run it under torch.cuda.set_sync_debug_mode(
     "error"), so any host synchronisation raises. Gates: every image
     equal to its family's reference (render_pass, render_pass_regen) on
     every pixel (pixel counts too for regen), the per-bounce ray counts
     and samples_completed equal, each kernel launched once a bounce with
     a live lane (16 + 16). (b) per form: wall ms a pass (after (a) and
     one more pass, where a graph entry point captures, EXEC_PASSES timed,
     the clock stopped after a synchronize), device ms, busy share,
     device launches and kernels by name of one profiled pass (a graph
     form's timed and profiled passes pass the launch gates of phase 3,
     an eager form replays nothing), and the host
     synchronisations of one more (set_sync_debug_mode("warn")). (c)
     [staged profile]: one profiled render_pass_staged, the device ms of
     each stage summed over the bounces, from its record_function range,
     and its share of the pass's device time.
 21. [graphs] the three entry points render/graphs.py captures as CUDA
     graphs (the counterpart of jax.jit), at the main path's
     configuration: (a) for the regen pass on "auto", the unrolled pass on
     "auto" and the regen pass on "cluster" (the tiles of phase 19): from
     one state, GRAPH_PASSES passes through the eager body
     (render/wavefront.py _regen_pass / _unrolled_pass) and GRAPH_PASSES
     calls of the entry point (warm-up, capture, replays), every result
     equal bit for bit (accumulator, pixel counts, pool, cam_seed,
     sample_count, stats); GRAPH_TIMED timed passes of each (wall ms,
     medians), one replay under set_sync_debug_mode("error"), one of each
     profiled (device ms, device launches), the launch gates of phase 3
     over every call, the busy share (the profiled pass's device ms over
     the median wall, and over its own profiled wall); the seconds of the
     capture and of the instantiation (with the end of the capture), the
     pool's reserved bytes, peak memory of the eager and the graph run.
     (b) on the live regen graph: a moved camera and new material colours
     replay, each equal to its eager pass; a Cornell box (other shapes)
     takes a new key and runs eagerly. (c) the fwd+bwd step (grads "all",
     remat) on "auto" and on "cluster": GRAPH_PASSES eager steps
     (diff/render.py fb_pass) against GRAPH_PASSES calls of
     regen_value_and_grad, then GRAPH_OPT_STEPS replays between which
     torch.optim.Adam steps the parameter leaves in place, each against
     fb_pass on the same inputs: loss and state bit-equal, each gradient
     group equal or within the spread of eager steps from the same inputs
     (GRAPH_SPREAD_STEPS); ms a step and fwd+bwd Mrays/s eager and
     replayed, device ms, capture and instantiation, peak memory, the
     launch gates of phase 3.
Since the graphs, the earlier phases' calls of render_pass_auto (regen,
and classic on the card), render_pass_regen, render_pass_unrolled, the
cores' passes and regen_value_and_grad run eagerly at the first call with
a key and replay a graph from the second (its capture inside that call).
A kernel's wrapper counts its launches in the eager call and in the
capture, never in a replay, which runs the graph's kernels without it:
the launch gates read which kind each call was from the wrappers' counts
and the graph replays, and count a replay's kernels by name with the
profiler.
It then prints one JSON line of per-kernel numbers (the two BVH4 kernels
and the two cluster kernels), the card's name and power limit, and last
the result line {"ok": true, "device": {...}}.
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
from concurrent.futures import ThreadPoolExecutor

KERNEL_ITERS = 20          # timed launches per kernel and batch
PLAIN_ITERS = 3            # timed calls per plain version and batch
AGREE_MIN = 0.9999         # fraction of lanes that must agree
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, FP32 outside tensor
# cores, dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
SHADE_KERNEL = "shade_bounce_kernel"   # csrc/shade.cu, by the profiler's name
SHADE_DISNEY_KERNEL = "shade_disney_kernel"   # its Disney kernel
SHADE_ITERS = 20           # timed launches of the shade kernel
SHADE_PLAIN_ITERS = 3      # timed calls of the composed shade stage
# the triangle rows the shade kernel gathers (scene.tris, by the hit prim)
# and the payload rows it reads (csrc/shade.cu shading_data): of the 38
# geometry rows all but v0, prim, mat and valid; of the 28 material rows
# colour, absorption, roughness, transmission, eta, flags and the texture
# ids
SHADE_TRI_ROWS = ("n0", "n1", "n2", "face_n", "uv0", "uv1", "uv2", "alpha",
                  "area", "lod", "tangent", "bitangent", "mat", "ltri")
SHADE_PAY_ROWS = 38 - 6 + 15
# the Disney kernel reads every material row of the payload (its twelve
# more fields and four more texture ids); on the gathers they come from the
# material table, which neither bound counts
SHADE_PAY_ROWS_DISNEY = 38 - 6 + 28
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# [cluster] (a): the cluster kernels (3xTF32 forms) against their plain
# versions (FP32 terms): t's mean relative error on the lanes whose hit
# agrees (3xTF32 keeps ~21 of FP32's 24 bits a product), the share of live
# blocks whose visit and sub-packet counters must be equal (a last-bit
# difference in a best t can move a sub-packet mark)
T_MEAN_REL_MAX = 1e-6
COUNTERS_MIN = 0.999
# the cluster kernels' work a (ray, triangle) pair: three TF32 products of
# depth 4 for each of the six forms (2 operations a multiply-add), and the
# FP32 epilogue (t = tn / dn counted as one, u and v two each, u + v, five
# tests, the running minimum's compare)
FORM_TF32_OPS = 3 * 6 * 4 * 2
EPILOGUE_FP32_OPS = 12
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
SHARD_MESH = (2, 2)        # ("rays", "scene") of [scene shard] (b)
SHARD_PASSES = 2           # timed passes of each [scene shard] (b) rank
SHARD_JOIN_TIMEOUT = 300   # seconds for the (b) ranks together
SHARD_GRAD_SIZE = 64       # Cornell box side of the [scene shard] gradient
FRAC_BAD_MAX = 5e-3        # __graft_entry__.py:118, pixels off
MEAN_REL_MAX = 1e-4        # __graft_entry__.py:118, mean relative error
TIE_SHARE = 1e-3           # stats totals: a t-tie may change a winner
CLUSTER_PASSES = 3         # timed passes of [cluster] (b)
TPC2_BLOCKS = 32           # 1024-ray blocks a batch of [cluster] (a')
CLUSTER_SHARD_PATH = 4     # path length of [cluster] (e)'s scene-sharded pass
LOSS_RTOL = 1e-4           # tests/test_torch_grad.py: the loss, relative
EXEC_PASSES = 3            # timed passes of each [executors] form
# [executors]: (label, render/wavefront.py entry point, classic or regen
# config, whether it reads back from the device: only render_pass and
# render_pass_jit do, one bool a bounce; whether it runs a captured graph
# from its second call)
EXEC_FORMS = (("render_pass", "render_pass", "classic", True, False),
              ("render_pass_jit", "render_pass_jit", "classic", True, False),
              ("render_pass_staged", "render_pass_staged", "classic", False,
               False),
              ("render_pass_unrolled", "render_pass_unrolled", "classic",
               False, True),
              ("render_pass_auto", "render_pass_auto", "classic", False,
               True),
              ("render_pass_regen", "render_pass_regen", "regen", False,
               True),
              ("render_pass_auto_regen", "render_pass_auto", "regen", False,
               True))
EXEC_REFERENCE = dict(classic="render_pass", regen="render_pass_regen")
EXEC_STAGES = ("_stage_generate", "_stage_prepare", "_stage_trace",
               "_stage_shade", "_stage_occlude", "_stage_apply",
               "_stage_finish")
# device-time shares of a fwd+bwd step: the cluster path's re-attach
# backward (index_add_) and the gather backward
TRAIN_SHARES = dict(reattach_index_add="indexFunc",
                    gather_backward="indexing_backward")
GRAPH_PASSES = 4           # [graphs]: passes (steps) held eager against graph
GRAPH_TIMED = 5            # [graphs]: timed passes (steps) of each, medians
GRAPH_MOVE = (0.05, 0.0, 0.02)   # [graphs] (b): camera translation (metres)
# [graphs] (c): eager steps from each compared graph step's inputs, where
# its gradients are not bit-equal (the cluster path's re-attach backward
# sums with atomics, so two eager steps differ in the last bits): the graph
# step must lie no farther from the nearest of its eager steps than the
# farthest two eager steps from one input are apart, over every compared
# step's inputs (the spread). Were each graph step one more eager step,
# that gate fails in none of 300 simulated runs of 6 compared steps
# (independent Gaussian noise on 400,000 entries) with 5 eager steps an
# input, in 4 with 3. 3 are taken first and 5 only where 3 do not hold
# the graph step: more eager steps can only widen the spread and bring
# the nearest nearer, so the verdict is that of 5. Then the replays
# between which torch.optim.Adam steps the parameter leaves in place, and
# its learning rate
GRAPH_SPREAD_STEPS = (3, 5)
GRAPH_OPT_STEPS = 2
GRAPH_OPT_LR = 1e-3
# the entry points render/graphs.py captures (_captured)
GRAPH_ENTRIES = ("render_pass_unrolled", "_render_pass_regen_jit",
                 "regen_value_and_grad")
# the numbers of each [graphs] run on its summary line
GRAPH_SUMMARY = ("wall_ms_eager", "wall_ms_replay", "ms_step_eager",
                 "ms_step_replay", "mrays_per_s_eager", "mrays_per_s_replay",
                 "device_ms_eager", "device_ms_replay", "busy_eager",
                 "busy_replay", "launches_eager", "launches_replay",
                 "replay_kernels", "capture_seconds", "instantiate_seconds",
                 "pool_reserved_bytes", "peak_eager", "peak_graph")


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


def _shade_inputs(scene, view, cfg, state, pool):
    """The shade stage's inputs at the next bounce of `pool` (a regen
    pool of `state`): dead lanes regenerated, traced and refined, as a
    bounce of trace_paths_regen. (args of shade_kernel, payload)."""
    import torch
    from lighthouse2_tpu_torch.render import wavefront as wf
    paths, depth, _ = wf.regenerate(view, cfg, *pool)
    *hit, payload = wf._intersect(scene, paths["origin"], paths["dir"],
                                  paths["alive"], cfg,
                                  wf.prepare_cluster_pay(scene, cfg))
    acc = torch.zeros((cfg.n_paths, 4), device=depth.device)
    return (scene, view, cfg, paths, acc, state.cam_seed, depth, *hit), payload


def _shade_bytes(args, out, payload):
    """The bytes the shade kernel must move at the least for the lanes of
    `args` (shade_kernel's arguments; `out` the outputs _args allocated):
    each lane's state, hit and depth in, its new state and shadow ray out,
    and its triangle's rows (gathers) or the payload rows it reads
    (SHADE_TRI_ROWS; SHADE_PAY_ROWS, SHADE_PAY_ROWS_DISNEY for the Disney
    kernel). Not counted: texels, lights, the material table (a few KB,
    gathered by the triangle's material id)."""
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
    return cfg.n_paths * (lane_in + lane_out + rows), dict(
        lane_in=lane_in, lane_out=lane_out, rows=rows)


def shade_kernel_check(scene, view, cfg, dev, iters=SHADE_ITERS):
    """[shade kernel]: on cfg's intersector (gathers on "auto", the payload
    on "cluster") and BSDF (the Lambert or the Disney kernel), at 262,144
    lanes at 512x512: the kernel through its
    wrapper against the composed code (_shade_composed) on the same inputs
    at the pass's first bounce (a fresh regen pool) and at a bounce one
    pass in, where the lanes stand at many path depths, held to
    render/kernels/shade.py agreement (AGREE_MIN, OFF_MAX; raises past
    them); at the first bounce the kernel's ms (CUDA events over `iters`
    launches of one set of arguments, so that the wrapper's host time is
    not counted) beside its byte bound (_shade_bytes) and the composed
    code's ms (eager, host-bound), and the launches one call of the
    wrapper made. Returns the numbers."""
    import ctypes
    import torch
    from lighthouse2_tpu_torch.render import wavefront as wf
    from lighthouse2_tpu_torch.render.kernels import shade as shade_k

    n = cfg.n_paths
    disney = cfg.bsdf == "disney"
    count = lambda: (shade_k.shade_kernel.disney_launches if disney
                     else shade_k.shade_kernel.launches)
    res = dict(intersector=cfg.intersector, bsdf=cfg.bsdf, lanes=n)
    with torch.no_grad():
        state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, dev),
                                      cfg)
        mid = wf.trace_paths_regen(scene, view, cfg, state)[3]
        for name, pool in (("bounce0", state.pool), ("one_pass_in", mid)):
            args, payload = _shade_inputs(scene, view, cfg, state, pool)
            if not shade_k.use_kernel(*args[:5], args[7:], payload):
                raise AssertionError(f"[shade kernel] the rule did not pick "
                                     f"the kernel for a forward {cfg.bsdf} "
                                     f"bounce")
            want = wf._shade_composed(*args, payload=payload)
            before = count()
            got = shade_k.shade_kernel(*args, payload=payload)
            launches = count() - before
            off, agree = shade_k.agreement(want, got)
            res[name] = dict(agree=agree, depths=int(args[6].max()),
                             launches=launches, off=off)
            if name == "bounce0":
                first = args, payload
        del want, got, mid
        args, payload = first
        res["rows"] = "gathers" if payload is None else "payload"
        launch_args, out, keep = shade_k._args(*args, payload)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = shade_k._load()
        launch = lib.lh2_shade_disney if disney else lib.lh2_shade_bounce
        kern = _time_ms(lambda: shade_k._check_rc(launch(
            ctypes.byref(launch_args), stream), "shade_kernel"), iters, dev)
        plain = _time_ms(lambda: wf._shade_composed(*args, payload=payload),
                         SHADE_PLAIN_ITERS, dev)
        n_bytes, per_lane = _shade_bytes(args, out, payload)
    bound, by = _bound(n_bytes, 0)
    res.update(ms=kern, bound_ms=bound, bound_by=by,
               share_of_bound=bound / kern, bytes=n_bytes,
               bytes_per_lane=per_lane, composed_eager_ms=plain)
    print("[shade kernel] " + json.dumps(res), flush=True)
    bad = []
    for name in ("bounce0", "one_pass_in"):
        r = res[name]
        if r["launches"] != 1:
            bad.append(f"{name}: {r['launches']} launches by one call, "
                       "want 1")
        if r["agree"] < shade_k.AGREE_MIN:
            bad.append(f"{name}: branches agree on {r['agree']:.6f} of the "
                       f"lanes, want >= {shade_k.AGREE_MIN}")
        bad += [f"{name}: {k} off on {v:.6f} of the lanes, want <= "
                f"{shade_k.OFF_MAX}" for k, v in r["off"].items()
                if v > shade_k.OFF_MAX]
    if bad:
        raise AssertionError("[shade kernel] " + "; ".join(bad))
    return res


def disney_bathroom(cfg, dev):
    """The bathroom under the benchmark's Disney materials (configuration
    bathroom-512-disney, benchmark/scenes/bathroom_disney.py) at cfg's size
    and path length, synced to `dev`: (scene, view, its config)."""
    from benchmark import harness
    with open(os.path.join(harness.ROOT, "benchmark", "configs",
                           "bathroom-512-disney.json")) as fh:
        conf = dict(json.load(fh), width=cfg.width, height=cfg.height,
                    max_path_length=cfg.max_path_length)
    raw = harness.load("scenes", conf["scene"]).build(conf)
    scene, view, _ = harness.build_program_scene(raw, conf, dev)
    return scene, view, harness.render_config(conf)


def _counts():
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    return dict(trace_closest=trace_closest.launches,
                trace_occluded=trace_occluded.launches)


def _cluster_counts():
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        cluster_closest, cluster_occluded)
    return dict(cluster_closest=cluster_closest.launches,
                cluster_occluded=cluster_occluded.launches)


def _shade_count():
    from lighthouse2_tpu_torch.render.kernels.shade import shade_kernel
    return dict(shade_kernel=shade_kernel.launches,
                shade_disney=shade_kernel.disney_launches)


def _zero_counts():
    """Every kernel's launch count to 0 (the BVH4, the cluster and the
    shade kernels)."""
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        cluster_closest, cluster_occluded)
    from lighthouse2_tpu_torch.render.kernels.shade import shade_kernel
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    for fn in (trace_closest, trace_occluded, cluster_closest,
               cluster_occluded, shade_kernel):
        fn.launches = 0
    shade_kernel.disney_launches = 0


def _tally():
    """The launch counts of every kernel and the graph replays of every
    graph entry point so far (render/graphs.py)."""
    return dict(_all_counts(), **_shade_count(),
                replays=sum(_captured(n).replays for n in GRAPH_ENTRIES))


def _clear_graphs():
    """Every graph entry point without a graph: its next call is eager."""
    for n in GRAPH_ENTRIES:
        _captured(n).clear()


def _call_kind(c, cfg, scene, grad=False):
    """What a call of a graph entry point was, from its _tally deltas `c`:
    "eager" (each of the path's kernels launched max_path_length times
    through its wrapper, no replay), "capture" (those launches recorded,
    then one replay), "replay" (no launch through a wrapper, one replay),
    or "unexpected". `grad`: the call needs gradients (a step)."""
    counts, _ = _kernel_syms(cfg, scene, grad)
    launched = {k: c[k] for k in c if k != "replays"}
    run = {k: (cfg.max_path_length if k in counts else 0) for k in launched}
    if launched == run and c["replays"] in (0, 1):
        return ("eager", "capture")[c["replays"]]
    if not any(launched.values()) and c["replays"] == 1:
        return "replay"
    return "unexpected"


def _tallied(fn, per_call):
    """fn(), its _tally deltas appended to `per_call`; fn's result."""
    before = _tally()
    out = fn()
    per_call.append(_launch_deltas(before, _tally()))
    return out


def _profile_replay(fn, dev, tag, per_call, **kw):
    """_profile of one call of fn (a replay of a graph), its _tally deltas
    appended to `per_call`."""
    return _tallied(lambda: _profile(fn, dev, tag, **kw), per_call)


def _launch_summary(res, name, sym):
    """A phase's launches of one kernel for the kernels line: through its
    wrapper in each call (eager and capture calls; a replay's are 0), and
    in the profiled replay by the profiler's count."""
    return dict(per_call=[c[name] for c in res["launches_per_call"]],
                replay_profiled=res["replay_kernels"][sym])


def _replay_gates(tag, cfg, scene, per_call, kinds, prof, grad=False):
    """The launch gates of calls that run a graph entry point: the calls'
    kinds (_call_kind, from the wrappers' counts and the replays) are
    `kinds`, and `prof`, the profiler's kernel counts of one of those
    replays, holds max_path_length of each of the path's kernels and none
    of the others: a replay runs its graph's kernels without the wrappers,
    so only the profiler counts them. The path's kernels: the trace kernels
    of its intersector, and the shade kernel where it shades (_kernel_syms,
    so never under `grad`)."""
    _, syms = _kernel_syms(cfg, scene, grad)
    got = [_call_kind(c, cfg, scene, grad) for c in per_call]
    want = {k: (cfg.max_path_length if k in syms else 0) for k in prof}
    bad = []
    if got != list(kinds):
        bad.append(f"calls {got}, want {list(kinds)}: {per_call}")
    if prof != want:
        bad.append(f"kernels of a profiled replay {prof}, want {want}")
    if bad:
        raise AssertionError(tag + "; ".join(bad))


def main_path(scene, view, cfg, dev, passes, tag="[main] "):
    """Phase 3 (and [disney kernel], the forward Disney pass of the shade
    check's scene, under `tag`). Returns the numbers of the timed passes
    and of one more, profiled, and the state."""
    import torch
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass_auto)

    state = AccumState.make(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _clear_graphs()
    _zero_counts()
    per_call = []
    t0 = time.perf_counter()
    # warm-up: the eager pass, then the pass that captures the CUDA graph
    for _ in range(2):
        state, stats = _tallied(
            lambda: render_pass_auto(scene, view, state, cfg), per_call)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    all_stats = []
    t0 = time.perf_counter()
    for _ in range(passes):
        state, stats = _tallied(
            lambda: render_pass_auto(scene, view, state, cfg), per_call)
        all_stats.append(stats)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    prof = _profile_replay(lambda: render_pass_auto(scene, view, state, cfg),
                           dev, "[profile] ", per_call)
    launches = _counts()
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
        launches=launches, launches_per_call=per_call,
        replay_kernels=prof["kernel_launches"],
        image_mean=img.mean().item(),
        image_finite=bool(torch.isfinite(img).all()),
        max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None))
    print(tag + json.dumps(res), flush=True)
    _replay_gates(tag, cfg, scene, per_call,
                  ("eager", "capture") + ("replay",) * (passes + 1),
                  prof["kernel_launches"])
    if not (res["image_finite"] and res["image_mean"] > 0):
        raise AssertionError("the rendered image is not finite and positive")
    res["profile"] = prof
    return res, state


def _kernel_name(key):
    """The function name in a profiler key (a demangled signature), so that
    closest_kernel does not also match cluster_closest_kernel."""
    head = key.split("(")[0].split()
    return head[-1] if head else key


def _device_rows(prof):
    """The device-side rows of prof.key_averages() (kernels, copies,
    memsets), without the device spans of record_function ranges (the
    staged executor's stages), which would count their kernels twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in EXEC_STAGES]


def _profile(fn, dev, tag, shares=None, cpu=True):
    """Run fn once under torch.profiler: device time by kernel name.
    `shares` {label: substring}: the share of the device time of the
    kernels whose names contain the substring. cpu=False records the
    device activity only, which the profiler parses in a fraction of the
    time (no host ops: ~50k of them a pass)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = []      # device-side events only (kernels, copies, memsets)
    for e in _device_rows(prof):
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    kernels = ("closest_kernel", "occluded_kernel", "cluster_closest_kernel",
               "cluster_occluded_kernel", SHADE_KERNEL, SHADE_DISNEY_KERNEL)
    name = _kernel_name
    share = {k: sum(r[0] for r in rows if name(r[1]) == k) / max(total, 1e-9)
             for k in kernels}
    per_launch = {k: sum(r[0] for r in rows if name(r[1]) == k) / 1e3
                  / max(sum(r[2] for r in rows if name(r[1]) == k), 1)
                  for k in kernels}
    res = dict(wall_ms=wall * 1e3, device_ms=total / 1e3,
               device_launches=sum(r[2] for r in rows),
               device_busy_share=total / 1e3 / (wall * 1e3),
               kernel_launches={k: sum(r[2] for r in rows if name(r[1]) == k)
                                for k in kernels},
               kernel_share_of_device=share,
               kernel_ms_per_launch=per_launch,
               top=[dict(name=k[:60], ms=us / 1e3, calls=c)
                    for us, k, c in rows[:12]])
    if shares:
        res["shares"] = {label: sum(r[0] for r in rows if sub in r[1])
                         / max(total, 1e-9) for label, sub in shares.items()}
    print(tag + json.dumps(res), flush=True)
    return res


def reference_check(dev, intersector="auto", tag="[reference] "):
    """Phase 4 (and [cluster] (d) with intersector="cluster", the scene
    synced with its cluster tiles): a small render on the card against the
    same render through the plain versions on the CPU, every pixel
    compared; the card's render launches the chosen path's kernels."""
    import torch
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass_auto)
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    cfg = RenderConfig(width=64, height=64, spp_per_pass=1, max_path_length=4,
                       path_regen=True, intersector=intersector)
    scene, cam = cornell_box(64, 64)
    cluster = intersector == "cluster"
    out = {}
    for where in (dev, torch.device("cpu")):
        ds = scene.sync(where, clusters=cluster)
        view = cam.get_view(where)
        st = AccumState.make(cfg, where)
        before = _all_counts()
        for _ in range(2):
            st, _ = render_pass_auto(ds, view, st, cfg)
        launched = _launch_deltas(before, _all_counts())
        out[where.type] = (st.accumulator.cpu(), finalize(st).cpu())
        if where.type == "cuda" and not all(
                n > 0 for k, n in launched.items()
                if k.startswith("cluster") == cluster):
            raise AssertionError(f"{tag}launches: {launched}")
    (ga, gi), (ca, ci) = out[dev.type], out["cpu"]
    close = torch.isclose(ga, ca, rtol=1e-3, atol=1e-4).all(-1)
    res = dict(pixels_close=close.float().mean().item(),
               mean_card=gi.mean().item(), mean_cpu=ci.mean().item(),
               mean_rel_diff=abs(gi.mean().item() - ci.mean().item())
               / max(abs(ci.mean().item()), 1e-30))
    print(tag + json.dumps(res), flush=True)
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
        AccumState, ensure_regen_state, render_pass_auto)

    cfg = dataclasses.replace(cfg, remat=True)
    size = cfg.width
    params, target = _headline_params(scene, size, dev)
    # ray count from one forward stats pass (bench.py:129-134)
    _, stats0 = render_pass_auto(scene, view, AccumState.make(cfg, dev), cfg)
    fixed_rays = int(stats0["total_extension"]) + int(stats0["total_shadow"])
    state = ensure_regen_state(view, AccumState.make(cfg, dev), cfg)
    step = lambda: regen_value_and_grad(scene, view, state, cfg, target,
                                        params)
    _zero_counts()
    per_call = []
    t0 = time.perf_counter()
    for _ in range(2):      # warm-up: the eager step, the capturing step
        loss, grads, state = _tallied(step, per_call)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, grads, state = _tallied(step, per_call)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    # one more step, a replay, under the profiler: device time by kernel
    # name and the shares of TRAIN_SHARES
    prof = _profile_replay(step, dev, "[train profile] ", per_call,
                           shares=TRAIN_SHARES, cpu=False)
    summary = _grad_summary(grads)
    res = dict(steps=steps, seconds=dt, warmup_seconds=warm_s,
               rays_per_step=fixed_rays,
               mrays_per_s=fixed_rays * steps / dt / 1e6,
               ms_per_step=dt * 1e3 / steps, loss=loss.item(),
               launches_per_call=per_call,
               replay_kernels=prof["kernel_launches"],
               max_memory_allocated=peak, grads=summary)
    print("[train] " + json.dumps(res), flush=True)
    _replay_gates("[train] ", cfg, scene, per_call,
                  ("eager", "capture") + ("replay",) * (steps + 1),
                  prof["kernel_launches"], grad=True)
    res["profile"] = prof

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

    bad = {k: v for k, v in summary.items()
           if not (v["finite"] and v["nonzero"] > 0)}
    if bad:
        raise AssertionError(f"gradients not finite or all zero: {bad}")
    return res, state


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
    """Two warm-ups (the first with the scene's sync, the second captures
    the pass's CUDA graph), `passes` timed api.render() calls and one
    profiled; checks that the timed and the profiled calls replayed the
    graph and the profiled replay's kernels (_replay_gates), and the
    images. Returns the numbers."""
    import numpy as np
    import torch

    cfg = api.config
    per_call = []
    t0 = time.perf_counter()
    _tallied(api.render, per_call)                  # sync + warm-up pass
    _tallied(api.render, per_call)                  # the graph's capture
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    stats = [dict(_tallied(api.render, per_call)) for _ in range(passes)]
    peak = torch.cuda.max_memory_allocated(dev)
    prof = _profile_replay(api.render, dev, tag + "profile: ", per_call)
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
        spp=api.core.stats["spp"], launches_per_call=per_call,
        replay_kernels=prof["kernel_launches"],
        image_mean=float(img.mean()),
        image_finite=bool(np.isfinite(img).all()),
        ldr_finite=bool(np.isfinite(ldr).all()),
        ldr_min=float(ldr.min()), ldr_max=float(ldr.max()),
        max_memory_allocated=peak)
    print(tag + json.dumps(res), flush=True)
    res["profile"] = prof
    _replay_gates(tag, cfg, api.device_scene(), per_call,
                  ("eager", "capture") + ("replay",) * (passes + 1),
                  prof["kernel_launches"])
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
    alternate, twice: `passes` render_pass_auto calls with one synchronize
    at the end (phase 3's) and `passes` api.render() calls (ms per pass
    each)."""
    import torch
    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, render_pass_auto)

    api = RenderAPI.create("wavefront", cfg, device=dev)
    api.scene, api.camera = host, cam
    res = api_passes(api, dev, passes, "[disney] Lambert through RenderAPI: ")
    scene, view = host.sync(dev), cam.get_view(dev)
    state, _ = render_pass_auto(scene, view, AccumState.make(cfg, dev), cfg)
    alt = dict(render_pass_ms=[], api_ms=[])
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(passes):
            state, _ = render_pass_auto(scene, view, state, cfg)
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
    parameter groups of [train]; two warm-up steps (eager, then the
    graph's capture), one timed and one profiled (_replay_gates)."""
    import torch
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, ensure_regen_state)

    cfg = dataclasses.replace(api.config, remat=True)
    scene = api.device_scene()
    view = api.camera.get_view(dev)
    params, target = _headline_params(scene, cfg.width, dev)
    state = ensure_regen_state(view, AccumState.make(cfg, dev), cfg)
    step = lambda: regen_value_and_grad(scene, view, state, cfg, target,
                                        params)
    per_call = []
    t0 = time.perf_counter()
    for _ in range(2):      # warm-up: the eager step, the capturing step
        _, _, state = _tallied(step, per_call)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss, grads, _ = _tallied(step, per_call)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    prof = _profile_replay(step, dev, "[disney train] profile: ", per_call,
                           cpu=False)
    summary = _grad_summary(grads)
    res = dict(ms_per_step=dt * 1e3, warmup_seconds=warm_s, loss=loss.item(),
               launches_per_call=per_call,
               replay_kernels=prof["kernel_launches"],
               max_memory_allocated=peak, grads=summary)
    print("[disney train] " + json.dumps(res), flush=True)
    _replay_gates("[disney train] ", cfg, scene, per_call,
                  ("eager", "capture", "replay", "replay"),
                  prof["kernel_launches"], grad=True)
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
        a = golden.render_golden(device=where).cpu()
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
                     ("two_level_clusters", dict(clusters=True)),
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
        if ds.cbvh is not None:
            res.update(clusters=ds.cbvh.n_clusters,
                       tiles_per_cluster=ds.cbvh.tiles_per_cluster)
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
    each trace kernel once in render_pass (render_pass_unrolled launches
    them every bounce)."""
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
    turning a little each frame; 2 warm-ups + `frames` timed frames, one
    profiled frame (_replay_gates), the filter alone profiled and timed on
    one frame's G-buffers, and a raw 1-spp frame of the last view. Returns
    the numbers."""
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

    per_call = []
    t0 = time.perf_counter()
    _tallied(api.render, per_call)                # sync + warm-up frame
    _tallied(api.render, per_call)                # the pass's graph capture
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    out = dict(warmup_seconds=warm_s, frames=[])
    for i in range(frames):
        move()
        st = dict(_tallied(api.render, per_call))
        img = api.get_image()
        fr = dict(
            frame=i + 1, pass_ms=st["pass_time"] * 1e3,
            filter_ms=st["filter_time"] * 1e3, frame_ms=st["render_time"] * 1e3,
            mrays_per_s=st["mrays_per_s"], live_bounces=_live_bounces(st),
            launches=per_call[-1],
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
    # one more frame, profiled: the pass's graph replayed
    out["profile"] = _profile_replay(lambda: (move(), api.render()), dev,
                                     "[filter profile] ", per_call)
    out.update(launches_per_call=per_call,
               replay_kernels=out["profile"]["kernel_launches"])
    filtered = api.get_image()

    # the raw 1-spp frame of the same (unjittered) view
    raw_api = RenderAPI.create("wavefront", dataclasses.replace(
        cfg, taa_enabled=False), device=dev)
    raw_api.scene, raw_api.camera = host, api.camera
    raw_api.render()
    out.update(filtered_neighbour_var=_neighbour_var(filtered),
               raw_neighbour_var=_neighbour_var(raw_api.get_image()))

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
    # the filter core's render_pass_auto runs render_pass_unrolled on the
    # card, captured at the second frame: each kernel launches once every
    # bounce, live or not, and every later frame replays that graph; the
    # core's own config (filter_enabled) says which kernels those are
    _replay_gates("[filter] ", api.core.config, api.device_scene(),
                  per_call,
                  ("eager", "capture") + ("replay",) * (frames + 1),
                  out["replay_kernels"])
    for f in fs:
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
        world = init_distributed(f"file://{store}/store", num_processes=1,
                                 process_id=0, device=dev)
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
                                         lambda s: s.materials.color, insert,
                                         ds.materials.color)
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


def _tensor_bytes(*objs):
    """Bytes of every tensor in the given tensors, dicts and dataclasses."""
    import torch
    n = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            n += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            n += _tensor_bytes(*obj.values())
        elif dataclasses.is_dataclass(obj):
            n += _tensor_bytes(*(getattr(obj, f.name)
                                 for f in dataclasses.fields(obj)))
    return n


def _image_agreement(got, want):
    """__graft_entry__.py:108-119's measure of two accumulators: the share
    of pixels off by more than 1e-3 of the largest value, and the mean
    absolute difference over that value."""
    import numpy as np
    scale = max(float(np.abs(want).max()), 1e-6)
    diff = np.abs(got - want)
    return dict(frac_bad=float((diff.max(-1) > 1e-3 * scale).mean()),
                mean_rel=float(diff.mean() / scale))


def _shard_grad_inputs(dev, k, size=SHARD_GRAD_SIZE):
    """The [scene shard] gradient step's inputs: a size^2 Cornell box,
    path 4, classic, its material colours and zero per-vertex offsets of
    one of k shards as parameters, a zero target."""
    import torch
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    host, cam = cornell_box(size, size)
    ds, view = host.sync(dev), cam.get_view(dev)
    cfg = RenderConfig(width=size, height=size, spp_per_pass=1,
                       max_path_length=4)
    tk = -(-ds.tris.count // k)
    params = dict(color=ds.materials.color,
                  offset=torch.zeros((tk, 3, 3), device=dev))
    return ds, view, cfg, params, torch.zeros((size * size, 3), device=dev)


def _shard_insert(scene, sh, p):
    """Colours into the replicated scene, vertex offsets into the shard
    (diff/params.py displace_vertices' arithmetic)."""
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    off = p["offset"]
    v0 = sh["v0"] + off[:, 0]
    v1 = sh["v0"] + sh["e1"] + off[:, 1]
    v2 = sh["v0"] + sh["e2"] + off[:, 2]
    return (set_material_fields(scene, color=p["color"]),
            dict(sh, v0=v0, e1=v1 - v0, e2=v2 - v0))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_memory(dev, reset=False):
    """Peak device memory since the last reset (None on the CPU)."""
    import torch
    if dev.type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev)


def _empty_shard_check(scene, view, cfg, dev):
    """Both kernels on an empty shard's tree (k = T + 1, the last shard: a
    one-leaf root over a degenerate triangle) for the primary rays: every
    lane a miss and unoccluded, as in the plain walk."""
    import torch
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.parallel.scene_shard import build_shard_bvh
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    from lighthouse2_tpu_torch.render.wavefront import generate_eye_rays
    t = scene.tris.count
    tree = build_shard_bvh(scene.tris, t + 1, t, dev)
    paths = generate_eye_rays(view, cfg, 0)
    o, d = paths["origin"].contiguous(), paths["dir"].contiguous()
    prim = trace_closest(o, d, 1e30, tree)[1]
    occ = trace_occluded(o, d, 1e30, tree)
    res = dict(root_count=tree.count.tolist(),
               misses=int((prim == -1).sum()), occluded=int(occ.sum()),
               plain_equal=bool(
                   (prim == wide_intersect(o, d, tree, t_max=1e30)[1]).all()
                   and (occ == wide_occluded(o, d, 1e30, tree)).all()),
               rays=int(prim.numel()))
    _sync(dev)
    return res


def scene_shard_rank(rank, store, inputs, out, device):
    """One rank of [scene shard] (b): a gloo rank of the SHARD_MESH group
    whose tensors all lie on `device` (cuda:0 on the card). Renders the bathroom from `inputs` (its
    shard cut and its tree built here), takes the Cornell gradient step and
    saves what it saw to `out`."""
    import torch
    import torch.distributed as dist
    from lighthouse2_tpu_torch.parallel.distributed import init_distributed
    from lighthouse2_tpu_torch.parallel.mesh import _to, make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        collective_bytes_per_pass, render_pass_scene_sharded, shard_scene,
        shard_triangle_arrays, train_step_scene_sharded)
    from lighthouse2_tpu_torch.render.wavefront import AccumState

    dev = torch.device(device)
    n_ray, n_scene = SHARD_MESH
    init_distributed(f"file://{store}", n_ray * n_scene, rank,
                     backend="gloo", device=dev)
    try:
        mesh = make_mesh2d(n_ray, n_scene, device=dev)
        inp = torch.load(inputs, weights_only=False)
        cfg = inp["config"]
        t0 = time.perf_counter()
        scene, sh, bvh = shard_scene(inp["scene"], mesh)
        view = _to(inp["view"], dev)
        _sync(dev)
        res = dict(rank=rank, coords=mesh.coords,
                   shard_seconds=time.perf_counter() - t0,
                   shard_bytes=_tensor_bytes(sh, bvh),
                   shard_triangles=int((sh["gid"] >= 0).sum()))
        _peak_memory(dev, reset=True)
        ms, launches = [], []
        for i in range(1 + SHARD_PASSES):          # one untimed warm-up
            before = _counts()
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            state, stats = render_pass_scene_sharded(
                scene, view, AccumState.make(cfg, dev), cfg, mesh, sh=sh,
                shard_bvh=bvh)
            _sync(dev)
            dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
            after = _counts()
            launches.append({k: after[k] - before[k] for k in after})
            if i:
                ms.append(dt.item() * 1e3)
        live = int((stats["extension_rays"] > 0).sum())
        res.update(ms=ms, launches_per_pass=launches,
                   max_memory_allocated=_peak_memory(dev),
                   totals=[int(stats["total_extension"]),
                           int(stats["total_shadow"])],
                   collective_bytes=collective_bytes_per_pass(cfg, mesh, live),
                   accumulator=state.accumulator.cpu())
        del state, scene, sh, bvh

        ds, gview, gcfg, params, target = _shard_grad_inputs(dev, n_scene)
        loss, grads = train_step_scene_sharded(ds, gview, target, gcfg, mesh,
                                               _shard_insert, params)
        res.update(loss=loss.item(),
                   grads={k: g.cpu() for k, g in grads.items()},
                   gid=shard_triangle_arrays(ds.tris, n_scene)["gid"][
                       mesh.coords[1]].cpu())
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _spawn_shard_ranks(directory, inputs, dev):
    """Start the SHARD_MESH gloo ranks (this script, scene_shard_rank),
    join them within SHARD_JOIN_TIMEOUT and return their results. Any rank
    that fails or outlives the timeout fails the phase; none is left
    running."""
    import torch
    n = SHARD_MESH[0] * SHARD_MESH[1]
    store = os.path.join(directory, "store")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    logs = [open(os.path.join(directory, f"rank{r}.log"), "w")
            for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--scene-shard-rank",
         str(r), store, inputs, os.path.join(directory, f"rank{r}.pt"),
         str(dev)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env) for r in range(n)]
    deadline = time.monotonic() + SHARD_JOIN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the {n} [scene shard] ranks did not finish "
                             f"in {SHARD_JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(directory, f"rank{r}.log")) as fh:
                raise AssertionError(f"[scene shard] rank {r} failed:\n"
                                     + fh.read()[-6000:])
    return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def scene_shard_path(host, cam, dev, size=512, path_len=16):
    """Phase 18, [scene shard]: scene-sharded rendering. (a) one NCCL rank,
    a 1x1 mesh: the bathroom through render_pass_scene_sharded against the
    unsharded classic render_pass, and the single-process Cornell gradient
    step; (b) SHARD_MESH gloo ranks on cuda:0 (spawn_shard_ranks), held
    against (a). Returns the numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.parallel.distributed import init_distributed
    from lighthouse2_tpu_torch.parallel.mesh import _to, make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        collective_bytes_per_pass, render_pass_scene_sharded, shard_scene,
        train_step_scene_sharded)
    from lighthouse2_tpu_torch.render.kernels.trace import BUILD_DIR
    from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass

    cfg = RenderConfig(width=size, height=size, spp_per_pass=1,
                       max_path_length=path_len)
    scene, view = host.sync(dev), cam.get_view(dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_shard_", dir=BUILD_DIR)
    try:
        init_distributed(f"file://{work}/store1", num_processes=1,
                         process_id=0, device=dev)
        res = dict(backend=dist.get_backend())
        if res["backend"] != "nccl":
            raise AssertionError(f"(a) must run on NCCL: {res}")
        mesh = make_mesh2d(1, 1, device=dev)
        t0 = time.perf_counter()
        srep, sh, bvh = shard_scene(scene, mesh)
        _sync(dev)
        res["shard_seconds"] = time.perf_counter() - t0
        res["bytes"] = dict(
            shard=_tensor_bytes(sh, bvh),
            replicated_tris_and_bvh=_tensor_bytes(scene.tris, scene.bvh),
            replicated_rest=_tensor_bytes(srep))
        run = lambda: render_pass_scene_sharded(
            srep, view, AccumState.make(cfg, dev), cfg, mesh, sh=sh,
            shard_bvh=bvh)
        t0 = time.perf_counter()
        run()                  # sets up the communicators: untimed
        _sync(dev)
        res["warmup_ms"] = (time.perf_counter() - t0) * 1e3
        _peak_memory(dev, reset=True)
        runs = dict(sharded=[], unsharded=[])
        for kind in ("sharded", "unsharded", "unsharded", "sharded"):
            before = _counts()
            _sync(dev)
            t0 = time.perf_counter()
            if kind == "sharded":
                st, stats = run()
            else:
                st, stats = render_pass(scene, view, AccumState.make(cfg, dev),
                                        cfg)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            after = _counts()
            runs[kind].append(dict(
                ms=ms, acc=st.accumulator.cpu().numpy(),
                live=int((stats["extension_rays"] > 0).sum()),
                totals=[int(stats["total_extension"]),
                        int(stats["total_shadow"])],
                launches={k: after[k] - before[k] for k in after}))
        res["max_memory_allocated"] = _peak_memory(dev)
        sh_run, un = runs["sharded"][-1], runs["unsharded"][0]
        res.update(
            sharded_ms=[r["ms"] for r in runs["sharded"]],
            unsharded_ms=[r["ms"] for r in runs["unsharded"]],
            agreement=_image_agreement(sh_run["acc"], un["acc"]),
            totals=dict(sharded=sh_run["totals"], unsharded=un["totals"]),
            launches_per_sharded_pass=[r["launches"]
                                       for r in runs["sharded"]],
            collective_bytes=collective_bytes_per_pass(cfg, mesh,
                                                       sh_run["live"]))
        res["profile"] = _profile(run, dev, "[scene shard profile] ")
        del srep, sh, bvh
        res["empty_shard"] = _empty_shard_check(scene, view, cfg, dev)

        ds, gview, gcfg, params, target = _shard_grad_inputs(dev, 1)
        loss1, g1 = train_step_scene_sharded(ds, gview, target, gcfg, mesh,
                                             _shard_insert, params)
        dist.destroy_process_group()

        inputs = os.path.join(work, "inputs.pt")
        torch.save(dict(scene=dataclasses.replace(_to(scene, "cpu"), bvh=None,
                                                  cbvh=None),
                        view=_to(view, "cpu"), config=cfg), inputs)
        t0 = time.perf_counter()
        ranks = _spawn_shard_ranks(work, inputs, dev)
        res["ranks_seconds"] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)

    g1 = {k: g.cpu().numpy() for k, g in g1.items()}
    grad_ok, parts = [], {}
    for r in ranks:
        gid = r["gid"].numpy()
        real = gid >= 0
        for name, g, want in (
                ("color", r["grads"]["color"].numpy(), g1["color"]),
                ("offset", r["grads"]["offset"].numpy()[real],
                 g1["offset"][gid[real]])):
            atol = 1e-6 * float(np.abs(want).max())
            grad_ok.append(float(np.isclose(g, want, rtol=1e-4,
                                            atol=atol).mean()))
        parts[r["coords"][1]] = float(np.abs(r["grads"]["offset"]).sum())
    res["ranks"] = dict(
        mesh=list(SHARD_MESH),
        ms=ranks[0]["ms"],
        agreement=_image_agreement(ranks[0]["accumulator"].numpy(),
                                   un["acc"]),
        totals=ranks[0]["totals"],
        max_memory_allocated=[r["max_memory_allocated"] for r in ranks],
        shard_bytes=[r["shard_bytes"] for r in ranks],
        shard_triangles=[r["shard_triangles"] for r in ranks],
        shard_seconds=[r["shard_seconds"] for r in ranks],
        launches_per_pass=[r["launches_per_pass"][-1] for r in ranks],
        collective_bytes=ranks[0]["collective_bytes"],
        loss=[r["loss"] for r in ranks], loss_single=loss1.item(),
        grad_close=min(grad_ok), offset_grad_abs_sum_by_shard=parts)
    print("[scene shard] " + json.dumps(res), flush=True)

    want = {k: path_len for k in ("trace_closest", "trace_occluded")}
    rk = res["ranks"]
    checks = dict(
        pixels=all(a["frac_bad"] < FRAC_BAD_MAX and a["mean_rel"] < MEAN_REL_MAX
                   for a in (res["agreement"], rk["agreement"])),
        totals=all(abs(a - b) <= TIE_SHARE * b for got in (
            res["totals"]["sharded"], rk["totals"])
            for a, b in zip(got, res["totals"]["unsharded"])),
        launches=all(l == want for l in res["launches_per_sharded_pass"]
                     + rk["launches_per_pass"]),
        empty_shard=(res["empty_shard"]["misses"] == res["empty_shard"]["rays"]
                     and res["empty_shard"]["occluded"] == 0
                     and res["empty_shard"]["plain_equal"]),
        loss=all(abs(x - rk["loss_single"]) <= 1e-5 * abs(rk["loss_single"])
                 for x in rk["loss"]),
        grads=rk["grad_close"] == 1.0 and all(
            v > 0 for v in parts.values()) and len(parts) == SHARD_MESH[1])
    if not all(checks.values()):
        raise AssertionError(f"[scene shard] failed: {checks}")
    return res


def _cluster_batches(scene, view, cfg, dev):
    """[cluster] (a)'s batches: trace_batches' primary, bounce-1 and shadow
    rays, each as the cluster path's ray tile in the executor's order
    (primaries as they come, bounce rays sorted by "dir", shadow rays by
    "origin_octant"). Returns {name: (o, d, tmax, x, inv)}."""
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


def cluster_kernels(scene, view, cfg, dev, kern, iters):
    """[cluster] (a): both cluster kernels against their plain versions
    on every lane of the three batches (code and occlusion on >= AGREE_MIN
    of the lanes, t's mean relative error on the agreeing hits <=
    T_MEAN_REL_MAX, the per-block visit and sub-packet counters on >=
    COUNTERS_MIN of the live blocks) and against the BVH4 kernels (prim and
    occlusion on >= AGREE_MIN of the lanes); CUDA-event ms over `iters`
    launches; the plain version's wall ms of the one compared call; the
    bound of the same work as the BVH4 rows (the BVH2 walk's counted
    operations from `kern`, the BVH2 arrays and the rays read once, this
    kernel's outputs written once); the kernels' copy statistics and the
    design's floor from one more launch each. Returns {kernel: {batch:
    numbers}}."""
    import torch
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        BLOCK, ROW, STATS, TILE_BYTES, cluster_closest, cluster_occluded)
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)

    cb, bvh = scene.cbvh, scene.bvh
    scene_bytes = sum(x.numel() * x.element_size() for x in (
        bvh.nbox, bvh.left, bvh.right, bvh.count, bvh.prim, bvh.tri9))
    out = {"cluster_closest": {}, "cluster_occluded": {}}
    for name, (o, d, tmax, x, inv) in _cluster_batches(
            scene, view, cfg, dev).items():
        n = o.shape[0]
        nb = x.shape[1] // BLOCK
        c, (code, t, visits, subs, occ), (pc_ms, po_ms) = _kernel_gates(
            x, cb, name, dev)
        unperm = (lambda a: a[:n] if inv is None else a[:n][inv])
        prim = unperm(torch.where(code >= 0, cb.prim.reshape(-1)[
            code.clamp(min=0).to(torch.int64)], -1))
        eq = lambda a, b: (a == b).float().mean().item()
        c = dict(
            c, rays=n,
            bvh4_prim_match=eq(prim, trace_closest(o, d, tmax, bvh)[1]),
            bvh4_occ_match=eq(unperm(occ), trace_occluded(o, d, tmax, bvh)),
            mean_visits_per_live_block=visits.sum().item() / max(
                c["live_blocks"], 1),
            mean_subs_per_live_block=subs.sum().item() / max(
                c["live_blocks"], 1))
        print(f"[cluster] {name}: " + json.dumps(c), flush=True)
        if c["bvh4_prim_match"] < AGREE_MIN or c["bvh4_occ_match"] < AGREE_MIN:
            raise AssertionError(f"cluster / BVH4 agreement below {AGREE_MIN} "
                                 f"on {name}: prim {c['bvh4_prim_match']}, "
                                 f"occ {c['bvh4_occ_match']}")
        ck = _time_ms(lambda: cluster_closest(x, cb), iters, dev)
        ok_ = _time_ms(lambda: cluster_occluded(x, cb), iters, dev)
        copies = {}
        for key, fn in (("cluster_closest", cluster_closest),
                        ("cluster_occluded", cluster_occluded)):
            st = torch.zeros((nb, len(STATS)), dtype=torch.int32, device=dev)
            fn(x, cb, stats=st)
            tot = dict(zip(STATS, st.sum(0).tolist()))
            per = st[st[:, STATS.index("leaves")] > 0].float()
            if per.shape[0] == 0:                 # no block walked a leaf
                per = torch.zeros((1, len(STATS)))
            spread = {k: dict(mean=per[:, i].mean().item(),
                              max=per[:, i].max().item())
                      for i, k in enumerate(STATS) if k in ("units", "leaves")}
            pairs = tot["units"] * ROW * 128      # evaluated (ray, triangle)
            floor_tf32 = pairs * FORM_TF32_OPS / TF32_OPS_PER_S * 1e3
            floor_fp32 = pairs * EPILOGUE_FP32_OPS / FP32_OPS_PER_S * 1e3
            copies[key] = dict(
                tile_bytes=tot["tiles"] * TILE_BYTES,
                unused_share=tot["tiles_unused"] / max(tot["tiles"], 1),
                marked_pairs=tot["pairs"], units=tot["units"],
                leaves=tot["leaves"],
                ray_triangle_pairs=pairs, design_floor_ms=max(
                    floor_tf32, floor_fp32),
                design_floor_tf32_ms=floor_tf32,
                design_floor_fp32_ms=floor_fp32, per_block=spread)
        ray_bytes = n * (12 + 12 + 4)
        cbd, cbb = _bound(ray_bytes + n * 8 + scene_bytes,
                          kern["trace_closest"][name]["ops"])
        obd, obb = _bound(ray_bytes + n + scene_bytes,
                          kern["trace_occluded"][name]["ops"])
        out["cluster_closest"][name] = dict(
            ms=ck, plain_ms=pc_ms, bound_ms=cbd, bound_by=cbb,
            max_abs_err=c["t_max_abs_err"], grays_per_s=n / ck / 1e6,
            bvh4_ms=kern["trace_closest"][name]["ms"],
            copies=copies["cluster_closest"])
        out["cluster_occluded"][name] = dict(
            ms=ok_, plain_ms=po_ms, bound_ms=obd, bound_by=obb,
            max_abs_err=c["occ_max_abs_err"], grays_per_s=n / ok_ / 1e6,
            bvh4_ms=kern["trace_occluded"][name]["ms"],
            copies=copies["cluster_occluded"])
        print(f"[cluster] {name}: closest {ck:.4f} ms (plain {pc_ms:.1f} ms, "
              f"BVH4 kernel {kern['trace_closest'][name]['ms']:.4f} ms, "
              f"bound {cbd:.4f} ms by {cbb}, {cbd / ck:.2%} of it); "
              f"occluded {ok_:.4f} ms (plain {po_ms:.1f} ms, BVH4 kernel "
              f"{kern['trace_occluded'][name]['ms']:.4f} ms, bound "
              f"{obd:.4f} ms by {obb}, {obd / ok_:.2%} of it)", flush=True)
        for key, cp in copies.items():
            ms = ck if key == "cluster_closest" else ok_
            print(f"[cluster] {name}: {key} copied {cp['tile_bytes']} tile "
                  f"bytes ({cp['unused_share']:.2%} for leaves with no marked "
                  f"sub-packet) over {cp['leaves']} leaves; "
                  f"{cp['marked_pairs']} marked (sub-packet, tile) pairs, "
                  f"{cp['units']} evaluated (sub-packet, row group, tile) "
                  f"units = {cp['ray_triangle_pairs']} (ray, triangle) pairs; "
                  f"design floor {cp['design_floor_ms']:.4f} ms (TF32 "
                  f"{cp['design_floor_tf32_ms']:.4f}, FP32 "
                  f"{cp['design_floor_fp32_ms']:.4f}), "
                  f"{cp['design_floor_ms'] / ms:.2%} of the kernel's ms, "
                  f"beside the common bound "
                  f"{(cbd if key == 'cluster_closest' else obd):.4f} ms; a "
                  f"block's units mean {cp['per_block']['units']['mean']:.1f} "
                  f"max {cp['per_block']['units']['max']:.0f}, leaves mean "
                  f"{cp['per_block']['leaves']['mean']:.1f} max "
                  f"{cp['per_block']['leaves']['max']:.0f}", flush=True)
    return out


def _kernel_gates(x, cb, name, dev):
    """Both cluster kernels against their plain versions on the ray tile x,
    every lane: code and occlusion on >= AGREE_MIN of the lanes, t's mean
    relative error on the agreeing hits <= T_MEAN_REL_MAX, the per-block
    visit and sub-packet counters on >= COUNTERS_MIN of the live blocks.
    Returns (the agreement numbers, the kernels' outputs (code, t, visits,
    subs, occ), the plain versions' wall ms (closest, any-hit))."""
    import torch
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        BLOCK, cluster_closest, cluster_closest_plain, cluster_occluded,
        cluster_occluded_plain)
    code, t, visits, subs = cluster_closest(x, cb)
    occ = cluster_occluded(x, cb)
    _sync(dev)
    t0 = time.perf_counter()
    pc = cluster_closest_plain(x, cb)
    _sync(dev)
    pc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    po = cluster_occluded_plain(x, cb)
    _sync(dev)
    po_ms = (time.perf_counter() - t0) * 1e3
    live = (x[7].reshape(-1, BLOCK) > 0).any(-1)
    same = code == pc[0]
    rel = ((t - pc[1]).abs() / pc[1].abs())[same & (code >= 0)]
    eq = lambda a, b: (a == b).float().mean().item()
    c = dict(
        lanes=int(x.shape[1]), live_blocks=int(live.sum()),
        hits=int((code >= 0).sum()), occluded=int(occ.sum()),
        code_match=same.float().mean().item(), occ_match=eq(occ, po),
        t_mean_rel_err=rel.mean().item() if rel.numel() else 0.0,
        t_max_rel_err=rel.max().item() if rel.numel() else 0.0,
        t_max_abs_err=(t - pc[1])[same].abs().max().item(),
        visits_match=eq(visits[live], pc[2][live]),
        subs_match=eq(subs[live], pc[3][live]),
        occ_max_abs_err=float((occ != po).any()))
    gates = dict(code=c["code_match"] >= AGREE_MIN,
                 occ=c["occ_match"] >= AGREE_MIN,
                 t=c["t_mean_rel_err"] <= T_MEAN_REL_MAX,
                 visits=c["visits_match"] >= COUNTERS_MIN,
                 subs=c["subs_match"] >= COUNTERS_MIN)
    if not all(gates.values()):
        raise AssertionError(f"cluster kernels and plain versions differ on "
                             f"{name}: {gates}, {c}")
    return c, (code, t, visits, subs, occ), (pc_ms, po_ms)


def cluster_tpc2(host, scene, view, cfg, dev, blocks=TPC2_BLOCKS):
    """[cluster] (a'): the kernels' path for clusters of several tiles,
    which the bathroom's cut (one tile a cluster) never takes: the same
    tree cut with tiles_per_cluster 2 (cut_clusters(min_tpc=2)), both
    kernels against their plain versions on the first `blocks` blocks of
    [cluster] (a)'s three batches, with (a)'s gates."""
    from lighthouse2_tpu_torch.bvh.clusters import cut_clusters
    from lighthouse2_tpu_torch.render.kernels.cluster import BLOCK
    a = host.world_arrays(True, True, True)
    w, tr = a["world"], a["tris"]
    cb = cut_clusters(a["bvh"], dict(w, ltri=tr["ltri"], lod=tr["lod"],
                                     tangent=tr["tangent"],
                                     bitangent=tr["bitangent"]),
                      min_tpc=2, device=dev)
    sc = dataclasses.replace(scene, cbvh=cb)
    res = dict(tiles_per_cluster=cb.tiles_per_cluster)
    for name, (_, _, _, x, _) in _cluster_batches(sc, view, cfg, dev).items():
        res[name] = _kernel_gates(x[:, :blocks * BLOCK].contiguous(), cb,
                                  name, dev)[0]
    print("[cluster] tiles_per_cluster 2: " + json.dumps(res), flush=True)
    return res


def _launch_deltas(before, after):
    return {k: after[k] - before[k] for k in after}


def _all_counts():
    return dict(_counts(), **_cluster_counts())


def cluster_main(scene, view, cfg, dev, passes):
    """[cluster] (b): render_pass_auto with intersector="cluster" (the main
    path's configuration otherwise), 2 warm-ups (eager, capture) and
    `passes` timed passes, each replaying the graph, and one profiled
    replay, which runs each cluster kernel max_path_length times and the
    BVH4 kernels never (_replay_gates); the image against the "auto"
    passes of the same run (FRAC_BAD_MAX, MEAN_REL_MAX: only t-ties
    between the two structures may differ). Returns the numbers."""
    import torch
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, finalize, render_pass_auto)
    ccfg = dataclasses.replace(cfg, intersector="cluster")
    st_auto = AccumState.make(cfg, dev)
    for _ in range(passes + 2):     # as many passes as the cluster run's
        st_auto, _ = render_pass_auto(scene, view, st_auto, cfg)
    state = AccumState.make(ccfg, dev)
    _peak_memory(dev, reset=True)
    _zero_counts()
    per_call = []
    one = lambda: render_pass_auto(scene, view, state, ccfg)
    t0 = time.perf_counter()
    for _ in range(2):      # warm-up: the eager pass, the capturing pass
        state, _ = _tallied(one, per_call)
    _sync(dev)
    warm_s = time.perf_counter() - t0
    all_stats = []
    t0 = time.perf_counter()
    for _ in range(passes):
        state, stats = _tallied(one, per_call)
        all_stats.append(stats)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = _all_counts()
    peak = _peak_memory(dev)
    prof = _profile_replay(one, dev, "[cluster profile] ", per_call)
    rays = sum(int(s["total_extension"]) + int(s["total_shadow"])
               for s in all_stats)
    img, img_auto = finalize(state), finalize(st_auto)
    res = dict(
        passes=passes, seconds=dt, warmup_seconds=warm_s,
        mrays_per_s=rays / dt / 1e6, rays=rays, ms_per_pass=dt * 1e3 / passes,
        launches=launches, launches_per_call=per_call,
        replay_kernels=prof["kernel_launches"], max_memory_allocated=peak,
        image_mean=img.mean().item(), image_mean_auto=img_auto.mean().item(),
        image_finite=bool(torch.isfinite(img).all()),
        agreement=_image_agreement(img.cpu().numpy(),
                                   img_auto.cpu().numpy()))
    print("[cluster main] " + json.dumps(res), flush=True)
    _replay_gates("[cluster main] ", ccfg, scene, per_call,
                  ("eager", "capture") + ("replay",) * (passes + 1),
                  prof["kernel_launches"])
    a = res["agreement"]
    if not (res["image_finite"] and a["frac_bad"] < FRAC_BAD_MAX
            and a["mean_rel"] < MEAN_REL_MAX):
        raise AssertionError(f"the cluster image differs from auto's: {a}")
    res["profile"] = prof
    return res


def cluster_train(scene, view, cfg, dev, auto_prof):
    """[cluster] (c): two warm-ups (eager, capture), one timed fwd+bwd
    step of regen_value_and_grad on the cluster path (grads "all":
    colours, light radiance, per-vertex offsets; remat) and one profiled,
    both replays, the profiled one running 16 + 16 cluster kernels and no
    BVH4 one (_replay_gates), ms and peak memory; the same step on the
    "auto" path from the same state: the loss within LOSS_RTOL and each
    gradient group within GRAD_RTOL, relative L2 (tests/test_torch_grad.py's
    bounds: both paths take the same samples and hit the same triangles
    but for t-ties, the offsets' refine terms round differently); the
    profiled step's TRAIN_SHARES of its device time, beside `auto_prof`,
    the "auto" step profiled in [train profile]."""
    import torch
    from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, ensure_regen_state)
    acfg = dataclasses.replace(cfg, remat=True)
    ccfg = dataclasses.replace(acfg, intersector="cluster")
    params, target = _headline_params(scene, cfg.width, dev)
    state = ensure_regen_state(view, AccumState.make(acfg, dev), acfg)
    step = lambda: regen_value_and_grad(scene, view, state, ccfg, target,
                                        params)
    _zero_counts()
    per_call = []
    for _ in range(2):      # warm-up: the eager step, the capturing step
        _tallied(step, per_call)
    _sync(dev)
    _peak_memory(dev, reset=True)
    t0 = time.perf_counter()
    loss_c, g_c, _ = _tallied(step, per_call)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = _peak_memory(dev)
    prof = _profile_replay(step, dev, "[cluster train profile] ", per_call,
                           shares=TRAIN_SHARES, cpu=False)
    loss_a, g_a, _ = regen_value_and_grad(scene, view, state, acfg, target,
                                          params)
    rel = {k: ((g_c[k] - g_a[k]).norm() / g_a[k].norm()).item() for k in g_a}
    res = dict(ms_per_step=ms, max_memory_allocated=peak,
               launches_per_call=per_call,
               replay_kernels=prof["kernel_launches"],
               loss=loss_c.item(), loss_auto=loss_a.item(),
               loss_rel_diff=abs(loss_c.item() - loss_a.item())
               / max(abs(loss_a.item()), 1e-30),
               grad_rel_l2=rel, bounds=GRAD_RTOL,
               grads=_grad_summary(g_c),
               shares=dict(cluster=prof["shares"], auto=auto_prof["shares"]),
               device_ms=dict(cluster=prof["device_ms"],
                              auto=auto_prof["device_ms"]))
    print("[cluster train] " + json.dumps(res), flush=True)
    _replay_gates("[cluster train] ", ccfg, scene, per_call,
                  ("eager", "capture", "replay", "replay"),
                  prof["kernel_launches"], grad=True)
    if res["loss_rel_diff"] > LOSS_RTOL or any(
            rel[k] > b for k, b in GRAD_RTOL.items()):
        raise AssertionError("cluster and auto fwd+bwd steps disagree")
    if not all(v["finite"] and v["nonzero"] > 0
               for v in res["grads"].values()):
        raise AssertionError(f"cluster gradients: {res['grads']}")
    return res


def cluster_bdpt_shard(scene, view, cfg, dev):
    """[cluster] (e): one BDPT pass (classic, spp 1, the main path's
    length) and one scene-sharded pass on a 1x1 NCCL mesh (path
    CLUSTER_SHARD_PATH; its shard's ClusterBVH cut once, timed apart) with
    intersector="cluster", each against its "auto" counterpart of the same
    run, the unsharded classic pass for the sharded one (FRAC_BAD_MAX,
    MEAN_REL_MAX), with the launches of every kernel: the cluster kernels
    only."""
    import torch.distributed as dist
    from lighthouse2_tpu_torch.parallel.distributed import init_distributed
    from lighthouse2_tpu_torch.parallel.mesh import make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        render_pass_scene_sharded, shard_scene)
    from lighthouse2_tpu_torch.render.bdpt import render_pass_bdpt
    from lighthouse2_tpu_torch.render.kernels.trace import BUILD_DIR
    from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass

    def run(fn, c):
        before = _all_counts()
        _sync(dev)
        t0 = time.perf_counter()
        st, _ = fn(AccumState.make(c, dev), c)
        _sync(dev)
        return (st.accumulator.cpu().numpy(), (time.perf_counter() - t0) * 1e3,
                _launch_deltas(before, _all_counts()))

    res = {}
    bcfg = dataclasses.replace(cfg, path_regen=False)
    for tag, fn, c in (
            ("bdpt", lambda st, c: render_pass_bdpt(scene, view, st, c),
             bcfg),
            ("scene_sharded", None, dataclasses.replace(
                bcfg, max_path_length=CLUSTER_SHARD_PATH))):
        if fn is None:
            work = tempfile.mkdtemp(prefix="chip_smoke_cshard_", dir=BUILD_DIR)
            init_distributed(f"file://{work}/store", num_processes=1,
                             process_id=0, device=dev)
            if dist.get_backend() != "nccl":
                raise AssertionError("(e) must run on NCCL")
            mesh = make_mesh2d(1, 1, device=dev)
            t0 = time.perf_counter()
            srep, sh, tree = shard_scene(scene, mesh, cluster=True)
            _sync(dev)
            shard_s = time.perf_counter() - t0
            fn = lambda st, c: render_pass_scene_sharded(
                srep, view, st, c, mesh, sh=sh, shard_cbvh=tree)
            auto_fn = lambda st, c: render_pass(scene, view, st, c)
        else:
            auto_fn = fn
        try:
            ccfg = dataclasses.replace(c, intersector="cluster")
            run(fn, ccfg)                                   # warm-up
            got, ms, launches = run(fn, ccfg)
            want, ms_auto, launches_auto = run(auto_fn, c)
        finally:
            if tag == "scene_sharded":
                dist.destroy_process_group()
                shutil.rmtree(work, ignore_errors=True)
        res[tag] = dict(ms=ms, ms_auto=ms_auto, launches=launches,
                        launches_auto=launches_auto,
                        agreement=_image_agreement(got, want))
    res["scene_sharded"]["shard_cluster_bvh_seconds"] = shard_s
    print("[cluster bdpt / scene shard] " + json.dumps(res), flush=True)
    for tag, r in res.items():
        a, l = r["agreement"], r["launches"]
        if not (a["frac_bad"] < FRAC_BAD_MAX and a["mean_rel"] < MEAN_REL_MAX):
            raise AssertionError(f"[cluster] {tag} differs from auto's: {a}")
        if (l["trace_closest"] or l["trace_occluded"]
                or not (l["cluster_closest"] and l["cluster_occluded"])):
            raise AssertionError(f"[cluster] {tag} launches: {l}")
    return res


def cluster_path(host, scene, view, cfg, dev, kern, train_prof):
    """Phase 19, [cluster]: intersector="cluster" (a)-(e). Returns the
    numbers, with the seconds each part took."""
    cb = scene.cbvh
    print(f"[cluster] ClusterBVH: {cb.n_nodes} top nodes, {cb.n_clusters} "
          f"clusters x {cb.tiles_per_cluster} tile(s), depth "
          f"{cb.max_depth}; bmat {_tensor_bytes(cb.bmat)} B, pgeo "
          f"{_tensor_bytes(cb.pgeo)} B", flush=True)
    import torch
    from lighthouse2_tpu_torch.render.kernels.cluster import ctas_per_sm
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = dict(closest=ctas_per_sm(False), occluded=ctas_per_sm(True), sms=sms)
    print(f"[cluster] CTAs (1024-ray blocks) resident an SM: closest "
          f"{occ['closest']}, occluded {occ['occluded']}, on {sms} SMs: "
          f"{occ['closest'] * sms} blocks a wave", flush=True)
    if min(occ["closest"], occ["occluded"]) < 2:
        raise AssertionError(f"the cluster kernels must hold two blocks an "
                             f"SM: {occ}")
    res, secs = {"ctas_per_sm": occ}, {}
    for key, fn in (
            ("kernels", lambda: cluster_kernels(scene, view, cfg, dev, kern,
                                                KERNEL_ITERS)),
            ("shade", lambda: shade_kernel_check(
                scene, view, dataclasses.replace(cfg, intersector="cluster"),
                dev)),
            ("tpc2", lambda: cluster_tpc2(host, scene, view, cfg, dev)),
            ("main", lambda: cluster_main(scene, view, cfg, dev,
                                          CLUSTER_PASSES)),
            ("train", lambda: cluster_train(scene, view, cfg, dev,
                                            train_prof)),
            ("reference", lambda: reference_check(dev, "cluster",
                                                  "[cluster reference] ")),
            ("bdpt_shard", lambda: cluster_bdpt_shard(scene, view, cfg,
                                                      dev))):
        t0 = time.perf_counter()
        res[key] = fn()
        secs[key] = time.perf_counter() - t0
    res["seconds"] = secs
    print("[cluster] seconds: " + json.dumps(secs), flush=True)
    return res


def _sync_count(fn):
    """fn() and the host synchronisations it makes on the card: the
    warnings of torch.cuda.set_sync_debug_mode("warn") while it runs.
    Returns (fn's result, count)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def _no_sync(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any operation
    that synchronises the host with the card raises. The mode is set back
    afterwards."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def staged_profile(scene, view, cfg, dev):
    """[executors] (c): one render_pass_staged under torch.profiler; the
    device ms of each stage summed over the bounces, from its
    record_function range (the kernels launched inside it), and its share
    of the pass's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch
    from lighthouse2_tpu_torch.render import wavefront as wf

    state = wf.AccumState.make(cfg, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wf.render_pass_staged(scene, view, state, cfg)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "device_time_total",
                               getattr(e, "cuda_time_total", 0.0))
    self_us = lambda e: getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0))
    device = _device_rows(prof)
    total = sum(self_us(e) for e in device)
    stages = {}
    for e in prof.key_averages():
        if e.key in EXEC_STAGES and e.device_type == DeviceType.CPU:
            stages[e.key] = dict(ms=dev_us(e) / 1e3, calls=e.count)
    # the kernels each range's device time holds: those whose launch the
    # profiler ties to an op inside it
    tied = {name: set() for name in EXEC_STAGES}

    def walk(e, stage):
        tied[stage].update(_kernel_name(k.name) for k in e.kernels)
        for ch in e.cpu_children:
            walk(ch, stage)
    for e in prof.events():
        if e.name in EXEC_STAGES and e.device_type == DeviceType.CPU:
            walk(e, e.name)
    # each trace kernel launches inside one stage only; where the profiler
    # does not tie a launch from the kernels' own library (ctypes, its own
    # CUDA runtime) to the range, its time is added to that stage by name
    for stage, kernel in (("_stage_trace", "closest_kernel"),
                          ("_stage_occlude", "occluded_kernel")):
        k_ms = sum(self_us(e) for e in device
                   if _kernel_name(e.key) == kernel) / 1e3
        s = stages.setdefault(stage, dict(ms=0.0, calls=0))
        s["kernel_ms"] = k_ms
        s["kernel_added_by_name"] = kernel not in tied[stage]
        if s["kernel_added_by_name"]:
            s["ms"] += k_ms
    for s in stages.values():
        s["share"] = s["ms"] * 1e3 / max(total, 1e-9)
    res = dict(wall_ms=wall * 1e3, device_ms=total / 1e3,
               device_busy_share=total / 1e3 / (wall * 1e3), stages=stages,
               stages_share=sum(s["share"] for s in stages.values()))
    print("[staged profile] " + json.dumps(res), flush=True)
    missing = [name for name in EXEC_STAGES if name not in stages]
    if missing:
        raise AssertionError(f"[staged profile] no range of {missing}")
    for name in EXEC_STAGES:
        s = stages[name]
        print(f"[staged profile] {name:15s} {s['ms']:9.3f} ms "
              f"{s['share']:7.2%} of the pass's device time, {s['calls']} "
              "calls", flush=True)
    return res


def executors_path(scene, view, dev, size=512, path_len=16):
    """Phase 20, [executors]: the JAX package's executor entry points on the
    bathroom at size^2, spp 1, path `path_len`, Lambert, intersector "auto"
    (BVH4). Returns the numbers per form."""
    import torch
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render import wavefront as wf

    cfg = RenderConfig(width=size, height=size, spp_per_pass=1,
                       max_path_length=path_len)
    rcfg = dataclasses.replace(cfg, path_regen=True)
    out, ref = {}, {}
    for name, fn_name, family, readback, captured in EXEC_FORMS:
        fn = getattr(wf, fn_name)
        c = rcfg if family == "regen" else cfg
        # no graph is left from an earlier form: (a) runs eagerly
        _clear_graphs()
        _zero_counts()
        one = lambda: fn(scene, view, wf.AccumState.make(c, dev), c)
        # (a) one pass from a fresh state, also the warm-up of (b). On the
        # card the forms without readback run it under the sync gate, which
        # raises on any host synchronisation (so they make none); the others
        # count theirs
        syncs = None
        if dev.type != "cuda":
            state, stats = one()
        elif readback:
            (state, stats), syncs = _sync_count(one)
        else:
            state, stats = _no_sync(one)
            syncs = 0
        launches = _counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ext = stats["extension_rays"].cpu()
        r = dict(family=family, launches=launches, host_syncs=syncs,
                 live_bounces=int((ext > 0).sum()),
                 extension_rays=ext.tolist(),
                 shadow_rays=stats["shadow_rays"].tolist(),
                 samples_completed=(int(stats["samples_completed"])
                                    if c.path_regen else None))
        if family not in ref:
            ref[family] = (state, r)
        rs, rr = ref[family]
        r["image_equal"] = bool(torch.equal(state.accumulator,
                                            rs.accumulator))
        if c.path_regen:
            r["image_equal"] &= bool(torch.equal(state.pixel_count,
                                                 rs.pixel_count))
        r["stats_equal"] = all(r[k] == rr[k] for k in (
            "extension_rays", "shadow_rays", "samples_completed"))
        # (b) one more pass (a graph entry point's capture), EXEC_PASSES
        # timed passes and one profiled pass
        per_call = []
        st, _ = _tallied(lambda: fn(scene, view, state, c), per_call)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(EXEC_PASSES):
            st, _ = _tallied(lambda: fn(scene, view, st, c), per_call)
        _sync(dev)
        r["wall_ms"] = (time.perf_counter() - t0) * 1e3 / EXEC_PASSES
        prof = _profile_replay(lambda: fn(scene, view, st, c), dev,
                               f"[executors] {name} profile: ", per_call,
                               cpu=False)
        r.update(device_ms=prof["device_ms"],
                 device_busy_share=prof["device_busy_share"],
                 device_launches=prof["device_launches"],
                 calls=[_call_kind(x, c, scene) for x in per_call],
                 profiled_kernels=prof["kernel_launches"])
        if captured:
            _replay_gates(f"[executors] {name}: ", c, scene, per_call,
                          ("capture",) + ("replay",) * (EXEC_PASSES + 1),
                          prof["kernel_launches"])
        elif any(x["replays"] for x in per_call):
            raise AssertionError(f"[executors] {name} replayed a graph: "
                                 f"{per_call}")
        print(f"[executors] {name}: " + json.dumps(r), flush=True)
        out[name] = r
    out["staged_profile"] = staged_profile(scene, view, cfg, dev)
    bad = []
    for name, r in ((k, v) for k, v in out.items() if k != "staged_profile"):
        want = {k: path_len for k in r["launches"]}
        if not (r["image_equal"] and r["stats_equal"]):
            bad.append(f"{name}: image or stats differ from "
                       f"{EXEC_REFERENCE[r['family']]}'s")
        if r["launches"] != want or r["live_bounces"] != path_len:
            bad.append(f"{name}: launches {r['launches']} over "
                       f"{r['live_bounces']} live bounces, want {path_len} "
                       "of each kernel, one a live bounce")
    if bad:
        raise AssertionError("[executors] " + "; ".join(bad))
    return out


def _captured(name):
    """The CapturedCall (render/graphs.py) of a graph entry point."""
    from lighthouse2_tpu_torch.diff import render as diff_render
    from lighthouse2_tpu_torch.render import wavefront as wf
    return dict(render_pass_unrolled=wf._unrolled_graph,
                _render_pass_regen_jit=wf._regen_graph,
                regen_value_and_grad=diff_render._step_graph)[name]


def _results(x):
    """(structure, tensors) of a result, in render/graphs.py's walk order."""
    from lighthouse2_tpu_torch.render import graphs
    tensors = []
    return graphs._walk(x, tensors), tensors


def _unequal(got, want):
    """Indices of the tensors of `got` that differ from `want`'s bit for bit
    (NaN == NaN); [-1] if the structures differ."""
    import torch
    sg, tg = _results(got)
    sw, tw = _results(want)
    if sg != sw:
        return [-1]
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return [i for i, (a, b) in enumerate(zip(tg, tw))
            if not torch.equal(bits(a), bits(b))]


def _timed(fn, dev, n):
    """fn() n times, each closed by a synchronize: (host ms of each, the
    last result)."""
    ms, out = [], None
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


def _kernel_syms(cfg, scene, grad=False):
    """(wrapper counts, profiler kernel names) of the config's kernels: its
    intersector's trace kernels, and the shade kernel where the config and
    scene take it and no gradient is needed (render/kernels/shade.py
    config_takes_kernel, use_kernel; `grad`: a call that needs gradients,
    which shades composed)."""
    from lighthouse2_tpu_torch.render.kernels.shade import (
        config_takes_kernel)
    if cfg.intersector == "cluster":
        counts = ("cluster_closest", "cluster_occluded")
        syms = ("cluster_closest_kernel", "cluster_occluded_kernel")
    else:
        counts = ("trace_closest", "trace_occluded")
        syms = ("closest_kernel", "occluded_kernel")
    if not grad and config_takes_kernel(cfg, scene):
        shade = (("shade_disney", SHADE_DISNEY_KERNEL) if cfg.bsdf == "disney"
                 else ("shade_kernel", SHADE_KERNEL))
        counts, syms = counts + shade[:1], syms + shade[1:]
    return counts, syms


def _graph_calls(call, dev, n, per_call):
    """n calls of a graph entry point (warm-up, capture, replays), each
    closed by a synchronize, its _tally deltas appended to `per_call`:
    (results, host ms of each call)."""
    results, ms = [], []
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        results.append(_tallied(call, per_call))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return results, ms


def graph_pass_run(tag, name, eager, scene, view, cfg, dev):
    """[graphs] (a) for one graph entry point of render/wavefront.py: from
    one state, GRAPH_PASSES passes through its eager body and GRAPH_PASSES
    calls of the entry point (warm-up, capture, replays) equal bit for bit,
    result by result (accumulator, pixel counts, pool, cam_seed,
    sample_count, stats); GRAPH_TIMED more of each timed (medians), one
    replay under the sync gate, one of each profiled; every call of the
    entry point the kind _replay_gates wants and the profiled replay's
    kernels; the capture's and instantiation's seconds and the pool's
    memory. Returns (numbers, the last state)."""
    import statistics
    import torch
    from lighthouse2_tpu_torch.render import wavefront as wf

    entry_fn = getattr(wf, name)
    state0 = wf.AccumState.make(cfg, dev)
    if cfg.path_regen:
        state0 = wf.ensure_regen_state(view, state0, cfg)
    _peak_memory(dev, reset=True)
    want, st = [], state0
    for _ in range(GRAPH_PASSES):
        st, stats = eager(scene, view, st, cfg)
        want.append((st, stats))
    eager_ms, _ = _timed(lambda: eager(scene, view, st, cfg), dev,
                         GRAPH_TIMED)
    eager_peak = _peak_memory(dev)
    eager_prof = _profile(lambda: eager(scene, view, st, cfg), dev,
                          f"[graphs] {tag} eager profile: ", cpu=False)

    _captured(name).clear()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    _peak_memory(dev, reset=True)
    held, per_call = [state0], []

    def call():
        out = entry_fn(scene, view, held[-1], cfg)
        held.append(out[0])
        return out
    got, call_ms = _graph_calls(call, dev, GRAPH_PASSES, per_call)
    e = _captured(name).entry
    pool = torch.cuda.memory_reserved(dev) - reserved0
    unequal = [_unequal(g, w) for g, w in zip(got, want)]
    st = got[-1][0]
    replay = lambda: _tallied(lambda: entry_fn(scene, view, st, cfg),
                              per_call)
    replay_ms, _ = _timed(replay, dev, GRAPH_TIMED)
    _no_sync(replay)
    graph_peak = _peak_memory(dev)
    replay_prof = _profile_replay(lambda: entry_fn(scene, view, st, cfg),
                                  dev, f"[graphs] {tag} replay profile: ",
                                  per_call, cpu=False)
    res = dict(
        entry=name, intersector=cfg.intersector, path_regen=cfg.path_regen,
        equal_calls=[not u for u in unequal], unequal_tensors=unequal,
        call_ms=call_ms, launches_per_call=per_call,
        calls=[_call_kind(c, cfg, scene) for c in per_call],
        eager_ms=eager_ms, replay_ms=replay_ms,
        wall_ms_eager=statistics.median(eager_ms),
        wall_ms_replay=statistics.median(replay_ms),
        device_ms_eager=eager_prof["device_ms"],
        device_ms_replay=replay_prof["device_ms"],
        busy_eager=eager_prof["device_ms"] / statistics.median(eager_ms),
        busy_replay=replay_prof["device_ms"] / statistics.median(replay_ms),
        busy_eager_profiled=eager_prof["device_busy_share"],
        busy_replay_profiled=replay_prof["device_busy_share"],
        launches_eager=eager_prof["device_launches"],
        launches_replay=replay_prof["device_launches"],
        capture_seconds=e.capture_seconds,
        instantiate_seconds=e.instantiate_seconds,
        pool_reserved_bytes=pool, peak_eager=eager_peak,
        peak_graph=graph_peak, replay_kernels=replay_prof["kernel_launches"],
        replay_kernel_ms_per_launch=replay_prof["kernel_ms_per_launch"])
    print(f"[graphs] {tag}: " + json.dumps(res), flush=True)
    if not all(res["equal_calls"]):
        raise AssertionError(f"[graphs] {tag}: graph and eager results "
                             f"differ: {unequal}")
    # the calls after the capture, the timed, the gated and the profiled
    # replays
    _replay_gates(f"[graphs] {tag}: ", cfg, scene, per_call, ("eager", "capture")
                  + ("replay",) * (GRAPH_PASSES - 2 + GRAPH_TIMED + 2),
                  replay_prof["kernel_launches"])
    return res, st


def graph_changes(scene, cam, view, cfg, state, dev):
    """[graphs] (b), on the live regen graph of (a): a moved camera
    (GRAPH_MOVE) and a new colour for every material (its channels
    reversed), the shapes kept, each one replay equal to its eager pass
    from the same state; then a Cornell box synced to the card (other
    shapes) takes a new key, whose first call runs eagerly and equals the
    eager pass."""
    import copy
    import numpy as np
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    from lighthouse2_tpu_torch.render import wavefront as wf
    from lighthouse2_tpu_torch.scene.presets import cornell_box

    name = "_render_pass_regen_jit"
    e = _captured(name).entry
    moved = copy.deepcopy(cam)
    moved.position = moved.position + np.float32(GRAPH_MOVE)
    recoloured = set_material_fields(
        scene, color=scene.materials.color.flip(-1).contiguous())
    res = {}
    for tag, sc, vw in (("moved_camera", scene, moved.get_view(dev)),
                        ("new_colour", recoloured, view)):
        c = []
        got = _tallied(lambda: wf._render_pass_regen_jit(sc, vw, state, cfg),
                       c)
        want = wf._regen_pass(sc, vw, state, cfg)
        res[tag] = dict(replayed=_captured(name).entry is e
                        and _call_kind(c[0], cfg, scene) == "replay",
                        unequal_tensors=_unequal(got, want),
                        image_mean=wf.finalize(got[0]).mean().item())
    host_c, cam_c = cornell_box(cfg.width, cfg.height)
    sc, vw = host_c.sync(dev), cam_c.get_view(dev)
    st = wf.ensure_regen_state(vw, wf.AccumState.make(cfg, dev), cfg)
    got = wf._render_pass_regen_jit(sc, vw, st, cfg)
    e2 = _captured(name).entry
    res["other_shapes"] = dict(
        new_key=e2 is not e and e2.key != e.key, eager=e2.graph is None,
        unequal_tensors=_unequal(got, wf._regen_pass(sc, vw, st, cfg)))
    print("[graphs] changes between replays: " + json.dumps(res), flush=True)
    bad = [k for k, r in res.items()
           if r["unequal_tensors"] or not r.get("replayed", True)
           or not r.get("new_key", True) or not r.get("eager", True)]
    if bad:
        raise AssertionError(f"[graphs] changes between replays: {bad}")
    return res


def _grad_rel(a, b):
    return {k: ((a[k] - b[k]).norm() / b[k].norm().clamp(min=1e-30)).item()
            for k in b}


def _spread(eager_sets):
    """Per gradient group, the largest relative L2 distance between two
    eager steps from one input, over the sets of such steps."""
    return {k: max(_grad_rel(a, b)[k] for es in eager_sets
                   for i, a in enumerate(es) for b in es[:i])
            for k in eager_sets[0][0]}


def _nearest(got, eagers):
    """Per gradient group, the relative L2 distance of `got` to the
    nearest of `eagers`."""
    return {k: min(_grad_rel(got, e)[k] for e in eagers) for k in got}


def graph_step_run(tag, scene, view, cfg, dev):
    """[graphs] (c): the headline step (regen_value_and_grad, grads "all",
    remat) from one state: GRAPH_PASSES eager steps (diff/render.py
    fb_pass, its eager body) and GRAPH_PASSES calls of the entry point
    (warm-up, capture, replays); GRAPH_TIMED timed steps of each
    (medians), one replay profiled; then GRAPH_OPT_STEPS replays whose
    parameter leaves (requiring grad) torch.optim.Adam steps in place
    between them from the replays' gradients, each against fb_pass on the
    same leaves and state. For every compared call: loss and state bit-
    equal; each gradient group equal, or, where not (the cluster path's
    re-attach backward sums with atomics), within the eager spread:
    eager steps from its inputs (GRAPH_SPREAD_STEPS), and the graph step
    no farther from the nearest of them (_nearest) than two eager steps
    from one input are apart, at most, over the compared calls (_spread).
    Fwd+bwd Mrays/s (the rays of one forward stats pass,
    bench.py:129-134), peak memory, the replay's kernels by the profiler
    (_replay_gates). Returns the numbers."""
    import statistics
    from lighthouse2_tpu_torch.diff.render import fb_pass, regen_value_and_grad
    from lighthouse2_tpu_torch.render import wavefront as wf
    import torch

    name = "regen_value_and_grad"
    params, target = _headline_params(scene, cfg.width, dev)
    state0 = wf.ensure_regen_state(view, wf.AccumState.make(cfg, dev), cfg)
    _, stats0 = wf._regen_pass(scene, view, state0, cfg)
    rays = int(stats0["total_extension"]) + int(stats0["total_shadow"])
    _peak_memory(dev, reset=True)
    held = [state0]

    def eager():
        out = fb_pass(scene, view, held[-1], cfg, target, params)
        held.append(out[2])
        return out
    eager_ms, want = [], []
    for _ in range(GRAPH_TIMED):
        ms, out = _timed(eager, dev, 1)
        eager_ms += ms
        want.append(out)
    eager_peak = _peak_memory(dev)
    eager_prof = _profile(lambda: fb_pass(scene, view, state0, cfg, target,
                                          params), dev,
                          f"[graphs] {tag} eager profile: ", cpu=False)

    _captured(name).clear()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved(dev)
    _peak_memory(dev, reset=True)
    held, per_call = [state0], []

    def call():
        out = regen_value_and_grad(scene, view, held[-1], cfg, target, params)
        held.append(out[2])
        return out
    got, call_ms = _graph_calls(call, dev, GRAPH_PASSES, per_call)
    e = _captured(name).entry
    pool = torch.cuda.memory_reserved(dev) - reserved0
    # (graph result, eager result, the inputs both started from)
    compared = [(g, w, (s, params))
                for g, w, s in zip(got, want, held[:GRAPH_PASSES])]
    st = got[-1][2]
    step = lambda: regen_value_and_grad(scene, view, st, cfg, target, params)
    replay_ms, _ = _timed(lambda: _tallied(step, per_call), dev, GRAPH_TIMED)
    graph_peak = _peak_memory(dev)
    replay_prof = _profile_replay(step, dev, f"[graphs] {tag} replay "
                                  "profile: ", per_call, cpu=False)

    # an optimizer's in-place step between replays: the replay must copy
    # the stepped leaves (same storage, a new version) into the graph
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=GRAPH_OPT_LR)
    for _ in range(GRAPH_OPT_STEPS):
        snap = {k: v.detach().clone() for k, v in leaves.items()}
        out = _tallied(lambda: regen_value_and_grad(scene, view, st, cfg,
                                                    target, leaves),
                       per_call)
        compared.append((out, fb_pass(scene, view, st, cfg, target, snap),
                         (st, snap)))
        for k, g in out[1].items():
            leaves[k].grad = g
        opt.step()
        st = out[2]

    fwd = [_unequal((g[0], g[2]), (w[0], w[2])) for g, w, _ in compared]
    grad_equal = [not _unequal(g[1], w[1]) for g, w, _ in compared]
    # eager steps from the inputs of each step whose gradients differ
    sets = {i: [w[1]] for i, ((_, w, _), eq) in enumerate(zip(compared,
                                                              grad_equal))
            if not eq}
    spread, nearest = None, {}
    for n in GRAPH_SPREAD_STEPS if sets else ():
        for i, es in sets.items():
            s, p = compared[i][2]
            es += [fb_pass(scene, view, s, cfg, target, p)[1]
                   for _ in range(n - len(es))]
        spread = _spread(list(sets.values()))
        nearest = {i: _nearest(compared[i][0][1], es)
                   for i, es in sets.items()}
        if all(v == 0.0 or v <= spread[k]
               for near in nearest.values() for k, v in near.items()):
            break
    res = dict(
        intersector=cfg.intersector, rays_per_step=rays,
        forward_unequal=fwd, grads_equal=grad_equal,
        grad_rel_l2=[_grad_rel(g[1], w[1]) for g, w, _ in compared],
        grad_nearest_eager=[nearest.get(i) for i in range(len(compared))],
        grad_eager_spread=spread,
        eager_steps_a_set=len(next(iter(sets.values()))) if sets else None,
        call_ms=call_ms,
        launches_per_call=per_call,
        calls=[_call_kind(c, cfg, scene, grad=True) for c in per_call],
        eager_ms=eager_ms, replay_ms=replay_ms,
        ms_step_eager=statistics.median(eager_ms),
        ms_step_replay=statistics.median(replay_ms),
        mrays_per_s_eager=rays / statistics.median(eager_ms) / 1e3,
        mrays_per_s_replay=rays / statistics.median(replay_ms) / 1e3,
        device_ms_eager=eager_prof["device_ms"],
        device_ms_replay=replay_prof["device_ms"],
        busy_eager=eager_prof["device_ms"] / statistics.median(eager_ms),
        busy_replay=replay_prof["device_ms"] / statistics.median(replay_ms),
        busy_eager_profiled=eager_prof["device_busy_share"],
        busy_replay_profiled=replay_prof["device_busy_share"],
        launches_eager=eager_prof["device_launches"],
        launches_replay=replay_prof["device_launches"],
        capture_seconds=e.capture_seconds,
        instantiate_seconds=e.instantiate_seconds,
        pool_reserved_bytes=pool, peak_eager=eager_peak,
        peak_graph=graph_peak, replay_kernels=replay_prof["kernel_launches"])
    print(f"[graphs] {tag}: " + json.dumps(res), flush=True)
    bad = [i for i, u in enumerate(fwd)
           if u or (i in nearest and not all(
               v == 0.0 or v <= spread[k] for k, v in nearest[i].items()))]
    if bad:
        raise AssertionError(f"[graphs] {tag}: graph and eager steps differ "
                             f"at compared calls {bad}")
    _replay_gates(f"[graphs] {tag}: ", cfg, scene, per_call, ("eager", "capture")
                  + ("replay",) * (GRAPH_PASSES - 2 + GRAPH_TIMED + 1
                                   + GRAPH_OPT_STEPS),
                  replay_prof["kernel_launches"], grad=True)
    return res


def graphs_path(scene, cscene, view, cam, dev, size=512, path_len=16):
    """Phase 21, [graphs]: the three entry points render/graphs.py captures,
    at the main path's configuration (bathroom size^2, spp 1, path
    `path_len`, Lambert): (a) graph_pass_run for the regen pass on "auto",
    then (b) graph_changes on its graph, the unrolled pass on "auto" and
    the regen pass on "cluster" (`cscene`, synced with its tiles); (c)
    graph_step_run for the fwd+bwd step on "auto" and on "cluster".
    Returns the numbers by run."""
    import dataclasses as dc
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render import wavefront as wf

    base = RenderConfig(width=size, height=size, spp_per_pass=1,
                        max_path_length=path_len)
    regen = dc.replace(base, path_regen=True)
    out = {}
    out["regen_auto"], st = graph_pass_run(
        "regen auto", "_render_pass_regen_jit", wf._regen_pass, scene, view,
        regen, dev)
    out["changes"] = graph_changes(scene, cam, view, regen, st, dev)
    out["unrolled_auto"], _ = graph_pass_run(
        "unrolled auto", "render_pass_unrolled", wf._unrolled_pass, scene,
        view, base, dev)
    out["regen_cluster"], _ = graph_pass_run(
        "regen cluster", "_render_pass_regen_jit", wf._regen_pass, cscene,
        view, dc.replace(regen, intersector="cluster"), dev)
    step = dc.replace(regen, remat=True)
    out["step_auto"] = graph_step_run("step auto", scene, view, step, dev)
    out["step_cluster"] = graph_step_run(
        "step cluster", cscene, view, dc.replace(step, intersector="cluster"),
        dev)
    for name in ("render_pass_unrolled", "_render_pass_regen_jit",
                 "regen_value_and_grad"):
        _captured(name).clear()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from lighthouse2_tpu_torch.core.types import RenderConfig
        from lighthouse2_tpu_torch.render.kernels.cluster import (
            SOURCE as CLUSTER_SOURCE)
        from lighthouse2_tpu_torch.render.kernels.shade import (
            SOURCE as SHADE_SOURCE)
        from lighthouse2_tpu_torch.render.kernels.trace import (
            BUILD_DIR, SOURCE, build_library)
        from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    SOURCES = (SOURCE, CLUSTER_SOURCE, SHADE_SOURCE)
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

    secs, mark = {}, [time.perf_counter()]

    def lap(phase):
        """The seconds since the last lap, under `phase`."""
        now = time.perf_counter()
        secs[phase] = now - mark[0]
        mark[0] = now

    t0 = time.perf_counter()
    # one nvcc for each source, started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build_library, SOURCES))
    for so, log in built:
        print(f"[build] {so}\n{log.strip()}", flush=True)
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lap("build")

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

    lap("scene")
    kern = check_kernels(scene, view, cfg, dev, KERNEL_ITERS, PLAIN_ITERS)
    single_ms = time_kernels(trees["single_level_numpy"], scene, view, cfg,
                             dev, KERNEL_ITERS)
    del trees
    print("[kernels] single-level numpy tree, same batches: "
          + json.dumps(single_ms), flush=True)
    lap("kernels")
    shade_auto = shade_kernel_check(scene, view, cfg, dev)
    d_scene, d_view, d_cfg = disney_bathroom(cfg, dev)
    shade_disney = shade_kernel_check(d_scene, d_view, d_cfg, dev)
    disney_fwd, _ = main_path(d_scene, d_view, d_cfg, dev, passes=3,
                              tag="[disney kernel] ")
    del d_scene, d_view
    main_res, state = main_path(scene, view, cfg, dev, passes=3)
    print(f"[main] {main_res['mrays_per_s']:.3f} Mrays/s on {card} "
          f"(bathroom {size}x{size}, path {path_len}, regen)", flush=True)
    lambert_prof = main_res["profile"]
    reference_check(dev)
    lap("main")
    train_res, _ = train_path(scene, view, cfg, dev, TRAIN_STEPS)
    train_prof = train_res["profile"]
    grad_reference_check(dev)
    lap("train")

    disney_res, api = disney_path(cfg, dev, DISNEY_PASSES)
    lambert_api = lambert_api_path(host, cam, cfg, dev, DISNEY_PASSES)
    print(f"[disney] {disney_res['mrays_per_s']:.3f} Mrays/s, "
          f"{disney_res['mean_ms_per_pass']:.1f} ms/pass on {card} (bathroom "
          f"{size}x{size}, path {path_len}, regen, Disney, IBL; Lambert "
          f"through RenderAPI {lambert_api['mrays_per_s']:.3f} Mrays/s, "
          f"{lambert_api['mean_ms_per_pass']:.1f} ms/pass; wall ratio "
          f"{disney_res['mean_ms_per_pass'] / lambert_api['mean_ms_per_pass']:.3f}"
          f")", flush=True)
    disney_prof = disney_res["profile"]
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
    lap("disney_golden")

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
    lap("anim_cli")

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
    lap("filter")
    probe_res = probe_path(scene, cam, dev)
    app_dir = tempfile.mkdtemp(prefix="chip_smoke_apps_", dir=BUILD_DIR)
    try:
        viewer = viewer_check(dev, app_dir)
        ai_check(dev, app_dir)
    finally:
        shutil.rmtree(app_dir, ignore_errors=True)
    lap("probe_apps")

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
    lap("bdpt")
    par = parallel_path(host, cam, dev, size, path_len)
    print(f"[parallel] sharded {min(par['sharded_ms']):.1f} ms, unsharded "
          f"{min(par['unsharded_ms']):.1f} ms a pass on {card} (one NCCL "
          f"rank, bathroom {size}x{size}, classic, path {path_len}); "
          f"{par['collective_bytes']['total_bytes']} bytes all-reduced a "
          "pass", flush=True)
    lap("parallel")
    shard = scene_shard_path(host, cam, dev, size, path_len)
    rk = shard["ranks"]
    print(f"[scene shard] (a) one NCCL rank, 1x1: sharded "
          f"{min(shard['sharded_ms']):.1f} ms, unsharded "
          f"{min(shard['unsharded_ms']):.1f} ms a pass on {card} (bathroom "
          f"{size}x{size}, classic, path {path_len}); peak "
          f"{shard['max_memory_allocated'] / 1e9:.3f} GB; shard "
          f"{shard['bytes']['shard']} B against the replicated triangles and "
          f"tree {shard['bytes']['replicated_tris_and_bvh']} B; collectives "
          f"{shard['collective_bytes']['scene']['total_bytes']} B over scene "
          f"+ {shard['collective_bytes']['rays']['total_bytes']} B over rays "
          f"a pass. (b) {rk['mesh'][0]}x{rk['mesh'][1]} gloo ranks on one "
          f"card: {min(rk['ms']):.1f} ms a pass (gloo stages every "
          f"collective through the host: not NCCL's cost), peak "
          f"{max(rk['max_memory_allocated']) / 1e9:.3f} GB and shard "
          f"{max(rk['shard_bytes'])} B a rank, collectives "
          f"{rk['collective_bytes']['scene']['total_bytes']} B over scene + "
          f"{rk['collective_bytes']['rays']['total_bytes']} B over rays a "
          f"pass a rank; pixels off {rk['agreement']['frac_bad']:.2e}",
          flush=True)
    lap("scene_shard")
    default_scene = scene
    # the cluster tiles are cut for phase 19 only, so that no earlier phase
    # holds them
    scene = host.sync(dev, clusters=True)
    print("[cluster] sync with the cluster tiles, host seconds: "
          + json.dumps(host.sync_seconds), flush=True)
    clus = cluster_path(host, scene, view, cfg, dev, kern, train_prof)
    cm, ct = clus["main"], clus["train"]
    print(f"[cluster] {cm['mrays_per_s']:.3f} Mrays/s, "
          f"{cm['ms_per_pass']:.1f} ms a pass, peak "
          f"{cm['max_memory_allocated'] / 1e9:.3f} GB on {card} (bathroom "
          f"{size}x{size}, path {path_len}, regen, intersector=\"cluster\"); "
          f"{cm['profile']['device_ms']:.1f} ms of device time, "
          f"{cm['profile']['device_launches']} device launches; fwd+bwd "
          f"{ct['ms_per_step']:.1f} ms a step, peak "
          f"{ct['max_memory_allocated'] / 1e9:.3f} GB, re-attach backward "
          f"{ct['shares']['cluster']['reattach_index_add']:.1%} of its device "
          f"time (the auto step's gather backward "
          f"{ct['shares']['auto']['gather_backward']:.1%})", flush=True)
    lap("cluster")
    t0 = time.perf_counter()
    execs = executors_path(default_scene, view, dev, size, path_len)
    print("[executors] on " + card + ": " + json.dumps({
        name: {k: r[k] for k in ("wall_ms", "device_ms", "device_busy_share",
                                 "device_launches", "host_syncs")}
        for name, r in execs.items() if name != "staged_profile"})
        + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    lap("executors")
    t0 = time.perf_counter()
    graph_res = graphs_path(default_scene, scene, view, cam, dev, size,
                            path_len)
    print("[graphs] on " + card + ": " + json.dumps({
        name: {k: r[k] for k in GRAPH_SUMMARY if k in r}
        for name, r in graph_res.items() if name != "changes"})
        + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    lap("graphs")
    print("[seconds] by phase: " + json.dumps(secs) + f"; total "
          f"{sum(secs.values()):.1f}", flush=True)

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
            launches_main=_launch_summary(main_res, name, sym),
            launches_fwd_bwd=_launch_summary(train_res, name, sym),
            launches_disney=_launch_summary(disney_res, name, sym),
            launches_disney_fwd_bwd=_launch_summary(disney_train, name, sym),
            launches_anim_per_frame=[f["launches"][name]
                                     for f in anim["frames"]],
            launches_filter=_launch_summary(filt, name, sym),
            launches_probe=dict(
                heatmap=probe_res["launches_heatmap"][name],
                probe_pixel_grid=probe_res["launches_probe_grid"][name],
                gbuffer_views=probe_res["launches_gbuffer"][name],
                viewer_session=viewer["launches"][name]),
            launches_bdpt_per_pass=bdpt["launches_per_pass"][-1][name],
            launches_executors_per_pass={
                f: r["launches"][name] for f, r in execs.items()
                if f != "staged_profile"},
            launches_graph_calls={
                f: [c[name] for c in graph_res[f]["launches_per_call"]]
                for f in ("regen_auto", "unrolled_auto", "step_auto")},
            launches_graph_replay_profiled=graph_res["regen_auto"][
                "replay_kernels"][sym],
            launches_sharded_per_pass=par["launches_per_sharded_pass"][-1][
                name],
            launches_scene_sharded_per_pass=shard[
                "launches_per_sharded_pass"][-1][name],
            launches_scene_sharded_per_rank_pass=[
                r[name] for r in shard["ranks"]["launches_per_pass"]],
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
    for name, batch, line, sym in (
            ("cluster_closest", "bounce1", 229, "cluster_closest_kernel"),
            ("cluster_occluded", "shadow", 414, "cluster_occluded_kernel")):
        k = clus["kernels"][name][batch]
        rows.append(dict(
            name=name, route="cuda",
            source="lighthouse2_tpu_torch/csrc/cluster_trace.cu",
            replaces=f"lighthouse2_tpu/render/kernels/trace.py:{line}",
            launches=cm["launches"][name],
            launches_main=_launch_summary(cm, name, sym),
            launches_fwd_bwd=_launch_summary(ct, name, sym),
            launches_bdpt_per_pass=clus["bdpt_shard"]["bdpt"]["launches"][
                name],
            launches_scene_sharded_per_pass=clus["bdpt_shard"][
                "scene_sharded"]["launches"][name],
            launches_graph_calls={
                f: [c[name] for c in graph_res[f]["launches_per_call"]]
                for f in ("regen_cluster", "step_cluster")},
            launches_graph_replay_profiled=graph_res["regen_cluster"][
                "replay_kernels"][sym],
            main_path_ms_per_launch=cm["profile"]["kernel_ms_per_launch"][
                sym],
            ms_by_batch={bt: v["ms"] for bt, v in
                         clus["kernels"][name].items()},
            plain_ms_by_batch={bt: v["plain_ms"] for bt, v in
                               clus["kernels"][name].items()},
            bound_ms_by_batch={bt: v["bound_ms"] for bt, v in
                               clus["kernels"][name].items()},
            copies_by_batch={bt: v["copies"] for bt, v in
                             clus["kernels"][name].items()},
            ctas_per_sm=clus["ctas_per_sm"],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None))
    sym = SHADE_KERNEL
    rows.append(dict(
        name="shade_kernel", route="cuda",
        source="lighthouse2_tpu_torch/csrc/shade.cu",
        replaces=None, launches=main_res["launches_per_call"][0][
            "shade_kernel"],
        launches_main=_launch_summary(main_res, "shade_kernel", sym),
        launches_fwd_bwd=_launch_summary(train_res, "shade_kernel", sym),
        launches_disney=_launch_summary(disney_res, "shade_kernel", sym),
        launches_filter=_launch_summary(filt, "shade_kernel", sym),
        launches_cluster_main=_launch_summary(cm, "shade_kernel", sym),
        launches_executors_profiled={
            f: r["profiled_kernels"][sym] for f, r in execs.items()
            if f != "staged_profile"},
        launches_graph_calls={
            f: [c["shade_kernel"] for c in graph_res[f]["launches_per_call"]]
            for f in ("regen_auto", "unrolled_auto", "regen_cluster",
                      "step_auto", "step_cluster")},
        main_path_ms_per_launch=dict(
            lambert=lambert_prof["kernel_ms_per_launch"][sym],
            cluster=cm["profile"]["kernel_ms_per_launch"][sym]),
        ms=dict(gathers=shade_auto["ms"], payload=clus["shade"]["ms"]),
        bound_ms=dict(gathers=shade_auto["bound_ms"],
                      payload=clus["shade"]["bound_ms"]),
        bound_by="bytes",
        composed_eager_ms=dict(gathers=shade_auto["composed_eager_ms"],
                               payload=clus["shade"]["composed_eager_ms"]),
        lanes_off_max={rows: {b: max(r[b]["off"].values())
                              for b in ("bounce0", "one_pass_in")}
                       for rows, r in (("gathers", shade_auto),
                                       ("payload", clus["shade"]))},
        library_ms=None))
    sym = SHADE_DISNEY_KERNEL
    rows.append(dict(
        name="shade_disney_kernel", route="cuda",
        source="lighthouse2_tpu_torch/csrc/shade.cu",
        replaces=None, launches=shade_disney["bounce0"]["launches"],
        launches_disney_ibl=_launch_summary(disney_res, "shade_disney", sym),
        launches_main=_launch_summary(disney_fwd, "shade_disney", sym),
        main_path_ms_per_launch=disney_fwd["profile"][
            "kernel_ms_per_launch"][sym],
        ms=dict(gathers=shade_disney["ms"]),
        bound_ms=dict(gathers=shade_disney["bound_ms"]), bound_by="bytes",
        composed_eager_ms=dict(gathers=shade_disney["composed_eager_ms"]),
        lanes_off_max={b: max(shade_disney[b]["off"].values())
                       for b in ("bounce0", "one_pass_in")},
        library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scene-shard-rank"]:
        scene_shard_rank(int(sys.argv[2]), *sys.argv[3:7])
        sys.exit(0)
    sys.exit(main())
