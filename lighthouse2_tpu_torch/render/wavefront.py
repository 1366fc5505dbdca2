"""The wavefront path tracer, in PyTorch: the classic fixed-spp executor
(run three ways: with its all-dead skip, staged, unrolled) and the
path-regeneration executor, all differentiable.

Counterpart of lighthouse2_tpu/render/wavefront.py under its own names:
AccumState, finalize, _clamp_intensity, _fixnan, _masked_div, _tiled_pixel,
untile_image, generate_eye_rays, _pick_intersector, _intersect /
_occluded (their BVH and brute-force branches), bounce_step (with the
intersect_fn / occluded_fn hooks of scene sharding), make_shading,
shade_bounce, apply_shadow, _finish_pass, trace_paths (with the filter's
G-buffer stream and filter_aux), render_pass and render_pass_jit, the
staged executor (_stage_generate, _stage_prepare, _stage_trace,
_stage_shade, _stage_occlude, _stage_apply, _stage_finish,
render_pass_staged), trace_paths_unrolled and render_pass_unrolled,
make_regen_pool, trace_paths_regen, ensure_regen_state,
_render_pass_regen_jit, render_pass_regen and render_pass_auto.

Each bounce traces (trace_closest), refines the hit and shades with NEE,
traces the shadow batch (trace_occluded) and accumulates. The classic
executor runs max_path_length bounces over a fresh wavefront of W*H*spp
lanes; the regen executor runs them over a persistent pool whose dead lanes
restart on a fresh sample of their pixel at every bounce, each lane at its
own path depth.

Gradients flow to whatever scene tensors require them (diff/params.py):
traversal is discrete and takes none, refine_hit reparameterises the hit.
Accumulation is functional (acc = acc + ...), as the JAX package's
.at[].add, so a bounce can be recomputed. With config.remat each bounce's
refine + shade runs under torch.utils.checkpoint (non-reentrant) and is
recomputed in the backward; the counter-based RNG replays the same samples.
Both trace launches stay outside the recomputed region and the backward
launches no kernel: their outputs ((t, prim, u, v) and occ, each [N]) are
small and saved.

The shade stage (shade_bounce) is one launch of a shade kernel
(render/kernels/shade.py, csrc/shade.cu) for a forward Lambert or Disney
bounce on a card, by the kernels' rule (use_kernel), in every executor;
everything else, the CPU, gradients, the filter, IBL sky NEE and scene
sharding, runs the composed code (_shade_composed), which is also the
kernels' plain version.

Stage marks (utils/telemetry.py): the bounce loop that trace_paths,
trace_paths_unrolled and trace_paths_regen share opens each stage of a
bounce with a device mark, which a CUDA graph captures with the pass:
generate (regeneration, or the eye rays and the live-lane count), trace
(with the cluster path's ray sort and payload fetch; the payload pack
before the loop is opened by one more trace mark), refine, shade (and,
in the composed shade code, its parts nee and sample), occlude, apply
(with the bounce's counters), then finish (untile, accumulate, stats)
after the loop, and end where the executor's pass ends (its new state
built). The recompute of config.remat in the backward launches no mark.
render_pass_staged places none: its stages run under host spans of their
names.

Differences from the JAX package:
  - a Python bounce loop instead of lax.scan / lax.cond; remat recomputes
    refine + shade only, where jax.checkpoint wraps the whole bounce
    including traversal;
  - jax.jit's counterpart is a CUDA graph (render/graphs.py): on a card,
    render_pass_unrolled and _render_pass_regen_jit (so render_pass_regen,
    render_pass_auto and the cores) are captured at the second call with
    the same key and replayed from then on, the state not donated;
    trace_paths_unrolled and trace_paths_regen stay their eager bodies.
    render_pass_jit (one bool read back a bounce, which a graph cannot
    hold) and the stages run eagerly;
  - AccumState's sample_count (int32) and cam_seed (int64 carrying the
    uint32) are 0-d device tensors, as JAX's scalars, so a pass advances
    them on the device;
  - trace_paths's all-lanes-dead skip (JAX's lax.cond) costs one host
    readback per bounce (the `any` of the alive mask), so render_pass and
    render_pass_jit read one bool back a bounce. The staged, unrolled and
    regen executors read nothing back: the first two run every bounce, a
    dead one on dead lanes (exact zeros, the same cam_seed advance), and
    after regeneration every lane of the regen pool is alive. So
    render_pass_auto, which takes render_pass_unrolled on the card as JAX
    takes it on an accelerator, launches each trace kernel once a bounce;
  - masks are bool tensors, which carry no gradient, so the stop_gradient
    JAX puts on the dead mask and the completed-sample count has no
    counterpart;
  - the intersector is the BVH4 trace kernels (trace_closest /
    trace_occluded) whenever the scene has a BVH and config.use_bvh, with
    intersector "auto" or "lockstep"; "auto" never resolves to "cluster"
    (JAX's resolves to its Pallas cluster kernel on an accelerator), which
    stays a choice for the benchmark; "cluster" takes the cluster-tile
    kernels (render/kernels/cluster.py) on the scene's ClusterBVH (cut by
    HostScene.sync(clusters=True)) and drops to the BVH4 kernels without
    one, as JAX drops to its lockstep walk;
    "brute" (or use_bvh=False, or a scene without a BVH) takes
    core/geometry.py's brute force, on detached rays as the kernels take
    them;
  - on the cluster path the trace returns the kernel's payload, the hit's
    int32 triangle id (ClusterBVH.prim) and t; the refine re-attaches the
    payload's geometry rows to tri9 (render/fetch.py) in the shade stage,
    so remat recomputes it as for the other paths;
  - filter_enabled with the regen executor raises ValueError where JAX
    asserts;
  - the render_pass family rejects scene_sharded=True: the scene-sharded
    pass is parallel/scene_shard.py's render_pass_scene_sharded, which runs
    trace_paths with its own intersect_fn / occluded_fn (keyword-only
    after JAX's arguments). trace_paths takes the path_idx shards of the
    parallel layer (parallel/mesh.py) as JAX's does;
  - intersect_fn returns the traversal's winner (t, prim, u, v) and the
    payload rows, and the refine from those rows runs in the shade stage
    (so remat recomputes it and no collective of the hook is recomputed);
    JAX's hook returns the refined hit.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from lighthouse2_tpu_torch.bvh.traverse import refine_hit, refine_hit_rows
from lighthouse2_tpu_torch.core import bluenoise as bn
from lighthouse2_tpu_torch.core import rng as rng_mod
from lighthouse2_tpu_torch.core.geometry import (
    BIG_T, dot, intersect_bruteforce, normalize, occluded_bruteforce,
    safe_origin)
from lighthouse2_tpu_torch.core.types import RenderConfig, ViewPyramid
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.render import bsdf_disney, bsdf_lambert, graphs
from lighthouse2_tpu_torch.render.fetch import reattach_rows
from lighthouse2_tpu_torch.render.kernels.cluster import (
    bake_material_rows, prepare_pay_tiles, ray_sort_perm, trace_cluster_bvh)
from lighthouse2_tpu_torch.render.kernels import shade as shade_k
from lighthouse2_tpu_torch.render.kernels.trace import trace_closest, trace_occluded
from lighthouse2_tpu_torch.render.lights import (
    calculate_light_pdf, light_pick_prob, random_point_on_light,
    sky_pick_prob)
from lighthouse2_tpu_torch.render.shading import (
    PAY_V0, get_shading_data, material_pack, shading_from_payload)
from lighthouse2_tpu_torch.render.sky import sample_skydome, sky_pdf
from lighthouse2_tpu_torch.scene.device_scene import DeviceScene
from lighthouse2_tpu_torch.utils import telemetry

EPSILON = 1e-4   # pathtracer epsilon for pdf cutoff


@dataclasses.dataclass
class AccumState:
    """Progressive-accumulation state (rendercore.cpp:627-634) plus the
    regen executor's per-pixel completed-sample counts and its persistent
    path pool (paths dict, per-lane depth, per-lane sample index)."""
    accumulator: torch.Tensor   # [W*H, 4]; .w accumulates primary depth
    sample_count: torch.Tensor  # int32 0-d (samplesTaken)
    cam_seed: torch.Tensor      # int64 0-d carrying the uint32 camRNGseed
    pixel_count: torch.Tensor | None = None   # [W*H] f32 completed samples
    pool: tuple | None = None

    @staticmethod
    def make(config: RenderConfig, device=None) -> "AccumState":
        """A restart: zero accumulator and samples, the restart seed; both
        seeds are device scalars, as JAX's int32 / uint32, so that a pass
        advances them on the device and reads nothing back."""
        dev = resolve_device(device)
        return AccumState(
            accumulator=torch.zeros((config.width * config.height, 4),
                                    dtype=torch.float32, device=dev),
            sample_count=torch.zeros((), dtype=torch.int32, device=dev),
            cam_seed=torch.full((), rng_mod.CAM_RNG_SEED & rng_mod.M32,
                                dtype=torch.int64, device=dev))


def _clamp_intensity(contrib, clamp_value):
    """CLAMPINTENSITY (core_settings.h:190-193): scale so max comp <= clamp."""
    v = contrib.amax(dim=-1, keepdim=True)
    vs = torch.clamp(v, min=clamp_value)
    scale = torch.where(v > clamp_value, clamp_value / vs, 1.0)
    return contrib * scale


def _fixnan(x):
    """FIXNAN_FLOAT3 (common_settings.h:57-66)."""
    return torch.where(torch.isfinite(x), x, 0.0)


def _masked_div(num, den, mask):
    """num/den where mask else 0, with the denominator masked first."""
    den_safe = torch.where(mask, den, 1.0)
    if num.dim() != den.dim():
        return torch.where(mask[..., None], num / den_safe[..., None], 0.0)
    return torch.where(mask, num / den_safe, 0.0)


def _tiled_pixel(slot, w: int):
    """Map a ray slot to its pixel in 32x32-tile order: slot s belongs to
    tile s>>10, within-tile s&1023 is row-major. path_idx seeds every RNG
    stream, so keeping this map is what makes per-lane parity possible."""
    tiles_x = w // 32
    tile = slot >> 10
    within = slot & 1023
    tx = tile % tiles_x
    ty = tile // tiles_x
    return (ty * 32 + (within >> 5)) * w + tx * 32 + (within & 31)


def untile_image(x, config: RenderConfig):
    """Inverse of _tiled_pixel over a [..., W*H, C] slot-ordered array."""
    if not config.tiled():
        return x
    w, h = config.width, config.height
    lead = x.shape[:-2]
    c = x.shape[-1]
    x = x.reshape(*lead, h // 32, w // 32, 32, 32, c)
    x = torch.movedim(x, -3, -4)      # [..., ty, ly, tx, lx, c]
    return x.reshape(*lead, h * w, c)


def generate_eye_rays(view: ViewPyramid, config: RenderConfig, sample_base,
                      path_idx=None, sample_idx=None):
    """Primary rays (optix/.optix.cu:66-99 generateEyeRay): pixel jitter,
    9-bladed lens DOF, optional barrel distortion. `sample_base` is an int
    or an integer device scalar (AccumState.sample_count); `sample_idx`
    (int64 carrying uint32, one per lane) overrides the per-lane sample
    numbers."""
    w, h = config.width, config.height
    dev = view.pos.device
    if path_idx is None:
        path_idx = torch.arange(config.n_paths, dtype=torch.int64, device=dev)
    n = path_idx.shape[0]
    slot = path_idx % (w * h)
    pixel_idx = _tiled_pixel(slot, w) if config.tiled() else slot
    if sample_idx is None:
        seed = rng_mod.raygen_seed(path_idx, sample_base)
        sample_idx = (sample_base + path_idx // (w * h)) & rng_mod.M32
    else:
        seed = rng_mod.raygen_seed(path_idx, sample_idx)

    seed, r0 = rng_mod.random_float(seed)
    seed, r1 = rng_mod.random_float(seed)
    seed, r2 = rng_mod.random_float(seed)
    seed, r3 = rng_mod.random_float(seed)
    px = pixel_idx % w
    py = pixel_idx // w
    if config.blue_noise:
        # camera AA/lens dims 0-3 for the first 256 spp (.optix.cu:72-79)
        mask = bn.device_mask(dev)
        use_bn = sample_idx < 256
        r0 = torch.where(use_bn, bn.sample(mask, px, py, sample_idx, 0), r0)
        r1 = torch.where(use_bn, bn.sample(mask, px, py, sample_idx, 1), r1)
        r2 = torch.where(use_bn, bn.sample(mask, px, py, sample_idx, 2), r2)
        r3 = torch.where(use_bn, bn.sample(mask, px, py, sample_idx, 3), r3)

    right = view.p2 - view.p1
    up = view.p3 - view.p1

    # RandomPointOnLens (.optix.cu:52-64): 9-bladed aperture
    blade = torch.floor(r2 * 9.0)
    r2b = (r2 - blade * (1.0 / 9.0)) * 9.0
    a1 = blade * (math.pi / 4.5)
    a2 = (blade + 1.0) * (math.pi / 4.5)
    x1, y1 = torch.sin(a1), torch.cos(a1)
    x2, y2 = torch.sin(a2), torch.cos(a2)
    flip = (r3 + r2b) > 1.0
    r3f = torch.where(flip, 1.0 - r3, r3)
    r2f = torch.where(flip, 1.0 - r2b, r2b)
    xr = x1 * r3f + x2 * r2f
    yr = y1 * r3f + y2 * r2f
    origin = view.pos[None] + view.aperture * (right[None] * xr[:, None]
                                               + up[None] * yr[:, None])

    sx = px.to(torch.float32)
    sy = py.to(torch.float32)
    u = (sx + r0) / w
    v = (sy + r1) / h
    pos_nodist = view.p1[None] + u[:, None] * right[None] + v[:, None] * up[None]

    # barrel distortion (.optix.cu:89-97)
    tx = sx / w - 0.5
    ty = sy / h - 0.5
    rr = tx * tx + ty * ty
    rq = torch.sqrt(rr) * (1.0 + view.distortion * rr
                           + view.distortion * rr * rr)
    theta = torch.atan2(tx, ty)
    bx = (torch.sin(theta) * rq + 0.5) * w
    by = (torch.cos(theta) * rq + 0.5) * h
    pos_dist = (view.p1[None] + ((bx + r0) / w)[:, None] * right[None]
                + ((by + r1) / h)[:, None] * up[None])
    pos_on_pixel = torch.where(view.distortion == 0.0, pos_nodist, pos_dist)

    direction = normalize(pos_on_pixel - origin)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    return dict(
        path_idx=path_idx,
        origin=origin,
        dir=direction,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        bsdf_pdf=torch.ones(n, dtype=torch.float32, device=dev),
        last_n=direction.clone(),          # unused until first diffuse hit
        prev_specular=ones,                # primary rays act as "via specular"
        n_diffuse=torch.zeros(n, dtype=torch.int32, device=dev),
        alive=ones.clone(),
        pixel=pixel_idx,
        sample=sample_idx,
    )


def _pick_intersector(scene: DeviceScene, config: RenderConfig) -> str:
    """"brute" without a BVH (config.use_bvh False, intersector "brute" or
    a scene synced without one); "cluster" for intersector="cluster" on a
    scene with cluster tiles; else "bvh": the BVH4 trace kernels."""
    mode = config.intersector
    if mode not in ("auto", "lockstep", "brute", "cluster"):
        raise ValueError(f"render_pass does not support intersector={mode!r}")
    if not config.use_bvh or mode == "brute":
        return "brute"
    if mode == "cluster" and getattr(scene, "cbvh", None) is not None:
        return "cluster"
    return "brute" if scene.bvh is None else "bvh"


def prepare_cluster_pay(scene: DeviceScene, config: RenderConfig,
                        mark=None):
    """The payload pack of the cluster path (render/kernels/cluster.py
    prepare_pay_tiles), its material rows baked from the live materials;
    None on the other paths. Built once a pass and handed to every bounce.
    `mark`, a device, opens the pack with a trace mark there (the
    executors' pack before their bounce loop)."""
    if _pick_intersector(scene, config) != "cluster":
        return None
    if mark is not None:
        telemetry.mark("trace", mark)
    paym = bake_material_rows(scene.cbvh,
                              material_pack(scene.materials).detach())
    return prepare_pay_tiles(scene.cbvh, paym)


def _trace(scene: DeviceScene, o, d, alive, config: RenderConfig,
           pay_tiles=None, sort_key="dir"):
    """Closest hit (t, prim, u, v, payload) through the trace kernels, or by
    brute force where _pick_intersector says so; dead lanes get tmax = 0.
    On the cluster path u and v are None (the refine computes them) and
    payload is the kernel's [72, N] payload; `sort_key` orders the rays
    first (ray_sort_perm: None for tiled primaries, "dir" for bounces)
    when config.ray_sort and the tree has at least 16 clusters. payload
    is None on the other paths."""
    tmax = torch.where(alive, BIG_T, 0.0)
    mode = _pick_intersector(scene, config)
    if mode == "brute":
        t = scene.tris
        return (*intersect_bruteforce(o.detach(), d.detach(), t.v0, t.e1,
                                      t.e2, t_max=tmax,
                                      chunk=config.tri_chunk), None)
    if mode == "bvh":
        return (*trace_closest(o, d, tmax, scene.bvh), None)
    cb = scene.cbvh
    if pay_tiles is None:
        pay_tiles = prepare_cluster_pay(scene, config)
    perm = inv = None
    if sort_key is not None and config.ray_sort and cb.n_clusters >= 16:
        perm, inv = ray_sort_perm(o, d, tmax, cb, key=sort_key)
    t, prim, payload = trace_cluster_bvh(o, d, cb, tmax, pay_tiles=pay_tiles,
                                         perm=perm, inv=inv)
    return t, prim, None, None, payload


def _occluded(scene: DeviceScene, o, d, tmax, config: RenderConfig):
    """Shadow-ray occlusion through the any-hit kernels or by brute force.
    The cluster path orders the rays by origin and direction octant first
    (config.shadow_sort, at least 16 clusters)."""
    mode = _pick_intersector(scene, config)
    if mode == "brute":
        t = scene.tris
        return occluded_bruteforce(o.detach(), d.detach(), tmax.detach(),
                                   t.v0, t.e1, t.e2, chunk=config.tri_chunk)
    if mode == "bvh":
        return trace_occluded(o, d, tmax, scene.bvh)
    cb = scene.cbvh
    perm = inv = None
    if config.shadow_sort and cb.n_clusters >= 16:
        perm, inv = ray_sort_perm(o, d, tmax, cb, key="origin_octant")
    return trace_cluster_bvh(o, d, cb, tmax, anyhit=True, perm=perm, inv=inv)


def _refine(scene: DeviceScene, o, d, t, prim, u, v, payload=None,
            reattach=False):
    """(t, u, v) recomputed differentiably from the winning triangle, read
    from the payload rows when there are some (re-attached to tri9 with
    `reattach`, the cluster path); lanes whose re-test loses the hit keep
    the traversal's t, and its u, v where it has them (the cluster path
    keeps the refine's, as JAX)."""
    if payload is None:
        rt, ru, rv, ok = refine_hit(o, d, prim, scene.tris.tri9)
    else:
        g9 = payload[PAY_V0:PAY_V0 + 9]
        if reattach:
            g9 = reattach_rows(scene.tris.tri9, prim, g9)
        rt, ru, rv, ok = refine_hit_rows(o, d, prim, g9)
    keep = (prim >= 0) & ok
    if u is None:
        return torch.where(keep, rt, t), prim, ru, rv
    return (torch.where(keep, rt, t), prim, torch.where(keep, ru, u),
            torch.where(keep, rv, v))


def _intersect(scene: DeviceScene, o, d, alive, config: RenderConfig,
               pay_tiles=None, sort_key="dir"):
    """Closest hit, then the differentiable refine: (t, prim, u, v,
    payload)."""
    *hit, payload = _trace(scene, o, d, alive, config, pay_tiles, sort_key)
    return (*_refine(scene, o, d, *hit, payload=payload,
                     reattach=not config.scene_sharded), payload)


def _shade_stage(scene, view, config, paths, acc, cam_seed, li, hit, payload,
                 marks=True):
    """refine + shade: the part of a bounce that remat recomputes; with
    `marks` each opened by its stage mark."""
    dev = paths["origin"].device
    if marks:
        telemetry.mark("refine", dev)
    t, prim, u, v = _refine(scene, paths["origin"], paths["dir"], *hit,
                            payload=payload,
                            reattach=not config.scene_sharded)
    if marks:
        telemetry.mark("shade", dev)
    return shade_bounce(scene, view, config, paths, acc, cam_seed, li,
                        t, prim, u, v, payload=payload, marks=marks)


def _once(fn):
    """fn with marks on its first call only: a checkpoint's recompute in the
    backward calls it again with the same arguments."""
    first = [True]

    def run(*args):
        marks, first[0] = first[0], False
        return fn(*args, marks=marks)
    return run


def bounce_step(scene, view, config: RenderConfig, paths, acc, cam_seed, li,
                pay_tiles=None, intersect_fn=None, occluded_fn=None,
                sort_key="dir"):
    """One full bounce: trace, refine + shade (checkpointed with
    config.remat), occlude, apply. Returns (paths, acc, cam_seed,
    n_shadow_connections).

    intersect_fn(o, d, alive) -> (t, prim, u, v, payload) replaces the
    trace: the traversal's winner and its payload rows [PAY_ROWS, N] (or
    None); occluded_fn(o, d, tmax) -> bool [N] replaces the shadow trace.
    The payload goes through the checkpoint with the hit. pay_tiles and
    sort_key go to the cluster path's trace (_trace). Opens the trace,
    refine, shade, occlude and apply stages with their marks."""
    dev = paths["origin"].device
    telemetry.mark("trace", dev)
    if intersect_fn is None:
        *hit, payload = _trace(scene, paths["origin"], paths["dir"],
                               paths["alive"], config, pay_tiles, sort_key)
    else:
        *hit, payload = intersect_fn(paths["origin"], paths["dir"],
                                     paths["alive"])
    args = (scene, view, config, paths, acc, cam_seed, li, tuple(hit),
            payload)
    if config.remat:
        # the bounce draws no torch random numbers (its RNG is counter-
        # based), so the CUDA RNG state is neither saved nor restored: a
        # CUDA graph cannot capture that
        paths, acc, cam_seed, shadow = checkpoint(_once(_shade_stage), *args,
                                                  use_reentrant=False,
                                                  preserve_rng_state=False)
    else:
        paths, acc, cam_seed, shadow = _shade_stage(*args)
    telemetry.mark("occlude", dev)
    if occluded_fn is None:
        occ = _occluded(scene, shadow["o"], shadow["d"], shadow["tmax"],
                        config)
    else:
        occ = occluded_fn(shadow["o"], shadow["d"], shadow["tmax"])
    telemetry.mark("apply", dev)
    acc, paths = apply_shadow(config, paths, acc, shadow, occ)
    return paths, acc, cam_seed, shadow["conn_ok"].sum()


def _add_rgb(acc, contrib, mask):
    """acc[:, :3] += where(mask, contrib, 0), functionally."""
    return acc + torch.nn.functional.pad(
        torch.where(mask[:, None], contrib, 0.0), (0, 1))


def _add_contrib(config, acc, paths, contrib, mask, to_direct):
    """Route a contribution to the direct stream (acc) or, with the filter
    on and a diffuse bounce behind the lane, to the indirect G-buffer."""
    if not config.filter_enabled:
        return _add_rgb(acc, contrib, mask), paths
    acc = _add_rgb(acc, contrib, mask & to_direct)
    ind = paths["acc_ind"] + torch.where((mask & ~to_direct)[:, None],
                                         contrib, 0.0)
    return acc, dict(paths, acc_ind=ind)


def make_shading(scene: DeviceScene, d, t, prim, u, v, spread_angle,
                 config: RenderConfig, payload=None):
    """GetShadingData from the payload rows when there are some (the
    cluster path, re-attached; scene sharding, config.scene_sharded, as
    they are), else by the gathers."""
    if payload is not None:
        return shading_from_payload(
            scene, d, t, payload, u, v, spread_angle,
            consistent_normals=config.consistent_normals,
            geom_reattach=not config.scene_sharded, prim=prim)
    return get_shading_data(scene, d, t, prim, u, v, spread_angle,
                            consistent_normals=config.consistent_normals)


def shade_bounce(scene, view, config: RenderConfig, paths, acc, cam_seed, li,
                 t, prim, u, v, payload=None, marks=False):
    """The shade stage for one bounce (pathtracer.h:54-240 without the trace
    launches). `li` is the path depth (0 = primary): an int in the classic
    executor, a per-lane tensor in the regen one. `payload` holds the hit
    triangles' rows (the cluster path, scene sharding). Returns (paths',
    acc', cam_seed', shadow).

    One launch of the shade kernel of config.bsdf (render/kernels/shade.py)
    where its rule (use_kernel) holds: CUDA tensors, the forward Lambert or
    Disney path; else the composed, differentiable code (_shade_composed),
    which with `marks` opens the stage's parts with their marks. With
    `marks` both count the Disney lobe picks."""
    if shade_k.use_kernel(scene, view, config, paths, acc, (t, prim, u, v),
                          payload):
        return shade_k.shade_kernel(scene, view, config, paths, acc, cam_seed,
                                    li, t, prim, u, v, payload=payload,
                                    marks=marks)
    return _shade_composed(scene, view, config, paths, acc, cam_seed, li,
                           t, prim, u, v, payload=payload, marks=marks)


def _shade_composed(scene, view, config: RenderConfig, paths, acc, cam_seed,
                    li, t, prim, u, v, payload=None, marks=False):
    """shade_bounce composed of tensor operations: every configuration,
    differentiable; the shade kernels' plain version. With `marks` (the
    bounce loop's first run of the bounce) the NEE and the BSDF sample open
    with the marks of telemetry.SHADE_PARTS, and a Disney bounce adds its
    lobe picks to telemetry.count_lobes."""
    bsdf_mod = bsdf_disney if config.bsdf == "disney" else bsdf_lambert
    geo_eps = config.geometry_epsilon
    path_length = li + 1                       # reference is 1-based
    is_primary = li == 0
    o, d = paths["origin"], paths["dir"]
    alive = paths["alive"]
    throughput = paths["throughput"]
    bsdf_pdf = paths["bsdf_pdf"]
    prim = torch.where(alive, prim, -1)

    # primary depth into accumulator .w (pathtracer.h:81)
    depth = torch.where(prim >= 0, t, 10000.0)
    # dead/miss lanes carry t = BIG_T; sanitize before any position math
    t = torch.where(prim >= 0, t, 1.0)
    acc = acc + torch.nn.functional.pad(
        torch.where(is_primary & alive, depth, 0.0)[:, None], (3, 0))

    # sky on miss (pathtracer.h:84-91)
    use_sky_nee = config.sky_ibl and scene.sky.has_ibl
    miss = alive & (prim < 0)
    sky_rad = throughput * sample_skydome(scene.sky, d)
    if use_sky_nee:
        # MIS against the sky-NEE strategy, as for implicit area-light
        # hits; specular chains keep the bsdf-only weight
        p_sky = sky_pick_prob(scene.lights, scene.sky, o, paths["last_n"])
        denom_sky = bsdf_pdf + sky_pdf(scene.sky, d) * p_sky
        sky_c = torch.where(paths["prev_specular"][:, None],
                            _masked_div(sky_rad, bsdf_pdf, miss),
                            _masked_div(sky_rad, denom_sky, miss))
    else:
        sky_c = _masked_div(sky_rad, bsdf_pdf, miss)
    if config.clamp_fireflies:
        sky_c = _clamp_intensity(sky_c, config.clamp_value)
    to_direct = paths["n_diffuse"] == 0
    acc, paths = _add_contrib(config, acc, paths, _fixnan(sky_c), miss,
                              to_direct)

    hit = alive & (prim >= 0)
    i_pos = o + t[:, None] * d
    sd = make_shading(scene, d, t, prim, u, v, view.spread_angle, config,
                      payload)

    # alpha cutout -> passthrough extension ray (pathtracer.h:107-118)
    cutout = hit & sd.alpha_cutout
    pass_ok = cutout & (path_length < config.max_path_length)
    hit = hit & ~cutout

    # implicit light hit (pathtracer.h:124-149)
    ddotnl = -dot(d, sd.n_geom)
    lit = hit & sd.emissive & (ddotnl > 0)
    l_pdf = calculate_light_pdf(d, t, sd.area, sd.n_geom)
    pick_p = light_pick_prob(scene.lights, sd.ltri, o, paths["last_n"], i_pos,
                             sky=scene.sky if use_sky_nee else None)
    denom_mis = bsdf_pdf + l_pdf * pick_p
    c_mis = _masked_div(throughput * sd.color, denom_mis, lit & (denom_mis > 0))
    c_spec = _masked_div(throughput * sd.color, bsdf_pdf, lit)
    c_light = torch.where(paths["prev_specular"][:, None], c_spec, c_mis)
    if config.clamp_fireflies:
        c_light = _clamp_intensity(c_light, config.clamp_value)
    acc, paths = _add_contrib(config, acc, paths, _fixnan(c_light), lit,
                              to_direct)

    if config.filter_enabled:
        # primary-hit features (kernels/pathtracer.h:98-122 in
        # RenderCore_Optix7Filter)
        cap = is_primary & hit
        cap3 = cap[:, None]
        paths = dict(
            paths,
            g_albedo=torch.where(cap3, sd.color, paths["g_albedo"]),
            g_normal=torch.where(cap3, sd.n_shading * sd.face_dir[:, None],
                                 paths["g_normal"]),
            g_depth=torch.where(cap, t, paths["g_depth"]),
            g_wpos=torch.where(cap3, i_pos, paths["g_wpos"]))

    active = hit & ~sd.emissive

    # prep (pathtracer.h:152-163)
    cur_spec = bsdf_mod.is_specular_material(sd)
    cam_seed, r0_frame = rng_mod.frame_r0(cam_seed, path_length)
    seed = rng_mod.path_seed(paths["path_idx"], r0_frame)
    face_dir = sd.face_dir
    sd = dataclasses.replace(sd, absorption=torch.where(
        (face_dir == 1.0)[:, None], 0.0, sd.absorption))
    throughput = _masked_div(throughput, bsdf_pdf, active)
    fn_flip = sd.n_shading * face_dir[:, None]

    if config.blue_noise:
        bn_mask = bn.device_mask(o.device)
        bn_px = paths["pixel"] % config.width
        bn_py = paths["pixel"] // config.width
        bn_dim0 = 4 * path_length

        def bn_or(r, dim, cap):
            use = paths["sample"] < cap
            return torch.where(use, bn.sample(bn_mask, bn_px, bn_py,
                                              paths["sample"], bn_dim0 + dim), r)
    else:
        def bn_or(r, dim, cap):
            return r

    # NEE (pathtracer.h:165-204); blue-noise dims 4/5 for the first 2 spp
    if marks:
        telemetry.mark("nee", o.device)
    seed, r0 = rng_mod.random_float(seed)
    seed, r1 = rng_mod.random_float(seed)
    r0 = bn_or(r0, 4, 2)
    r1 = bn_or(r1, 5, 2)
    nee_mask = active & ~cur_spec
    sky_kw = {}
    if use_sky_nee:       # two more draws, after r0 r1, for the sky sample
        seed, r6 = rng_mod.random_float(seed)
        seed, r7 = rng_mod.random_float(seed)
        sky_kw = dict(sky=scene.sky, r2=r6, r3=r7)
    ls = random_point_on_light(scene.lights, r0, r1, i_pos, fn_flip, **sky_kw)
    l_vec = ls["point"] - i_pos
    dist = torch.sqrt(torch.clamp(dot(l_vec, l_vec), min=1e-20))
    l_dir = l_vec / dist[:, None]
    n_dot_l = dot(l_dir, fn_flip)
    e_bsdf, e_pdf = bsdf_mod.evaluate(sd, sd.n_shading, -d, l_dir)
    if config.bsdf == "lambert":
        # BSDF_HAS_PURE_SPECULARS scale (lambert.h:19-30)
        e_bsdf = e_bsdf * sd.roughness[:, None]
    conn_ok = nee_mask & (n_dot_l > 0) & (ls["light_pdf"] > 0) & (e_pdf > 0)
    denom = ls["pick_prob"] * ls["light_pdf"] + e_pdf
    potential = (throughput * e_bsdf * ls["color"]
                 * _masked_div(n_dot_l, denom, conn_ok)[:, None])
    potential = _fixnan(potential)
    if config.clamp_fireflies:
        potential = _clamp_intensity(potential, config.clamp_value)
    shadow_o = safe_origin(i_pos, l_dir, sd.n_geom * face_dir[:, None], geo_eps)
    shadow_tmax = torch.where(conn_ok, dist - 2.0 * geo_eps, 0.0)
    shadow = dict(o=shadow_o, d=l_dir, tmax=shadow_tmax, potential=potential,
                  conn_ok=conn_ok, to_direct=to_direct)

    # bounce (pathtracer.h:207-239); blue-noise dims 6/7 for the first 256 spp
    if marks:
        telemetry.mark("sample", o.device)
    may_extend = (active & (paths["n_diffuse"] < config.max_diffuse_bounces)
                  & (path_length < config.max_path_length))
    seed, r3 = rng_mod.random_float(seed)
    seed, r4 = rng_mod.random_float(seed)
    r3 = bn_or(r3, 6, 256)
    r4 = bn_or(r4, 7, 256)
    smp = bsdf_mod.sample(sd, sd.n_shading, sd.n_geom, -d, t, r3, r4)
    if marks and "lobe" in smp:
        telemetry.count_lobes(smp["lobe"], may_extend)
    ok_pdf = (smp["pdf"] >= EPSILON) & torch.isfinite(smp["pdf"])
    new_spec = smp["specular"]

    # russian roulette (pathtracer.h:229-230)
    seed, r5 = rng_mod.random_float(seed)
    bounced = paths["n_diffuse"] > 0
    surv = torch.clamp(smp["bsdf"].amax(dim=-1), max=1.0)
    p_surv = torch.where(new_spec | ~bounced, 1.0, surv)
    if not config.russian_roulette:
        p_surv = torch.ones_like(p_surv)
    rr_ok = r5 <= p_surv

    extend = may_extend & ok_pdf & rr_ok
    new_throughput = (_masked_div(throughput, p_surv, extend) * smp["bsdf"]
                      * torch.abs(dot(sd.n_shading, smp["wi"]))[:, None])
    new_throughput = _fixnan(new_throughput)
    new_o = safe_origin(i_pos, smp["wi"], sd.n_geom * face_dir[:, None],
                        geo_eps)

    # passthrough lanes keep their original throughput (the pdf division is
    # postponed to the next real vertex)
    pass_o = i_pos + geo_eps * d
    ext3, pass3 = extend[:, None], pass_ok[:, None]
    paths = dict(
        paths,
        origin=torch.where(ext3, new_o, torch.where(pass3, pass_o, o)),
        dir=torch.where(ext3, smp["wi"], d),
        throughput=torch.where(ext3, new_throughput,
                               torch.where(pass3, paths["throughput"],
                                           throughput)),
        bsdf_pdf=torch.where(extend, smp["pdf"],
                             torch.where(pass_ok, bsdf_pdf, 1.0)),
        last_n=torch.where(ext3, fn_flip, paths["last_n"]),
        prev_specular=torch.where(extend, new_spec, paths["prev_specular"]),
        n_diffuse=paths["n_diffuse"] + (extend & ~new_spec).to(torch.int32),
        alive=extend | pass_ok,
    )
    return paths, acc, cam_seed, shadow


def apply_shadow(config: RenderConfig, paths, acc, shadow, occ):
    """Fold unoccluded NEE contributions into the accumulator, or into the
    indirect G-buffer (finalizeConnections analog, kernels/connections.h).
    Returns (acc, paths)."""
    return _add_contrib(config, acc, paths, shadow["potential"],
                        shadow["conn_ok"] & ~occ, shadow["to_direct"])


def _pass_stats(ext, conn, **extra):
    """The per-bounce ray counts ([L] tensors) and their totals, int32 as in
    JAX."""
    ext = ext.to(torch.int32)
    conn = conn.to(torch.int32)
    return dict(extension_rays=ext, shadow_rays=conn,
                total_extension=ext.sum(dtype=torch.int32),
                total_shadow=conn.sum(dtype=torch.int32), **extra)


def _sort_key(config: RenderConfig, li: int):
    """The cluster path's ray order at bounce li: tiled primaries are
    coherent already, the bounces sort by direction."""
    return None if li == 0 and config.tiled() else "dir"


def _add_buffers(paths: dict, config: RenderConfig):
    """A zero accumulator [n, 4] for `paths` and, with the filter on, the
    SVGF G-buffers (RenderCore_Optix7Filter features) in `paths`. Returns
    (paths, acc)."""
    n = paths["path_idx"].shape[0]
    dev = paths["path_idx"].device
    acc = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    if config.filter_enabled:
        f3 = lambda v: torch.full((n, 3), v, dtype=torch.float32, device=dev)
        paths = dict(paths, acc_ind=f3(0.0), g_albedo=f3(1.0),
                     g_normal=f3(0.0),
                     g_depth=torch.zeros(n, dtype=torch.float32, device=dev),
                     g_wpos=f3(1e30))
    return paths, acc


def _finish_pass(config: RenderConfig, paths, acc, stats, path_idx, cam_seed):
    """Per-path -> per-pixel reduction and the stats totals, shared by the
    classic, staged and unrolled executors. `stats` holds the per-bounce
    counts extension_rays and shadow_rays ([L] tensors). Returns
    (acc_delta [W*H, 4], cam_seed, stats); with path_idx (a shard of the
    path range) the lanes are scatter-added by pixel and no filter_aux is
    returned."""
    wh = config.width * config.height
    n = paths["path_idx"].shape[0]
    dev = acc.device
    stats = _pass_stats(stats["extension_rays"], stats["shadow_rays"],
                        primary_rays=torch.full((), n, dtype=torch.int32,
                                                device=dev))
    if path_idx is not None:
        acc_px = torch.zeros((wh, 4), dtype=torch.float32,
                             device=dev).index_add(0, paths["pixel"], acc)
        return acc_px, cam_seed, stats
    unt = lambda x: untile_image(x.reshape(config.spp_per_pass, wh, -1),
                                 config)
    if config.filter_enabled:
        stats["filter_aux"] = dict(
            indirect=unt(paths["acc_ind"]).sum(0),
            albedo=unt(paths["g_albedo"]).mean(0),
            normal=unt(paths["g_normal"]).mean(0),
            depth=unt(paths["g_depth"]).mean(0)[:, 0],
            world_pos=unt(paths["g_wpos"]).mean(0))
    return unt(acc).sum(0), cam_seed, stats


def trace_paths(scene, view, config: RenderConfig, path_idx, sample_base,
                cam_seed, *, intersect_fn=None, occluded_fn=None):
    """The classic executor: one wavefront of W*H*spp fresh paths traced for
    max_path_length bounces. Returns (acc_delta [W*H,4], cam_seed', stats);
    stats hold device tensors. sample_base and cam_seed are ints or device
    scalars (AccumState's); cam_seed' is cam_seed's kind.

    `path_idx` (int64 [n]) traces only those global path indices, a shard
    of [0, W*H*spp) (the parallel layer): their results are scatter-added
    into the [W*H, 4] accumulator by pixel, and no filter_aux is returned.
    None traces every path.

    A bounce whose lanes are all dead is skipped, as the reference ends its
    loop when no extension ray is left (rendercore.cpp:723-726) and JAX's
    lax.cond skips it on the device, but still advances cam_seed, so the
    sampling schedule does not depend on where the paths died. Testing for
    that reads one bool back from the device each bounce.
    intersect_fn / occluded_fn (keyword-only: the port's hooks of scene
    sharding) go to every bounce_step.

    With config.filter_enabled the accumulator holds the direct stream
    only, and stats["filter_aux"] holds the filter's per-pixel inputs: the
    indirect sum and the primary hit's albedo, normal, depth and world
    position (means over spp; misses keep albedo 1, normal 0, depth 0 and
    world position 1e30).

    Marks its stages up to finish; the caller closes the pass with the end
    mark once its result is built."""
    dev = view.pos.device
    pay_tiles = (None if intersect_fn
                 else prepare_cluster_pay(scene, config, mark=dev))
    telemetry.mark("generate", dev)
    paths, acc = _add_buffers(
        generate_eye_rays(view, config, sample_base, path_idx), config)
    ext, conn = [], []
    for li in range(config.max_path_length):
        if li:   # bounce 0's generate mark opened the eye rays
            telemetry.mark("generate", dev)
        n_alive = paths["alive"].sum()
        ext.append(n_alive)
        if not bool(n_alive):
            cam_seed, _ = rng_mod.frame_r0(cam_seed, li + 1)
            conn.append(torch.zeros_like(n_alive))
            continue
        paths, acc, cam_seed, n_conn = bounce_step(
            scene, view, config, paths, acc, cam_seed, li,
            pay_tiles=pay_tiles, intersect_fn=intersect_fn,
            occluded_fn=occluded_fn, sort_key=_sort_key(config, li))
        conn.append(n_conn)
    telemetry.mark("finish", dev)
    return _finish_pass(config, paths, acc,
                        dict(extension_rays=torch.stack(ext),
                             shadow_rays=torch.stack(conn)),
                        path_idx, cam_seed)


def make_regen_pool(view: ViewPyramid, config: RenderConfig):
    """Fresh persistent pool: lane k starts sample path_idx // (W*H) of its
    pixel. Returns (paths, depth, sample_k)."""
    wh = config.width * config.height
    path_idx = torch.arange(config.n_paths, dtype=torch.int64,
                            device=view.pos.device)
    sample_k = path_idx // wh
    paths = generate_eye_rays(view, config, 0, sample_idx=sample_k)
    depth = torch.zeros(config.n_paths, dtype=torch.int64,
                        device=view.pos.device)
    return paths, depth, sample_k


def regenerate(view: ViewPyramid, config: RenderConfig, paths, depth,
               sample_k):
    """The pool's dead lanes restarted: a dead lane completed its previous
    sample (credited at death, in trace_paths_regen) and starts its NEXT
    sample of the same pixel. The sample index advances BEFORE generation;
    live lanes discard the fresh values. Returns (paths, depth, sample_k)."""
    dead = ~paths["alive"]
    sample_k = sample_k + config.spp_per_pass * dead.to(torch.int64)
    fresh = generate_eye_rays(view, config, 0, sample_idx=sample_k)
    paths = {k: torch.where(dead if fresh[k].dim() == 1 else dead[:, None],
                            fresh[k], paths[k]) for k in fresh}
    return paths, torch.where(dead, 0, depth), sample_k


def trace_paths_regen(scene, view, config: RenderConfig, state: AccumState):
    """One pass of max_path_length full-occupancy bounce iterations over the
    persistent pool. Returns (acc_delta [W*H,4], count_delta [W*H],
    cam_seed', pool', stats); stats hold device tensors. Nothing is read
    back from the device: after regeneration every lane is alive, so each
    bounce launches each trace kernel exactly once. Marks its stages up to
    finish; the caller closes the pass with the end mark."""
    if config.filter_enabled:
        raise ValueError("the regen executor (path_regen) does not support "
                         "filter_enabled: it has no G-buffer stream; the "
                         "filter runs on the classic executor")
    wh = config.width * config.height
    spp = config.spp_per_pass
    paths, depth, sample_k = state.pool
    n = paths["path_idx"].shape[0]
    dev = paths["path_idx"].device
    acc = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    count = torch.zeros(n, dtype=torch.float32, device=dev)
    cam_seed = state.cam_seed
    ext, conn = [], []
    pay_tiles = prepare_cluster_pay(scene, config, mark=dev)
    for _ in range(config.max_path_length):
        telemetry.mark("generate", dev)
        paths, depth, sample_k = regenerate(view, config, paths, depth,
                                            sample_k)
        ext.append(paths["alive"].sum())

        paths, acc, cam_seed, n_conn = bounce_step(
            scene, view, config, paths, acc, cam_seed, depth,
            pay_tiles=pay_tiles)
        depth = depth + paths["alive"].to(torch.int64)
        # credit the completed sample at DEATH: its energy entered acc in
        # this bounce, so energy and count land in the same pass
        count = count + (~paths["alive"]).to(torch.float32)
        conn.append(n_conn)

    telemetry.mark("finish", dev)
    acc_px = untile_image(acc.reshape(spp, wh, -1), config).sum(0)
    count_px = untile_image(count.reshape(spp, wh, 1), config).sum(0)[:, 0]
    # "primary_rays" = samples completed this pass, as in JAX: lanes
    # restart asynchronously, so there is no per-pass primary wavefront
    done = count.sum().to(torch.int32)
    stats = _pass_stats(torch.stack(ext), torch.stack(conn),
                        primary_rays=done, samples_completed=done)
    return acc_px, count_px, cam_seed, (paths, depth, sample_k), stats


def ensure_regen_state(view, state: AccumState, config: RenderConfig):
    """Attach a fresh pool and zero per-pixel counts (restart)."""
    if state.pool is not None:
        return state
    return dataclasses.replace(
        state, pool=make_regen_pool(view, config),
        pixel_count=torch.zeros(config.width * config.height,
                                dtype=torch.float32, device=view.pos.device))


def _check_config(config: RenderConfig):
    unsupported = dict(
        bsdf=config.bsdf not in ("lambert", "disney"),
        scene_sharded=config.scene_sharded,
        intersector=config.intersector not in ("auto", "lockstep", "brute",
                                               "cluster"))
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"render_pass does not support these RenderConfig "
                         f"settings yet: {bad}")


def _next_state(state: AccumState, config: RenderConfig, acc_delta,
                cam_seed) -> AccumState:
    """The classic executors' new AccumState after one pass."""
    return AccumState(accumulator=state.accumulator + acc_delta,
                      sample_count=state.sample_count + config.spp_per_pass,
                      cam_seed=cam_seed)


def render_pass(scene: DeviceScene, view: ViewPyramid, state: AccumState,
                config: RenderConfig):
    """One progressive pass of spp_per_pass samples a pixel through the
    classic executor (trace_paths), whatever config.path_regen says: as in
    JAX (lighthouse2_tpu/render/wavefront.py:736), only render_pass_auto
    routes to the regen executor. Runs on the scene's device: the trace
    kernels on a CUDA device, their plain versions on the CPU. Returns
    (new AccumState, stats)."""
    _check_config(config)
    acc_delta, cam_seed, stats = trace_paths(
        scene, view, config, None, state.sample_count, state.cam_seed)
    state = _next_state(state, config, acc_delta, cam_seed)
    telemetry.mark("end", view.pos.device)
    return state, stats


def render_pass_jit(scene, view, state: AccumState, config: RenderConfig):
    """render_pass (JAX :751 jit-compiles it with config static), eagerly:
    its all-dead skip reads one bool back a bounce, which a CUDA graph
    cannot hold (render_pass_unrolled is the captured classic pass)."""
    return render_pass(scene, view, state, config)


# ---------------------------------------------------------------------------
# The staged executor (JAX :754-850): one call per stage per bounce, driven
# by a host loop over device-resident state; nothing is read back. Each
# stage runs under a host span of its JAX name (telemetry.named_stage), the
# counterpart of the per-stage jits that an XLA profile shows by name, so
# that a trace attributes device time to stages. Differences: no jit or
# buffer donation (eager), and config.remat is not applied (JAX's stages
# have no checkpoint either).
# ---------------------------------------------------------------------------

@telemetry.named_stage
def _stage_generate(view, sample_base, config):
    return generate_eye_rays(view, config, sample_base)


@telemetry.named_stage
def _stage_prepare(scene, config):
    return prepare_cluster_pay(scene, config)


@telemetry.named_stage
def _stage_trace(scene, o, d, alive, config, pay_tiles=None, sort_key="dir"):
    """The closest hit and its refine: (t, prim, u, v, payload)."""
    return _intersect(scene, o, d, alive, config, pay_tiles, sort_key)


@telemetry.named_stage
def _stage_shade(scene, view, paths, acc, cam_seed, li, t, prim, u, v, config,
                 payload=None):
    """shade_bounce, plus the bounce's live lanes and NEE connections as
    device scalars: (paths, acc, cam_seed, shadow, n_alive, n_conn)."""
    n_alive = paths["alive"].sum()
    paths, acc, cam_seed, shadow = shade_bounce(
        scene, view, config, paths, acc, cam_seed, li, t, prim, u, v,
        payload=payload)
    return paths, acc, cam_seed, shadow, n_alive, shadow["conn_ok"].sum()


@telemetry.named_stage
def _stage_occlude(scene, o, d, tmax, config):
    return _occluded(scene, o, d, tmax, config)


@telemetry.named_stage
def _stage_apply(paths, acc, shadow, occ, config):
    acc, paths = apply_shadow(config, paths, acc, shadow, occ)
    return paths, acc


@telemetry.named_stage
def _stage_finish(paths, acc, ext_counts, conn_counts, cam_seed, config):
    stats = dict(extension_rays=torch.stack(ext_counts),
                 shadow_rays=torch.stack(conn_counts))
    return _finish_pass(config, paths, acc, stats, None, cam_seed)


def render_pass_staged(scene: DeviceScene, view: ViewPyramid,
                       state: AccumState, config: RenderConfig):
    """render_pass's result through per-stage calls (JAX :812): every bounce
    runs, dead or not, and nothing is read back from the device. Returns
    (new AccumState, stats)."""
    _check_config(config)
    paths, acc = _add_buffers(
        _stage_generate(view, state.sample_count, config), config)
    cam_seed = state.cam_seed
    ext_counts, conn_counts = [], []
    pay_tiles = _stage_prepare(scene, config)
    for li in range(config.max_path_length):
        t, prim, u, v, payload = _stage_trace(
            scene, paths["origin"], paths["dir"], paths["alive"], config,
            pay_tiles, sort_key=_sort_key(config, li))
        paths, acc, cam_seed, shadow, n_alive, n_conn = _stage_shade(
            scene, view, paths, acc, cam_seed, li, t, prim, u, v, config,
            payload=payload)
        occ = _stage_occlude(scene, shadow["o"], shadow["d"], shadow["tmax"],
                             config)
        paths, acc = _stage_apply(paths, acc, shadow, occ, config)
        ext_counts.append(n_alive)
        conn_counts.append(n_conn)
    acc_delta, cam_seed, stats = _stage_finish(paths, acc, ext_counts,
                                               conn_counts, cam_seed, config)
    return _next_state(state, config, acc_delta, cam_seed), stats


def trace_paths_unrolled(scene, view, config: RenderConfig, state: AccumState):
    """The classic pass with every bounce run (JAX :853): no all-dead skip
    and no readback, so a bounce whose lanes are all dead launches both
    trace kernels on dead lanes and adds exact zeros; it advances cam_seed
    as the skipped bounce of trace_paths does, so the result is
    trace_paths's. With config.remat each bounce's refine + shade is
    recomputed (bounce_step), where JAX checkpoints the whole bounce.
    Returns (acc_delta [W*H,4], cam_seed', stats). Marks its stages up to
    finish; the caller closes the pass with the end mark."""
    dev = view.pos.device
    pay_tiles = prepare_cluster_pay(scene, config, mark=dev)
    telemetry.mark("generate", dev)
    paths, acc = _add_buffers(
        generate_eye_rays(view, config, state.sample_count), config)
    cam_seed = state.cam_seed
    ext, conn = [], []
    for li in range(config.max_path_length):
        if li:   # bounce 0's generate mark opened the eye rays
            telemetry.mark("generate", dev)
        ext.append(paths["alive"].sum())
        paths, acc, cam_seed, n_conn = bounce_step(
            scene, view, config, paths, acc, cam_seed, li,
            pay_tiles=pay_tiles, sort_key=_sort_key(config, li))
        conn.append(n_conn)
    telemetry.mark("finish", dev)
    return _finish_pass(config, paths, acc,
                        dict(extension_rays=torch.stack(ext),
                             shadow_rays=torch.stack(conn)),
                        None, cam_seed)


def _unrolled_pass(scene, view, state: AccumState, config: RenderConfig):
    """render_pass_unrolled's body, eagerly: trace_paths_unrolled and the
    new state."""
    acc_delta, cam_seed, stats = trace_paths_unrolled(scene, view, config,
                                                      state)
    state = _next_state(state, config, acc_delta, cam_seed)
    telemetry.mark("end", view.pos.device)
    return state, stats


_unrolled_graph = graphs.CapturedCall("render_pass_unrolled", _unrolled_pass)


def render_pass_unrolled(scene, view, state: AccumState, config: RenderConfig):
    """One pass through trace_paths_unrolled, compiled as JAX :891 compiles
    it: on a card the pass is captured as a CUDA graph at the second call
    with the same key and replayed from then on (render/graphs.py); the
    state is not donated. Returns (new AccumState, stats)."""
    _check_config(config)
    return _unrolled_graph(scene, view, state, config)


def _regen_pass(scene, view, state: AccumState, config: RenderConfig):
    """_render_pass_regen_jit's body, eagerly: trace_paths_regen and the new
    state."""
    acc_delta, count_px, cam_seed, pool, stats = trace_paths_regen(
        scene, view, config, state)
    state = AccumState(
        accumulator=state.accumulator + acc_delta,
        sample_count=state.sample_count + config.spp_per_pass,
        cam_seed=cam_seed,
        pixel_count=state.pixel_count + count_px,
        pool=pool)
    telemetry.mark("end", view.pos.device)
    return state, stats


_regen_graph = graphs.CapturedCall("_render_pass_regen_jit", _regen_pass)


def _render_pass_regen_jit(scene, view, state: AccumState,
                           config: RenderConfig):
    """The regen pass on a state that holds its pool, compiled as JAX :1010
    compiles it: on a card a CUDA graph captured at the second call with the
    same key and replayed from then on (render/graphs.py); the state is not
    donated."""
    return _regen_graph(scene, view, state, config)


def render_pass_regen(scene, view, state: AccumState, config: RenderConfig):
    """One pass of the path-regeneration executor (JAX :1032), a fresh pool
    attached first when the state has none. Nothing is read back from the
    device. Returns (new AccumState, stats)."""
    _check_config(config)
    state = ensure_regen_state(view, state, config)
    return _render_pass_regen_jit(scene, view, state, config)


def render_pass_auto(scene, view, state: AccumState, config: RenderConfig):
    """Pick the executor as JAX does (:1037): the regen executor when
    config.path_regen; else render_pass_jit on the CPU and
    render_pass_unrolled on the card (JAX's accelerator choice; there it is
    also the form with no readback a bounce). The cores call this."""
    if config.path_regen:
        return render_pass_regen(scene, view, state, config)
    if scene.device.type == "cpu":
        return render_pass_jit(scene, view, state, config)
    return render_pass_unrolled(scene, view, state, config)


def finalize(state: AccumState):
    """accumulator / completed samples -> linear HDR image [W*H,3]
    (finalize_shared.h:29-45), per pixel for regen states."""
    if state.pixel_count is not None:
        cnt = torch.clamp(state.pixel_count, min=1.0)
        return state.accumulator[:, :3] / cnt[:, None]
    spp = torch.clamp(state.sample_count, min=1).to(torch.float32)
    return state.accumulator[:, :3] / spp
