"""Pixel probe and debug views (core probe counters core_settings.h:114-116,
consumed at apps/imguiapp/main.cpp:123-134; ColorDebugBVH; the F4 G-buffer
views; BVH::Print).

Counterpart of lighthouse2_tpu/render/probe.py: _pixel_rays, _colormap,
bvh_heatmap, gbuffer_views, bvh_print and probe_pixel. Differences:
  - bvh_heatmap colours the per-ray step counts (BVH4 node visits) of
    trace_closest(stats=True), the closest-hit kernel on a card and its plain
    BVH4 walk on the CPU, where JAX counts the steps of its BVH2 lockstep
    walk; on the cluster path (intersector="cluster") both colour the
    per-block tile-visit counter of the cluster kernel (the Pallas
    kernel's walk schedule, render/kernels/cluster.py);
  - gbuffer_views runs the classic executor with filter_enabled, whatever
    config.path_regen says (as JAX's render_pass_jit does);
  - bvh_print prints the BVH2 line exactly as JAX does, then a line on the
    BVH4 that the kernels walk, then JAX's ClusterBVH line;
  - probe_pixel traces through trace_closest (the kernel on a card), where
    JAX walks its BVH2 in lockstep; without a BVH both take the brute force.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lighthouse2_tpu_torch.core.geometry import (
    BIG_T, intersect_bruteforce, normalize)
from lighthouse2_tpu_torch.bvh.clusters import PAY_VALID
from lighthouse2_tpu_torch.render.kernels.cluster import (
    PAY_STAT_VISITS, trace_cluster_bvh)
from lighthouse2_tpu_torch.render.kernels.trace import trace_closest


def _pixel_rays(view, config):
    """Pixel-centre primary rays in scanline order, [W*H, 3] each."""
    w, h = config.width, config.height
    right = view.p2 - view.p1
    up = view.p3 - view.p1
    i = torch.arange(w * h, device=view.pos.device)
    u = ((i % w).to(torch.float32) + 0.5) / w
    v = ((i // w).to(torch.float32) + 0.5) / h
    p = view.p1[None] + u[:, None] * right[None] + v[:, None] * up[None]
    o = view.pos[None].expand(w * h, 3).contiguous()
    return o, normalize(p - view.pos[None])


def _colormap(x):
    """A 3-stop heat colormap of [0,1] scalars -> [...,3]."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = np.clip(2.0 * x, 0, 1)
    g = np.clip(2.0 * x - 0.5, 0, 1) * np.clip(2.0 - 2.0 * x, 0, 1)
    b = np.clip(1.0 - 2.0 * x, 0, 1)
    return np.stack([r, g, b], -1)


def bvh_heatmap(scene, view, config) -> np.ndarray:
    """BVH cost heatmap [H,W,3], the ColorDebugBVH view
    (RenderCore_Bart/raytracer.cpp:102-120): each pixel-centre ray's node
    visits (on the cluster path its 1024-ray block's tile visits), over the
    image's peak. Black-blue without a BVH."""
    from lighthouse2_tpu_torch.render.wavefront import _pick_intersector
    mode = _pick_intersector(scene, config)
    if mode == "bvh":
        o, d = _pixel_rays(view, config)
        counts = trace_closest(o, d, BIG_T, scene.bvh, stats=True)[4][0]
        counts = counts.cpu().numpy().astype(np.float32)
    elif mode == "cluster":
        o, d = _pixel_rays(view, config)
        _, _, payload = trace_cluster_bvh(o, d, scene.cbvh, BIG_T)
        counts = payload[PAY_STAT_VISITS].cpu().numpy()
    else:
        counts = np.zeros((config.width * config.height,), np.float32)
    peak = max(float(counts.max()), 1.0)
    img = _colormap(counts / peak)
    return img.reshape(config.height, config.width, 3)


def gbuffer_views(scene, view, config) -> np.ndarray:
    """The filter G-buffer debug mosaic [2H,2W,3]: albedo, shading normal,
    depth and world position (the F4 multi-view, finalize_shared.h:491-541)."""
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, render_pass_jit)
    cfg = dataclasses.replace(config, filter_enabled=True, spp_per_pass=1,
                              path_regen=False)
    _, stats = render_pass_jit(scene, view, AccumState.make(cfg, scene.device),
                               cfg)
    aux = {k: v.cpu().numpy() for k, v in stats["filter_aux"].items()}
    h, w = cfg.height, cfg.width
    alb = aux["albedo"].reshape(h, w, 3)
    nrm = aux["normal"].reshape(h, w, 3) * 0.5 + 0.5
    dep = aux["depth"].reshape(h, w)
    dvis = _colormap(dep / max(float(dep[np.isfinite(dep)].max()
                                     if np.isfinite(dep).any() else 1.0),
                               1e-6))
    wp = aux["world_pos"].reshape(h, w, 3)
    wvis = np.clip(np.abs(wp - np.floor(wp)), 0, 1)
    wvis = np.where(np.isfinite(wvis), wvis, 0.0)
    top = np.concatenate([alb, nrm], axis=1)
    bot = np.concatenate([dvis, wvis], axis=1)
    return np.clip(np.concatenate([top, bot], axis=0), 0.0, 1.0)


def bvh_print(scene) -> str:
    """BVH::Print (RenderCore_Bart/bvh.cpp:304-314): the shape of the
    scene's BVH2, of the BVH4 the trace kernels walk and of the ClusterBVH
    the cluster kernels walk."""
    lines = []
    b = getattr(scene, "bvh", None)
    if b is not None:
        count = b.count.cpu().numpy()
        leaves = count > 0
        lines.append(
            f"BVH2 (lockstep): {count.shape[0]} nodes, "
            f"{int(leaves.sum())} leaves, "
            f"{int(count[leaves].sum())} prim slots, "
            f"max leaf size {int(count.max())}, "
            f"mean {float(count[leaves].mean()):.2f}")
        # node4 record: floats 24..27 are the child codes, 28..31 the counts
        # (-1 = empty slot, 0 = interior child, > 0 = leaf of that many prims)
        cnt4 = b.node4[:, 28:32].cpu().numpy().view(np.int32)
        used = cnt4 >= 0
        lines.append(
            f"BVH4 (trace kernels): {b.node4.shape[0]} nodes "
            f"({int(b.node4.numel() * 4)} bytes), depth {b.depth4}, "
            f"{int(used.sum())} child slots used of {cnt4.size}, "
            f"{int((cnt4 > 0).sum())} leaf children, "
            f"{b.tri4.shape[0]} triangles")
    c = getattr(scene, "cbvh", None)
    if c is not None:
        valid = int((c.pgeo[:, PAY_VALID, :] > 0).sum())
        lines.append(
            f"ClusterBVH: {c.n_nodes} top nodes, {c.n_clusters} clusters x "
            f"{c.tiles_per_cluster} tile(s), depth {c.max_depth}, "
            f"{c.n_prims} prims ({valid} tile slots used, "
            f"{c.n_clusters * c.tiles_per_cluster * 128} capacity)")
    return "\n".join(lines) if lines else "no acceleration structures"


def probe_pixel(scene, view, config, x: int, y: int) -> dict:
    """The primary hit through the centre of pixel (x, y): prim, material,
    distance (inf on a miss), u, v."""
    right = view.p2 - view.p1
    up = view.p3 - view.p1
    u = (x + 0.5) / config.width
    v = (y + 0.5) / config.height
    p = view.p1 + u * right + v * up
    o = view.pos[None]
    d = normalize(p - view.pos)[None]
    tris = scene.tris
    if config.use_bvh and scene.bvh is not None:
        t, prim, bu, bv = trace_closest(o, d, BIG_T, scene.bvh)
    else:
        t, prim, bu, bv = intersect_bruteforce(o, d, tris.v0, tris.e1,
                                               tris.e2)
    prim_i = int(prim[0])
    mat = int(tris.mat[prim_i]) if prim_i >= 0 else -1
    return dict(prim=prim_i, material=mat,
                distance=float(t[0]) if prim_i >= 0 else float("inf"),
                u=float(bu[0]), v=float(bv[0]))
