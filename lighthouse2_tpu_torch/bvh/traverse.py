"""BVH2 traversal in plain PyTorch: the BVH2 reference of the trace kernels.

Counterpart of lighthouse2_tpu/bvh/traverse.py (DeviceBVH,
build_device_bvh, device_bvh_from_flat, _traverse_chunk, bvh_intersect,
bvh_intersect_counts, bvh_occluded, refine_hit, refine_hit_rows and the
clipped _refine_tuv backward). All rays advance in lockstep: each step
every live ray either tests the triangles of its leaf, descends into the
nearer hit child (pushing the farther one), or pops its explicit stack. The trace wrappers detach their
rays, as the JAX package stop_gradients its traversal; refine_hit is where
gradients reach the hit.

The CUDA kernels (csrc/trace.cu) do not walk this BVH2: they walk the BVH4
that bvh/wide.py collapses from it, and bvh/wide.py's plain walk is what they
are held against lane for lane. DeviceBVH carries both: the BVH2 arrays
(which shading and refine_hit gather by triangle id) and the packed BVH4.
bvh_intersect / bvh_occluded stay as the port's counterparts of the JAX
lockstep and as the BVH2 reference the BVH4 walk is checked against.

Deliberate differences from the JAX version:
  - the stack holds STACK_CAP = 64 entries and a BVH2 deeper than
    STACK_CAP - 2 raises ValueError (the JAX lockstep clips at 48);
  - lanes that finish are compacted out of the working set between
    convergence checks, so long-tailed batches cost what their live rays
    need (results are per lane and do not change);
  - optional per-ray int32 [3, N] counts: steps (node visits), interior
    nodes whose child boxes were tested, and triangle tests;
  - the clipped refine backward is a torch.autograd.Function (_RefineTUV)
    in place of jax.custom_vjp, with the same clip (REFINE_GRAD_LIMIT); its
    forward also returns the hit mask, computed without autograd, where
    JAX runs the re-test a second time on stop_gradient inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lighthouse2_tpu_torch.bvh.builder import bvh_depth
from lighthouse2_tpu_torch.bvh.wide import check_depth4, pack_wide
from lighthouse2_tpu_torch.core.geometry import BIG_T, mt_comp, per_lane
from lighthouse2_tpu_torch.device import resolve_device

STACK_CAP = 64            # per-ray stack entries of the BVH2 walk
DEFAULT_CHUNK = 1 << 30   # JAX's ray chunk, accepted and not used
STEPS_PER_CHECK = 4       # traversal steps between convergence checks


@dataclasses.dataclass
class DeviceBVH:
    nbox: torch.Tensor    # [6,M] f32 component-major: min.xyz, max.xyz
    left: torch.Tensor    # [M] int32: interior -> left child; leaf -> first prim slot
    right: torch.Tensor   # [M] int32: interior -> right child; leaf -> -1
    count: torch.Tensor   # [M] int32: 0 interior, >0 leaf prim count
    prim: torch.Tensor    # [T] int32 triangle ids, contiguous per leaf
    tri9: torch.Tensor    # [9,T] f32: v0.xyz, e1.xyz, e2.xyz
    node4: torch.Tensor   # [M4,32] f32 BVH4 node records (bvh/wide.py)
    tri4: torch.Tensor    # [T,12] f32 triangles in leaf order (bvh/wide.py)
    max_leaf: int = 4
    depth: int = 0        # BVH2 root-to-leaf edges, measured at upload
    depth4: int = 0       # BVH4 root-to-leaf edges, measured at upload


def pack_flat(flat: dict, v0, v1, v2, max_leaf: int = 4) -> dict:
    """The host half of device_bvh_from_flat: the BVH2 arrays in the
    traversal layout, the BVH4 collapsed and packed from them, and both
    depths, as numpy arrays and ints."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    return pack_flat_tri9(flat, np.concatenate([v0.T, e1.T, e2.T], 0),
                          max_leaf)


def pack_flat_tri9(flat: dict, tri9, max_leaf: int = 4) -> dict:
    """pack_flat over triangles given as tri9 [9, T] (v0, e1, e2
    component-major), so their edges are used as they are rather than
    derived again from the corners."""
    nbox = np.concatenate([flat["nmin"].T, flat["nmax"].T], 0).astype(np.float32)
    tri9 = np.asarray(tri9, np.float32)
    wide = pack_wide(nbox, flat["left"], flat["right"], flat["count"],
                     flat["prim"], tri9, max_leaf)
    return dict(nbox=nbox, left=flat["left"], right=flat["right"],
                count=flat["count"], prim=flat["prim"], tri9=tri9,
                node4=wide["node4"], tri4=wide["tri4"], depth=bvh_depth(flat),
                depth4=wide["depth4"], max_leaf=max_leaf)


def upload_bvh(packed: dict, device) -> DeviceBVH:
    """The device half of device_bvh_from_flat: pack_flat's arrays as
    tensors on `device`."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DeviceBVH(**{k: (v if isinstance(v, int) else t(v))
                        for k, v in packed.items()})


def build_device_bvh(v0, v1, v2, max_leaf: int = 4, *,
                     device=None) -> DeviceBVH:
    """Build the SAH BVH2 over triangles v0, v1, v2 [T,3] (bvh/builder.py
    build_sah_bvh: the native builder) and upload it with
    device_bvh_from_flat to `device` (default: the card)."""
    from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh
    flat = build_sah_bvh(v0, v1, v2, max_leaf=max_leaf)
    return device_bvh_from_flat(flat, v0, v1, v2, max_leaf, device=device)


def device_bvh_from_flat(flat: dict, v0, v1, v2, max_leaf: int = 4, *,
                         device=None) -> DeviceBVH:
    """Upload a builder.py flat dict in the traversal layout to `device`
    (default: the card): the BVH2 arrays and the BVH4 collapsed and packed
    from them."""
    if not isinstance(max_leaf, int):
        raise TypeError(f"max_leaf must be an int, got {max_leaf!r} (the "
                        "device is keyword-only: device=...)")
    return upload_bvh(pack_flat(flat, v0, v1, v2, max_leaf),
                      resolve_device(device))


def check_depth(bvh: DeviceBVH) -> None:
    """Raise if the trace kernels' stack could overflow on this BVH's BVH4."""
    check_depth4(bvh.depth4)


def _check_depth2(bvh: DeviceBVH) -> None:
    """Raise if the BVH2 walk's stack could overflow on this BVH."""
    if bvh.depth + 2 > STACK_CAP:
        raise ValueError(
            f"BVH depth {bvh.depth} needs more than the {STACK_CAP}-entry "
            f"traversal stack (depth + 2 must be <= {STACK_CAP})")


def _slab(ox, oy, oz, ix, iy, iz, nbox, nid, t_best):
    """Component-major slab test of node nid."""
    t0x = (nbox[0, nid] - ox) * ix
    t1x = (nbox[3, nid] - ox) * ix
    t0y = (nbox[1, nid] - oy) * iy
    t1y = (nbox[4, nid] - oy) * iy
    t0z = (nbox[2, nid] - oz) * iz
    t1z = (nbox[5, nid] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                     torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                     torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    hit = (tf >= torch.clamp(tn, min=0.0)) & (tn < t_best)
    return tn, hit


def _traverse(o, d, t_max, bvh: DeviceBVH, anyhit: bool):
    """Lockstep traversal of all rays. Returns the per-lane result arrays
    (best_t, best_p, best_u, best_v, occ, visits, boxes, tests)."""
    _check_depth2(bvh)
    n = o.shape[0]
    dev = o.device
    n_tris = bvh.prim.shape[0]
    ds = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    inv = 1.0 / ds
    s = dict(
        lane=torch.arange(n, device=dev),
        ox=o[:, 0], oy=o[:, 1], oz=o[:, 2],
        dx=d[:, 0], dy=d[:, 1], dz=d[:, 2],
        ix=inv[:, 0], iy=inv[:, 1], iz=inv[:, 2],
        node=torch.zeros(n, dtype=torch.int64, device=dev),
        cur_t=torch.zeros(n, dtype=torch.float32, device=dev),
        sptr=torch.zeros(n, dtype=torch.int64, device=dev),
        stack=torch.zeros((n, STACK_CAP), dtype=torch.int64, device=dev),
        tstack=torch.zeros((n, STACK_CAP), dtype=torch.float32, device=dev),
        best_t=torch.clamp(t_max, max=BIG_T),
        best_p=torch.full((n,), -1, dtype=torch.int32, device=dev),
        best_u=torch.zeros(n, dtype=torch.float32, device=dev),
        best_v=torch.zeros(n, dtype=torch.float32, device=dev),
        occ=torch.zeros(n, dtype=torch.bool, device=dev),
        done=torch.zeros(n, dtype=torch.bool, device=dev),
        visits=torch.zeros(n, dtype=torch.int32, device=dev),
        boxes=torch.zeros(n, dtype=torch.int32, device=dev),
        tests=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    outputs = ("best_t", "best_p", "best_u", "best_v", "occ", "visits",
               "boxes", "tests")
    out = {k: s[k].clone() for k in outputs}

    def step(s):
        node = s["node"]
        alive = ~s["done"]
        prune = s["cur_t"] >= s["best_t"]
        cnt = bvh.count[node]
        is_leaf = alive & ~prune & (cnt > 0)
        is_int = alive & ~prune & (cnt == 0)

        first = bvh.left[node].to(torch.int64)
        best_t, best_p = s["best_t"], s["best_p"]
        best_u, best_v = s["best_u"], s["best_v"]
        occ, tests = s["occ"], s["tests"]
        for k in range(bvh.max_leaf):
            slot = torch.clamp(first + k, 0, n_tris - 1)
            pid = bvh.prim[slot]
            g = bvh.tri9[:, pid]
            t, u, v, h = mt_comp(s["ox"], s["oy"], s["oz"],
                                 s["dx"], s["dy"], s["dz"],
                                 g[0], g[1], g[2], g[3], g[4], g[5],
                                 g[6], g[7], g[8], 1e-6, best_t)
            live_k = is_leaf & (k < cnt)
            h = h & live_k
            best_p = torch.where(h, pid, best_p)
            best_u = torch.where(h, u, best_u)
            best_v = torch.where(h, v, best_v)
            best_t = torch.where(h, t, best_t)
            occ = occ | h
            tests = tests + live_k.to(torch.int32)

        # interior: test both children (leaf lanes index node 0, masked)
        l = torch.where(is_int, bvh.left[node], 0).to(torch.int64)
        rt = torch.where(is_int, bvh.right[node], 0).to(torch.int64)
        ray = (s["ox"], s["oy"], s["oz"], s["ix"], s["iy"], s["iz"], bvh.nbox)
        tl, hl = _slab(*ray, l, best_t)
        tr, hr = _slab(*ray, rt, best_t)
        hl = hl & is_int
        hr = hr & is_int
        both = hl & hr
        any_h = hl | hr
        near_is_l = tl <= tr
        nnode = torch.where(both, torch.where(near_is_l, l, rt),
                            torch.where(hl, l, rt))
        nt = torch.where(both, torch.minimum(tl, tr), torch.where(hl, tl, tr))
        fnode = torch.where(near_is_l, rt, l)
        ft = torch.maximum(tl, tr)

        sptr = s["sptr"]
        stack, tstack = s["stack"], s["tstack"]
        slot = sptr[:, None]
        stack = stack.scatter(1, slot, torch.where(
            both, fnode, stack.gather(1, slot)[:, 0])[:, None])
        tstack = tstack.scatter(1, slot, torch.where(
            both, ft, tstack.gather(1, slot)[:, 0])[:, None])
        sptr = sptr + both.to(torch.int64)

        if anyhit:
            # stop at the first hit (OPTIX_RAY_FLAG_TERMINATE_ON_FIRST_HIT)
            newly_occluded = occ & alive
        else:
            newly_occluded = torch.zeros_like(occ)
        goto = any_h & ~newly_occluded
        need_pop = alive & ~goto & ~newly_occluded
        can_pop = need_pop & (sptr > 0)
        done = s["done"] | (need_pop & (sptr == 0)) | newly_occluded

        pidx = torch.clamp(sptr - 1, 0, STACK_CAP - 1)[:, None]
        pnode = stack.gather(1, pidx)[:, 0]
        pt = tstack.gather(1, pidx)[:, 0]
        return dict(
            s, node=torch.where(goto, nnode, torch.where(can_pop, pnode, node)),
            cur_t=torch.where(goto, nt, torch.where(can_pop, pt, s["cur_t"])),
            sptr=sptr - can_pop.to(torch.int64), stack=stack, tstack=tstack,
            best_t=best_t, best_p=best_p, best_u=best_u, best_v=best_v,
            occ=occ, done=done, tests=tests,
            boxes=s["boxes"] + is_int.to(torch.int32),
            visits=s["visits"] + alive.to(torch.int32))

    while True:
        for _ in range(STEPS_PER_CHECK):
            s = step(s)
        live = (~s["done"]).nonzero()[:, 0]
        if live.numel() == 0 or 2 * live.numel() < s["lane"].numel():
            for k in outputs:
                out[k][s["lane"]] = s[k]
            if live.numel() == 0:
                return out
            s = {k: v[live] for k, v in s.items()}


def bvh_intersect(o, d, bvh: DeviceBVH, v0=None, e1=None, e2=None,
                  t_max=BIG_T, chunk: int = DEFAULT_CHUNK, *,
                  stats: bool = False):
    """Closest hit of [N] rays. Returns (t, prim, u, v) with prim = -1 and
    t = min(t_max, BIG_T) on a miss; with stats=True also the int32 [3, N]
    per-ray counts (steps, box-pair tests, triangle tests). v0, e1, e2 are
    accepted for JAX's signature and not read (the triangles come from
    bvh.tri9, as in JAX); chunk is accepted too: the walk takes every ray
    at once and compacts finished lanes instead."""
    t_max = per_lane(t_max, o.shape[0], o.device)
    r = _traverse(o, d, t_max, bvh, anyhit=False)
    res = (r["best_t"], r["best_p"], r["best_u"], r["best_v"])
    if stats:
        return res + (torch.stack([r["visits"], r["boxes"], r["tests"]]),)
    return res


def bvh_intersect_counts(o, d, bvh: DeviceBVH, t_max=BIG_T,
                         chunk: int = DEFAULT_CHUNK):
    """bvh_intersect plus each ray's traversal steps, int32 [N] (the
    ColorDebugBVH instrument, RenderCore_Bart/raytracer.cpp:102-120):
    (t, prim, u, v, steps). chunk as in bvh_intersect."""
    *hit, st = bvh_intersect(o, d, bvh, t_max=t_max, stats=True)
    return (*hit, st[0])


def bvh_occluded(o, d, t_max, bvh: DeviceBVH, v0=None, e1=None, e2=None,
                 chunk: int = DEFAULT_CHUNK, *, stats: bool = False):
    """Any-hit occlusion of [N] rays before t_max. Returns bool [N] (and the
    [3, N] counts with stats=True; the plain version tests a whole leaf
    before stopping, the kernel stops at the first hit). v0, e1, e2 and
    chunk as in bvh_intersect."""
    t_max = per_lane(t_max, o.shape[0], o.device)
    r = _traverse(o, d, t_max, bvh, anyhit=True)
    if stats:
        return r["occ"], torch.stack([r["visits"], r["boxes"], r["tests"]])
    return r["occ"]


def refine_hit(o, d, prim, tri9):
    """Differentiably recompute (t, u, v) for a known hit primitive.
    Gradients flow to the ray and to the triangle data: the reparameterised
    hit that stands in for differentiating the discrete traversal. The rows
    of the hit triangles are gathered first, so the clipped backward of
    refine_hit_rows acts on each lane before the gather's backward sums the
    lanes into their triangle. Returns (t, u, v, ok); ok is False where the
    re-test loses the hit."""
    p = torch.clamp(prim, min=0)
    return refine_hit_rows(o, d, prim, tri9[:, p])


# bound on the refine cotangents: the reparameterised-hit derivative carries
# 1/det and 1/det^2 factors that are real but unbounded at grazing incidence;
# unclipped they compound across bounces and overflow float32
REFINE_GRAD_LIMIT = 1e4


def _refine_tuv_impl(o, d, g9):
    """The refine re-test: (t, u, v, hit) of each lane's own triangle."""
    return mt_comp(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                   g9[0], g9[1], g9[2], g9[3], g9[4], g9[5], g9[6], g9[7],
                   g9[8], -BIG_T, BIG_T, det_eps=1e-6)


def _clip_grad(g):
    return torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0),
                       -REFINE_GRAD_LIMIT, REFINE_GRAD_LIMIT)


class _RefineTUV(torch.autograd.Function):
    """(t, u, v, hit) of the refine re-test. The backward is the VJP of
    (t, u, v) with NaN/inf zeroed and each lane's gradient clipped to
    +-REFINE_GRAD_LIMIT (JAX _refine_tuv's custom_vjp); hit is a bool and
    takes no gradient (JAX computes it apart, on stop_gradient inputs)."""

    @staticmethod
    def forward(ctx, o, d, g9):
        ctx.save_for_backward(o, d, g9)
        t, u, v, hit = _refine_tuv_impl(o, d, g9)
        ctx.mark_non_differentiable(hit)
        return t, u, v, hit

    @staticmethod
    def backward(ctx, gt, gu, gv, _):
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            grads = torch.autograd.grad(_refine_tuv_impl(*ins)[:3], ins,
                                        (gt, gu, gv))
        return tuple(_clip_grad(g) for g in grads)


def refine_hit_rows(o, d, prim, g9):
    """refine_hit from per-ray triangle rows g9 [9, N] (v0, e1, e2
    component-major). Uses a raised determinant cutoff (1e-6) and the
    clipped backward of _RefineTUV. Returns (t, u, v, ok); callers keep the
    traversal's (t, u, v) where ok is False (edge and grazing re-tests)."""
    t, u, v, h = _RefineTUV.apply(o, d, g9)
    valid = prim >= 0
    return (torch.where(valid, t, BIG_T), torch.where(valid, u, 0.0),
            torch.where(valid, v, 0.0), valid & h)
