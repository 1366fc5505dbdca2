"""The 4-wide BVH (BVH4) that both trace kernels walk, and its plain walk.

No JAX counterpart: the JAX package walks the BVH2 (bvh/traverse.py) and
its Pallas kernels walk cluster tiles. This module holds
  - `collapse`: the SAH BVH2 of bvh/builder.py collapsed into a BVH4. Each
    BVH4 node takes the place of one BVH2 interior node and holds as
    children that node's grandchildren; a child that is a BVH2 leaf (at most
    max_leaf triangles) stays a leaf. Child boxes are the BVH2 nodes' own
    float32 boxes, not quantised;
  - `pack_wide`: one 128-byte record (32 four-byte words) per node and the
    triangles in leaf order as three 16-byte rows each;
  - `wide_intersect` / `wide_occluded`: the plain lockstep walk of the packed
    BVH4, the plain version of csrc/trace.cu. It repeats the kernels' node
    order and arithmetic operation by operation, so kernel and plain version
    agree on every lane, counts included.

Node record, float32 [M4, 32] (the last eight words are int32 bits):
    words  0..23  lo.x[4] lo.y[4] lo.z[4] hi.x[4] hi.y[4] hi.z[4]
    words 24..27  child code: BVH4 node index, or a leaf's first triangle row
    words 28..31  child count: 0 interior, > 0 leaf, -1 empty slot
Empty slots are masked by their count, never by an inverted box (lo = +inf,
hi = -inf gives tn = -inf, tf = +inf: a hit). Their box words are 0.

Triangle rows, float32 [T, 12], in leaf order (BVH2 prim slot order):
    (v0.xyz, triangle id as int32 bits), (e1.xyz, 0), (e2.xyz, 0)

The walk. Every lane holds one item: a BVH4 node (index >= 0) or a leaf
(~(first << 3 | count)). Each step a live lane either pops a pruned item
(entry t >= best t), tests a leaf's triangles, or slab-tests the 4 children
of a node, descends into the nearest hit child and pushes the other hit
children far-first with their entry t (ties go to the lower slot). Any-hit
takes the hit children in slot order and stops at the first hit triangle.
Per-ray int32 [3, N] counts: steps (items visited), child boxes tested
(non-empty slots of visited nodes) and triangle tests.
"""
from __future__ import annotations

import numpy as np
import torch

from lighthouse2_tpu_torch.core.geometry import BIG_T, mt_comp

WIDTH = 4
NODE_WORDS = 32           # one 128-byte record per node
TRI_WORDS = 12            # three 16-byte rows per triangle
LEAF_SHIFT = 3            # leaf item = ~(first << 3 | count), count <= 7
STACK_CAP = 64            # per-ray stack entries (csrc/trace.cu STACK_CAP)
STEPS_PER_CHECK = 4       # walk steps between convergence checks


def _children(n, left, right, interior):
    """The (up to) four BVH4 children of BVH2 interior nodes n, as BVH2 ids
    [F, 4] with -1 for an empty slot, empties last, order kept."""
    slots = []
    for c in (left[n], right[n]):
        inner = interior[c]
        slots.append(np.where(inner, left[c], c))
        slots.append(np.where(inner, right[c], -1))
    s = np.stack(slots, 1).astype(np.int64)
    order = np.argsort(s < 0, axis=1, kind="stable")
    return np.take_along_axis(s, order, 1)


def collapse(left, right, count):
    """Collapse a flat BVH2 (builder.py layout) into a BVH4.

    Returns (nodes, slots, depth4): nodes int64 [M4], the BVH2 interior node
    each BVH4 node stands for, in BVH2 depth-first order (so BVH4 node 0 is
    the root); slots int64 [M4, 4], the BVH2 ids of each node's children
    (-1 = empty); depth4, the most BVH4 edges from the root to a leaf. A
    BVH2 whose root is a leaf gives one BVH4 node with that leaf as its one
    child."""
    left = np.asarray(left, np.int64)
    right = np.asarray(right, np.int64)
    interior = np.asarray(count) == 0
    if not interior[0]:
        return (np.zeros(1, np.int64), np.array([[0, -1, -1, -1]], np.int64),
                1)
    is_node = np.zeros(left.shape[0], bool)
    frontier = np.zeros(1, np.int64)
    depth4 = 0
    while frontier.size:
        is_node[frontier] = True
        depth4 += 1
        s = _children(frontier, left, right, interior)
        s = s[s >= 0]
        frontier = s[interior[s]]
    nodes = np.nonzero(is_node)[0]
    return nodes, _children(nodes, left, right, interior), depth4


def pack_wide(nbox, left, right, count, prim, tri9, max_leaf: int = 4):
    """Pack a BVH2 in the DeviceBVH layout (numpy: nbox [6,M], left, right,
    count [M], prim [T], tri9 [9,T]) into the BVH4 arrays. Returns
    dict(node4 float32 [M4, 32], tri4 float32 [T, 12], depth4 int)."""
    nbox = np.asarray(nbox, np.float32)
    left = np.asarray(left, np.int64)
    count = np.asarray(count, np.int64)
    prim = np.asarray(prim, np.int64)
    tri9 = np.asarray(tri9, np.float32)
    n_tris = prim.shape[0]
    if not 0 < max_leaf < (1 << LEAF_SHIFT):
        raise ValueError(f"max_leaf {max_leaf} does not fit a leaf item")
    if n_tris << LEAF_SHIFT >= 2 ** 31:
        raise ValueError(f"{n_tris} triangles do not fit a 32-bit leaf item")
    nodes, slots, depth4 = collapse(left, right, count)
    m4 = nodes.shape[0]
    index4 = np.full(left.shape[0], -1, np.int64)
    index4[nodes] = np.arange(m4)
    full = slots >= 0
    s = np.where(full, slots, 0)
    leaf = count[s] > 0
    box = np.where(full[None], nbox[:, s], np.float32(0))       # [6, M4, 4]
    code = np.where(full, np.where(leaf, left[s], index4[s]), 0)
    cnt = np.where(full, np.where(leaf, count[s], 0), -1)
    ints = np.concatenate([code, cnt], 1).astype(np.int32)
    node4 = np.concatenate([box.transpose(1, 0, 2).reshape(m4, 24),
                            ints.view(np.float32)], 1)
    g = tri9[:, prim].T.reshape(n_tris, 3, 3)                     # leaf order
    tri4 = np.zeros((n_tris, 3, 4), np.float32)
    tri4[:, :, :3] = g
    tri4[:, 0, 3] = prim.astype(np.int32).view(np.float32)
    return dict(node4=np.ascontiguousarray(node4, np.float32),
                tri4=tri4.reshape(n_tris, TRI_WORDS), depth4=int(depth4))


def check_depth4(depth4: int) -> None:
    """Raise if the walk's stack could overflow: a node pushes at most 3
    children, so the stack never holds more than 3 * depth4 + 1 entries."""
    if 3 * depth4 + 1 > STACK_CAP:
        raise ValueError(
            f"BVH4 depth {depth4} needs more than the {STACK_CAP}-entry "
            f"traversal stack (3 * depth + 1 must be <= {STACK_CAP})")


def _walk(o, d, t_max, node4, tri4, depth4: int, max_leaf: int,
          anyhit: bool):
    """Lockstep walk of all rays. Returns the per-lane result arrays
    (best_t, best_p, best_u, best_v, occ, visits, boxes, tests)."""
    check_depth4(depth4)
    n = o.shape[0]
    dev = o.device
    n_tris = tri4.shape[0]
    nodei = node4.view(torch.int32)
    trii = tri4.view(torch.int32)
    slot_ids = torch.arange(WIDTH, device=dev)
    ds = torch.where(torch.abs(d) < 1e-20, 1e-20, d)
    inv = 1.0 / ds
    s = dict(
        lane=torch.arange(n, device=dev),
        ox=o[:, 0], oy=o[:, 1], oz=o[:, 2],
        dx=d[:, 0], dy=d[:, 1], dz=d[:, 2],
        ix=inv[:, 0], iy=inv[:, 1], iz=inv[:, 2],
        item=torch.zeros(n, dtype=torch.int64, device=dev),
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
        item = s["item"]
        alive = ~s["done"]
        prune = s["cur_t"] >= s["best_t"]
        is_leaf = alive & ~prune & (item < 0)
        is_int = alive & ~prune & (item >= 0)

        code = ~item
        first = code >> LEAF_SHIFT
        cnt = code & ((1 << LEAF_SHIFT) - 1)
        best_t, best_p = s["best_t"], s["best_p"]
        best_u, best_v = s["best_u"], s["best_v"]
        occ, tests = s["occ"], s["tests"]
        for k in range(max_leaf):
            live_k = is_leaf & (k < cnt)
            if anyhit:
                live_k = live_k & ~occ
            row = torch.clamp(first + k, 0, n_tris - 1)
            g = tri4[row]
            t, u, v, h = mt_comp(s["ox"], s["oy"], s["oz"],
                                 s["dx"], s["dy"], s["dz"],
                                 g[:, 0], g[:, 1], g[:, 2], g[:, 4], g[:, 5],
                                 g[:, 6], g[:, 8], g[:, 9], g[:, 10],
                                 1e-6, best_t)
            h = h & live_k
            best_p = torch.where(h, trii[row, 3], best_p)
            best_u = torch.where(h, u, best_u)
            best_v = torch.where(h, v, best_v)
            best_t = torch.where(h, t, best_t)
            occ = occ | h
            tests = tests + live_k.to(torch.int32)

        # interior: slab-test the four children (other lanes read node 0)
        rec = node4[torch.where(is_int, item, 0)]
        reci = nodei[torch.where(is_int, item, 0)]
        c_code = reci[:, 24:28].to(torch.int64)
        c_cnt = reci[:, 28:32].to(torch.int64)
        ox, oy, oz = s["ox"][:, None], s["oy"][:, None], s["oz"][:, None]
        ix, iy, iz = s["ix"][:, None], s["iy"][:, None], s["iz"][:, None]
        t0x = (rec[:, 0:4] - ox) * ix
        t1x = (rec[:, 12:16] - ox) * ix
        t0y = (rec[:, 4:8] - oy) * iy
        t1y = (rec[:, 16:20] - oy) * iy
        t0z = (rec[:, 8:12] - oz) * iz
        t1z = (rec[:, 20:24] - oz) * iz
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                         torch.minimum(t0y, t1y)),
                           torch.minimum(t0z, t1z))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                         torch.maximum(t0y, t1y)),
                           torch.maximum(t0z, t1z))
        full = (c_cnt >= 0) & is_int[:, None]
        hit = ((tf >= torch.clamp(tn, min=0.0)) & (tn < best_t[:, None])
               & full)
        child = torch.where(c_cnt > 0, ~((c_code << LEAF_SHIFT) | c_cnt),
                            c_code)
        # rank of each hit child: nearer first (closest) or slot order (any)
        hj, hk = hit[:, :, None], hit[:, None, :]
        lower = slot_ids[:, None] < slot_ids[None, :]                # j < k
        if anyhit:
            before = lower[None]
        else:
            tj, tk = tn[:, :, None], tn[:, None, :]
            before = (tj < tk) | ((tj == tk) & lower[None])
        rank = (hj & before).sum(1)                                  # [n, 4]
        nh = hit.sum(1)
        nearest = hit & (rank == 0)
        nnode = (child * nearest).sum(1)
        nt = torch.where(nearest, tn, 0.0).sum(1)

        sptr = s["sptr"]
        stack, tstack = s["stack"], s["tstack"]
        for k in range(WIDTH):
            push = hit[:, k] & (rank[:, k] > 0)
            pos = torch.clamp(sptr + nh - 1 - rank[:, k], 0,
                              STACK_CAP - 1)[:, None]
            stack = stack.scatter(1, pos, torch.where(
                push, child[:, k], stack.gather(1, pos)[:, 0])[:, None])
            tstack = tstack.scatter(1, pos, torch.where(
                push, tn[:, k], tstack.gather(1, pos)[:, 0])[:, None])
        sptr = sptr + torch.clamp(nh - 1, min=0)

        if anyhit:
            # stop at the first hit (OPTIX_RAY_FLAG_TERMINATE_ON_FIRST_HIT)
            newly_occluded = occ & alive
        else:
            newly_occluded = torch.zeros_like(occ)
        goto = (nh > 0) & ~newly_occluded
        need_pop = alive & ~goto & ~newly_occluded
        can_pop = need_pop & (sptr > 0)
        done = s["done"] | (need_pop & (sptr == 0)) | newly_occluded

        pidx = torch.clamp(sptr - 1, 0, STACK_CAP - 1)[:, None]
        pitem = stack.gather(1, pidx)[:, 0]
        pt = tstack.gather(1, pidx)[:, 0]
        return dict(
            s, item=torch.where(goto, nnode, torch.where(can_pop, pitem, item)),
            cur_t=torch.where(goto, nt, torch.where(can_pop, pt, s["cur_t"])),
            sptr=sptr - can_pop.to(torch.int64), stack=stack, tstack=tstack,
            best_t=best_t, best_p=best_p, best_u=best_u, best_v=best_v,
            occ=occ, done=done, tests=tests,
            boxes=s["boxes"] + full.sum(1, dtype=torch.int32),
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


def _tmax(t_max, o):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                              device=o.device), (o.shape[0],))


def wide_intersect(o, d, bvh, t_max=BIG_T, stats: bool = False):
    """Closest hit of [N] rays over bvh's BVH4 (a DeviceBVH). Returns
    (t, prim, u, v) with prim = -1 and t = min(t_max, BIG_T) on a miss; with
    stats=True also the int32 [3, N] counts (steps, child boxes, triangle
    tests)."""
    r = _walk(o, d, _tmax(t_max, o), bvh.node4, bvh.tri4, bvh.depth4,
              bvh.max_leaf, anyhit=False)
    res = (r["best_t"], r["best_p"], r["best_u"], r["best_v"])
    if stats:
        return res + (torch.stack([r["visits"], r["boxes"], r["tests"]]),)
    return res


def wide_occluded(o, d, t_max, bvh, stats: bool = False):
    """Any-hit occlusion of [N] rays before t_max over bvh's BVH4. Returns
    bool [N] (and the int32 [3, N] counts with stats=True)."""
    r = _walk(o, d, _tmax(t_max, o), bvh.node4, bvh.tri4, bvh.depth4,
              bvh.max_leaf, anyhit=True)
    if stats:
        return r["occ"], torch.stack([r["visits"], r["boxes"], r["tests"]])
    return r["occ"]
