"""The two cluster-tile trace kernels: build, bind and call csrc/cluster_trace.cu.

Counterpart of the ClusterBVH path of lighthouse2_tpu/render/kernels/trace.py:
the Pallas kernels _make_closest_kernel and _make_anyhit_kernel (launched by
_trace_chunk), _block_frustum, bake_material_rows, ray_sort_perm,
prepare_pay_tiles and trace_cluster_bvh. Both CUDA kernels take the Pallas
kernels' own inputs (the top tree's boxes and meta, the bmat tiles and the
[8, Nc] ray tile), run the Pallas kernels' walk schedule (RING, BM_PERIOD)
and compute their outputs; the CUDA source explains the design.

Their plain PyTorch versions, cluster_closest_plain and
cluster_occluded_plain, walk all blocks of a launch in lockstep (one top-tree
step of every block per iteration, vectorised over blocks) with that
schedule: the closest walk fills a per-block ring of RING leaves, takes two
leaves a step with both sub-packet masks from the best t at the step's
start, and refreshes the walk bound when tail % BM_PERIOD < 2; the any-hit
walk fetches a leaf ahead and refreshes after every BM_PERIOD-th leaf. So
their per-block visit and sub-packet counters are the Pallas kernel's. They
are the wrappers' CPU branch and the kernels' reference on the card.

The library is built with nvcc at first use (render/kernels/trace.py
build_library: sm_90a, -fmad=false, into build/lighthouse2_tpu_torch/) and
loaded with ctypes. cluster_closest / cluster_occluded take the plain version
for tensors on the CPU and launch the kernel for tensors on a CUDA device,
never falling back; `cluster_closest.launches` and
`cluster_occluded.launches` count kernel launches.

Differences from the JAX package:
  - the closest kernel's outputs are the winner code as int32 (-1 on a
    miss), the best t, and the tile-visit and sub-packet counters per block
    (int32 [n_blocks]); the Pallas kernel writes all four as f32 rows of
    an [8, Nc] tile, the code exact only below 2^24. trace_cluster_bvh
    broadcasts the counters into payload rows 38 and 39 as JAX does;
  - a launch covers all blocks (JAX chunks 32 blocks a pallas_call for
    VMEM); the plain version works in chunks of pair evaluations instead;
  - trace_cluster_bvh returns (t, prim, payload) for closest hits: prim is
    the int32 triangle id read from ClusterBVH.prim by the code, where JAX
    reads the f32 PAY_PRIM row of the payload (which the payload keeps);
  - tmax is clamped to 1e30 (BIG), as the BVH4 kernels clamp theirs, so a
    larger tmax cannot admit a miss as a hit;
  - the six linear forms: the kernels compute them on tensor cores in
    3xTF32 (mma.sync) and decide the pairs near a test's boundary, and a
    tile's winner, with the plain versions' FP32 terms; the plain versions
    compute them term by term in FP32; JAX's kernels as one MXU product at
    Precision.HIGHEST. JAX and the port agree to the last bits of t, so a
    hit at an exact t-tie, and through the best t a borderline sub-packet
    mark and so a block's counters, may differ; the interpret-mode Pallas
    kernels are the reference of the hits;
  - a marked sub-packet's tile is evaluated for its 16-ray row groups that
    hold a candidate lane (a ray passing the leaf's slab test), where the
    Pallas kernel evaluates all 128 rays: a ray of another row group can
    only miss a hit whose point lies on its leaf's box within rounding.
    The counters still count marked sub-packets;
  - the top tree's walk stack holds at most MAX_STACK = 128 entries (a
    tree of depth <= 62; the bathroom's is 13), checked by the wrappers;
  - RING is a constant here, where JAX reads LH2_RING from the
    environment (default 4);
  - ray_sort_perm sorts int64 keys with a stable torch.argsort (JAX: uint32
    keys, jnp.argsort, also stable).
"""
from __future__ import annotations

import ctypes
import os

import torch

from lighthouse2_tpu_torch.bvh.clusters import (
    CLUSTER_LANES, PAY_MAT, PAY_MAT_ROWS, PAY_PRIM, PAY_ROWS, PAY_VALID,
    ClusterBVH)
from lighthouse2_tpu_torch.core.geometry import per_lane
from lighthouse2_tpu_torch.render.kernels.trace import (
    _check_rc, build_library)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "cluster_trace.cu")

BLOCK = 1024           # rays per block (one top-tree walk per block)
SUB = 128              # sub-packet lanes
NSUB = BLOCK // SUB
ROW = 16               # rays of a row group (the kernels' mma row tile)
ROW_GROUPS = SUB // ROW
MT_EPS = 1e-6          # t epsilon (bvh/traverse.py parity)
BIG = 1e30
MAX_STACK = 128        # csrc/cluster_trace.cu MAX_STACK
RING = 4               # leaf ring of the closest walk (csrc RING)
BM_PERIOD = 8          # leaves between walk-bound refreshes (csrc BM_PERIOD)
PAIR_CHUNK = 256       # (block, sub-packet) pairs a plain evaluation step
# per-block statistics of the kernels (stats=, csrc ST_*): tiles copied,
# those of leaves with no marked sub-packet, marked (sub-packet, tile)
# pairs, leaves processed, evaluated (sub-packet, row group, tile) units of
# ROW rays x 128 triangles
STATS = ("tiles", "tiles_unused", "pairs", "leaves", "units")
TILE_BYTES = 7 * 768 * 4   # bytes a tile copy moves (rows 0..6 of bmat)

# per-block counters in the payload's pad rows (JAX PAY_STAT_*)
PAY_STAT_VISITS = 38
PAY_STAT_SUBS = 39

# frustum-row layout of _block_frustum ([16, n_blocks] f32)
FR_OMIN, FR_OMAX, FR_IMIN, FR_IMAX = 0, 3, 6, 9
FR_TLIM, FR_LIVE = 12, 13
FR_ROWS = 16

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library(SOURCE)[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lh2_cluster_closest.argtypes = [p] * 4 + [i] * 3 + [p] * 6
        lib.lh2_cluster_closest.restype = i
        lib.lh2_cluster_occluded.argtypes = [p] * 4 + [i] * 3 + [p] * 3
        lib.lh2_cluster_occluded.restype = i
        lib.lh2_cluster_ctas_per_sm.argtypes = [i]
        lib.lh2_cluster_ctas_per_sm.restype = i
        _lib = lib
    return _lib


def ctas_per_sm(anyhit: bool = False) -> int:
    """CTAs of the closest-hit (or any-hit) kernel that one SM of the
    current card holds at the kernels' launch configuration (each CTA
    traces one 1024-ray block)."""
    n = _load().lh2_cluster_ctas_per_sm(int(anyhit))
    if n < 0:
        raise RuntimeError(f"occupancy query failed (CUDA error {-n})")
    return n


def stack_cap(bvh: ClusterBVH) -> int:
    """Top-tree stack entries of a walk (JAX: max(64, 2 (depth + 2)))."""
    return max(64, 2 * (bvh.max_depth + 2))


def _inv(d):
    mag = torch.clamp(d.abs(), min=1e-18)
    return torch.where(d < 0, -1.0 / mag, 1.0 / mag)


def _block_frustum(x, n_blocks: int):
    """Per-block conservative frustum rows [FR_ROWS, n_blocks]: origin box,
    inverse-direction interval, largest live tmax, live flag. Dead lanes
    (tmax <= 0) are left out of every bound."""
    xb = x.reshape(8, n_blocks, BLOCK)
    o, tmax = xb[0:3], xb[7]
    live = tmax > 0.0
    inv = _inv(xb[3:6])
    lv = live[None]
    rows = [torch.where(lv, o, BIG).amin(-1), torch.where(lv, o, -BIG).amax(-1),
            torch.where(lv, inv, BIG).amin(-1),
            torch.where(lv, inv, -BIG).amax(-1),
            torch.where(live, tmax, 0.0).amax(-1)[None],
            live.any(-1).to(torch.float32)[None]]
    pad = torch.zeros((2, n_blocks), dtype=x.dtype, device=x.device)
    return torch.cat(rows + [pad], 0)


def _frustum_bounds(boxes, frs):
    """_frustum_hit's interval bounds (tn, tf), each [B, M], of every node
    for every block: node nd is hit before tlim where tf >= tn and
    tn < tlim. boxes [8, M] the top tree's, frs [16, B] the blocks'
    frustums. Computed once a walk, with the kernel's operations."""
    tn = torch.zeros((frs.shape[1], boxes.shape[1]), dtype=torch.float32,
                     device=frs.device)
    tf = torch.full_like(tn, BIG)
    for a in range(3):
        om_lo, om_hi = frs[FR_OMIN + a][:, None], frs[FR_OMAX + a][:, None]
        i_lo, i_hi = frs[FR_IMIN + a][:, None], frs[FR_IMAX + a][:, None]
        bmin, bmax = boxes[a][None], boxes[3 + a][None]
        u1, v1 = bmin - om_hi, bmin - om_lo
        u2, v2 = bmax - om_hi, bmax - om_lo
        p = torch.stack([u1 * i_lo, u1 * i_hi, v1 * i_lo, v1 * i_hi,
                         u2 * i_lo, u2 * i_hi, v2 * i_lo, v2 * i_hi])
        tn = torch.maximum(tn, torch.maximum(p.amin(0),
                                             torch.maximum(u1, -v2)))
        tf = torch.minimum(tf, p.amax(0))
    return tn, tf


class _TopWalk:
    """The top-tree walks of B blocks, one stack each, in lockstep."""

    def __init__(self, boxes, meta, frs, cap: int):
        b = frs.shape[1]
        dev = frs.device
        self.meta = meta.to(torch.int64)
        self.tn, self.tf = _frustum_bounds(boxes, frs)
        self.rows = torch.arange(b, device=dev)
        self.stack = torch.zeros((b, cap), dtype=torch.int64, device=dev)
        self.sp = torch.ones(b, dtype=torch.int64, device=dev)
        nl = [(frs[FR_IMIN + a] + frs[FR_IMAX + a] >= 0.0).to(torch.int64)
              << a for a in range(3)]
        self.nl = nl[0] | nl[1] | nl[2]

    def next_leaf(self, bm, active):
        """Pop until a frustum-hit leaf (its node id) or an empty stack
        (-1), for every active block; `bm` [B] is the walk bound."""
        meta, stack = self.meta, self.stack
        leaf = torch.full_like(self.sp, -1)
        srch = active & (self.sp > 0)
        while bool(srch.any()):
            spb = torch.where(srch, self.sp - 1, self.sp)
            lo = spb.clamp(min=0)[:, None]
            nd = stack.gather(1, lo)[:, 0]
            tn = self.tn[self.rows, nd]
            hit = srch & (self.tf[self.rows, nd] >= tn) & (tn < bm)
            is_leaf = meta[1, nd] >= 0
            found = hit & is_leaf
            leaf = torch.where(found, nd, leaf)
            push = hit & ~is_leaf
            right, axis = meta[2, nd], meta[3, nd]
            near_left = ((self.nl >> axis) & 1) != 0
            far = torch.where(near_left, right, nd + 1)
            near = torch.where(near_left, nd + 1, right)
            stack.scatter_(1, lo, torch.where(push, far, nd)[:, None])
            stack.scatter_(1, lo + 1, torch.where(
                push, near, stack.gather(1, lo + 1)[:, 0])[:, None])
            self.sp = torch.where(srch, spb + 2 * push.to(torch.int64),
                                  self.sp)
            srch = srch & ~found & (self.sp > 0)
        return leaf


def _lane_slab(bx, o, inv, limit):
    """_lane_slab: every lane of B blocks against its block's leaf box.
    bx [8, B], o / inv [3, B, 1024], limit [B, 1024]."""
    t = [((bx[r][:, None] - o[a]) * inv[a]) for a in range(3)
         for r in (a, 3 + a)]
    t0x, t1x, t0y, t1y, t0z, t1z = t
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.clamp(torch.minimum(t0z, t1z), min=0.0))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                     torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return (tf >= tn) & (tn < limit)


def _tile_forms(tiles, o, d, limit):
    """The six forms of every (triangle, ray) pair: tiles [P, 8, 768], o / d
    [3, P, 128], limit [P, 128]. Returns (t, ok), each [P, 128 tri, 128
    ray], term by term as the kernel's tri_hit."""
    L = CLUSTER_LANES

    def c(row, blk):
        return tiles[:, row, blk * L:(blk + 1) * L][:, :, None]

    ox, oy, oz = (o[a][:, None, :] for a in range(3))
    dx, dy, dz = (d[a][:, None, :] for a in range(3))

    def origin_form(blk):
        return ((c(0, blk) * ox + c(1, blk) * oy) + c(2, blk) * oz) + c(6, blk)

    def dir_form(blk):
        return (c(3, blk) * dx + c(4, blk) * dy) + c(5, blk) * dz

    t = origin_form(0) / dir_form(1)
    u = origin_form(2) + t * dir_form(3)
    v = origin_form(4) + t * dir_form(5)
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > MT_EPS)
          & (t < limit[:, None, :]))
    return t, ok


def _pairs(bits):
    """(block row, sub-packet) index pairs of the set bits [A, NSUB]."""
    nz = bits.nonzero()
    return nz[:, 0], nz[:, 1]


def _live_blocks(x):
    """(n_blocks, the frustum rows, the indices of the live blocks)."""
    nb = x.shape[1] // BLOCK
    fr = _block_frustum(x, nb)
    return nb, fr, (fr[FR_LIVE] > 0).nonzero()[:, 0]


class _Rays:
    """The live blocks' rays of a launch, per block and sub-packet."""

    def __init__(self, x, sel):
        xb = x.reshape(8, -1, BLOCK)[:, sel]
        nbl = sel.numel()
        self.o, self.d, self.tmax = xb[0:3], xb[3:6], xb[7]
        self.inv = _inv(self.d)
        self.o4 = self.o.reshape(3, nbl, NSUB, SUB)
        self.d4 = self.d.reshape(3, nbl, NSUB, SUB)

    def groups(self, boxes, nd, a, limit):
        """Candidate row groups [len(a), NSUB, ROW_GROUPS] of leaves nd for
        blocks a: a 16-ray row group of a sub-packet with a lane whose ray
        passes the leaf's slab test before `limit`. A sub-packet is marked
        where one of its row groups is."""
        return _lane_slab(boxes[:, nd], self.o[:, a], self.inv[:, a],
                          limit).view(-1, NSUB, ROW_GROUPS, ROW).any(-1)


def _group_limit(groups, ai, si, limit):
    """`limit` [P, 128] of the pairs (ai, si) where the ray's row group is
    a candidate, else 0 (no hit can pass t < 0)."""
    lane_ok = groups[ai, si].repeat_interleave(ROW, dim=-1)
    return torch.where(lane_ok, limit, 0.0)


def _closest_leaf(r, bvh: ClusterBVH, a, nd, groups, best4, code4, lanes):
    """The tiles of leaves nd (one a block of a) on the candidate row groups
    of the marked sub-packets: the closest hit of each ray, taken where
    strictly closer than its best t (tie: lowest lane of the tile)."""
    tpc = bvh.tiles_per_cluster
    t0 = bvh.meta[1].to(torch.int64)[nd].clamp(min=0) * tpc
    ai, si = _pairs(groups.any(-1))
    pb = a[ai]
    for j in range(tpc):
        for lo in range(0, pb.numel(), PAIR_CHUNK):
            cb, cs = pb[lo:lo + PAIR_CHUNK], si[lo:lo + PAIR_CHUNK]
            tile = t0[ai[lo:lo + PAIR_CHUNK]] + j
            bs = best4[cb, cs]
            tt, ok = _tile_forms(bvh.bmat[tile], r.o4[:, cb, cs],
                                 r.d4[:, cb, cs], _group_limit(
                                     groups, ai[lo:lo + PAIR_CHUNK],
                                     si[lo:lo + PAIR_CHUNK], bs))
            tm = torch.where(ok, tt, BIG)
            tb = tm.amin(1)
            win = torch.where(tm <= tb[:, None], lanes,
                              CLUSTER_LANES).amin(1)
            upd = tb < bs
            best4[cb, cs] = torch.where(upd, tb, bs)
            code4[cb, cs] = torch.where(
                upd, tile[:, None] * CLUSTER_LANES + win, code4[cb, cs])


def cluster_closest_plain(x, bvh: ClusterBVH):
    """Plain version of the closest-hit kernel. x [8, Nc] f32 (o, d, 1,
    tmax), Nc a multiple of 1024. Returns (code int32 [Nc] (tile * 128 +
    lane, -1 on a miss), t f32 [Nc] (the best t; tmax where nothing was
    hit, 0 in blocks without a live lane), visits int32 [n_blocks], subs
    int32 [n_blocks]).

    The Pallas schedule, lockstep over blocks: a step fills each block's
    ring up to RING leaves with its walk bound, takes its two oldest
    leaves, marks both leaves' sub-packets (their candidate row groups)
    against the best t at the step's start, processes the first then the
    second, and refreshes the bound (the largest best t of a live lane)
    when tail % BM_PERIOD < 2. visits = tail * tpc; subs counts the marked
    (sub-packet, tile) pairs."""
    nb, fr, sel = _live_blocks(x)
    dev = x.device
    code = torch.full((nb, BLOCK), -1, dtype=torch.int32, device=dev)
    t_out = torch.zeros((nb, BLOCK), dtype=torch.float32, device=dev)
    visits = torch.zeros(nb, dtype=torch.int32, device=dev)
    subs = torch.zeros(nb, dtype=torch.int32, device=dev)
    if sel.numel() == 0:
        return code.reshape(-1), t_out.reshape(-1), visits, subs
    nbl = sel.numel()
    r = _Rays(x, sel)
    live = r.tmax > 0.0
    best = r.tmax.clone()
    bcode = torch.full((nbl, BLOCK), -1, dtype=torch.int64, device=dev)
    walk = _TopWalk(bvh.boxes, bvh.meta, fr[:, sel], stack_cap(bvh))
    tpc = bvh.tiles_per_cluster
    bm = fr[FR_TLIM, sel].clone()
    i64 = dict(dtype=torch.int64, device=dev)
    ring = torch.zeros((nbl, RING), **i64)
    head, tail = torch.zeros(nbl, **i64), torch.zeros(nbl, **i64)
    wd = torch.zeros(nbl, dtype=torch.bool, device=dev)
    sb = torch.zeros(nbl, **i64)
    rows = torch.arange(nbl, device=dev)
    lanes = torch.arange(CLUSTER_LANES, device=dev)[None, :, None]
    best4 = best.view(nbl, NSUB, SUB)
    code4 = bcode.view(nbl, NSUB, SUB)
    while True:
        need = ~wd & (head - tail < RING)
        while bool(need.any()):
            leaf = walk.next_leaf(bm, need)
            got = need & (leaf >= 0)
            ring[rows[got], head[got] % RING] = leaf[got]
            head = head + got.to(torch.int64)
            wd = wd | (need & (leaf < 0))
            need = ~wd & (head - tail < RING)
        n_avail = head - tail
        a = (n_avail > 0).nonzero()[:, 0]
        if a.numel() == 0:
            break
        nd_a = ring[a, tail[a] % RING]
        nd_b = ring[a, (tail[a] + 1) % RING]
        two = n_avail[a] >= 2
        grp_a = r.groups(bvh.boxes, nd_a, a, best[a])
        grp_b = r.groups(bvh.boxes, nd_b, a, best[a]) & two[:, None, None]
        _closest_leaf(r, bvh, a, nd_a, grp_a, best4, code4, lanes)
        _closest_leaf(r, bvh, a[two], nd_b[two], grp_b[two], best4, code4,
                      lanes)
        sb[a] += tpc * (grp_a.any(-1).sum(-1) + grp_b.any(-1).sum(-1))
        tail[a] += n_avail[a].clamp(max=2)
        ref = a[tail[a] % BM_PERIOD < 2]
        bm[ref] = torch.where(live[ref], best[ref], 0.0).amax(-1)
    code[sel] = bcode.to(torch.int32)
    t_out[sel] = best
    visits[sel] = (tail * tpc).to(torch.int32)
    subs[sel] = sb.to(torch.int32)
    return code.reshape(-1), t_out.reshape(-1), visits, subs


def cluster_occluded_plain(x, bvh: ClusterBVH):
    """Plain version of the any-hit kernel: bool [Nc], True where a triangle
    lies at 1e-6 < t < tmax (dead lanes False).

    The Pallas schedule, lockstep over blocks: leaf k + 1 is fetched before
    leaf k is processed; each tile is masked against the live unoccluded
    lanes; the walk bound (the largest tmax of a live unoccluded lane) is
    refreshed after leaf k when k % BM_PERIOD == 0, and a block stops once
    it is <= 0."""
    nb, fr, sel = _live_blocks(x)
    dev = x.device
    out = torch.zeros((nb, BLOCK), dtype=torch.bool, device=dev)
    if sel.numel() == 0:
        return out.reshape(-1)
    nbl = sel.numel()
    r = _Rays(x, sel)
    tmax = r.tmax
    occ = ~(tmax > 0.0)                     # occluded or dead
    walk = _TopWalk(bvh.boxes, bvh.meta, fr[:, sel], stack_cap(bvh))
    meta1 = bvh.meta[1].to(torch.int64)
    tpc = bvh.tiles_per_cluster
    bm = fr[FR_TLIM, sel].clone()
    tmax4 = tmax.view(nbl, NSUB, SUB)
    occ4 = occ.view(nbl, NSUB, SUB)
    l0 = walk.next_leaf(bm, torch.ones(nbl, dtype=torch.bool, device=dev))
    active = l0 >= 0
    k = 0
    while bool(active.any()):
        l1 = walk.next_leaf(bm, active)
        a = active.nonzero()[:, 0]
        nd = l0[a]
        t0 = meta1[nd].clamp(min=0) * tpc
        for j in range(tpc):
            groups = r.groups(bvh.boxes, nd, a,
                              torch.where(occ[a], 0.0, tmax[a]))
            ai, si = _pairs(groups.any(-1))
            pb = a[ai]
            for lo in range(0, pb.numel(), PAIR_CHUNK):
                cb, cs = pb[lo:lo + PAIR_CHUNK], si[lo:lo + PAIR_CHUNK]
                tile = t0[ai[lo:lo + PAIR_CHUNK]] + j
                _, ok = _tile_forms(bvh.bmat[tile], r.o4[:, cb, cs],
                                    r.d4[:, cb, cs], _group_limit(
                                        groups, ai[lo:lo + PAIR_CHUNK],
                                        si[lo:lo + PAIR_CHUNK],
                                        tmax4[cb, cs]))
                occ4[cb, cs] = occ4[cb, cs] | ok.any(1)
        if k % BM_PERIOD == 0:
            bm[a] = torch.where(~occ[a], tmax[a], 0.0).amax(-1)
        l0 = torch.where(active, l1, l0)
        k += 1
        active = active & (l0 >= 0) & (bm > 0.0)
    out[sel] = occ & (tmax > 0.0)
    return out.reshape(-1)


def _check(x, bvh: ClusterBVH):
    if x.dim() != 2 or x.shape[0] != 8 or x.shape[1] % BLOCK:
        raise ValueError(f"x must be [8, 1024 * n_blocks], got "
                         f"{tuple(x.shape)}")
    for name, t, dtype in (("x", x, torch.float32),
                           ("boxes", bvh.boxes, torch.float32),
                           ("meta", bvh.meta, torch.int32),
                           ("bmat", bvh.bmat, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, rays on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if bvh.bmat.dim() != 3 or tuple(bvh.bmat.shape[1:]) != (8, 768):
        raise ValueError("bvh.bmat must be [CT, 8, 768]")
    if stack_cap(bvh) > MAX_STACK:
        raise ValueError(f"top tree of depth {bvh.max_depth} needs "
                         f"{stack_cap(bvh)} stack entries, more than the "
                         f"kernels' {MAX_STACK}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _args(x, bvh: ClusterBVH):
    if bvh.bmat.data_ptr() % 16:
        raise ValueError("bmat must be 16-byte aligned (TMA bulk copies)")
    return [bvh.boxes.data_ptr(), bvh.meta.data_ptr(), bvh.bmat.data_ptr(),
            x.data_ptr(), bvh.boxes.shape[1], bvh.tiles_per_cluster,
            x.shape[1] // BLOCK]


def _stats_ptr(x, stats):
    """The kernel's optional per-block copy statistics (STATS): an int32
    [n_blocks, 4] tensor on the rays' card, filled by the launch."""
    if stats is None:
        return None
    if x.device.type != "cuda":
        raise ValueError("stats count the kernels' tile copies: CUDA only")
    if (stats.dtype != torch.int32 or stats.device != x.device
            or tuple(stats.shape) != (x.shape[1] // BLOCK, len(STATS))
            or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int32 "
                         f"[{x.shape[1] // BLOCK}, {len(STATS)}] tensor on "
                         f"{x.device}")
    return stats.data_ptr()


def cluster_closest(x, bvh: ClusterBVH, stats=None):
    """Closest hits of the ray tile x [8, Nc] against the ClusterBVH:
    (code int32 [Nc], t f32 [Nc], visits int32 [n_blocks], subs int32
    [n_blocks]) as cluster_closest_plain. The kernel for CUDA tensors, the
    plain version for CPU tensors; `stats` (CUDA only) receives the
    kernel's per-block copy statistics (STATS)."""
    _check(x, bvh)
    if x.device.type == "cpu" and stats is None:
        return cluster_closest_plain(x, bvh)
    st = _stats_ptr(x, stats)
    nc, nb = x.shape[1], x.shape[1] // BLOCK
    dev = x.device
    code = torch.empty(nc, dtype=torch.int32, device=dev)
    t = torch.empty(nc, dtype=torch.float32, device=dev)
    visits = torch.empty(nb, dtype=torch.int32, device=dev)
    subs = torch.empty(nb, dtype=torch.int32, device=dev)
    rc = _load().lh2_cluster_closest(
        *_args(x, bvh), code.data_ptr(), t.data_ptr(), visits.data_ptr(),
        subs.data_ptr(), st, torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(rc, "cluster_closest")
    cluster_closest.launches += 1
    return code, t, visits, subs


def cluster_occluded(x, bvh: ClusterBVH, stats=None):
    """Any-hit of the ray tile x [8, Nc]: bool [Nc] as
    cluster_occluded_plain. The kernel for CUDA tensors, the plain version
    for CPU tensors; `stats` (CUDA only) as cluster_closest's."""
    _check(x, bvh)
    if x.device.type == "cpu" and stats is None:
        return cluster_occluded_plain(x, bvh)
    st = _stats_ptr(x, stats)
    dev = x.device
    occ = torch.empty(x.shape[1], dtype=torch.bool, device=dev)
    rc = _load().lh2_cluster_occluded(
        *_args(x, bvh), occ.data_ptr(), st,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(rc, "cluster_occluded")
    cluster_occluded.launches += 1
    return occ


cluster_closest.launches = 0
cluster_occluded.launches = 0


def bake_material_rows(cbvh: ClusterBVH, mpack22):
    """The material payload rows of every tile lane from the live material
    pack ([28, M], render/shading.py material_pack): [CT, PAY_MAT_ROWS, 128]
    f32, one triangle-count-sized gather a pass."""
    ct = cbvh.pgeo.shape[0]
    valid = cbvh.pgeo[:, PAY_VALID, :] > 0.0
    ids = torch.where(valid, cbvh.pgeo[:, PAY_MAT, :], 0.0).to(torch.int64)
    rows = mpack22[:, ids.reshape(-1)].reshape(
        mpack22.shape[0], ct, CLUSTER_LANES).transpose(0, 1)
    return torch.nn.functional.pad(rows, (0, 0, 0,
                                          PAY_MAT_ROWS - mpack22.shape[0]))


def _stretch3(b, nbits: int):
    out = torch.zeros_like(b)
    for i in range(nbits):
        out = out | (((b >> i) & 1) << (3 * i))
    return out


def _morton3(q, nbits: int):
    return (_stretch3(q[:, 0], nbits) | (_stretch3(q[:, 1], nbits) << 1)
            | (_stretch3(q[:, 2], nbits) << 2))


def ray_sort_perm(o, d, t_max, bvh: ClusterBVH, key: str = "dir"):
    """Coherence permutation of one wavefront; dead lanes (t_max <= 0) sort
    to the end, so all-dead tail blocks are skipped.

    key="dir": coarse origin cell (2 bits an axis), then direction morton
    (5 bits an axis), for bounce rays; key="origin_octant": fine origin
    morton (4 bits an axis), then the direction octant, for batches whose
    origins spread (shadow rays). Returns (perm, inv) int64 [N]."""
    o, d = o.detach(), d.detach()
    t_max = per_lane(t_max, o.shape[0], o.device)
    bmin = bvh.boxes[0:3, 0]                     # root node box
    bmax = bvh.boxes[3:6, 0]
    extent = torch.clamp(bmax - bmin, min=1e-6)
    if key == "dir":
        q = torch.clamp(((o - bmin) / extent) * 3.999, 0.0, 3.0
                        ).to(torch.int64)
        ocell = _morton3(q, 2)                   # 6 bits
        dq = torch.clamp((d * 0.5 + 0.5) * 31.999, 0.0, 31.0
                         ).to(torch.int64)
        k = (ocell << 15) | _morton3(dq, 5)      # 15 bits
    elif key == "origin_octant":
        q = torch.clamp(((o - bmin) / extent) * 15.999, 0.0, 15.0
                        ).to(torch.int64)
        octant = ((d[:, 0] < 0).to(torch.int64)
                  | ((d[:, 1] < 0).to(torch.int64) << 1)
                  | ((d[:, 2] < 0).to(torch.int64) << 2))
        k = (_morton3(q, 4) << 3) | octant
    else:
        raise ValueError(f"unknown sort key {key!r}")
    k = torch.where(t_max > 0.0, k, 0x7FFFFFFF)
    perm = torch.argsort(k, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv


def prepare_pay_tiles(bvh: ClusterBVH, paym=None):
    """The flat payload pack [PAY_ROWS, CT * 128 + 1]: host-baked geometry
    rows and device-baked material rows (bake_material_rows), once a pass.
    The kernel's winner code indexes its columns; the trailing column is
    the miss column (zeros, PAY_PRIM = -1)."""
    ct = bvh.pgeo.shape[0]
    if paym is None:
        paym = torch.zeros((ct, PAY_MAT_ROWS, CLUSTER_LANES),
                           dtype=torch.float32, device=bvh.device)
    tiles = torch.cat([bvh.pgeo.detach(), paym.detach()], 1)   # [CT, 72, 128]
    pack = tiles.transpose(0, 1).reshape(PAY_ROWS, -1)
    miss = torch.zeros((PAY_ROWS, 1), dtype=torch.float32, device=pack.device)
    miss[PAY_PRIM] = -1.0
    return torch.cat([pack, miss], 1)


def ray_tile(o, d, t_max, perm=None):
    """The kernels' ray tile [8, Nc]: rows o.xyz, d.xyz, 1, tmax (clamped
    to BIG), detached, permuted by `perm`, padded with dead lanes to a
    multiple of 1024."""
    o, d = o.detach(), d.detach()
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o and d must both be [N,3], got {tuple(o.shape)} "
                         f"and {tuple(d.shape)}")
    n = o.shape[0]
    tmax = per_lane(t_max, n, o.device).detach()
    x = torch.cat([o.T, d.T, torch.ones((1, n), dtype=torch.float32,
                                        device=o.device),
                   torch.clamp(tmax, max=BIG)[None]], 0)
    if perm is not None:
        x = x[:, perm]
    pad = -(-n // BLOCK) * BLOCK - n
    return torch.nn.functional.pad(x, (0, pad)).contiguous()


def trace_cluster_bvh(o, d, bvh: ClusterBVH, t_max, anyhit: bool = False,
                      paym=None, pay_tiles=None, interpret: bool = False,
                      perm=None, inv=None, ablate: str = ""):
    """Closest hit (or any-hit) of rays o, d [N,3] against a ClusterBVH,
    through the kernels on a card and their plain versions on the CPU.

    Closest: returns (t [N], prim int32 [N] (-1 on a miss), payload
    [PAY_ROWS, N]): the hit's payload rows (bvh/clusters.py PAY_*; the
    material rows filled when `paym` from bake_material_rows or
    `pay_tiles` from prepare_pay_tiles is given), gathered in one fetch
    pay_tiles[:, code], with the best t in the PAY_VALID row and the
    block's counters in rows 38 and 39; t is tmax on a miss. Any-hit:
    returns occluded bool [N]. `perm` / `inv` (ray_sort_perm) reorder the
    rays for the kernel and its outputs back. Takes no gradient; the
    payload's gradients re-attach through render/fetch.py reattach_rows.
    `interpret` (JAX's Pallas interpret mode) changes nothing: CPU tensors
    take the plain versions. `ablate`, JAX's switch that skips parts of its
    kernel for time attribution, must be empty."""
    if ablate:
        raise ValueError(f"ablate={ablate!r}: the port's kernels have no "
                         "ablation switches")
    n = o.shape[0]
    x = ray_tile(o, d, t_max, perm)
    tmax = torch.clamp(per_lane(t_max, n, o.device), max=BIG)
    if anyhit:
        occ = cluster_occluded(x, bvh)[:n]
        return occ[inv] if inv is not None else occ
    if pay_tiles is None:
        pay_tiles = prepare_pay_tiles(bvh, paym)
    code, t_k, visits, subs = cluster_closest(x, bvh)
    lane_blk = torch.arange(x.shape[1], device=x.device) // BLOCK
    stats = torch.stack([visits[lane_blk], subs[lane_blk]]).to(torch.float32)
    code, t_k, stats = code[:n], t_k[:n], stats[:, :n]
    if inv is not None:
        code, t_k, stats = code[inv], t_k[inv], stats[:, inv]
    hit = code >= 0
    ci = torch.where(hit, code, pay_tiles.shape[1] - 1).to(torch.int64)
    g = pay_tiles[:, ci]                    # the single payload fetch
    payload = torch.cat([g[:PAY_VALID], t_k[None], g[PAY_VALID + 1:
                                                     PAY_STAT_VISITS],
                         stats, g[PAY_STAT_SUBS + 1:]], 0)
    prim = torch.where(hit, bvh.prim.reshape(-1)[code.clamp(min=0).to(
        torch.int64)], -1)
    return torch.where(hit, t_k, tmax.detach()), prim, payload
