"""Two-level acceleration structure: a TLAS over cached per-mesh BLASes.

Numpy copy of lighthouse2_tpu/bvh/tlas.py (transform_aabbs, _build_tlas,
compose_two_level), with no deliberate difference. The kernels walk one
world-space tree, so the two levels are composed at every sync: a TLAS over
the instances' world boxes, each TLAS leaf spliced by that instance's BLAS
(built once in mesh space and cached by HostScene._mesh_blas) with its node
boxes conservatively transformed to world space. A transform change costs an
O(nodes) box transform and a small TLAS build, not an SAH rebuild;
conservative boxes loosen pruning and never cause a miss. The composed flat
dict has the builder's layout and feeds device_bvh_from_flat (BVH2 arrays and
the BVH4 of bvh/wide.py) like a single-level build.
"""
from __future__ import annotations

import numpy as np


def transform_aabbs(bmin, bmax, mat):
    """Conservatively transform AABBs [N,3] by a 4x4 matrix (world = M·local).

    Standard min/max-of-column-contributions form (equivalent to transforming
    all 8 corners, vectorized)."""
    r = np.asarray(mat[:3, :3], np.float32)
    t = np.asarray(mat[:3, 3], np.float32)
    # contribution of local axis j to world axis i: r[i,j] * (bmin|bmax)[:,j]
    lo = bmin[:, None, :] * r[None]          # [N,3(world),3(local)]
    hi = bmax[:, None, :] * r[None]
    wmin = np.minimum(lo, hi).sum(-1) + t[None]
    wmax = np.maximum(lo, hi).sum(-1) + t[None]
    return wmin.astype(np.float32), wmax.astype(np.float32)


def _build_tlas(bmin, bmax):
    """Small recursive SAH-ish (largest-axis median) BVH over instance boxes.

    Returns (nodes, leaf_inst): nodes is a list of dicts
    {bmin,bmax,left,right,inst} in DFS order with -1 for absent links;
    leaves carry inst >= 0. Instance counts are small (the reference caps
    TLAS size by scene design too), so plain recursion is fine.
    """
    n = bmin.shape[0]
    cent = 0.5 * (bmin + bmax)
    nodes = []

    def emit(ids):
        my = len(nodes)
        nodes.append(dict(bmin=bmin[ids].min(0), bmax=bmax[ids].max(0),
                          left=-1, right=-1, inst=-1))
        if ids.shape[0] == 1:
            nodes[my]["inst"] = int(ids[0])
            return my
        c = cent[ids]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = ids[np.argsort(c[:, ax], kind="stable")]
        half = order.shape[0] // 2
        nodes[my]["left"] = emit(order[:half])
        nodes[my]["right"] = emit(order[half:])
        return my

    emit(np.arange(n, dtype=np.int64))
    return nodes


def compose_two_level(entries):
    """Compose per-instance BLASes into one flat world-space BVH2 dict.

    entries: list of (blas_flat_dict, world_mat4, tri_offset) per instance,
    where tri_offset is the instance's first triangle in the flattened world
    triangle arrays (instances concatenated in entry order).

    Returns the same flat dict layout as bvh.builder (DFS order, contiguous
    per-leaf prims), consumable by device_bvh_from_flat.
    """
    n_inst = len(entries)
    assert n_inst >= 1
    # world AABB per instance = transformed BLAS root box
    wmins, wmaxs = [], []
    for blas, mat, _off in entries:
        wmin, wmax = transform_aabbs(blas["nmin"][:1], blas["nmax"][:1], mat)
        wmins.append(wmin[0])
        wmaxs.append(wmax[0])
    tlas = _build_tlas(np.stack(wmins), np.stack(wmaxs))

    total_nodes = sum(e[0]["n_nodes"] for e in entries) + max(
        0, 2 * n_inst - 1) - n_inst
    total_prims = sum(e[0]["n_prims"] for e in entries)
    nmin = np.zeros((max(total_nodes, 1), 3), np.float32)
    nmax = np.zeros_like(nmin)
    left = np.zeros(max(total_nodes, 1), np.int32)
    right = np.full(max(total_nodes, 1), -1, np.int32)
    count = np.zeros(max(total_nodes, 1), np.int32)
    prim = np.zeros(max(total_prims, 1), np.int32)

    idx = [0]          # next node slot
    pslot = [0]        # next prim slot

    def splice_instance(i):
        blas, mat, tri_off = entries[i]
        m = blas["n_nodes"]
        base = idx[0]
        idx[0] += m
        wmin, wmax = transform_aabbs(blas["nmin"], blas["nmax"], mat)
        nmin[base:base + m] = wmin
        nmax[base:base + m] = wmax
        cnt = blas["count"]
        is_leaf = cnt > 0
        count[base:base + m] = cnt
        right[base:base + m] = np.where(is_leaf, -1, blas["right"] + base)
        # leaf 'left' = first prim slot (shifted); interior = child id
        pbase = pslot[0]
        left[base:base + m] = np.where(is_leaf, blas["left"] + pbase,
                                       blas["left"] + base)
        np_ = blas["n_prims"]
        prim[pbase:pbase + np_] = blas["prim"] + tri_off
        pslot[0] += np_
        return base

    def emit(tnode_id, tlas_nodes):
        tn = tlas_nodes[tnode_id]
        if tn["inst"] >= 0:
            return splice_instance(tn["inst"])
        my = idx[0]
        idx[0] += 1
        nmin[my] = tn["bmin"]
        nmax[my] = tn["bmax"]
        count[my] = 0
        l = emit(tn["left"], tlas_nodes)
        r = emit(tn["right"], tlas_nodes)
        left[my] = l
        right[my] = r
        return my

    emit(0, tlas)
    n = idx[0]
    assert pslot[0] == total_prims, (pslot[0], total_prims)
    return dict(
        nmin=nmin[:n], nmax=nmax[:n], left=left[:n], right=right[:n],
        count=count[:n], prim=prim[:total_prims],
        n_nodes=n, n_prims=total_prims,
    )
