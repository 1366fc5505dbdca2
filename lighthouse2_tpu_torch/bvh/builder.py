"""Binned-SAH BVH2 builder, level-synchronous and vectorized in numpy.

Copy of lighthouse2_tpu/bvh/builder.py (build_sah_bvh, build_sah_bvh_numpy
and its flattening), plus bvh_depth. build_sah_bvh picks the native C++
builder (native/) or the numpy one by its `native` argument; the JAX
package prefers the native one and falls back to numpy silently when it
cannot build it or LH2_NO_NATIVE is set, the port raises instead and reads
no environment. The two builders break ties differently, so they can build
different trees over the same triangles.

Flattened layout (depth-first, left child first):
    nmin, nmax   [N,3] float32   node bounds
    left         [N]   int32     interior: left child id; leaf: first prim
    right        [N]   int32     interior: right child id; leaf: -1
    count        [N]   int32     0 = interior, >0 = leaf primitive count
    prim         [T]   int32     triangle ids, contiguous per leaf
"""
from __future__ import annotations

import numpy as np

_INF = np.float32(np.inf)


def _half_area(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]


def build_sah_bvh(v0, v1, v2, max_leaf=4, bins=8, prefer_native=True) -> dict:
    """Build a BVH2 over triangles (v0, v1, v2 [T,3]); returns the flat
    dict. prefer_native=True: the C++ builder, which raises if it cannot be
    built (JAX's falls back to the numpy builder); False: the numpy
    builder."""
    if prefer_native:
        from lighthouse2_tpu_torch.native import build_sah_bvh_native
        return build_sah_bvh_native(v0, v1, v2, max_leaf=max_leaf, bins=bins)
    return build_sah_bvh_numpy(v0, v1, v2, max_leaf=max_leaf, bins=bins)


def build_sah_bvh_numpy(v0, v1, v2, max_leaf=4, bins=8):
    """Pure-numpy level-synchronous builder (see module docstring)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t_count = v0.shape[0]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    cent = 0.5 * (tmin + tmax)

    cap = 2 * t_count + 2
    nmin = np.zeros((cap, 3), np.float32)
    nmax = np.zeros((cap, 3), np.float32)
    nleft = np.full(cap, -1, np.int64)
    nright = np.full(cap, -1, np.int64)
    nleaf = np.zeros(cap, bool)
    n_nodes = 1

    prim_node = np.zeros(t_count, np.int64)
    node_to_local = np.full(cap, -1, np.int64)
    active = np.array([0], np.int64)

    while active.size:
        a_n = active.size
        node_to_local[:n_nodes] = -1
        node_to_local[active] = np.arange(a_n)
        loc = node_to_local[prim_node]
        sel = loc >= 0
        p_idx = loc[sel]                       # local node index per active prim
        p_tmin, p_tmax, p_cent = tmin[sel], tmax[sel], cent[sel]
        p_global = np.nonzero(sel)[0]

        counts = np.bincount(p_idx, minlength=a_n)
        bbmin = np.full((a_n, 3), _INF)
        bbmax = np.full((a_n, 3), -_INF)
        np.minimum.at(bbmin, p_idx, p_tmin)
        np.maximum.at(bbmax, p_idx, p_tmax)
        cbmin = np.full((a_n, 3), _INF)
        cbmax = np.full((a_n, 3), -_INF)
        np.minimum.at(cbmin, p_idx, p_cent)
        np.maximum.at(cbmax, p_idx, p_cent)
        nmin[active] = bbmin
        nmax[active] = bbmax

        cext = cbmax - cbmin
        # hard leaf cap: traversal unrolls leaf tests max_leaf wide, so any
        # node above the cap MUST split (SAH picks where; median is fallback)
        want_split = counts > max_leaf
        split_loc = np.nonzero(want_split)[0]
        if split_loc.size:
            s_n = split_loc.size
            loc_to_split = np.full(a_n, -1, np.int64)
            loc_to_split[split_loc] = np.arange(s_n)
            sp = loc_to_split[p_idx]           # split-local index per prim, -1 if none
            psel = sp >= 0
            s_prim_idx = sp[psel]
            s_cent = p_cent[psel]
            s_tmin = p_tmin[psel]
            s_tmax = p_tmax[psel]

            ext = np.maximum(cext[split_loc], 1e-12)           # [S,3]
            rel = (s_cent - cbmin[split_loc][s_prim_idx]) / ext[s_prim_idx]
            b = np.minimum((rel * bins).astype(np.int64), bins - 1)  # [P,3]

            # accumulate per (node, axis, bin)
            ravel = (s_prim_idx[:, None] * 3 + np.arange(3)[None]) * bins + b  # [P,3]
            flat = ravel.reshape(-1)
            bc = np.bincount(flat, minlength=s_n * 3 * bins).reshape(s_n, 3, bins)
            bmn = np.full((s_n * 3 * bins, 3), _INF)
            bmx = np.full((s_n * 3 * bins, 3), -_INF)
            rep_tmin = np.repeat(s_tmin, 3, axis=0)
            rep_tmax = np.repeat(s_tmax, 3, axis=0)
            np.minimum.at(bmn, flat, rep_tmin)
            np.maximum.at(bmx, flat, rep_tmax)
            bmn = bmn.reshape(s_n, 3, bins, 3)
            bmx = bmx.reshape(s_n, 3, bins, 3)

            # prefix/suffix sweeps over bins
            lmin = np.minimum.accumulate(bmn, axis=2)
            lmax = np.maximum.accumulate(bmx, axis=2)
            rmin = np.minimum.accumulate(bmn[:, :, ::-1], axis=2)[:, :, ::-1]
            rmax = np.maximum.accumulate(bmx[:, :, ::-1], axis=2)[:, :, ::-1]
            lcnt = np.cumsum(bc, axis=2)
            rcnt = counts[split_loc][:, None, None] - lcnt

            # split after bin k (k = 0..bins-2)
            la = np.where(lcnt[:, :, :-1] > 0, _half_area(lmin, lmax)[:, :, :-1], 0.0)
            ra = np.where(rcnt[:, :, :-1] > 0, _half_area(rmin, rmax)[:, :, 1:], 0.0)
            cost = lcnt[:, :, :-1] * la + rcnt[:, :, :-1] * ra   # SplitCost, bvh.cpp:76-94
            cost = np.where((lcnt[:, :, :-1] == 0) | (rcnt[:, :, :-1] == 0), _INF, cost)
            cost2 = cost.reshape(s_n, -1)
            best = np.argmin(cost2, axis=1)
            best_cost = cost2[np.arange(s_n), best]
            best_axis = best // (bins - 1)
            best_bin = best % (bins - 1)

            # SAH chooses the split plane; a node above the leaf cap always
            # splits (hard cap — see class docstring). Median fallback when
            # every SAH candidate had an empty side (degenerate centroids).
            do_split = np.isfinite(best_cost)
            med_nodes = ~do_split

            goes_left = np.zeros(s_prim_idx.shape[0], bool)
            part_of_split = do_split[s_prim_idx]
            ax = best_axis[s_prim_idx]
            bb = b[np.arange(b.shape[0]), ax]
            goes_left = part_of_split & (bb <= best_bin[s_prim_idx])

            if med_nodes.any():
                # median split along largest centroid axis by per-node rank
                m_ax = np.argmax(ext, axis=1)
                key_ax = m_ax[s_prim_idx]
                pm = med_nodes[s_prim_idx]
                order = np.lexsort(
                    (s_cent[np.arange(s_cent.shape[0]), key_ax], s_prim_idx))
                rank = np.empty_like(order)
                rank[order] = np.arange(order.shape[0])
                start = np.zeros(s_n, np.int64)
                cc = np.bincount(s_prim_idx, minlength=s_n)
                start[1:] = np.cumsum(cc)[:-1]
                within = rank - start[s_prim_idx]
                goes_left = np.where(pm, within < (cc[s_prim_idx] // 2), goes_left)
                do_split = do_split | med_nodes

            # allocate children for splitting nodes
            n_split = int(do_split.sum())
            if n_split:
                split_ids = np.full(s_n, -1, np.int64)
                split_ids[np.nonzero(do_split)[0]] = np.arange(n_split)
                base = n_nodes
                lefts = base + 2 * np.arange(n_split)
                rights = lefts + 1
                gl = active[split_loc[do_split]]
                nleft[gl] = lefts
                nright[gl] = rights
                n_nodes = base + 2 * n_split

                sid = split_ids[s_prim_idx]
                splitting_prims = sid >= 0
                new_nodes = np.where(goes_left, lefts[np.maximum(sid, 0)],
                                     rights[np.maximum(sid, 0)])
                upd = p_global[psel][splitting_prims]
                prim_node[upd] = new_nodes[splitting_prims]
                active = np.concatenate(
                    [np.stack([lefts, rights], 1).reshape(-1)])
            else:
                active = np.array([], np.int64)
        else:
            active = np.array([], np.int64)

    # any node that never received children is a leaf
    nleaf[:n_nodes] = nleft[:n_nodes] < 0

    return _flatten(nmin[:n_nodes], nmax[:n_nodes], nleft[:n_nodes],
                    nright[:n_nodes], nleaf[:n_nodes], prim_node, t_count)


def _flatten(nmin, nmax, nleft, nright, nleaf, prim_node, t_count):
    """DFS re-order (left child first) + contiguous per-leaf prim layout."""
    n = nmin.shape[0]
    new_id = np.full(n, -1, np.int64)
    order = []
    stack = [0]
    while stack:
        nd = stack.pop()
        new_id[nd] = len(order)
        order.append(nd)
        if not nleaf[nd]:
            stack.append(int(nright[nd]))
            stack.append(int(nleft[nd]))
    order = np.asarray(order, np.int64)
    m = order.shape[0]

    o_min = nmin[order]
    o_max = nmax[order]
    o_leaf = nleaf[order]
    o_left = np.where(o_leaf, 0, new_id[np.maximum(nleft[order], 0)]).astype(np.int64)
    o_right = np.where(o_leaf, -1, new_id[np.maximum(nright[order], 0)]).astype(np.int64)

    # prim ordering: sort prims by DFS rank of their leaf
    leaf_rank = new_id[prim_node]
    prim_order = np.argsort(leaf_rank, kind="stable").astype(np.int64)
    sorted_rank = leaf_rank[prim_order]
    # per-leaf first/count
    count = np.zeros(m, np.int64)
    np.add.at(count, sorted_rank, 1)
    first = np.zeros(m, np.int64)
    first[1:] = np.cumsum(count)[:-1]
    o_first = np.where(o_leaf, first, o_left)

    return dict(
        nmin=o_min.astype(np.float32),
        nmax=o_max.astype(np.float32),
        left=o_first.astype(np.int32),
        right=o_right.astype(np.int32),
        count=np.where(o_leaf, count, 0).astype(np.int32),
        prim=prim_order.astype(np.int32),
        n_nodes=m,
        n_prims=t_count,
    )


def bvh_depth(flat: dict) -> int:
    """Largest number of edges from the root to a leaf. A traversal stack
    never holds more entries than this."""
    left, right, count = flat["left"], flat["right"], flat["count"]
    interior = count == 0
    frontier = np.array([0], np.int64)
    depth = -1
    while frontier.size:
        depth += 1
        f = frontier[interior[frontier]]
        frontier = np.concatenate([left[f], right[f]]).astype(np.int64)
    return depth
