"""ClusterBVH: the cluster-tile acceleration structure of the JAX package.

Counterpart of lighthouse2_tpu/bvh/clusters.py (the PAY_* / BLK_* layout,
ClusterBVH, _default_tri_aux, build_cluster_bvh, _plane_forms,
rebake_geometry, cut_clusters). The host code is a copy of the JAX
package's numpy code; rebake_geometry is torch.

A ClusterBVH re-cuts a flattened SAH BVH2 (bvh/builder.py layout) into
  - a small top tree above the cluster roots: `boxes` [8, M] f32 (bmin.xyz,
    bmax.xyz, two pad rows) and `meta` [4, M] int32 (row 0 the DFS skip
    link, 1 the leaf's cluster id or -1, 2 the right child or -1 (the left
    child is always id + 1), 3 the split axis that orders the children);
  - clusters of at most 128 * tiles_per_cluster triangles (whole SAH
    subtrees), stored as 128-triangle tiles twice: `bmat` [CT, 8, 768], six
    plane + barycentric linear forms per triangle (t = (d0 - O.N) / (D.N),
    u = Gu.P + cu, v = Gv.P + cv), and `pgeo` [CT, 40, 128], the shading
    payload rows (PAY_*).
render/kernels/cluster.py traces it: csrc/cluster_trace.cu on a card, the
plain walks of that module on the CPU.

Differences from the JAX package:
  - ClusterBVH also holds `prim` [CT, 128] int32, each tile lane's triangle
    id (-1 on padding). The f32 PAY_PRIM row is kept for the layout, but it
    is exact only below 2^24 triangles; the port reads triangle ids from
    this int table;
  - cut_clusters takes `min_tpc` as an argument only (the JAX sync reads
    LH2_MIN_TPC from the environment) and uploads to `device` (the card by
    default, device.resolve_device);
  - build_cluster_bvh takes `native` (the JAX package picks the native
    builder unless LH2_NO_NATIVE is set).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lighthouse2_tpu_torch.device import resolve_device

CLUSTER_LANES = 128
MAX_TOP_NODES = 4096      # top-tree budget (the TPU kernel's SMEM)

# bmat column blocks (each CLUSTER_LANES wide): the six linear forms
BLK_TN, BLK_DN, BLK_OU, BLK_DU, BLK_OV, BLK_DV = range(6)
BMAT_COLS = 6 * CLUSTER_LANES

# geometry payload rows (host-baked)
PAY_V0 = 0          # 0:9  v0, e1, e2
PAY_E1 = 3
PAY_E2 = 6
PAY_N0 = 9          # 9:18 vertex normals
PAY_N1 = 12
PAY_N2 = 15
PAY_UV0 = 18        # 18:24 uv0, uv1, uv2
PAY_UV1 = 20
PAY_UV2 = 22
PAY_ALPHA = 24      # 24:27 consistent-normal alphas
PAY_PRIM = 27       # triangle id as f32 (-1 = padding)
PAY_MAT = 28        # material id as f32
PAY_LTRI = 29       # area-light slot as f32 (-1 = none)
PAY_LOD = 30        # texture LOD base
PAY_VALID = 31      # 1.0 real, 0.0 padding
PAY_TAN = 32        # 32:35 uv tangent
PAY_BIT = 35        # 35:38 uv bitangent
PAY_GEO_ROWS = 40   # 38:40 pad

# material payload rows (baked on the device each pass from
# render/shading.py material_pack)
PAY_MAT_ROWS = 32
PAY_ROWS = PAY_GEO_ROWS + PAY_MAT_ROWS   # 72


@dataclasses.dataclass
class ClusterBVH:
    boxes: torch.Tensor    # [8, M] f32: bmin.xyz, bmax.xyz, pad, pad
    meta: torch.Tensor     # [4, M] int32: skip, cluster id, right, axis
    bmat: torch.Tensor     # [CT, 8, 768] f32 plane + barycentric forms
    pgeo: torch.Tensor     # [CT, 40, 128] f32 geometry payload
    prim: torch.Tensor     # [CT, 128] int32 triangle ids (-1 = padding)
    n_nodes: int = 0
    n_clusters: int = 0
    tiles_per_cluster: int = 1
    n_prims: int = 0
    max_depth: int = 64

    @property
    def device(self) -> torch.device:
        return self.bmat.device


def _default_tri_aux(v0):
    """Fill optional attribute arrays with neutral values."""
    t = v0.shape[0]
    z3 = np.zeros((t, 3), np.float32)
    z2 = np.zeros((t, 2), np.float32)
    return dict(n0=z3, n1=z3, n2=z3, uv0=z2, uv1=z2, uv2=z2,
                alpha=np.ones((t, 3), np.float32),
                mat=np.zeros((t,), np.int32),
                ltri=np.full((t,), -1, np.int32),
                lod=np.zeros((t,), np.float32),
                tangent=z3, bitangent=z3)


def build_cluster_bvh(v0, v1, v2, tri: dict | None = None, max_leaf: int = 4,
                      max_top_nodes: int = MAX_TOP_NODES, native: bool = True,
                      device=None) -> ClusterBVH:
    """The cluster structure over triangles [T,3]: an SAH BVH2, cut.
    `tri` optionally carries the shading attributes (n0/n1/n2, uv0/uv1/uv2,
    alpha, mat, ltri, lod, tangent, bitangent); missing keys get neutral
    defaults."""
    from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    flat = build_sah_bvh(v0, v1, v2, max_leaf=max_leaf,
                         prefer_native=native)
    tri = dict(tri or {})
    tri.setdefault("v0", v0)
    tri.setdefault("v1", v1)
    tri.setdefault("v2", v2)
    return cut_clusters(flat, tri, max_top_nodes=max_top_nodes,
                        device=device)


def _plane_forms(v0, v1, v2):
    """Per-triangle plane + barycentric linear forms, computed in f64.
    Returns (N, d0, Gu, cu, Gv, cv); degenerate triangles get N=0, d0=-1
    so the kernel's t = (d0 - O.N)/(D.N) = -1/0 never hits."""
    v0 = v0.astype(np.float64)
    e1 = v1.astype(np.float64) - v0
    e2 = v2.astype(np.float64) - v0
    n = np.cross(e1, e2)
    nn = (n * n).sum(-1)
    bad = nn < 1e-24
    nn_safe = np.where(bad, 1.0, nn)
    gu = np.cross(e2, n) / nn_safe[:, None]
    gv = np.cross(n, e1) / nn_safe[:, None]
    d0 = (n * v0).sum(-1)
    cu = -(gu * v0).sum(-1)
    cv = -(gv * v0).sum(-1)
    n = np.where(bad[:, None], 0.0, n)
    d0 = np.where(bad, -1.0, d0)
    gu = np.where(bad[:, None], 0.0, gu)
    gv = np.where(bad[:, None], 0.0, gv)
    cu = np.where(bad, -1.0, cu)
    cv = np.where(bad, -1.0, cv)
    return (x.astype(np.float32) for x in (n, d0, gu, cu, gv, cv))


def _cross1(a, b):
    """Cross product along dim 1 of [CT, 3, L] tensors."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def rebake_geometry(cb: ClusterBVH, tri9) -> ClusterBVH:
    """Refresh the tiles' triangle geometry from a live [9, T] tri9: payload
    rows 0..8 and the bmat plane forms, so the kernels test displaced
    vertices as the gather path does. The top-tree boxes stay as they are
    (the reparameterisation detachment). The caller detaches the result;
    gradients re-attach per ray (render/fetch.py)."""
    L = CLUSTER_LANES
    valid = cb.prim >= 0                                    # [CT, 128]
    ids = torch.where(valid, cb.prim, 0).to(torch.int64)
    ct = ids.shape[0]
    rows9 = tri9[:, ids.reshape(-1)].reshape(9, ct, L).transpose(0, 1)
    rows9 = torch.where(valid[:, None, :], rows9, 0.0)      # [CT, 9, 128]
    pgeo = cb.pgeo.clone()
    pgeo[:, 0:9, :] = torch.where(valid[:, None, :], rows9, cb.pgeo[:, 0:9])

    v0, e1, e2 = rows9[:, 0:3], rows9[:, 3:6], rows9[:, 6:9]
    n = _cross1(e1, e2)
    nn = (n * n).sum(1, keepdim=True)
    bad = (nn < 1e-24) | ~valid[:, None, :]
    nn_safe = torch.where(bad, 1.0, nn)
    gu = _cross1(e2, n) / nn_safe
    gv = _cross1(n, e1) / nn_safe
    d0 = (n * v0).sum(1, keepdim=True)
    cu = -(gu * v0).sum(1, keepdim=True)
    cv = -(gv * v0).sum(1, keepdim=True)
    n = torch.where(bad, 0.0, n)
    d0 = torch.where(bad, -1.0, d0)
    gu = torch.where(bad, 0.0, gu)
    gv = torch.where(bad, 0.0, gv)
    cu = torch.where(bad, -1.0, cu)
    cv = torch.where(bad, -1.0, cv)

    bmat = cb.bmat.clone()

    def blk(b):
        return slice(b * L, (b + 1) * L)

    bmat[:, 0:3, blk(BLK_TN)] = -n
    bmat[:, 6:7, blk(BLK_TN)] = d0
    bmat[:, 3:6, blk(BLK_DN)] = n
    bmat[:, 0:3, blk(BLK_OU)] = gu
    bmat[:, 6:7, blk(BLK_OU)] = cu
    bmat[:, 3:6, blk(BLK_DU)] = gu
    bmat[:, 0:3, blk(BLK_OV)] = gv
    bmat[:, 6:7, blk(BLK_OV)] = cv
    bmat[:, 3:6, blk(BLK_DV)] = gv
    return dataclasses.replace(cb, pgeo=pgeo, bmat=bmat)


def cut_clusters(flat: dict, tri: dict, max_top_nodes: int = MAX_TOP_NODES,
                 min_tpc: int = 1, device=None) -> ClusterBVH:
    """Re-cut a flattened SAH BVH2 (builder.py layout) into the cluster
    structure on `device`. Subtree prims are contiguous in flat['prim'] (DFS
    leaf order), so a cluster is a (first, count) range of that array.
    `min_tpc` forces a larger tiles_per_cluster."""
    dev = resolve_device(device)
    v0 = np.asarray(tri["v0"], np.float32)
    v1 = np.asarray(tri["v1"], np.float32)
    v2 = np.asarray(tri["v2"], np.float32)
    aux = _default_tri_aux(v0)
    for k in aux:
        if tri.get(k) is not None:
            aux[k] = np.asarray(tri[k])

    nmin, nmax = flat["nmin"], flat["nmax"]
    left = flat["left"].astype(np.int64)
    right = flat["right"].astype(np.int64)
    count = flat["count"].astype(np.int64)
    prim = flat["prim"].astype(np.int64)
    n = nmin.shape[0]
    is_leaf = count > 0

    # subtree prim counts + first prim slot (children have larger DFS ids)
    sub_cnt = count.copy()
    sub_first = np.where(is_leaf, left, 0)
    for i in range(n - 1, -1, -1):
        if not is_leaf[i]:
            sub_cnt[i] = sub_cnt[left[i]] + sub_cnt[right[i]]
            sub_first[i] = sub_first[left[i]]

    # smallest tiles_per_cluster whose pruned top tree fits the budget
    tpc = max(1, int(min_tpc))
    while True:
        k = CLUSTER_LANES * tpc
        kept = 1
        stack = [0]
        while stack:
            node = stack.pop()
            if sub_cnt[node] > k and not is_leaf[node]:
                kept += 2
                stack.append(int(left[node]))
                stack.append(int(right[node]))
        if kept <= max_top_nodes or tpc >= 64:
            break
        tpc *= 2
    if kept > max_top_nodes:
        raise ValueError(
            f"scene too large for the top tree: {kept} nodes at "
            f"tiles_per_cluster={tpc}")

    # iterative DFS emit: skip links (row 0), right child + split axis
    # (rows 2-3) for the near-child-first stack walk
    boxes = np.zeros((kept, 8), np.float32)
    meta = np.zeros((kept, 4), np.int32)
    meta[:, 2] = -1
    clusters = []
    idx = 0
    max_depth = 1
    stack = [("visit", 0, -1, 0)]
    while stack:
        kind, node, parent_idx, depth = stack.pop()
        if kind == "close":
            meta[node, 0] = idx          # here node is the emit idx
            continue
        my_idx = idx
        idx += 1
        max_depth = max(max_depth, depth + 1)
        if parent_idx >= 0:              # I am the right child of parent_idx
            meta[parent_idx, 2] = my_idx
        boxes[my_idx, 0:3] = nmin[node]
        boxes[my_idx, 3:6] = nmax[node]
        if sub_cnt[node] <= CLUSTER_LANES * tpc or is_leaf[node]:
            cid = len(clusters)
            clusters.append((int(sub_first[node]), int(sub_cnt[node])))
            meta[my_idx, 1] = cid
            meta[my_idx, 0] = my_idx + 1
        else:
            meta[my_idx, 1] = -1
            l, r = int(left[node]), int(right[node])
            # split axis = largest |child-centre delta|: the direction sign
            # along it decides which child is nearer for a ray packet
            cl = 0.5 * (nmin[l] + nmax[l])
            cr2 = 0.5 * (nmin[r] + nmax[r])
            meta[my_idx, 3] = int(np.argmax(np.abs(cr2 - cl)))
            stack.append(("close", my_idx, -1, 0))
            stack.append(("visit", r, my_idx, depth + 1))
            stack.append(("visit", l, -1, depth + 1))
    assert idx == kept, (idx, kept)

    c = len(clusters)
    N, d0, Gu, cu, Gv, cv = _plane_forms(v0, v1, v2)
    e1 = v1 - v0
    e2 = v2 - v0

    bmat = np.zeros((c * tpc, 8, BMAT_COLS), np.float32)
    # padding lanes: all-zero coefficients except TN const = -1 -> t = -inf
    bmat[:, 6, BLK_TN * CLUSTER_LANES:(BLK_TN + 1) * CLUSTER_LANES] = -1.0
    pgeo = np.zeros((c * tpc, PAY_GEO_ROWS, CLUSTER_LANES), np.float32)
    pgeo[:, PAY_PRIM, :] = -1.0
    pgeo[:, PAY_LTRI, :] = -1.0
    tile_prim = np.full((c * tpc, CLUSTER_LANES), -1, np.int32)

    def put_blk(t, blk, rows, data, m):
        bmat[t, rows, blk * CLUSTER_LANES:blk * CLUSTER_LANES + m] = data

    for cid, (first, cnt) in enumerate(clusters):
        ids = prim[first:first + cnt]
        for j in range(tpc):
            seg = ids[j * CLUSTER_LANES:(j + 1) * CLUSTER_LANES]
            m = len(seg)
            if m == 0:
                break
            t = cid * tpc + j
            # intersection forms: out = bmat^T . [o; d; 1; 0]
            put_blk(t, BLK_TN, slice(0, 3), -N[seg].T, m)
            put_blk(t, BLK_TN, 6, d0[seg], m)
            put_blk(t, BLK_DN, slice(3, 6), N[seg].T, m)
            put_blk(t, BLK_OU, slice(0, 3), Gu[seg].T, m)
            put_blk(t, BLK_OU, 6, cu[seg], m)
            put_blk(t, BLK_DU, slice(3, 6), Gu[seg].T, m)
            put_blk(t, BLK_OV, slice(0, 3), Gv[seg].T, m)
            put_blk(t, BLK_OV, 6, cv[seg], m)
            put_blk(t, BLK_DV, slice(3, 6), Gv[seg].T, m)
            # geometry payload
            g = pgeo[t]
            g[PAY_V0:PAY_V0 + 3, :m] = v0[seg].T
            g[PAY_E1:PAY_E1 + 3, :m] = e1[seg].T
            g[PAY_E2:PAY_E2 + 3, :m] = e2[seg].T
            g[PAY_N0:PAY_N0 + 3, :m] = aux["n0"][seg].T
            g[PAY_N1:PAY_N1 + 3, :m] = aux["n1"][seg].T
            g[PAY_N2:PAY_N2 + 3, :m] = aux["n2"][seg].T
            g[PAY_UV0:PAY_UV0 + 2, :m] = aux["uv0"][seg].T
            g[PAY_UV1:PAY_UV1 + 2, :m] = aux["uv1"][seg].T
            g[PAY_UV2:PAY_UV2 + 2, :m] = aux["uv2"][seg].T
            g[PAY_ALPHA:PAY_ALPHA + 3, :m] = aux["alpha"][seg].T
            g[PAY_PRIM, :m] = seg.astype(np.float32)
            g[PAY_MAT, :m] = aux["mat"][seg].astype(np.float32)
            g[PAY_LTRI, :m] = aux["ltri"][seg].astype(np.float32)
            g[PAY_LOD, :m] = aux["lod"][seg].astype(np.float32)
            g[PAY_VALID, :m] = 1.0
            g[PAY_TAN:PAY_TAN + 3, :m] = aux["tangent"][seg].T
            g[PAY_BIT:PAY_BIT + 3, :m] = aux["bitangent"][seg].T
            tile_prim[t, :m] = seg

    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return ClusterBVH(
        boxes=up(boxes.T), meta=up(meta.T), bmat=up(bmat), pgeo=up(pgeo),
        prim=up(tile_prim), n_nodes=kept, n_clusters=c,
        tiles_per_cluster=tpc, n_prims=int(v0.shape[0]),
        max_depth=int(max_depth))

