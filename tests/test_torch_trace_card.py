"""The trace kernels on the card against their plain versions, every lane.

On the bathroom at 512x512, path 16, regen (the main path), for the three
batches of card_support.trace_batches (the 512x512 primary rays,
the bounce-1 rays of one shade_bounce and that bounce's NEE shadow rays):

- csrc/trace.cu's two kernels on the default tree against their plain
  version, bvh/wide.py's BVH4 walk (t, prim, u, v, occlusion and the
  per-ray counts equal on every lane), and against bvh/traverse.py's BVH2
  walk (prim and occlusion on >= AGREE_MIN of the lanes);
- csrc/cluster_trace.cu's two kernels on the tree synced with its cluster
  tiles, in the executor's ray order (card_support.cluster_batches),
  against their plain versions (the kernels' forms are 3xTF32 tensor-core
  products, the plain versions' FP32 terms: code and occlusion equal on >=
  AGREE_MIN of the lanes, t's mean relative error on the agreeing hits <=
  T_MEAN_REL_MAX, the per-block visit and sub-packet counters equal on >=
  COUNTERS_MIN of the live blocks; the plain walk takes 2-13 s a batch)
  and against the BVH4 kernels (prim and occlusion on >= AGREE_MIN);
- the same cluster gates on a tiles_per_cluster 2 cut of the tree, the
  first TPC2_BLOCKS blocks of each batch: the kernels' path for clusters
  of several tiles, which the bathroom's own cut never takes;
- both cluster kernels hold two CTAs (1024-ray blocks) an SM.

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import dataclasses

import pytest
import torch

from card_support import bathroom, card  # noqa: F401 (fixtures)
from card_support import MAIN, cluster_batches, trace_batches

BATCHES = ("primary", "bounce1", "shadow")
AGREE_MIN = 0.9999         # share of lanes that must agree
# t's mean relative error on the lanes whose cluster hit agrees (3xTF32
# keeps ~21 of FP32's 24 bits a product), and the share of live blocks
# whose visit and sub-packet counters must be equal (a last-bit difference
# in a best t can move a sub-packet mark)
T_MEAN_REL_MAX = 1e-6
COUNTERS_MIN = 0.999
TPC2_BLOCKS = 32           # 1024-ray blocks a batch of the tpc-2 cut

eq = lambda a, b: (a == b).float().mean().item()


@pytest.fixture(scope="module")
def bvh4(bathroom, card):
    host, cam = bathroom
    scene = host.sync(card)
    return scene, trace_batches(scene, cam.get_view(card), MAIN, card)


@pytest.fixture(scope="module")
def clusters(bathroom, card):
    host, cam = bathroom
    scene, view = host.sync(card, clusters=True), cam.get_view(card)
    return host, scene, view, cluster_batches(scene, view, MAIN, card)


@pytest.fixture(scope="module")
def tpc2(clusters, card):
    """The tree of `clusters` cut with tiles_per_cluster 2, and the first
    TPC2_BLOCKS blocks of each batch's ray tile on it: (tree, {batch:
    tile})."""
    from lighthouse2_tpu_torch.bvh.clusters import cut_clusters
    from lighthouse2_tpu_torch.render.kernels.cluster import BLOCK
    host, scene, view, _ = clusters
    a = host.world_arrays(True, True, True)
    w, tr = a["world"], a["tris"]
    cb = cut_clusters(a["bvh"], dict(w, ltri=tr["ltri"], lod=tr["lod"],
                                     tangent=tr["tangent"],
                                     bitangent=tr["bitangent"]),
                      min_tpc=2, device=card)
    sc = dataclasses.replace(scene, cbvh=cb)
    return cb, {name: b[3][:, :TPC2_BLOCKS * BLOCK].contiguous()
                for name, b in cluster_batches(sc, view, MAIN, card).items()}


@pytest.mark.card
@pytest.mark.parametrize("batch", BATCHES)
def test_bvh4_kernels_equal_their_plain_walk(bvh4, batch):
    from lighthouse2_tpu_torch.bvh.traverse import bvh_intersect, bvh_occluded
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    scene, batches = bvh4
    o, d, tmax = batches[batch]
    bvh = scene.bvh
    got = trace_closest(o, d, tmax, bvh, stats=True)
    want = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
    ko, kost = trace_occluded(o, d, tmax, bvh, stats=True)
    wo, wost = wide_occluded(o, d, tmax, bvh, stats=True)
    for name, g, w in zip(("t", "prim", "u", "v", "counts"), got, want):
        assert (g == w).all(), name
    assert (ko == wo).all() and (kost == wost).all(), "occluded"
    # against the BVH2 walk: the same hits up to exact t-ties
    bp = bvh_intersect(o, d, bvh, t_max=tmax)[1]
    bo = bvh_occluded(o, d, tmax, bvh)
    assert eq(got[1], bp) >= AGREE_MIN and eq(ko, bo) >= AGREE_MIN, (
        eq(got[1], bp), eq(ko, bo))


def _kernel_gates(x, cb):
    """Both cluster kernels against their plain versions on the ray tile
    x, every lane; returns the closest kernel's code and the occlusion."""
    from lighthouse2_tpu_torch.render.kernels.cluster import (
        BLOCK, cluster_closest, cluster_closest_plain, cluster_occluded,
        cluster_occluded_plain)
    code, t, visits, subs = cluster_closest(x, cb)
    occ = cluster_occluded(x, cb)
    pc = cluster_closest_plain(x, cb)
    po = cluster_occluded_plain(x, cb)
    live = (x[7].reshape(-1, BLOCK) > 0).any(-1)
    same = code == pc[0]
    rel = ((t - pc[1]).abs() / pc[1].abs())[same & (code >= 0)]
    got = dict(code=same.float().mean().item(), occ=eq(occ, po),
               t=rel.mean().item() if rel.numel() else 0.0,
               visits=eq(visits[live], pc[2][live]),
               subs=eq(subs[live], pc[3][live]))
    assert (got["code"] >= AGREE_MIN and got["occ"] >= AGREE_MIN
            and got["t"] <= T_MEAN_REL_MAX
            and got["visits"] >= COUNTERS_MIN
            and got["subs"] >= COUNTERS_MIN), got
    return code, occ


@pytest.mark.card
@pytest.mark.parametrize("batch", BATCHES)
def test_cluster_kernels_match_their_plain_walk_and_the_bvh4(clusters,
                                                             batch):
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    _, scene, _, batches = clusters
    o, d, tmax, x, inv = batches[batch]
    cb, n = scene.cbvh, o.shape[0]
    code, occ = _kernel_gates(x, cb)
    unperm = lambda a: a[:n] if inv is None else a[:n][inv]
    prim = unperm(torch.where(code >= 0, cb.prim.reshape(-1)[
        code.clamp(min=0).to(torch.int64)], -1))
    prim_eq = eq(prim, trace_closest(o, d, tmax, scene.bvh)[1])
    occ_eq = eq(unperm(occ), trace_occluded(o, d, tmax, scene.bvh))
    assert prim_eq >= AGREE_MIN and occ_eq >= AGREE_MIN, (prim_eq, occ_eq)


@pytest.mark.card
@pytest.mark.parametrize("batch", BATCHES)
def test_cluster_kernels_on_two_tiles_a_cluster(tpc2, batch):
    cb, tiles = tpc2
    assert cb.tiles_per_cluster >= 2
    _kernel_gates(tiles[batch], cb)


@pytest.mark.card
def test_cluster_kernels_hold_two_blocks_an_sm(card):
    from lighthouse2_tpu_torch.render.kernels.cluster import ctas_per_sm
    occ = dict(closest=ctas_per_sm(False), occluded=ctas_per_sm(True))
    assert min(occ.values()) >= 2, occ
