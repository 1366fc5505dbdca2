"""The BVH4 of bvh/wide.py: its collapse, its packing and its plain walk.

Both CUDA trace kernels walk this BVH4, and the plain walk (wide_intersect,
wide_occluded) is the version test_torch_trace_card.py holds them against
lane for lane on the card. Here, on the CPU, the plain walk is held against
  - the BVH2 it was collapsed from: every child box is the BVH2 node's box
    bit for bit and every triangle lies in exactly one leaf;
  - the port's BVH2 walk (bvh/traverse.py): t equal on every lane, prim
    equal except on exact t-ties (two triangles at the same t, which the
    two walks may meet in another order), occlusion equal;
  - the JAX package: its lockstep traversal (prim equal, t within rtol 1e-6,
    u and v within 5e-5 for XLA's FMA contraction) and its Pallas kernels in
    interpret mode (prim and occlusion equal, t within rtol 2e-4 for the MXU
    plane forms), the tolerances of tests/test_torch_trace.py.
Scenes: random 300- and 500-triangle soups and the Cornell box.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.bvh.builder import build_sah_bvh_numpy as jbuild
from lighthouse2_tpu.bvh.clusters import PAY_PRIM, cut_clusters
from lighthouse2_tpu.bvh.traverse import (
    bvh_intersect_counts, bvh_occluded as jbvh_occluded,
    device_bvh_from_flat as jdevice_bvh)
from lighthouse2_tpu.render.kernels.trace import trace_cluster_bvh
from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh_numpy
from lighthouse2_tpu_torch.bvh.traverse import (
    bvh_intersect, bvh_occluded, device_bvh_from_flat)
from lighthouse2_tpu_torch.bvh.wide import (
    NODE_WORDS, STACK_CAP, collapse, wide_intersect, wide_occluded)
from lighthouse2_tpu_torch.core.geometry import BIG_T, mt_comp
from lighthouse2_tpu_torch.render.kernels.trace import (
    trace_closest, trace_occluded)
from lighthouse2_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

SCENES = ("rand300", "rand500", "cornell")


def _soup(n_tris, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return tuple(c + rng.uniform(-0.1, 0.1, (n_tris, 3)).astype(np.float32)
                 for _ in range(3))


def _vertices(name):
    if name == "cornell":
        w = tpresets.cornell_box(32, 32)[0].world_arrays()["world"]
        return w["v0"], w["v1"], w["v2"]
    return _soup(int(name[4:]), seed=int(name[4:]))


def _rays(name, n, seed):
    """Rays from around a soup into it, or from inside the Cornell box."""
    rng = np.random.default_rng(seed)
    if name == "cornell":
        o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 2.5], (n, 3))
        d = rng.normal(size=(n, 3))
    else:
        o = rng.uniform(-3, 3, (n, 3))
        d = rng.uniform(-1, 1, (n, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(1.5, 6, n)
    return o.astype(np.float32), d.astype(np.float32), tmax.astype(np.float32)


@pytest.fixture(scope="module", params=SCENES)
def scene(request):
    v0, v1, v2 = _vertices(request.param)
    flat = build_sah_bvh_numpy(v0, v1, v2)
    bvh = device_bvh_from_flat(flat, v0, v1, v2, device="cpu")
    o, d, tmax = _rays(request.param, 1536, seed=3)
    return dict(name=request.param, v=(v0, v1, v2), flat=flat, bvh=bvh,
                o=torch.from_numpy(o), d=torch.from_numpy(d),
                tmax=torch.from_numpy(tmax))


def _records(bvh):
    node = bvh.node4.numpy()
    ints = node.view(np.int32)
    return (node[:, :24].reshape(-1, 6, 4), ints[:, 24:28], ints[:, 28:32])


def test_every_triangle_in_exactly_one_leaf(scene):
    bvh, flat = scene["bvh"], scene["flat"]
    _, codes, cnts = _records(bvh)
    leaf = cnts > 0
    rows = np.concatenate([np.arange(c, c + k) for c, k in
                           zip(codes[leaf], cnts[leaf])])
    n_tris = flat["prim"].shape[0]
    np.testing.assert_array_equal(np.sort(rows), np.arange(n_tris))
    assert cnts.max() <= bvh.max_leaf
    # interior codes name every BVH4 node but the root exactly once
    inner = codes[cnts == 0]
    np.testing.assert_array_equal(np.sort(inner), np.arange(1, len(codes)))
    # the triangle rows are the BVH2 prims in slot order, ids as int bits
    tri4 = bvh.tri4.numpy().reshape(n_tris, 3, 4)
    np.testing.assert_array_equal(tri4[:, 0, 3].view(np.int32), flat["prim"])
    want = bvh.tri9.numpy()[:, flat["prim"]].T.reshape(n_tris, 3, 3)
    np.testing.assert_array_equal(tri4[:, :, :3].view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(tri4[:, 1:, 3], 0.0)


def test_child_boxes_are_the_bvh2_boxes(scene):
    """Bit for bit, one 128-byte record per node, empty slots masked by
    count -1 with a zero box."""
    bvh, flat = scene["bvh"], scene["flat"]
    assert bvh.node4.shape[1] == NODE_WORDS
    assert bvh.node4.element_size() * NODE_WORDS == 128
    assert bvh.tri4.element_size() * bvh.tri4.shape[1] == 48
    box, _, cnts = _records(bvh)
    nodes, slots, depth4 = collapse(flat["left"], flat["right"],
                                    flat["count"])
    assert depth4 == bvh.depth4 and nodes[0] == 0
    assert bvh.depth4 <= (bvh.depth + 2) // 2 and bvh.depth4 >= 1
    nbox = bvh.nbox.numpy()
    full = slots >= 0
    np.testing.assert_array_equal(full, cnts >= 0)
    got = box.transpose(1, 0, 2)[:, full]
    np.testing.assert_array_equal(got.view(np.int32),
                                  nbox[:, slots[full]].view(np.int32))
    np.testing.assert_array_equal(box.transpose(1, 0, 2)[:, ~full], 0.0)
    assert (full.sum(1) >= 2).all() or len(full) == 1
    # every BVH2 interior node is a BVH4 node or a child of one whose own
    # children were lifted into it, never both
    interior = np.flatnonzero(flat["count"] == 0)
    kids = np.concatenate([flat["left"][nodes], flat["right"][nodes]])
    lifted = kids[flat["count"][kids] == 0]
    np.testing.assert_array_equal(np.sort(np.concatenate([nodes, lifted])),
                                  interior)


def test_walk_matches_bvh2_closest(scene):
    o, d, tmax, bvh = scene["o"], scene["d"], scene["tmax"], scene["bvh"]
    t, p, u, v, st = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
    t2, p2, u2, v2, st2 = bvh_intersect(o, d, bvh, t_max=tmax, stats=True)
    np.testing.assert_array_equal(t.numpy(), t2.numpy())
    assert (p2 >= 0).sum() > 100
    same = p == p2
    tie = ~same
    assert tie.float().mean() < 0.01
    if tie.any():
        # the two walks met two triangles at exactly the same t
        assert (p[tie] >= 0).all() and (p2[tie] >= 0).all()
        g = bvh.tri9[:, p2[tie]]
        ot, dt = o[tie], d[tie]
        t_other, *_, h = mt_comp(*ot.T, *dt.T, *g, 1e-6, BIG_T)
        assert h.all() and torch.equal(t_other, t[tie])
    assert torch.equal(u[same], u2[same]) and torch.equal(v[same], v2[same])
    # fewer, wider steps; the same triangle tests up to the pruning order
    assert st[0].float().mean() < st2[0].float().mean()
    assert (st[1] >= 0).all() and (st[2] >= 0).all()


def test_walk_matches_bvh2_occluded(scene):
    o, d, tmax, bvh = scene["o"], scene["d"], scene["tmax"], scene["bvh"]
    occ, st = wide_occluded(o, d, tmax, bvh, stats=True)
    want = bvh_occluded(o, d, tmax, bvh)
    np.testing.assert_array_equal(occ.numpy(), want.numpy())
    assert 0 < want.sum() < want.numel()
    _, p, _, _ = wide_intersect(o, d, bvh, t_max=tmax)
    np.testing.assert_array_equal(occ.numpy(), (p >= 0).numpy())
    # without a hit nothing is pruned: both walks visit the same items
    _, _, _, _, stc = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
    assert torch.equal(st[:, ~occ], stc[:, ~occ])


def test_wrappers_take_the_wide_walk_on_the_cpu(scene):
    o, d, tmax, bvh = scene["o"], scene["d"], scene["tmax"], scene["bvh"]
    got = trace_closest(o, d, tmax, bvh, stats=True)
    want = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ, st = trace_occluded(o, d, tmax, bvh, stats=True)
    wocc, wst = wide_occluded(o, d, tmax, bvh, stats=True)
    assert torch.equal(occ, wocc) and torch.equal(st, wst)


def _lockstep_inputs(name):
    """The soup, rays and tmax of tests/test_torch_trace.py's lockstep test
    (500 triangles, seed 0; rays seed 1; tmax seed 6), or Cornell rays."""
    if name == "cornell":
        return _vertices(name), _rays(name, 1024, seed=6)
    rng = np.random.default_rng(1)
    o = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (2048, 3)).astype(np.float32) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.random.default_rng(6).uniform(0.5, 4, 2048).astype(np.float32)
    return _soup(500, seed=0), (o, d, tmax)


@pytest.mark.parametrize("name", ["rand500", "cornell"])
def test_walk_matches_jax_lockstep(name):
    """prim equal (except the Cornell quads' t-ties), u and v within 5e-5
    and t within rtol 1e-6: XLA's CPU backend contracts multiply-adds into
    FMAs and torch does not, and 1/det amplifies that last-bit difference on
    grazing hits. On the Cornell rays one lane in a thousand grazes enough
    to leave rtol 1e-6; there t is held to rtol 1e-6 on >= 99.9% of lanes
    and to 1e-5 on all."""
    (v0, v1, v2), (o, d, tmax) = _lockstep_inputs(name)
    flat = build_sah_bvh_numpy(v0, v1, v2)
    bvh = device_bvh_from_flat(flat, v0, v1, v2, device="cpu")
    jbvh = jdevice_bvh(flat, v0, v1, v2)
    jt, jp, ju, jv, _ = bvh_intersect_counts(jnp.asarray(o), jnp.asarray(d),
                                             jbvh, t_max=jnp.asarray(tmax))
    to, td, tt = (torch.from_numpy(a) for a in (o, d, tmax))
    t, p, u, v = wide_intersect(to, td, bvh, t_max=tt)
    jp, jt = np.asarray(jp), np.asarray(jt)
    if name == "cornell":
        rel = np.abs(t.numpy() - jt) / jt
        assert (rel <= 1e-6).mean() >= 0.999 and rel.max() <= 1e-5
    else:
        np.testing.assert_allclose(t.numpy(), jt, rtol=1e-6)
    same = p.numpy() == jp
    if name != "cornell":
        assert same.all()
    assert same.mean() > 0.99 and (jp >= 0).sum() > 100
    np.testing.assert_allclose(u.numpy()[same], np.asarray(ju)[same],
                               atol=5e-5)
    np.testing.assert_allclose(v.numpy()[same], np.asarray(jv)[same],
                               atol=5e-5)
    occ = wide_occluded(to, td, tt, bvh).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jbvh_occluded(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tmax), jbvh)))


@pytest.mark.parametrize("anyhit", [False, True])
def test_walk_matches_pallas_interpret(anyhit):
    v0, v1, v2 = _soup(300, seed=8)
    cb = cut_clusters(jbuild(v0, v1, v2), dict(v0=v0, v1=v1, v2=v2))
    bvh = device_bvh_from_flat(build_sah_bvh_numpy(v0, v1, v2), v0, v1, v2,
                               device="cpu")
    o, d, tmax = _rays("rand300", 1024, seed=9)
    to, td, tt = (torch.from_numpy(a) for a in (o, d, tmax))
    if anyhit:
        want = np.asarray(trace_cluster_bvh(
            jnp.asarray(o), jnp.asarray(d), cb, jnp.asarray(tmax),
            anyhit=True, interpret=True))
        np.testing.assert_array_equal(wide_occluded(to, td, tt, bvh).numpy(),
                                      want)
        assert 0 < want.sum() < want.size
        return
    jt, payload = trace_cluster_bvh(jnp.asarray(o), jnp.asarray(d), cb, BIG_T,
                                    interpret=True)
    jp = np.asarray(payload[PAY_PRIM])
    jp = np.where(jp >= 0, jp.astype(np.int64), -1)
    t, p, _, _ = wide_intersect(to, td, bvh)
    np.testing.assert_array_equal(p.numpy(), jp)
    hit = jp >= 0
    assert hit.sum() > 200
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit], rtol=2e-4)


def test_dead_lanes_miss(scene):
    o, d, bvh = scene["o"], scene["d"], scene["bvh"]
    tmax = torch.where(torch.arange(o.shape[0]) % 2 == 0, BIG_T, 0.0)
    tmax[1::4] = -1.0
    t, p, u, v, st = wide_intersect(o, d, bvh, t_max=tmax, stats=True)
    assert (p[1::2] == -1).all() and (p[0::2] >= 0).any()
    assert torch.equal(t[1::2], tmax[1::2])
    assert (u[1::2] == 0).all() and (v[1::2] == 0).all()
    # a dead lane visits the root once, prunes it and stops
    assert (st[0, 1::2] == 1).all() and (st[1:, 1::2] == 0).all()
    occ, ost = wide_occluded(o, d, tmax, bvh, stats=True)
    assert not occ[1::2].any() and occ[0::2].any()
    assert (ost[0, 1::2] == 1).all()


def _comb(depth):
    """A BVH2 whose right spine is `depth` interior nodes long."""
    rng = np.random.default_rng(7)
    n = depth + 1
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1, v2 = v0 + 0.1, v0 + np.float32([0.1, -0.1, 0.0])
    m = 2 * depth + 1
    left = np.zeros(m, np.int32)
    right = np.full(m, -1, np.int32)
    count = np.ones(m, np.int32)
    for i in range(depth):
        left[2 * i], right[2 * i], count[2 * i] = 2 * i + 1, 2 * i + 2, 0
        left[2 * i + 1] = i
    left[2 * depth] = depth
    flat = dict(nmin=np.full((m, 3), -2, np.float32),
                nmax=np.full((m, 3), 2, np.float32), left=left, right=right,
                count=count, prim=np.arange(n, dtype=np.int32))
    return flat, device_bvh_from_flat(flat, v0, v1, v2, device="cpu")


def test_depth_check_on_a_comb():
    """A comb of BVH2 depth 2k collapses to BVH4 depth k; the walk refuses
    a BVH4 whose worst stack (3 * depth4 + 1) exceeds STACK_CAP, and agrees
    with the BVH2 walk on the deepest comb it takes."""
    o, d, _ = _rays("rand300", 256, seed=10)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    limit = (STACK_CAP - 1) // 3
    flat, ok = _comb(2 * limit)
    assert ok.depth4 == limit and ok.depth == 2 * limit
    t, p, _, _ = wide_intersect(o, d, ok)
    t2, p2, _, _ = bvh_intersect(o, d, ok)
    assert torch.equal(t, t2) and torch.equal(p, p2) and (p >= 0).any()
    assert torch.equal(wide_occluded(o, d, BIG_T, ok), p >= 0)
    _, deep = _comb(2 * limit + 1)
    assert deep.depth4 == limit + 1
    with pytest.raises(ValueError, match="depth"):
        wide_intersect(o, d, deep)
    with pytest.raises(ValueError, match="depth"):
        wide_occluded(o, d, BIG_T, deep)


@pytest.mark.parametrize("n_tris", [1, 3, 4])
def test_root_leaf_and_empty_slots(n_tris):
    """A BVH2 whose root is a leaf packs into one node with one leaf child
    and three empty slots. Rays from the origin meet the empty slots' zero
    boxes on their faces; the count mask keeps them out of the walk."""
    v0, v1, v2 = _soup(n_tris, seed=11)
    flat = build_sah_bvh_numpy(v0, v1, v2)
    bvh = device_bvh_from_flat(flat, v0, v1, v2, device="cpu")
    _, codes, cnts = _records(bvh)
    assert bvh.node4.shape[0] == 1 and bvh.depth4 == 1
    np.testing.assert_array_equal(cnts[0], [n_tris, -1, -1, -1])
    o, d, _ = _rays("rand300", 512, seed=12)
    o = np.zeros_like(o)
    o[::2] = _rays("rand300", 256, seed=13)[0]
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, p, _, _, st = wide_intersect(to, td, bvh, stats=True)
    t2, p2, _, _ = bvh_intersect(to, td, bvh)
    assert torch.equal(t, t2) and torch.equal(p, p2)
    assert (st[0] <= 2).all() and (st[1] == 1).all()
    assert (st[2] <= n_tris).all()
