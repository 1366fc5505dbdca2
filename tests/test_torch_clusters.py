"""The port's ClusterBVH and cluster-tile trace path against the JAX package.

lighthouse2_tpu_torch/bvh/clusters.py, render/kernels/cluster.py and
render/fetch.py on the CPU, where the kernel wrappers run their plain
versions (chip_smoke.py's [cluster] phase holds the CUDA kernels against
those on the card):
  - cut_clusters and build_cluster_bvh array for array against JAX's, at
    tiles_per_cluster 1 and forced to 2 (min_tpc=2), and the DeviceScene.cbvh
    of a sync asked for it against the JAX default sync's (both cut the
    composed two-level tree of the native builder; the port's default sync
    cuts none);
  - both plain walks against JAX's Pallas kernels in interpret mode
    (trace_cluster_bvh(interpret=True), as tests/test_cluster_kernel.py runs
    them, once for the module) on 2,500 rays (not a multiple of 1024),
    every seventh lane dead: the hit triangle on >= 99.9% of lanes and t
    within rtol 2e-4 (as test_torch_trace.py; JAX evaluates the forms with
    an MXU-precision matrix product, the port term by term), the 72-row
    payload (material rows baked) equal on the agreeing lanes but for row
    31 (t) and rows 38 / 39 (the block counters), occlusion on >= 99.9%;
    at tiles_per_cluster 2 through a ray_sort_perm permutation;
  - the plain closest walk's per-block tile visits and sub-packet
    intersections against JAX's payload rows 38 / 39 on the blocks whose
    hits all agree: both run the Pallas schedule (RING = 4 leaves, two
    a step, the bound refreshed every BM_PERIOD = 8);
  - ray_sort_perm (both keys, dead lanes), bake_material_rows,
    prepare_pay_tiles and rebake_geometry against JAX's: the permutations
    and the baked tiles equal, >= 99.99% of the rebaked form coefficients
    within rtol 1e-5 / atol 1e-6 and all within rtol 1e-3 / atol 1e-4
    (XLA:CPU contracts multiply-adds in its cross products, which thin
    triangles amplify), and
    exactly degenerate triangles rebaked to cut_clusters' never-hit forms
    (where JAX's contracted cross product leaves a rounding residue);
  - reattach_rows' gradient against jax.vjp of JAX's and against the
    gradient of the gather pack[:, idx] it stands for (misses, idx < 0,
    take none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.bvh import clusters as jcl
from lighthouse2_tpu.bvh.builder import build_sah_bvh_numpy as jbuild
from lighthouse2_tpu.render import fetch as jfetch
from lighthouse2_tpu.render.kernels import trace as jtrace
from lighthouse2_tpu.scene import bench_scene as jbench
from lighthouse2_tpu_torch.bvh import clusters as tcl
from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh_numpy
from lighthouse2_tpu_torch.render import fetch as tfetch
from lighthouse2_tpu_torch.render.kernels import cluster as tk
from lighthouse2_tpu_torch.scene import bench_scene as tbench

torch.set_num_threads(1)

BIG_T = 1e30
AGREE = 0.999
ARRAYS = ("boxes", "meta", "bmat", "pgeo")
INTS = ("n_nodes", "n_clusters", "tiles_per_cluster", "n_prims",
        "max_depth")


def _scene(n_tris, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return tuple(c + rng.uniform(-0.1, 0.1, (n_tris, 3)).astype(np.float32)
                 for _ in range(3))


def _attrs(n_tris, n_mats, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-1, 1, (n_tris,) + s).astype(np.float32)
    return dict(n0=f(3), n1=f(3), n2=f(3), uv0=f(2), uv1=f(2), uv2=f(2),
                alpha=f(3), mat=rng.integers(0, n_mats, n_tris).astype(
                    np.int32),
                ltri=rng.integers(-1, 4, n_tris).astype(np.int32),
                lod=f(), tangent=f(3), bitangent=f(3))


def _rays(n, seed=2):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, BIG_T, np.float32)
    tmax[::7] = 0.0
    return o, d, tmax


def _assert_cbvh_equal(t, j):
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(t, f).cpu().numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in INTS:
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(
        t.prim.numpy(), np.asarray(j.pgeo)[:, jcl.PAY_PRIM].astype(np.int32))


@pytest.fixture(scope="module")
def tri_scene():
    v0, v1, v2 = _scene(3000)
    tri = dict(v0=v0, v1=v1, v2=v2, **_attrs(3000, 5))
    flat = jbuild(v0, v1, v2)
    assert all(np.array_equal(a, build_sah_bvh_numpy(v0, v1, v2)[k])
               for k, a in flat.items())
    mpack = np.random.default_rng(3).uniform(0, 1, (28, 5)).astype(
        np.float32)
    out = {}
    for tpc in (1, 2):
        out[tpc] = (jcl.cut_clusters(flat, tri, min_tpc=tpc),
                    tcl.cut_clusters(flat, tri, min_tpc=tpc, device="cpu"))
    return dict(tri=tri, flat=flat, cuts=out, mpack=mpack)


def test_cut_clusters_and_sync_match_jax(tri_scene, monkeypatch):
    for tpc, (j, t) in tri_scene["cuts"].items():
        assert t.tiles_per_cluster == tpc and t.n_clusters >= 16
        _assert_cbvh_equal(t, j)
    v0, v1, v2 = (tri_scene["tri"][k][:700] for k in ("v0", "v1", "v2"))
    monkeypatch.setenv("LH2_NO_NATIVE", "1")
    _assert_cbvh_equal(tcl.build_cluster_bvh(v0, v1, v2, native=False,
                                             device="cpu"),
                       jcl.build_cluster_bvh(v0, v1, v2))
    monkeypatch.delenv("LH2_NO_NATIVE")
    # the default syncs: the composed two-level tree of native BLASes
    jhost, _ = jbench.bathroom(32, 32, detail=0)
    thost, _ = tbench.bathroom(32, 32, detail=0)
    assert thost.sync("cpu").cbvh is None       # cut only when asked for
    jc, tc = jhost.sync().cbvh, thost.sync("cpu", clusters=True).cbvh
    assert tc.n_clusters >= 16
    _assert_cbvh_equal(tc, jc)
    assert thost.sync_seconds["cut"] > 0


def _jax_trace(cb, o, d, tmax, anyhit, **kw):
    return jtrace.trace_cluster_bvh(jnp.asarray(o), jnp.asarray(d), cb,
                                    jnp.asarray(tmax), anyhit=anyhit,
                                    interpret=True, **kw)


@pytest.fixture(scope="module")
def pallas_runs(tri_scene):
    """JAX's interpret-mode Pallas kernels on 2,500 rays for each cut (at
    tiles_per_cluster 2 through a ray_sort_perm permutation): {tpc: dict(
    perm, inv, kw, t, payload, occ)}, computed once for the tests below."""
    o, d, tmax = _rays(2500)
    mpack = tri_scene["mpack"]
    to, td, tt = (torch.from_numpy(a) for a in (o, d, tmax))
    short = np.where(tmax > 0, 1.5, 0.0).astype(np.float32)
    out = {}
    for tpc, (jc, tc) in tri_scene["cuts"].items():
        perm = inv = None
        kw = {}
        if tpc == 2:
            perm, inv = tk.ray_sort_perm(to, td, tt, tc, key="dir")
            kw = dict(perm=jnp.asarray(perm.numpy().astype(np.int32)),
                      inv=jnp.asarray(inv.numpy().astype(np.int32)))
        jt, jpay = _jax_trace(jc, o, d, tmax, False,
                              paym=jtrace.bake_material_rows(
                                  jc, jnp.asarray(mpack)), **kw)
        jocc = _jax_trace(jc, o, d, short, True, **kw)
        out[tpc] = dict(perm=perm, inv=inv, t=np.asarray(jt),
                        payload=np.asarray(jpay), occ=np.asarray(jocc))
    return dict(rays=(o, d, tmax, short), runs=out)


def _jax_prim(jpay):
    return np.where(jpay[jcl.PAY_PRIM] >= 0,
                    jpay[jcl.PAY_PRIM].astype(np.int64), -1)


def test_plain_walks_match_pallas_interpret(tri_scene, pallas_runs):
    o, d, tmax, short = pallas_runs["rays"]
    mpack = tri_scene["mpack"]
    to, td, tt = (torch.from_numpy(a) for a in (o, d, tmax))
    for tpc, (jc, tc) in tri_scene["cuts"].items():
        run = pallas_runs["runs"][tpc]
        perm, inv, jt, jpay = run["perm"], run["inv"], run["t"], run["payload"]
        t, prim, pay = tk.trace_cluster_bvh(
            to, td, tc, tt, paym=tk.bake_material_rows(
                tc, torch.from_numpy(mpack)), perm=perm, inv=inv)
        jprim = _jax_prim(jpay)
        same = prim.numpy() == jprim
        assert same.mean() >= AGREE, same.mean()
        hit = same & (jprim >= 0)
        assert hit.sum() > 300
        assert (prim.numpy()[tmax == 0] == -1).all()
        np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=2e-4)
        np.testing.assert_array_equal(t.numpy()[~hit & same],
                                      jt[~hit & same])
        rows = [r for r in range(jcl.PAY_ROWS) if r not in (31, 38, 39)]
        np.testing.assert_array_equal(pay.numpy()[rows][:, same],
                                      jpay[rows][:, same])
        np.testing.assert_allclose(pay.numpy()[31][hit], jpay[31][hit],
                                   rtol=2e-4)
        # the counters are the block's, broadcast over its lanes
        vis = pay.numpy()[38] if inv is None else pay.numpy()[38][
            np.argsort(inv.numpy())]
        assert (vis.reshape(-1)[:2048].reshape(2, 1024).std(-1) == 0).all()

        occ = tk.trace_cluster_bvh(to, td, tc, torch.from_numpy(short),
                                   anyhit=True, perm=perm, inv=inv).numpy()
        assert (occ == run["occ"]).mean() >= AGREE
        assert 0.05 < occ.mean() < 0.95 and not occ[tmax == 0].any()


def test_plain_counters_match_pallas_schedule(tri_scene, pallas_runs):
    """The plain closest walk runs the Pallas kernel's schedule (RING,
    two leaves a step, BM_PERIOD), so its per-block tile visits and
    sub-packet intersections are JAX's payload rows 38 and 39 on every
    block whose lanes all hit what the Pallas kernel hits (the forms round
    differently, and a different best t may mark another sub-packet)."""
    o, d, tmax, _ = pallas_runs["rays"]
    n = o.shape[0]
    for tpc, (_, tc) in tri_scene["cuts"].items():
        run = pallas_runs["runs"][tpc]
        perm = run["perm"]
        x = tk.ray_tile(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(tmax), perm)
        code, _, visits, subs = tk.cluster_closest_plain(x, tc)
        # kernel lane order: lane p traces ray perm[p]
        order = np.arange(n) if perm is None else perm.numpy()
        jpay = run["payload"][:, order]
        code = code.numpy()[:n]
        prim = np.where(code >= 0, tc.prim.numpy().reshape(-1)[
            np.maximum(code, 0)], -1)
        blocks = np.arange(n) // tk.BLOCK
        nb = blocks[-1] + 1
        agree = np.ones(nb, bool)
        np.logical_and.at(agree, blocks, prim == _jax_prim(jpay))
        first = np.arange(nb) * tk.BLOCK
        assert agree.sum() >= nb - 1 and (visits.numpy() > 0).all()
        np.testing.assert_array_equal(
            visits.numpy()[agree], jpay[tk.PAY_STAT_VISITS][first][agree])
        np.testing.assert_array_equal(
            subs.numpy()[agree], jpay[tk.PAY_STAT_SUBS][first][agree])
        assert tk.RING == 4 and tk.BM_PERIOD == 8


def test_sort_bake_pack_rebake_match_jax(tri_scene):
    jc, tc = tri_scene["cuts"][1]
    o, d, tmax = _rays(3000, seed=5)
    for key in ("dir", "origin_octant"):
        jp, ji = jtrace.ray_sort_perm(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(tmax), jc, key=key)
        tp, ti = tk.ray_sort_perm(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(tmax), tc, key=key)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert (tmax[tp.numpy()[-(tmax == 0).sum():]] == 0).all()

    mpack = tri_scene["mpack"]
    jpaym = jtrace.bake_material_rows(jc, jnp.asarray(mpack))
    tpaym = tk.bake_material_rows(tc, torch.from_numpy(mpack))
    np.testing.assert_array_equal(tpaym.numpy(), np.asarray(jpaym))
    for jm, tm in ((jpaym, tpaym), (None, None)):
        np.testing.assert_array_equal(
            tk.prepare_pay_tiles(tc, tm).numpy(),
            np.asarray(jtrace.prepare_pay_tiles(jc, jm)))

    tri = tri_scene["tri"]
    rng = np.random.default_rng(6)
    v0 = tri["v0"] + rng.normal(0, 0.01, tri["v0"].shape).astype(np.float32)
    e1 = tri["v1"] - v0
    e2 = tri["v2"] - v0
    e2[::97] = e1[::97]                     # some degenerate triangles
    tri9 = np.concatenate([v0.T, e1.T, e2.T], 0).astype(np.float32)
    jr = jcl.rebake_geometry(jc, jnp.asarray(tri9))
    tr = tcl.rebake_geometry(tc, torch.from_numpy(tri9))
    np.testing.assert_array_equal(tr.pgeo.numpy(), np.asarray(jr.pgeo))
    # [CT, 8, 6, 128]: the forms by tile, row, block and lane
    tb = tr.bmat.numpy().reshape(-1, 8, 6, 128)
    jb = np.asarray(jr.bmat).reshape(-1, 8, 6, 128)
    deg = np.isin(tc.prim.numpy(), np.arange(0, 3000, 97))
    got, want = tb.transpose(0, 3, 1, 2)[~deg], jb.transpose(0, 3, 1, 2)[~deg]
    assert np.isclose(got, want, rtol=1e-5, atol=1e-6).mean() >= 0.9999
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    # exactly degenerate triangles get cut_clusters' never-hit forms (JAX's
    # contracted cross products leave a rounding residue there instead)
    sentinel = np.zeros((8, 6), np.float32)
    sentinel[6, [jcl.BLK_TN, jcl.BLK_OU, jcl.BLK_OV]] = -1.0
    assert (tb.transpose(0, 3, 1, 2)[deg] == sentinel).all()
    # the rebaked forms still find the displaced triangles
    o, d, tmax = _rays(1024, seed=7)
    t, prim, _ = tk.trace_cluster_bvh(torch.from_numpy(o), torch.from_numpy(d),
                                      tr, torch.from_numpy(tmax))
    jt, jpay = _jax_trace(jr, o, d, tmax, False)
    jprim = np.where(np.asarray(jpay)[jcl.PAY_PRIM] >= 0,
                     np.asarray(jpay)[jcl.PAY_PRIM].astype(np.int64), -1)
    assert (prim.numpy() == jprim).mean() >= AGREE


def test_reattach_rows_gradient():
    rng = np.random.default_rng(8)
    pack = rng.normal(size=(9, 40)).astype(np.float32)
    idx = rng.integers(-1, 40, 300).astype(np.int32)   # misses and repeats
    idx[:5] = 7
    rows = np.where(idx >= 0, pack[:, np.maximum(idx, 0)], 0.0).astype(
        np.float32)
    g = rng.normal(size=rows.shape).astype(np.float32)

    _, vjp = jax.vjp(lambda p: jfetch.reattach_rows(p, jnp.asarray(idx),
                                                    jnp.asarray(rows)),
                     jnp.asarray(pack))
    jgrad = np.asarray(vjp(jnp.asarray(g))[0])

    tp = torch.from_numpy(pack).requires_grad_()
    ti = torch.from_numpy(idx)
    out = tfetch.reattach_rows(tp, ti, torch.from_numpy(rows))
    np.testing.assert_array_equal(out.detach().numpy(), rows)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=1e-6, atol=1e-6)

    gp = torch.from_numpy(pack).requires_grad_()
    hit = ti >= 0
    gathered = torch.where(hit[None], gp[:, ti.clamp(min=0).long()], 0.0)
    (gathered * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), gp.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not tp.grad[:, np.setdiff1d(np.arange(40), idx)].any()
