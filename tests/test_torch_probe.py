"""The brute-force intersector, the pixel probe and the debug views of the
port against the JAX package.

  - intersect_bruteforce / occluded_bruteforce against JAX's on a seeded
    soup of 1,500 triangles in chunks of 512 (the last chunk padded) and
    400 rays: prim and occlusion equal on every lane, t / u / v within
    rtol 1e-4 / atol 1e-5 (XLA:CPU contracts multiply-adds, ATen does not);
    then on the carried-across Cornell box against the plain BVH4 walk
    (the trace kernels' CPU route): t within rtol 1e-5 on every lane, prim
    equal except where two coplanar triangles tie in t exactly (>= 97% of
    these random rays; the boxes stand on the floor), occlusion equal on
    >= 99.9%;
  - probe_pixel against JAX's on a 4x4 grid of pixels of the Cornell box,
    with and without a BVH: material equal, distance within rtol 1e-5,
    prim equal but on at most 2 rays through a quad's diagonal (a t-tie
    that the BVH walks may break either way), u / v within atol 1e-5 on
    the other hits;
  - bvh_print: the BVH2 line equals JAX's on the carried-across tree, and
    the BVH4 line names the packed tree; bvh_heatmap equals _colormap of the
    plain walk's per-ray step counts over their peak;
  - a use_bvh=False render (classic, then regen) against the BVH render on
    the same scene: >= 99% of pixels within rtol 1e-3 / atol 1e-4 (the
    two intersectors may break t-ties differently).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core import geometry as jgeo
from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import probe as jprobe
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core import geometry as tgeo
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import probe as tprobe
from lighthouse2_tpu_torch.render import wavefront as twf
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE = 16


@pytest.fixture(scope="module")
def cornell():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    return jds, jview, tds, tview


def test_bruteforce_matches_jax_and_the_bvh_walk(cornell):
    rng = np.random.default_rng(0)
    t_n, r_n = 1500, 400
    v0 = rng.uniform(-1, 1, (t_n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (t_n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (t_n, 3)).astype(np.float32)
    o = np.tile(np.float32([[0.0, 0.0, -3.0]]), (r_n, 1))
    d = rng.normal(size=(r_n, 3)).astype(np.float32)
    d[:, 2] = 4.0 * np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(0.0, 5.0, r_n).astype(np.float32)
    j = [np.asarray(x) for x in jgeo.intersect_bruteforce(
        *map(jnp.asarray, (o, d, v0, e1, e2)), chunk=512)]
    t = [x.numpy() for x in tgeo.intersect_bruteforce(
        *map(torch.from_numpy, (o, d, v0, e1, e2)), chunk=512)]
    np.testing.assert_array_equal(t[1], j[1])
    assert 0.3 < (t[1] >= 0).mean() < 1.0 and (t[1] >= 1024).any()
    for a, b in zip(t[::2] + t[3:], j[::2] + j[3:]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    jo = np.asarray(jgeo.occluded_bruteforce(
        *map(jnp.asarray, (o, d, tmax, v0, e1, e2)), chunk=512))
    to = tgeo.occluded_bruteforce(*map(torch.from_numpy,
                                       (o, d, tmax, v0, e1, e2)), chunk=512)
    np.testing.assert_array_equal(to.numpy(), jo)
    assert 0 < jo.mean() < 1

    # the Cornell box: brute force against the plain BVH4 walk
    _, _, tds, _ = cornell
    tri = tds.tris
    o = torch.from_numpy(rng.uniform(-0.9, 0.9, (r_n, 3)).astype(np.float32)
                         + np.float32([0.0, 1.0, 0.0]))
    d = tgeo.normalize(torch.from_numpy(rng.normal(size=(r_n, 3))
                                        .astype(np.float32)))
    bt, bp, _, _ = tgeo.intersect_bruteforce(o, d, tri.v0, tri.e1, tri.e2)
    wt, wp, _, _ = wide_intersect(o, d, tds.bvh)
    same = bp == wp
    assert same.float().mean() >= 0.97 and (bp >= 0).float().mean() > 0.5
    torch.testing.assert_close(bt, wt, rtol=1e-5, atol=0)
    # lanes whose prim differs hit coplanar triangles at one t (a box's
    # bottom face lies on the floor)
    assert (bt[~same] == wt[~same]).all()
    tm = torch.from_numpy(rng.uniform(0.0, 3.0, r_n).astype(np.float32))
    bo = tgeo.occluded_bruteforce(o, d, tm, tri.v0, tri.e1, tri.e2)
    assert (bo == wide_occluded(o, d, tm, tds.bvh)).float().mean() >= 0.999


@pytest.mark.parametrize("use_bvh", [True, False])
def test_probe_pixel_matches_jax(cornell, use_bvh, monkeypatch):
    jds, jview, tds, tview = cornell
    # JAX's probe_pixel as it is, its traversal jitted once (eagerly each
    # call re-traces its loop: seconds a pixel)
    for name in ("bvh_intersect", "intersect_bruteforce"):
        monkeypatch.setattr(jprobe, name, jax.jit(getattr(jprobe, name)))
    jcfg = JConfig(width=SIZE, height=SIZE, use_bvh=use_bvh)
    tcfg = RenderConfig(width=SIZE, height=SIZE, use_bvh=use_bvh)
    if not use_bvh:
        jds = jds.replace(bvh=None)
        tds = dataclasses.replace(tds, bvh=None)
    hits = ties = 0
    for y in np.linspace(0, SIZE - 1, 4).astype(int):
        for x in np.linspace(0, SIZE - 1, 4).astype(int):
            j = jprobe.probe_pixel(jds, jview, jcfg, int(x), int(y))
            t = tprobe.probe_pixel(tds, tview, tcfg, int(x), int(y))
            assert t["material"] == j["material"]
            np.testing.assert_allclose(t["distance"], j["distance"],
                                       rtol=1e-5)
            if t["prim"] != j["prim"]:
                # a ray through the shared edge of two triangles of a quad:
                # a t-tie, which the two walks may break either way
                ties += 1
                continue
            if t["prim"] >= 0:
                hits += 1
                np.testing.assert_allclose([t["u"], t["v"]],
                                           [j["u"], j["v"]], atol=1e-5)
    assert hits >= 12 and ties <= 2


def test_bvh_print_and_heatmap(cornell):
    jds, jview, tds, tview = cornell
    want = jprobe.bvh_print(jds).splitlines()[0]
    got = tprobe.bvh_print(tds).splitlines()
    assert got[0] == want and want.startswith("BVH2 (lockstep)")
    assert got[1].startswith(f"BVH4 (trace kernels): "
                             f"{tds.bvh.node4.shape[0]} nodes")
    assert tprobe.bvh_print(dataclasses.replace(tds, bvh=None)) == \
        "no acceleration structures"

    cfg = RenderConfig(width=SIZE, height=SIZE)
    img = tprobe.bvh_heatmap(tds, tview, cfg)
    o, d = tprobe._pixel_rays(tview, cfg)
    steps = wide_intersect(o, d, tds.bvh, stats=True)[4][0].numpy()
    want = tprobe._colormap(steps / max(steps.max(), 1)).reshape(
        SIZE, SIZE, 3)
    np.testing.assert_array_equal(img, want)
    assert img.std() > 0
    np.testing.assert_array_equal(
        tprobe.bvh_heatmap(tds, tview, dataclasses.replace(cfg,
                                                           use_bvh=False)),
        tprobe._colormap(np.zeros((SIZE, SIZE))))


def test_no_bvh_render_equals_bvh_render(cornell):
    _, _, tds, tview = cornell
    brute = dataclasses.replace(tds, bvh=None)
    for regen in (False, True):
        cfg = RenderConfig(width=SIZE, height=SIZE, spp_per_pass=2,
                           max_path_length=3, path_regen=regen)
        nb = dataclasses.replace(cfg, use_bvh=False)
        out = []
        for scene, c in ((tds, cfg), (brute, nb), (tds, nb)):
            st = twf.AccumState.make(c, "cpu")
            for _ in range(2):
                st, _ = twf.render_pass_auto(scene, tview, st, c)
            out.append(st.accumulator.numpy())
        # use_bvh=False ignores a BVH the scene still carries
        np.testing.assert_array_equal(out[2], out[1])
        close = np.isclose(out[1], out[0], rtol=1e-3, atol=1e-4).all(-1)
        assert close.mean() >= 0.99, (regen, close.mean())
        assert out[1][:, :3].mean() > 0
