"""intersector="cluster" through the port's entry points, on the CPU.

On the CPU the cluster kernels' wrappers run their plain versions
(render/kernels/cluster.py); the card tests (test_torch_*_card.py) run
the same entry points on the card.
  - a Cornell 16x16 cluster render of the classic executor (path 2, two
    passes) against the JAX package's cluster render with its Pallas
    kernels in interpret mode, the scene and its ClusterBVH carried across:
    within rtol 1e-4 / atol 1e-5 (tests/test_grad.py:171's bounds for the
    cluster image), cam_seed and the ray counts equal. The JAX side is
    compiled once, at XLA's backend optimisation level 0;
  - on the bathroom's 20k-triangle variant (76 clusters, so the bounce
    rays are sorted): regen_value_and_grad with colours, area-light
    radiance and per-vertex offsets on the cluster path against the port's
    "auto" path, loss within 1e-4 and each gradient group within
    tests/test_torch_grad.py's relative L2 bounds (both paths hit the same
    triangles; the re-attach backward's index_add_ and the gather backward
    sum in other orders), every kernel lane of the path traced by the
    plain versions; remat on and off equal;
  - the heatmap on the cluster branch colours each 1024-ray block's tile
    visits (the plain walk's counter), bvh_print prints the ClusterBVH
    line, and the RenderAPI cores "wavefront", "preview" and "bdpt" give
    the "auto" image under intersector="cluster" (RenderAPI syncs the
    cluster tiles for that intersector only);
  - a single-rank gloo group (a 1x1 mesh whose collectives run):
    render_pass_scene_sharded on the cluster path (resolved by
    _pick_intersector on the scene synced with its cluster tiles) (the shard's ClusterBVH
    built from its arrays) equals the BVH4 scene-sharded pass, and the
    cluster gradient step equals the BVH4 step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.api import RenderAPI
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
from lighthouse2_tpu_torch.render import probe
from lighthouse2_tpu_torch.render import wavefront as twf
from lighthouse2_tpu_torch.render.kernels import cluster as tk
from lighthouse2_tpu_torch.scene import bench_scene, presets
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE, PATH = 16, 2
LOSS_RTOL = 1e-4
GRAD_RTOL = dict(color=1e-3, light=1e-3, offset=2e-2)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
CBVH = ("boxes", "meta", "bmat", "pgeo", "n_nodes", "n_clusters",
        "tiles_per_cluster", "n_prims", "max_depth")


@pytest.fixture(scope="module")
def bathroom():
    host, cam = bench_scene.bathroom(32, 32, detail=0)
    return host.sync("cpu", clusters=True), cam.get_view("cpu")


def test_cluster_render_matches_jax_cluster_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    jcfg = JConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                   intersector="cluster", kernel_interpret=True)
    jstate = jwf.AccumState.make(jcfg)
    step = jwf.render_pass_jit.lower(jds, jview, jstate, config=jcfg).compile(
        compiler_options=FAST_COMPILE)
    jstats = []
    for _ in range(2):
        jstate, st = step(jds, jview, jstate)
        jstats.append(st)

    arrays = jax_scene_arrays(jds, jview)
    arrays.update({f"cbvh.{f}": (getattr(jds.cbvh, f)
                                 if isinstance(getattr(jds.cbvh, f), int)
                                 else np.asarray(getattr(jds.cbvh, f)))
                   for f in CBVH})
    tds, tview = scene_from_numpy(arrays, "cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       intersector="cluster")
    assert twf._pick_intersector(tds, cfg) == "cluster"
    state = twf.AccumState.make(cfg, "cpu")
    launches = tk.cluster_closest.launches
    for j in jstats:
        state, st = twf.render_pass(tds, tview, state, cfg)
        for k in ("extension_rays", "shadow_rays"):
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(j[k]))
    assert tk.cluster_closest.launches == launches      # the CPU: no kernel
    assert state.cam_seed == int(jstate.cam_seed)
    np.testing.assert_allclose(state.accumulator.numpy(),
                               np.asarray(jstate.accumulator),
                               rtol=1e-4, atol=1e-5)
    assert twf.finalize(state).mean() > 0


def _step(scene, view, cfg):
    params = dict(color=scene.materials.color.clone(),
                  light=scene.lights.tri_radiance.clone(),
                  offset=torch.zeros((scene.tris.count, 3, 3)))
    target = torch.full((cfg.width * cfg.height, 3), 0.25)
    loss, grads, _ = regen_value_and_grad(
        scene, view, twf.AccumState.make(cfg, "cpu"), cfg, target, params)
    return loss, grads


def test_cluster_regen_gradients_match_auto(bathroom):
    scene, view = bathroom
    assert scene.cbvh.n_clusters >= 16           # the bounces are sorted
    cfg = RenderConfig(width=32, height=32, max_path_length=3,
                       path_regen=True, remat=True)
    ccfg = dataclasses.replace(cfg, intersector="cluster")
    la, ga = _step(scene, view, cfg)
    lc, gc = _step(scene, view, ccfg)
    assert abs(lc.item() - la.item()) <= LOSS_RTOL * abs(la.item())
    for k, bound in GRAD_RTOL.items():
        assert torch.isfinite(gc[k]).all() and gc[k].abs().sum() > 0, k
        rel = ((gc[k] - ga[k]).norm() / ga[k].norm()).item()
        assert rel <= bound, (k, rel)
    ln, gn = _step(scene, view, dataclasses.replace(ccfg, remat=False))
    assert ln.item() == lc.item()
    for k in gn:
        np.testing.assert_allclose(gn[k].numpy(), gc[k].numpy(), rtol=1e-6,
                                   atol=1e-9)


def test_cluster_heatmap_print_and_cores(bathroom):
    scene, view = bathroom
    cfg = RenderConfig(width=64, height=64, intersector="cluster")
    heat = probe.bvh_heatmap(scene, view, cfg)
    o, d = probe._pixel_rays(view, cfg)
    visits = tk.cluster_closest_plain(tk.ray_tile(o, d, 1e30),
                                      scene.cbvh)[2].numpy()
    assert heat.shape == (64, 64, 3) and (visits > 0).all()
    want = probe._colormap(np.repeat(visits, 1024) / visits.max())
    np.testing.assert_allclose(heat.reshape(-1, 3), want, rtol=1e-6)
    assert "ClusterBVH: " + str(scene.cbvh.n_nodes) in probe.bvh_print(scene)

    host, cam = presets.cornell_box(16, 16)
    for core, kw in (("wavefront", dict(path_regen=True)), ("preview", {}),
                     ("bdpt", dict(max_path_length=4))):
        imgs = {}
        for isect in ("auto", "cluster"):
            api = RenderAPI.create(core, width=16, height=16,
                                   intersector=isect, device="cpu", **kw)
            api.scene, api.camera = host, cam
            api.render()
            imgs[isect] = api.get_image()
            assert ((api.device_scene().cbvh is not None)
                    == (isect == "cluster"))
        assert np.isfinite(imgs["cluster"]).all()
        np.testing.assert_allclose(imgs["cluster"], imgs["auto"], rtol=1e-5,
                                   atol=1e-6, err_msg=core)


def test_scene_sharded_cluster_pass_single_rank_gloo(tmp_path, monkeypatch):
    import torch.distributed as dist
    from lighthouse2_tpu_torch.parallel.distributed import init_distributed
    from lighthouse2_tpu_torch.parallel.mesh import make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        _shard_pack, _use_cluster, build_shard_cluster_bvhs,
        collective_bytes_per_pass, render_pass_scene_sharded,
        shard_triangle_arrays, train_step_scene_sharded)
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    from lighthouse2_tpu_torch.render.shading import material_pack

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    host, cam = presets.cornell_box(16, 16)
    scene, view = host.sync("cpu", clusters=True), cam.get_view("cpu")
    cfg = RenderConfig(width=16, height=16, max_path_length=4)
    ccfg = dataclasses.replace(cfg, intersector="cluster")
    assert _use_cluster(scene, ccfg, None) and not _use_cluster(scene, cfg,
                                                                 None)
    stacked = shard_triangle_arrays(scene.tris, 1)
    sh = {f: a[0] for f, a in stacked.items()}
    cb = build_shard_cluster_bvhs(stacked, "cpu")[0]
    pack = _shard_pack(sh, material_pack(scene.materials))
    valid = cb.prim >= 0
    np.testing.assert_array_equal(          # the tiles hold the pack's rows
        cb.pgeo[:, :27].permute(1, 0, 2)[:, valid].numpy(),
        pack[:27, cb.prim[valid].long()].numpy())
    init_distributed(f"file://{tmp_path}/store", num_processes=1,
                     process_id=0, device="cpu")
    try:
        mesh = make_mesh2d(1, 1, device="cpu")
        assert mesh.groups["scene"] is not None     # collectives run
        imgs = {}
        for c in (cfg, ccfg):
            st, stats = render_pass_scene_sharded(
                scene, view, twf.AccumState.make(c, "cpu"), c, mesh)
            imgs[c.intersector] = (st.accumulator.numpy(),
                                   int(stats["total_shadow"]))
        np.testing.assert_allclose(imgs["cluster"][0], imgs["auto"][0],
                                   rtol=1e-6, atol=1e-7)
        assert imgs["cluster"][1] == imgs["auto"][1]
        assert (collective_bytes_per_pass(ccfg, mesh)["scene"]["per_bounce"]
                ["payload"] == 4 * 63 * 256)

        def insert(s, shard, p):
            return set_material_fields(s, color=p["color"]), dict(
                shard, v0=shard["v0"] + p["offset"])
        params = dict(color=scene.materials.color,
                      offset=torch.zeros((scene.tris.count, 3)))
        target = torch.zeros((256, 3))
        out = {c.intersector: train_step_scene_sharded(
            scene, view, target, c, mesh, insert, params) for c in (cfg, ccfg)}
    finally:
        dist.destroy_process_group()
    (la, ga), (lc, gc) = out["auto"], out["cluster"]
    assert abs(lc.item() - la.item()) <= 1e-6 * abs(la.item())
    for k in ga:
        assert gc[k].abs().sum() > 0, k
        np.testing.assert_allclose(gc[k].numpy(), ga[k].numpy(), rtol=1e-4,
                                   atol=1e-6 * ga[k].abs().max().item())
