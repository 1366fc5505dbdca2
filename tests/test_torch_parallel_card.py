"""Parallel rendering on the card (parallel/), on the bathroom at 512x512,
classic, spp 1, path 16 unless named.

- Ray-data parallel (parallel/mesh.py) with NCCL and one rank (a file://
  store): render_pass_sharded (one pass first sets up the communicator)
  against the unsharded classic render_pass, sharded, unsharded,
  unsharded, sharded: every pixel within rtol 1e-6, the stats totals
  equal; train_step_sharded on a 64x64 Cornell box (material colours)
  against the single-process gradient: the loss within rtol 1e-5, every
  gradient entry within rtol 1e-5, the gradient nonzero.
- Scene sharding (parallel/scene_shard.py). (a) NCCL, one rank, a 1x1
  mesh: render_pass_scene_sharded against the unsharded pass (one pass
  first, then sharded, unsharded, unsharded, sharded): pixels off <
  FRAC_BAD_MAX and mean relative error < MEAN_REL_MAX (the two passes walk
  different trees, so only t-ties may differ), the stats totals within
  TIE_SHARE, 16 + 16 launches a sharded pass; both kernels on an empty
  shard's one-leaf tree (every primary ray a miss and unoccluded, as in
  the plain walk); the 1x1 gradient step of a SHARD_GRAD_SIZE^2 Cornell
  box (material colours, per-vertex offsets). (b) this file started
  SHARD_MESH[0] * SHARD_MESH[1] times as the gloo ranks of a SHARD_MESH
  mesh whose tensors all lie on cuda:0 (NCCL refuses two ranks on one
  card; gloo stages each collective through the host), joined within
  SHARD_JOIN_TIMEOUT: each rank cuts its shard and builds its tree, one
  pass and SHARD_PASSES more, 16 + 16 launches a pass on every rank; the
  image within (a)'s bounds against the unsharded pass, the Cornell
  step's loss within rtol 1e-5 and its gradients (the per-shard vertex
  gradients mapped back through gid) within rtol 1e-4 / atol 1e-6 of the
  largest of (a)'s 1x1 step, both shards' vertex gradients nonzero.
- intersector="cluster": one BDPT pass (classic, spp 1, path 16) and one
  scene-sharded pass on a 1x1 NCCL mesh (path CLUSTER_SHARD_PATH), each
  against its "auto" counterpart (the unsharded classic pass for the
  sharded one) within FRAC_BAD_MAX / MEAN_REL_MAX, launching only the
  cluster kernels.

Marked `card`: they skip without one (tests/card_support.py says how to
run them). No JAX.
"""
import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from card_support import bathroom, card  # noqa: F401 (fixtures)
from card_support import (MAIN, PATH, all_counts, assert_agrees, counts,
                          deltas)
from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSIC = dataclasses.replace(MAIN, path_regen=False)
SHARD_MESH = (2, 2)        # ("rays", "scene") of the gloo ranks
SHARD_PASSES = 2           # passes of each gloo rank after its first
SHARD_JOIN_TIMEOUT = 300   # seconds for the gloo ranks together
SHARD_GRAD_SIZE = 64       # Cornell box side of the sharded gradient step
TIE_SHARE = 1e-3           # stats totals: a t-tie may change a winner
CLUSTER_SHARD_PATH = 4     # path length of the cluster scene-sharded pass


@contextlib.contextmanager
def one_rank_nccl(dev, store):
    """A process group of this process alone, on NCCL, with a file://
    store; destroyed on exit."""
    from lighthouse2_tpu_torch.parallel.distributed import init_distributed
    init_distributed(f"file://{store}", num_processes=1, process_id=0,
                     device=dev)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _pass(fn, cfg, dev, launches=counts):
    """One pass of fn(state, cfg) from a fresh state: (its accumulator on
    the host, stats, the launches it made)."""
    before = launches()
    st, stats = fn(AccumState.make(cfg, dev), cfg)
    return st.accumulator.cpu().numpy(), stats, deltas(before, launches())


def _totals(stats):
    return [int(stats["total_extension"]), int(stats["total_shadow"])]


@pytest.mark.card
def test_ray_parallel_render_and_step_on_nccl(bathroom, card, tmp_path):
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    from lighthouse2_tpu_torch.parallel.distributed import global_mesh
    from lighthouse2_tpu_torch.parallel.mesh import (
        render_pass_sharded, train_step_sharded)
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    host, cam = bathroom
    scene, view = host.sync(card), cam.get_view(card)
    with one_rank_nccl(card, tmp_path / "store"):
        mesh = global_mesh()
        sharded = lambda st, c: render_pass_sharded(scene, view, st, c, mesh)
        unsharded = lambda st, c: render_pass(scene, view, st, c)
        _pass(sharded, CLASSIC, card)    # sets up the NCCL communicator
        runs = {}
        for fn in (sharded, unsharded, unsharded, sharded):
            runs.setdefault(fn, []).append(_pass(fn, CLASSIC, card))
        (sh, sh_stats, _), (un, un_stats, _) = (runs[sharded][0],
                                                runs[unsharded][0])

        tcfg = dataclasses.replace(CLASSIC, width=64, height=64,
                                   max_path_length=4)
        host_c, cam_c = cornell_box(64, 64)
        ds, cview = host_c.sync(card), cam_c.get_view(card)
        target = torch.zeros((64 * 64, 3), device=card)
        insert = lambda s, c: set_material_fields(s, color=c)
        color = ds.materials.color.detach().clone().requires_grad_()
        st, _ = render_pass(insert(ds, color), cview,
                            AccumState.make(tcfg, card), tcfg)
        loss1 = torch.mean((st.accumulator[:, :3] / float(tcfg.spp_per_pass)
                            - target) ** 2)
        (g1,) = torch.autograd.grad(loss1, color)
        loss_s, g_s = train_step_sharded(ds, cview, target, tcfg, mesh,
                                         lambda s: s.materials.color, insert,
                                         ds.materials.color)
    assert np.isclose(sh, un, rtol=1e-6, atol=0.0).all()
    assert _totals(sh_stats) == _totals(un_stats)
    g1, g_s = g1.cpu().numpy(), g_s.cpu().numpy()
    assert abs(loss_s.item() - loss1.item()) <= 1e-5 * abs(loss1.item())
    assert np.isclose(g_s, g1, rtol=1e-5, atol=1e-9).all()
    assert np.linalg.norm(g1) > 0


def _shard_grad_inputs(dev, k, size=SHARD_GRAD_SIZE):
    """The sharded gradient step's inputs: a size^2 Cornell box, path 4,
    classic, its material colours and zero per-vertex offsets of one of k
    shards as parameters, a zero target."""
    from lighthouse2_tpu_torch.scene.presets import cornell_box
    host, cam = cornell_box(size, size)
    ds, view = host.sync(dev), cam.get_view(dev)
    cfg = dataclasses.replace(CLASSIC, width=size, height=size,
                              max_path_length=4)
    tk = -(-ds.tris.count // k)
    params = dict(color=ds.materials.color,
                  offset=torch.zeros((tk, 3, 3), device=dev))
    return ds, view, cfg, params, torch.zeros((size * size, 3), device=dev)


def _shard_insert(scene, sh, p):
    """Colours into the replicated scene, vertex offsets into the shard
    (diff/params.py displace_vertices' arithmetic)."""
    from lighthouse2_tpu_torch.diff.params import set_material_fields
    off = p["offset"]
    v0 = sh["v0"] + off[:, 0]
    v1 = sh["v0"] + sh["e1"] + off[:, 1]
    v2 = sh["v0"] + sh["e2"] + off[:, 2]
    return (set_material_fields(scene, color=p["color"]),
            dict(sh, v0=v0, e1=v1 - v0, e2=v2 - v0))


def _empty_shard_misses(scene, view, cfg, dev):
    """Both kernels on an empty shard's tree (k = T + 1, the last shard: a
    one-leaf root over a degenerate triangle) for the primary rays: every
    lane a miss and unoccluded, as in the plain walk."""
    from lighthouse2_tpu_torch.bvh.wide import wide_intersect, wide_occluded
    from lighthouse2_tpu_torch.parallel.scene_shard import build_shard_bvh
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    from lighthouse2_tpu_torch.render.wavefront import generate_eye_rays
    t = scene.tris.count
    tree = build_shard_bvh(scene.tris, t + 1, t, dev)
    paths = generate_eye_rays(view, cfg, 0)
    o, d = paths["origin"].contiguous(), paths["dir"].contiguous()
    prim = trace_closest(o, d, 1e30, tree)[1]
    occ = trace_occluded(o, d, 1e30, tree)
    return bool((prim == -1).all() and not occ.any()
                and (prim == wide_intersect(o, d, tree, t_max=1e30)[1]).all()
                and (occ == wide_occluded(o, d, 1e30, tree)).all())


def scene_shard_rank(rank, store, inputs, out, device):
    """One gloo rank of the SHARD_MESH group whose tensors all lie on
    `device`: renders the bathroom from `inputs` (its shard cut and its
    tree built here), takes the Cornell gradient step and saves what it
    saw to `out`."""
    from lighthouse2_tpu_torch.parallel.distributed import init_distributed
    from lighthouse2_tpu_torch.parallel.mesh import _to, make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        render_pass_scene_sharded, shard_scene, shard_triangle_arrays,
        train_step_scene_sharded)
    dev = torch.device(device)
    n_ray, n_scene = SHARD_MESH
    init_distributed(f"file://{store}", n_ray * n_scene, rank,
                     backend="gloo", device=dev)
    try:
        mesh = make_mesh2d(n_ray, n_scene, device=dev)
        inp = torch.load(inputs, weights_only=False)
        cfg = inp["config"]
        scene, sh, bvh = shard_scene(inp["scene"], mesh)
        view = _to(inp["view"], dev)
        for _ in range(1 + SHARD_PASSES):
            acc, stats, launches = _pass(
                lambda st, c: render_pass_scene_sharded(
                    scene, view, st, c, mesh, sh=sh, shard_bvh=bvh), cfg, dev)
        res = dict(coords=mesh.coords, launches=launches,
                   totals=_totals(stats), accumulator=acc)
        del scene, sh, bvh
        ds, gview, gcfg, params, target = _shard_grad_inputs(dev, n_scene)
        loss, grads = train_step_scene_sharded(ds, gview, target, gcfg, mesh,
                                               _shard_insert, params)
        res.update(loss=loss.item(),
                   grads={k: g.cpu() for k, g in grads.items()},
                   gid=shard_triangle_arrays(ds.tris, n_scene)["gid"][
                       mesh.coords[1]].cpu())
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _spawn_shard_ranks(directory, inputs, dev):
    """Start the SHARD_MESH gloo ranks (this file, scene_shard_rank), join
    them within SHARD_JOIN_TIMEOUT and return their results. A rank that
    fails or outlives the timeout fails the test; none is left running."""
    n = SHARD_MESH[0] * SHARD_MESH[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [open(directory / f"rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--scene-shard-rank",
         str(r), str(directory / "store"), str(inputs),
         str(directory / f"rank{r}.pt"), str(dev)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in range(n)]
    deadline = time.monotonic() + SHARD_JOIN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {n} ranks did not finish in {SHARD_JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (
            f"rank {r} failed:\n"
            + (directory / f"rank{r}.log").read_text()[-6000:])
    return [torch.load(directory / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


@pytest.mark.card
def test_scene_sharded_render_and_step(bathroom, card, tmp_path):
    from lighthouse2_tpu_torch.parallel.mesh import _to, make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        render_pass_scene_sharded, shard_scene, train_step_scene_sharded)
    host, cam = bathroom
    scene, view = host.sync(card), cam.get_view(card)
    with one_rank_nccl(card, tmp_path / "store1"):
        mesh = make_mesh2d(1, 1, device=card)
        srep, sh, bvh = shard_scene(scene, mesh)
        sharded = lambda st, c: render_pass_scene_sharded(
            srep, view, st, c, mesh, sh=sh, shard_bvh=bvh)
        unsharded = lambda st, c: render_pass(scene, view, st, c)
        _pass(sharded, CLASSIC, card)    # sets up the communicators
        runs = {}
        for fn in (sharded, unsharded, unsharded, sharded):
            runs.setdefault(fn, []).append(_pass(fn, CLASSIC, card))
        del srep, sh, bvh
        empty_misses = _empty_shard_misses(scene, view, CLASSIC, card)
        ds, gview, gcfg, params, target = _shard_grad_inputs(card, 1)
        loss1, g1 = train_step_scene_sharded(ds, gview, target, gcfg, mesh,
                                             _shard_insert, params)
    inputs = tmp_path / "inputs.pt"
    torch.save(dict(scene=dataclasses.replace(_to(scene, "cpu"), bvh=None,
                                              cbvh=None),
                    view=_to(view, "cpu"), config=CLASSIC), inputs)
    ranks = _spawn_shard_ranks(tmp_path, inputs, card)

    sh_acc, sh_stats, _ = runs[sharded][-1]
    un_acc, un_stats, _ = runs[unsharded][0]
    for acc in (sh_acc, ranks[0]["accumulator"]):
        assert_agrees(acc, un_acc)
    for got in (_totals(sh_stats), ranks[0]["totals"]):
        assert all(abs(a - b) <= TIE_SHARE * b
                   for a, b in zip(got, _totals(un_stats))), got
    want = dict(trace_closest=PATH, trace_occluded=PATH)
    launches = [r[2] for r in runs[sharded]] + [r["launches"] for r in ranks]
    assert all(x == want for x in launches), launches
    assert empty_misses
    g1 = {k: g.cpu().numpy() for k, g in g1.items()}
    close, parts = [], {}
    for r in ranks:
        assert abs(r["loss"] - loss1.item()) <= 1e-5 * abs(loss1.item())
        gid = r["gid"].numpy()
        real = gid >= 0
        for g, w in ((r["grads"]["color"].numpy(), g1["color"]),
                     (r["grads"]["offset"].numpy()[real],
                      g1["offset"][gid[real]])):
            close.append(np.isclose(g, w, rtol=1e-4,
                                    atol=1e-6 * float(np.abs(w).max())).all())
        parts[r["coords"][1]] = float(np.abs(r["grads"]["offset"]).sum())
    assert all(close) and len(parts) == SHARD_MESH[1], (close, parts)
    assert all(v > 0 for v in parts.values()), parts


@pytest.mark.card
def test_cluster_bdpt_and_scene_sharded_passes_match_auto(bathroom, card,
                                                          tmp_path):
    from lighthouse2_tpu_torch.parallel.mesh import make_mesh2d
    from lighthouse2_tpu_torch.parallel.scene_shard import (
        render_pass_scene_sharded, shard_scene)
    from lighthouse2_tpu_torch.render.bdpt import render_pass_bdpt
    host, cam = bathroom
    scene, view = host.sync(card, clusters=True), cam.get_view(card)
    cluster = lambda c: dataclasses.replace(c, intersector="cluster")
    bdpt = lambda st, c: render_pass_bdpt(scene, view, st, c)
    _pass(bdpt, cluster(CLASSIC), card, all_counts)     # warm-up
    got = {"bdpt": _pass(bdpt, cluster(CLASSIC), card, all_counts),
           "bdpt auto": _pass(bdpt, CLASSIC, card, all_counts)}
    scfg = dataclasses.replace(CLASSIC, max_path_length=CLUSTER_SHARD_PATH)
    with one_rank_nccl(card, tmp_path / "store"):
        mesh = make_mesh2d(1, 1, device=card)
        srep, sh, tree = shard_scene(scene, mesh, cluster=True)
        sharded = lambda st, c: render_pass_scene_sharded(
            srep, view, st, c, mesh, sh=sh, shard_cbvh=tree)
        _pass(sharded, cluster(scfg), card, all_counts)  # warm-up
        got["scene_sharded"] = _pass(sharded, cluster(scfg), card, all_counts)
        got["scene_sharded auto"] = _pass(
            lambda st, c: render_pass(scene, view, st, c), scfg, card,
            all_counts)
    for tag in ("bdpt", "scene_sharded"):
        acc, _, launched = got[tag]
        assert_agrees(acc, got[tag + " auto"][0])
        assert not (launched["trace_closest"] or launched["trace_occluded"])
        assert launched["cluster_closest"] and launched["cluster_occluded"], (
            tag, launched)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one gloo rank of "
                                 "test_scene_sharded_render_and_step")
    ap.add_argument("--scene-shard-rank", nargs=5, required=True,
                    metavar=("RANK", "STORE", "INPUTS", "OUT", "DEVICE"))
    rank, store, inputs, out, device = ap.parse_args().scene_shard_rank
    scene_shard_rank(int(rank), store, inputs, out, device)
