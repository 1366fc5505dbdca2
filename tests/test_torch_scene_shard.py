"""Scene-sharded rendering of the port (parallel/scene_shard.py) against the
JAX package's parallel/scene_shard.py and against the port's single-process
passes.

The scene is tests/test_scene_shard.py's `_many_tri_scene`: the Cornell box
with a bumpy 24x24 heightfield (1,184 triangles), so each shard's tree is a
real tree. Both packages sync it single-level with the numpy builder
(two_level=False; LH2_NO_NATIVE=1 on the JAX side), which
tests/test_torch_scene.py holds equal array for array. 16x16, spp 1, path
2, the classic executor.

The ranks are this file run as a script: four gloo ranks on the CPU,
started once per module with a file:// rendezvous in a temporary
directory and joined with a timeout. Each rank renders on the 1x4, 2x2 and
4x1 meshes, takes one 2x2 gradient step and checks the errors, and saves
what it saw. The items:
  1. shard_triangle_arrays and build_shard_bvh against JAX's
     shard_triangle_arrays / build_shard_bvhs at k = 1, 2, 4 and T + 1
     (one triangle a shard and an empty last shard): every field, gid, the
     padding and each shard's BVH2 arrays equal, array for array (JAX pads
     the trees to one shape: its arrays up to each shard's own size);
  2. one wavefront of primary rays traced on each of 4 shards, the winner
     picked by hand: the port's _local_payload, summed over the shards,
     equals JAX's row for row (the port's layout is narrower: the id rides
     as int32, and equals JAX's PAY_PRIM row), and shading_from_payload on
     that payload equals JAX's field by field within rtol 1e-6 (eager jnp);
  3. the whole pass: JAX's render_pass_scene_sharded on make_mesh2d(1, 4)
     (the file's one JAX compile, at XLA's backend optimisation level 0)
     against the port's 1x4 and 2x2 ranks, within tests/test_scene_shard.py's
     rtol 2e-4 / atol 2e-5 on >= PIXELS_CLOSE of the pixels (the port's
     kernels walk the BVH4 and XLA:CPU contracts multiply-adds, so a grazing
     hit can change winner) and the image mean within 1e-4; the 4x1 ranks
     (k = 1) equal the port's single-process classic render_pass exactly;
     the stats totals of every mesh equal the single-process pass's;
  4. the 2x2 gradient step (material colours and per-vertex offsets, the
     vertex gradients mapped back through gid) against the single-process
     port step (the same train_step_scene_sharded on a 1x1 mesh) within
     rtol 1e-4 / atol 1e-6, every group finite and nonzero; and the 1x1
     step against the classic render_pass's gradient through
     set_material_fields / displace_vertices within the same bounds. A
     gradient scaled by the shard count, or one without another shard's
     share, fails. The 2x2 step with remat (refine + shade recomputed from
     the payload carried through the checkpoint) equals it exactly;
  5. ValueError for path_regen=True, for n_paths % rays != 0 and for a
     stripped scene handed to shard_scene without its shard (the global
     triangles it would cut are gone); render_pass still rejects
     scene_sharded=True.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lighthouse2_tpu_torch.core.geometry import BIG_T
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.params import (
    displace_vertices, set_material_fields)
from lighthouse2_tpu_torch.parallel.distributed import init_distributed
from lighthouse2_tpu_torch.parallel.mesh import make_mesh2d
from lighthouse2_tpu_torch.parallel.scene_shard import (
    _local_payload, _strip_scene, build_shard_bvh, build_shard_bvhs,
    render_pass_scene_sharded, shard_scene,
    shard_triangle_arrays, train_step_scene_sharded)
from lighthouse2_tpu_torch.render import shading as tsh
from lighthouse2_tpu_torch.render.kernels.trace import trace_closest
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, generate_eye_rays, render_pass)
from lighthouse2_tpu_torch.scene.host_mesh import HostMesh
from lighthouse2_tpu_torch.scene.presets import cornell_box

torch.set_num_threads(1)

SIZE, SPP, PATH = 16, 1, 2
WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
PIXELS_CLOSE = 0.99
JOIN_TIMEOUT = 300.0       # seconds for the four ranks together
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _heightfield(k=24):
    """tests/test_scene_shard.py _many_tri_scene's bumpy heightfield."""
    xs = np.linspace(-0.4, 0.4, k + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    rng = np.random.default_rng(3)
    gy = 0.12 + 0.04 * rng.standard_normal(gx.shape).astype(np.float32)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    idx = []
    for i in range(k):
        for j in range(k):
            a = i * (k + 1) + j
            b = (i + 1) * (k + 1) + j
            idx += [[a, b, a + 1], [b, b + 1, a + 1]]
    return verts, np.asarray(idx, np.int32)


def _add_heightfield(scene, mesh_cls):
    verts, idx = _heightfield()
    mid = scene.add_mesh(mesh_cls.from_indexed_data(verts, idx, material=1,
                                                    name="bumpy"))
    scene.add_instance(mid)


def _scene():
    """The port's many-triangle scene, single-level numpy sync, on the CPU."""
    host, cam = cornell_box(SIZE, SIZE)
    _add_heightfield(host, HostMesh)
    return (host.sync("cpu", two_level=False, native=False),
            cam.get_view("cpu"))


def _config(**kw):
    return RenderConfig(width=SIZE, height=SIZE, spp_per_pass=SPP,
                        max_path_length=PATH, path_regen=False, **kw)


def _insert(scene, sh, p):
    """Colours into the replicated scene, vertex offsets [Tk, 3, 3] into
    the shard (diff/params.py displace_vertices' arithmetic)."""
    off = p["offset"]
    v0 = sh["v0"] + off[:, 0]
    v1 = sh["v0"] + sh["e1"] + off[:, 1]
    v2 = sh["v0"] + sh["e2"] + off[:, 2]
    return (set_material_fields(scene, color=p["color"]),
            dict(sh, v0=v0, e1=v1 - v0, e2=v2 - v0))


def _raises_value_error(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _rank_main(rank: int, store: str, out: str):
    """One rank: every multi-rank check of this file, saved to `out`."""
    import torch.distributed as dist
    init_distributed(f"file://{store}", WORLD, rank, device="cpu")
    try:
        ds, view = _scene()
        cfg = _config()
        res = {}
        meshes = {m: make_mesh2d(*m, device="cpu") for m in MESHES}
        for m, mesh in meshes.items():
            state, stats = render_pass_scene_sharded(
                ds, view, AccumState.make(cfg, "cpu"), cfg, mesh)
            res[m] = dict(accumulator=state.accumulator,
                          cam_seed=state.cam_seed,
                          stats={k: v.clone() for k, v in stats.items()})
        mesh = meshes[(2, 2)]
        tk = -(-ds.tris.count // 2)
        params = dict(color=ds.materials.color,
                      offset=torch.zeros((tk, 3, 3)))
        loss, grads = train_step_scene_sharded(
            ds, view, torch.zeros((SIZE * SIZE, 3)), cfg, mesh, _insert,
            params)
        s = mesh.coords[1]
        res["grad"] = dict(loss=loss, grads=grads, coords=mesh.coords,
                           gid=shard_triangle_arrays(ds.tris, 2)["gid"][s])
        res["grad_remat"] = train_step_scene_sharded(
            ds, view, torch.zeros((SIZE * SIZE, 3)),
            dataclasses.replace(cfg, remat=True), mesh, _insert, params)
        odd = dataclasses.replace(cfg, width=3, height=3)
        res["regen_raises"] = _raises_value_error(
            lambda: render_pass_scene_sharded(
                ds, view, AccumState.make(cfg, "cpu"),
                dataclasses.replace(cfg, path_regen=True), mesh))
        res["indivisible_raises"] = _raises_value_error(
            lambda: render_pass_scene_sharded(
                ds, view, AccumState.make(odd, "cpu"), odd, mesh))
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, from one spawn of the group."""
    d = tmp_path_factory.mktemp("scene_shard")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--store", str(d / "store"), "--out", str(d / f"rank{r}.pt")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0].decode())
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} ranks did not finish in {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_scene(monkeypatch):
    """The same scene synced by the JAX package (numpy builder)."""
    from lighthouse2_tpu.scene import presets as jpresets
    from lighthouse2_tpu.scene.host_mesh import HostMesh as JHostMesh
    monkeypatch.setenv("LH2_NO_NATIVE", "1")
    host, cam = jpresets.cornell_box(SIZE, SIZE)
    _add_heightfield(host, JHostMesh)
    return host.sync(two_level=False), cam.get_view()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's scene, view and its 1x4 sharded pass (the one compile)."""
    import jax
    from lighthouse2_tpu.core.types import RenderConfig as JConfig
    from lighthouse2_tpu.parallel import scene_shard as jss
    from lighthouse2_tpu.render.wavefront import AccumState as JState
    with pytest.MonkeyPatch.context() as mp:
        jds, jview = _jax_scene(mp)
        jcfg = JConfig(width=SIZE, height=SIZE, spp_per_pass=SPP,
                       max_path_length=PATH, use_bvh=True,
                       intersector="lockstep")
        mesh = jss.make_mesh2d(1, 4)
        sh = jss.shard_triangle_arrays(jds.tris, 4)
        bvhs = jss.build_shard_bvhs(jds.tris, 4)
    step = jax.jit(lambda ds, view, st, sh, bvhs: jss.render_pass_scene_sharded(
        ds, view, st, jcfg, mesh, sh=sh, shard_bvh=bvhs))
    st0 = JState.make(jcfg)
    state, stats = step.lower(jds, jview, st0, sh, bvhs).compile(
        compiler_options=FAST_COMPILE)(jds, jview, st0, sh, bvhs)
    return dict(jds=jds, jview=jview, accumulator=np.asarray(state.accumulator),
                stats={k: np.asarray(v) for k, v in stats.items()})


@pytest.fixture(scope="module")
def single():
    """The port's single-process classic pass and gradient, and the
    single-process sharded step (a 1x1 mesh)."""
    ds, view = _scene()
    cfg = _config()
    state, stats = render_pass(ds, view, AccumState.make(cfg, "cpu"), cfg)
    color = ds.materials.color.detach().clone().requires_grad_()
    offset = torch.zeros((ds.tris.count, 3, 3), requires_grad=True)
    st, _ = render_pass(displace_vertices(set_material_fields(ds, color=color),
                                          offset),
                        view, AccumState.make(cfg, "cpu"), cfg)
    loss = torch.mean((st.accumulator[:, :3] / SPP) ** 2)
    g_color, g_offset = torch.autograd.grad(loss, [color, offset])
    target = torch.zeros((SIZE * SIZE, 3))
    loss1, grads1 = train_step_scene_sharded(
        ds, view, target, cfg, make_mesh2d(1, 1, device="cpu"), _insert,
        dict(color=ds.materials.color,
             offset=torch.zeros((ds.tris.count, 3, 3))))
    return dict(ds=ds, view=view, state=state, stats=stats,
                classic=dict(loss=loss.detach(), color=g_color,
                             offset=g_offset),
                sharded=dict(loss=loss1, **grads1))


def test_shard_split_and_trees_match_jax(monkeypatch):
    from lighthouse2_tpu.parallel import scene_shard as jss
    jds, _ = _jax_scene(monkeypatch)
    ds, _ = _scene()
    t = ds.tris.count
    for k in (1, 2, 4, t + 1):
        got = shard_triangle_arrays(ds.tris, k)
        want = jss.shard_triangle_arrays(jds.tris, k)
        assert sorted(got) == sorted(want)
        for f in want:
            w = np.asarray(want[f])
            assert got[f].numpy().dtype == w.dtype, f
            np.testing.assert_array_equal(got[f].numpy(), w, err_msg=f)
        tk = -(-t // k)
        gid = got["gid"].numpy().ravel()
        assert gid.tolist() == list(range(t)) + [-1] * (k * tk - t)
        assert (got["e1"].numpy().reshape(-1, 3)[gid < 0] == 0).all()
        jb = jss.build_shard_bvhs(jds.tris, k)
        if k <= 4:
            trees = enumerate(build_shard_bvhs(ds.tris, k, "cpu"))
        else:
            trees = ((s, build_shard_bvh(ds.tris, k, s, "cpu"))
                     for s in (0, t // 2, t - 1, t))
        for s, b in trees:
            m, n_prim = b.left.shape[0], b.prim.shape[0]
            for f, n in (("nbox", m), ("left", m), ("right", m),
                         ("count", m), ("prim", n_prim), ("tri9", tk)):
                w = np.asarray(getattr(jb, f)[s])[..., :n]
                np.testing.assert_array_equal(getattr(b, f).numpy(), w,
                                              err_msg=f"k={k} shard {s} {f}")
            assert b.node4.shape[0] >= 1 and b.tri4.shape == (n_prim, 12)
            if s == t:          # the empty last shard: JAX's one-leaf dummy
                assert b.count.tolist() == [1] and b.depth4 == 1
                o = torch.zeros((4, 3))
                d = torch.nn.functional.normalize(torch.randn(4, 3), dim=-1)
                assert (trace_closest(o, d, BIG_T, b)[1] == -1).all()


# (port rows, JAX rows) of one payload field: the port's layout drops JAX's
# PAY_PRIM, PAY_MAT, PAY_VALID rows and the sublane pads
_ROWS = (("v0..alpha", tsh.PAY_V0, 0, 27), ("ltri", tsh.PAY_LTRI, 29, 1),
         ("lod", tsh.PAY_LOD, 30, 1), ("tangent, bitangent", tsh.PAY_TAN, 32, 6),
         ("material", tsh.PAY_GEO_ROWS, 40, tsh.MAT_PACK_ROWS))


def test_payload_and_payload_shading_match_jax(jax_side):
    import jax.numpy as jnp
    from lighthouse2_tpu.parallel import scene_shard as jss
    from lighthouse2_tpu.render import shading as jsh
    ds, view = _scene()
    jds = jax_side["jds"]
    k = 4
    sh = shard_triangle_arrays(ds.tris, k)
    jsh_all = jss.shard_triangle_arrays(jds.tris, k)
    paths = generate_eye_rays(view, _config(), 0)
    # the primary rays, and the same rays turned round, out of the box
    o = torch.cat([paths["origin"], paths["origin"]])
    d = torch.cat([paths["dir"], -paths["dir"]])
    traced = []
    for s in range(k):
        t, prim, u, v = trace_closest(o, d, BIG_T, build_shard_bvh(
            ds.tris, k, s, "cpu"))
        hit = (prim >= 0) & (sh["gid"][s][prim.clamp(min=0).long()] >= 0)
        traced.append((torch.where(hit, t, BIG_T), prim, u, v, hit))
    tmin = torch.stack([x[0] for x in traced]).amin(0)
    won = torch.stack([x[4] & (x[0] <= tmin) for x in traced])
    owner = torch.where(won.any(0), won.int().argmax(0), -1)
    mpack = tsh.material_pack(ds.materials)
    jmpack = jsh.material_pack(jds.materials)
    pay = 0.0
    jpay = 0.0
    prim_g = torch.full_like(traced[0][1], -1)
    u_g = torch.zeros_like(tmin)
    v_g = torch.zeros_like(tmin)
    for s, (t, prim, u, v, hit) in enumerate(traced):
        mine = owner == s
        local = {f: a[s] for f, a in sh.items()}
        pay = pay + _local_payload(local, prim, mine, mpack)
        jpay = jpay + jss._local_payload(
            {f: a[s] for f, a in jsh_all.items()}, jnp.asarray(prim.numpy()),
            jnp.asarray(mine.numpy()), jmpack)
        gid = local["gid"][prim.clamp(min=0).long()]
        prim_g = torch.where(mine, gid, prim_g)
        u_g = torch.where(mine, u, u_g)
        v_g = torch.where(mine, v, v_g)
    jpay = np.asarray(jpay)
    hits = prim_g >= 0
    assert 0 < int(hits.sum()) < 2 * SIZE * SIZE
    assert len(set(owner[hits].tolist())) > 1
    assert pay.shape == (tsh.PAY_ROWS, 2 * SIZE * SIZE)
    for name, lo, jlo, n in _ROWS:
        np.testing.assert_array_equal(pay[lo:lo + n].detach().numpy(),
                                      jpay[jlo:jlo + n], err_msg=name)
    np.testing.assert_array_equal(jpay[27], prim_g.clamp(min=0).float().numpy())
    np.testing.assert_array_equal(jpay[31], hits.float().numpy())

    ts = torch.where(hits, tmin, 1.0)
    sd = tsh.shading_from_payload(ds, d, ts, pay, u_g, v_g,
                                  view.spread_angle, geom_reattach=False,
                                  prim=prim_g)
    j = lambda x: jnp.asarray(x.detach().numpy())
    jsd = jsh.shading_from_payload(jds, j(d), j(ts), jnp.asarray(jpay),
                                   j(u_g), j(v_g), float(view.spread_angle),
                                   geom_reattach=False)
    h = hits.numpy()
    for f in dataclasses.fields(sd):
        got = getattr(sd, f.name).detach().numpy()[h]
        want = np.asarray(getattr(jsd, f.name))[h]
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=1e-6,
                                   atol=1e-6, err_msg=f.name)



def test_sharded_pass_matches_jax_and_single_process(ranks, jax_side, single):
    ja = jax_side["accumulator"]
    want = single["state"]
    totals = {k: int(single["stats"][k]) for k in (
        "total_extension", "total_shadow", "primary_rays")}
    for m in MESHES:
        for r in ranks:
            got = r[m]
            acc = got["accumulator"].numpy()
            assert got["cam_seed"] == want.cam_seed
            assert {k: int(got["stats"][k]) for k in totals} == totals, m
            if m[1] == 1:       # one scene shard: the replicated image
                np.testing.assert_array_equal(acc, want.accumulator.numpy())
                continue
            close = np.isclose(acc, ja, rtol=2e-4, atol=2e-5).all(-1)
            assert close.mean() >= PIXELS_CLOSE, (m, close.mean())
            assert abs(acc.mean() - ja.mean()) <= 1e-4 * abs(ja.mean()), m
        torch.testing.assert_close(ranks[0][m]["accumulator"],
                                   ranks[-1][m]["accumulator"], rtol=0, atol=0)
    close = np.isclose(want.accumulator.numpy(), ja, rtol=2e-4,
                       atol=2e-5).all(-1)
    assert close.mean() >= PIXELS_CLOSE, close.mean()
    assert int(jax_side["stats"]["total_extension"]) == \
        totals["total_extension"]


def test_sharded_gradients_match_single_process(ranks, single):
    one, classic = single["sharded"], single["classic"]
    for g in (one["color"], one["offset"]):
        assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    np.testing.assert_allclose(float(one["loss"]), float(classic["loss"]),
                               rtol=1e-5)
    for f in ("color", "offset"):
        np.testing.assert_allclose(one[f].numpy(), classic[f].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    offset = {}
    for r in ranks:
        g = r["grad"]
        np.testing.assert_allclose(float(g["loss"]), float(one["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(g["grads"]["color"].numpy(),
                                   one["color"].numpy(), rtol=1e-4, atol=1e-6)
        gid = g["gid"].numpy()
        real = gid >= 0
        part = g["grads"]["offset"].numpy()
        assert np.isfinite(part).all() and np.abs(part).sum() > 0
        np.testing.assert_allclose(part[real], one["offset"].numpy()[gid[real]],
                                   rtol=1e-4, atol=1e-6)
        offset.setdefault(g["coords"][1], part)
        # remat recomputes refine + shade from the payload it was given
        loss_r, grads_r = r["grad_remat"]
        assert float(loss_r) == float(g["loss"])
        for f in ("color", "offset"):
            torch.testing.assert_close(grads_r[f], g["grads"][f], rtol=0,
                                       atol=0)
    assert sorted(offset) == [0, 1]


def test_errors(ranks, single):
    for r in ranks:
        assert r["regen_raises"] and r["indivisible_raises"]
    ds, view = single["ds"], single["view"]
    with pytest.raises(ValueError, match="stripped scene"):
        shard_scene(_strip_scene(ds), make_mesh2d(1, 1, device="cpu"))
    cfg = _config(scene_sharded=True)
    with pytest.raises(ValueError, match="scene_sharded"):
        render_pass(ds, view, AccumState.make(cfg, "cpu"), cfg)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of this file's group")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.rank, args.store, args.out)
