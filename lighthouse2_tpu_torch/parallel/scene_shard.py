"""Scene-sharded rendering: the triangles split over a "scene" mesh axis.

Counterpart of lighthouse2_tpu/parallel/scene_shard.py (make_mesh2d, which
lives in parallel/mesh.py here, shard_triangle_arrays, build_shard_bvhs,
build_shard_cluster_bvhs, _shard_pack, _local_payload, _shard_intersect,
_shard_intersect_kernel, _shard_occluded, _shard_occluded_kernel,
_strip_scene, render_pass_scene_sharded). When a scene is too large for one
device, its
triangles are split over the "scene" axis of a ("rays", "scene") mesh:
  - the path index range is split over "rays" as in parallel/mesh.py; the
    triangle arrays are split over "scene" into contiguous blocks of
    ceil(T/k), the last padded with degenerate triangles;
  - each scene shard has its own SAH BVH over its block, and every rank
    traces the whole local wavefront against its shard's tree with both
    trace kernels (render/kernels/trace.py: closest_kernel and
    occluded_kernel on a CUDA device, their plain BVH4 walk on the CPU);
  - the global winner of a ray is the argmin of (t, triangle id) over the
    "scene" axis, so ties go to the lowest shard as in JAX; its owner
    gathers the shading payload rows (render/shading.py PAY_*), which one
    sum over "scene" assembles on every rank; shading then runs on that
    payload (shading_from_payload) and never reads the global tables;
  - a shadow ray is occluded where any shard's any-hit trace says so;
  - where _pick_intersector resolves "cluster" (the scene synced with its
    cluster tiles, or a shard's ClusterBVH given) each shard has a
    ClusterBVH instead (build_shard_cluster_bvh) traced by the cluster kernels
    (render/kernels/cluster.py): the owner's payload is the kernel's
    payload re-attached to the shard's differentiable pack (_shard_pack,
    render/fetch.py reattach_rows), cut to the 63 payload rows and summed
    over "scene" like the gathered one;
  - materials, lights and the sky stay replicated; the scene that enters
    the pass carries no triangle arrays and no BVH (_strip_scene);
  - gradients: the payload gather is differentiable, so pixel gradients
    reach the shard's triangle arrays (scatter-added on the owner) and the
    material table. The material table is replicated but enters the
    payload gather, which differs between shards: it goes through
    mesh.broadcast_over, whose backward sums its gradient over "scene"
    (the transpose of shard_map's implicit pbroadcast); the payload's sum
    passes its gradient through (psum's transpose). After the backward
    every gradient, replicated or per shard, is summed over "rays" only.

Collectives a bounce with a live lane, over "scene": one MIN of an int64
key [N] (t's float bits over the triangle id: positive floats order as
their bits), one SUM of the payload and the winner's (u, v) [PAY_ROWS + 2,
N] f32 (the payload alone, [PAY_ROWS, N], on the cluster path), one MAX of
the uint8 occlusion [N]; a pass, over "rays": one SUM of the accumulator
and one of the stats. Every rank of a row holds the
same rays, so all of them skip the same dead bounces and call the same
collectives.

Differences from the JAX package:
  - each rank holds only its own shard: build_shard_bvh builds and packs
    one shard's tree and build_shard_cluster_bvh cuts one shard's cluster
    tiles, each with its own tiles_per_cluster, and
    render_pass_scene_sharded's `sh` / `shard_bvh` / `shard_cbvh` are this
    rank's shard (JAX pads every shard to one shape, and to one
    tiles_per_cluster, and stacks them, because shard_map splits one
    array). shard_triangle_arrays still returns all k shards stacked, as
    JAX's;
  - on the cluster path the payload summed over "scene" is the 63 rows of
    the gathered path (render/shading.py PAY_*), cut from the kernel's 72
    after the re-attach, and (u, v) come from the refine, as in JAX's
    kernel path; the shard trees are built with the numpy builder;
  - the winner's global triangle id is an int32 tensor from the key, never
    a float32 payload row (JAX's PAY_PRIM row is exact only below 2^24);
    t and the owner come from the same one collective, where JAX takes two
    pmins;
  - the stripped scene has tris=None and bvh=None, not a one-row stub, so
    a stray read of the global triangles fails;
  - the refine of the hit runs in the shade stage, from the payload rows
    (render/wavefront.py bounce_step);
  - ValueError where JAX asserts (path_regen, n_paths not divisible over
    "rays");
  - train_step_scene_sharded is new: JAX differentiates the sharded pass
    with jax.grad, the port needs a step that sums the gradients over
    "rays" as train_step_sharded does;
  - each shard's tree holds its own copy of the triangles, as JAX's
    lockstep shards do: moving vertices through `sh` does not move what the
    traversal tests (rebuild the trees to follow large moves).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from lighthouse2_tpu_torch.bvh import clusters as CL
from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh
from lighthouse2_tpu_torch.bvh.traverse import (
    DeviceBVH, pack_flat_tri9, upload_bvh)
from lighthouse2_tpu_torch.core.geometry import BIG_T
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.parallel.mesh import (
    Mesh2D, _STAT_KEYS, _to, broadcast_over, reduce_over, sum_over,
    unflatten_stats)
from lighthouse2_tpu_torch.render.fetch import reattach_rows
from lighthouse2_tpu_torch.render.kernels.cluster import (
    bake_material_rows, prepare_pay_tiles, ray_sort_perm, trace_cluster_bvh)
from lighthouse2_tpu_torch.render.kernels.trace import (
    trace_closest, trace_occluded)
from lighthouse2_tpu_torch.render.shading import PAY_ROWS, material_pack
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, _check_config, _pick_intersector, trace_paths)
from lighthouse2_tpu_torch.utils import telemetry

# the key of a ray that no shard hit: BIG_T's bits over the largest id
_MISS_LOW = 0x7FFFFFFF
_MISS_KEY = (int(np.float32(BIG_T).view(np.int32)) << 32) | _MISS_LOW

# the cluster payload's rows (bvh/clusters.py PAY_*) that make the 63 rows
# of render/shading.py's payload, in its order
_CLUSTER_TO_PAY = (list(range(CL.PAY_V0, CL.PAY_ALPHA + 3))
                   + [CL.PAY_LTRI, CL.PAY_LOD]
                   + list(range(CL.PAY_TAN, CL.PAY_BIT + 3))
                   + list(range(CL.PAY_GEO_ROWS,
                                CL.PAY_GEO_ROWS + PAY_ROWS - 35)))


def shard_triangle_arrays(tris, k: int) -> dict:
    """The triangle arrays split into k shards of ceil(T/k) along the
    triangle axis, stacked [k, Tk, ...], the last padded with degenerate
    triangles (e1 = e2 = 0, alpha 1, ltri -1), plus gid [k, Tk] int32, the
    global triangle id (-1 on the padding). Plain torch ops, so gradients
    reach the DeviceTriangles fields."""
    t = tris.count
    tk = -(-t // k)
    pad = k * tk - t

    def split(a, fill=0):
        if pad:
            a = torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                         dtype=a.dtype, device=a.device)])
        return a.reshape(k, tk, *a.shape[1:])

    dev = tris.v0.device
    gid = torch.cat([torch.arange(t, dtype=torch.int32, device=dev),
                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    return dict(
        v0=split(tris.v0), e1=split(tris.e1), e2=split(tris.e2),
        n0=split(tris.n0), n1=split(tris.n1), n2=split(tris.n2),
        uv0=split(tris.uv0), uv1=split(tris.uv1), uv2=split(tris.uv2),
        alpha=split(tris.alpha, 1.0), mat=split(tris.mat),
        ltri=split(tris.ltri, -1), lod=split(tris.lod),
        tangent=split(tris.tangent), bitangent=split(tris.bitangent),
        gid=gid.reshape(k, tk))


def _shard_flat(v0, e1, e2):
    """The BVH2 of one shard's triangles (numpy builder), or JAX's one-leaf
    dummy over padding triangle 0 for an empty shard, which must still
    trace (and join every collective)."""
    if v0.shape[0] == 0:
        return dict(nmin=np.zeros((1, 3), np.float32),
                    nmax=np.zeros((1, 3), np.float32),
                    left=np.zeros(1, np.int32), right=np.full(1, -1, np.int32),
                    count=np.ones(1, np.int32), prim=np.zeros(1, np.int32))
    return build_sah_bvh(v0, v0 + e1, v0 + e2, prefer_native=False)


def build_shard_bvh(tris, k: int, shard: int, device=None) -> DeviceBVH:
    """Shard `shard` of k's tree on `device` (the card by default): the
    numpy-built SAH BVH2 over its triangles (the JAX package's topology),
    collapsed and packed into the BVH4 that both kernels walk. Its
    triangle rows cover the padded shard (Tk columns) and its prim ids are
    shard-local."""
    device = resolve_device(device)
    v0, e1, e2 = (a.detach().cpu().numpy().astype(np.float32)
                  for a in (tris.v0, tris.e1, tris.e2))
    t = v0.shape[0]
    tk = -(-t // k)
    lo, hi = shard * tk, min((shard + 1) * tk, t)
    hi = max(hi, lo)
    tri9 = np.zeros((9, tk), np.float32)
    tri9[:, :hi - lo] = np.concatenate([v0[lo:hi].T, e1[lo:hi].T,
                                        e2[lo:hi].T], 0)
    flat = _shard_flat(v0[lo:hi], e1[lo:hi], e2[lo:hi])
    return upload_bvh(pack_flat_tri9(flat, tri9), device)


def build_shard_bvhs(tris, k: int, device=None) -> list:
    """Every shard's tree (build_shard_bvh), one DeviceBVH each."""
    return [build_shard_bvh(tris, k, s, device) for s in range(k)]


def build_shard_cluster_bvh(sh: dict, device=None) -> CL.ClusterBVH:
    """One shard's ClusterBVH on `device` (the card by default), cut from
    the numpy-built SAH BVH2 over its triangles, padding included (sh: its
    [Tk, ...] arrays). Tile ids are shard-local, the reattach target being
    the shard's pack (_shard_pack); the payload's e1 / e2 rows are set to
    the shard's own values (cut_clusters derives them again from v1 - v0,
    not bit for bit), so that the payload equals the pack on hit lanes."""
    device = resolve_device(device)
    host = {k: v.detach().cpu().numpy() for k, v in sh.items()}
    v0, e1, e2 = host["v0"], host["e1"], host["e2"]
    v1, v2 = v0 + e1, v0 + e2
    tri = dict(v0=v0, v1=v1, v2=v2, n0=host["n0"], n1=host["n1"],
               n2=host["n2"], uv0=host["uv0"], uv1=host["uv1"],
               uv2=host["uv2"], alpha=host["alpha"],
               mat=host["mat"].astype(np.int32),
               ltri=host["ltri"].astype(np.int32),
               lod=host["lod"].astype(np.float32), tangent=host["tangent"],
               bitangent=host["bitangent"])
    cb = CL.cut_clusters(build_sah_bvh(v0, v1, v2, prefer_native=False), tri,
                         device="cpu")
    pg = cb.pgeo.numpy().copy()
    valid = cb.prim.numpy() >= 0
    loc = np.where(valid, cb.prim.numpy(), 0)
    for row, arr in ((CL.PAY_E1, e1), (CL.PAY_E2, e2)):
        vals = np.moveaxis(arr[loc], 2, 1)                  # [CT, 3, 128]
        pg[:, row:row + 3] = np.where(valid[:, None], vals,
                                      pg[:, row:row + 3])
    cb = dataclasses.replace(cb, pgeo=torch.from_numpy(pg))
    return dataclasses.replace(
        cb, **{f: getattr(cb, f).to(device)
               for f in ("boxes", "meta", "bmat", "pgeo", "prim")})


def build_shard_cluster_bvhs(sh: dict, device=None) -> list:
    """Every shard's ClusterBVH (build_shard_cluster_bvh) from the stacked
    shard arrays of shard_triangle_arrays."""
    k = sh["v0"].shape[0]
    return [build_shard_cluster_bvh({f: a[s] for f, a in sh.items()},
                                    device) for s in range(k)]


def _shard_pack(sh: dict, mpack22) -> torch.Tensor:
    """[72, Tk]: one column per shard triangle in the cluster payload's
    layout (bvh/clusters.py PAY_*), built differentiably from the shard's
    arrays and the material pack: the reattach_rows target of the kernel's
    payload in the sharded pass."""
    tk = sh["v0"].shape[0]
    dev = sh["v0"].device
    f32 = lambda a: a.to(torch.float32)
    row = lambda a: f32(a)[None]
    pack = torch.cat([
        sh["v0"].T, sh["e1"].T, sh["e2"].T,
        sh["n0"].T, sh["n1"].T, sh["n2"].T,
        sh["uv0"].T, sh["uv1"].T, sh["uv2"].T,
        sh["alpha"].T,
        row(torch.arange(tk, device=dev)),                  # PRIM (local id)
        row(sh["mat"]), row(sh["ltri"]), row(sh["lod"]),
        torch.ones((1, tk), device=dev),                    # VALID slot
        sh["tangent"].T, sh["bitangent"].T,
        torch.zeros((2, tk), device=dev),                   # counter rows
        mpack22[:, sh["mat"].to(torch.int64)]], 0)
    return torch.nn.functional.pad(pack, (0, 0, 0, CL.PAY_ROWS
                                          - pack.shape[0]))


def geometry_pack(sh: dict) -> torch.Tensor:
    """The shard's triangles as the payload's geometry rows [PAY_GEO_ROWS,
    Tk] (render/shading.py PAY_*), one column per triangle."""
    return torch.cat([
        sh["v0"].T, sh["e1"].T, sh["e2"].T,
        sh["n0"].T, sh["n1"].T, sh["n2"].T,
        sh["uv0"].T, sh["uv1"].T, sh["uv2"].T,
        sh["alpha"].T,
        sh["ltri"].to(torch.float32)[None], sh["lod"].to(torch.float32)[None],
        sh["tangent"].T, sh["bitangent"].T], 0)


def _local_payload(sh, prim, mine, mpack22, pack=None):
    """The payload rows [PAY_ROWS, N] of the rays this shard won (`mine`,
    prim = their shard-local triangle), zero elsewhere, so that a sum over
    "scene" assembles every ray's rows. `pack` is geometry_pack(sh), built
    once a pass by the caller. Differentiable: the gathers' backward
    scatter-adds into the shard's arrays and into mpack22."""
    if pack is None:
        pack = geometry_pack(sh)
    p = torch.where(mine, prim, 0).clamp(min=0).to(torch.int64)
    rows = torch.cat([pack[:, p], mpack22[:, sh["mat"][p].to(torch.int64)]],
                     0)
    return torch.where(mine[None], rows, 0.0)


def _shard_intersect(sh, bvh, pack, mpack22, o, d, alive, mesh: Mesh2D):
    """Closest hit across the scene shards: the local trace, the argmin of
    (t, global id) over "scene", the winner's payload and (u, v) summed
    over "scene". Returns (t, prim, u, v, payload) of the winner; prim is
    the global triangle id (-1 = miss), t, u, v the winner's traversal
    values, which the shade stage refines from the payload."""
    tmax = torch.where(alive, BIG_T, 0.0)
    t, prim, u, v = trace_closest(o, d, tmax, bvh)
    gid = sh["gid"][prim.clamp(min=0).to(torch.int64)]
    hit = (prim >= 0) & alive & (t < tmax) & (gid >= 0)
    t_win, prim_g = _win(t, gid, hit, mesh)
    mine = hit & (gid == prim_g)
    uv = torch.stack([torch.where(mine, u, 0.0), torch.where(mine, v, 0.0)])
    out = sum_over(torch.cat([_local_payload(sh, prim, mine, mpack22, pack),
                              uv], 0), mesh, "scene")
    return t_win, prim_g, out[PAY_ROWS], out[PAY_ROWS + 1], out[:PAY_ROWS]


def _shard_occluded(bvh, o, d, tmax, mesh: Mesh2D):
    """Any-hit across the scene shards: the local trace, MAX over "scene"."""
    occ = trace_occluded(o, d, tmax, bvh).to(torch.uint8)
    return reduce_over(occ, mesh, "scene", dist.ReduceOp.MAX) > 0


def _win(t, gid, hit, mesh: Mesh2D):
    """The winner over "scene" of each ray: one MIN of the (t bits, global
    id) key. Returns (t, global id (-1 on a miss))."""
    key = torch.where(
        hit, (t.view(torch.int32).to(torch.int64) << 32) | gid.to(torch.int64),
        _MISS_KEY)
    key = reduce_over(key, mesh, "scene", dist.ReduceOp.MIN)
    t_win = (key >> 32).to(torch.int32).view(torch.float32)
    low = (key & 0xFFFFFFFF).to(torch.int32)
    return t_win, torch.where(low == _MISS_LOW, -1, low)


def _shard_intersect_kernel(sh, cbvh, pay_tiles, pack, config, o, d, alive,
                            mesh: Mesh2D):
    """Closest hit across the scene shards through the cluster kernel: the
    local trace of the shard's ClusterBVH, the winner over "scene" as in
    _shard_intersect, and the owner's kernel payload re-attached to the
    shard's pack, cut to the 63 payload rows and summed over "scene".
    Returns (t, prim, None, None, payload): u and v come from the refine."""
    tmax = torch.where(alive, BIG_T, 0.0)
    perm = inv = None
    if config.ray_sort and cbvh.n_clusters >= 16:
        perm, inv = ray_sort_perm(o, d, tmax, cbvh, key="dir")
    t, prim_l, pay = trace_cluster_bvh(o, d, cbvh, tmax, pay_tiles=pay_tiles,
                                       perm=perm, inv=inv)
    gid = sh["gid"][prim_l.clamp(min=0).to(torch.int64)]
    hit = (prim_l >= 0) & alive & (gid >= 0)
    t_win, prim_g = _win(t, gid, hit, mesh)
    mine = hit & (gid == prim_g)
    rows = reattach_rows(pack, torch.where(mine, prim_l, -1),
                         torch.where(mine[None], pay, 0.0))
    return t_win, prim_g, None, None, sum_over(rows[_CLUSTER_TO_PAY], mesh,
                                                "scene")


def _shard_occluded_kernel(cbvh, config, o, d, tmax, mesh: Mesh2D):
    """Any-hit across the scene shards through the cluster kernel."""
    perm = inv = None
    if config.shadow_sort and cbvh.n_clusters >= 16:
        perm, inv = ray_sort_perm(o, d, tmax, cbvh, key="origin_octant")
    occ = trace_cluster_bvh(o, d, cbvh, tmax, anyhit=True, perm=perm,
                            inv=inv).to(torch.uint8)
    return reduce_over(occ, mesh, "scene", dist.ReduceOp.MAX) > 0


def _strip_scene(scene):
    """The replicated part of the scene: no global triangle arrays and no
    global BVH or cluster tiles (shading reads the assembled payload), so
    that no rank holds the whole scene beside its shard."""
    return dataclasses.replace(scene, tris=None, bvh=None, cbvh=None)


def _use_cluster(scene, config: RenderConfig, shard_cbvh) -> bool:
    """Whether the cluster kernels trace the shards: _pick_intersector's
    choice, a given shard_cbvh standing for the scene's cluster tiles."""
    if shard_cbvh is not None:
        scene = dataclasses.replace(scene, cbvh=shard_cbvh)
    return _pick_intersector(scene, config) == "cluster"


def shard_scene(scene, mesh: Mesh2D, sh=None, shard_bvh=None,
                cluster: bool = False):
    """This rank's inputs of a scene-sharded pass on mesh.device: (the
    stripped replicated scene, its shard's triangle arrays {field: [Tk,
    ...]}, its shard's tree: the BVH4, or with `cluster` the ClusterBVH).
    `sh` / `shard_bvh` given are used as they are; the others are cut and
    built from scene.tris (which may lie on the host: only the shard goes
    to the device), a ClusterBVH from `sh`."""
    k, s = mesh.shape["scene"], mesh.coords[1]
    if scene.tris is None and (sh is None
                               or (shard_bvh is None and not cluster)):
        raise ValueError("a stripped scene needs both sh and shard_bvh")
    if sh is None:
        sh = {f: a[s] for f, a in shard_triangle_arrays(scene.tris,
                                                         k).items()}
    sh = {f: a.to(mesh.device) for f, a in sh.items()}
    if shard_bvh is None:
        shard_bvh = (build_shard_cluster_bvh(sh, mesh.device) if cluster
                     else build_shard_bvh(scene.tris, k, s, mesh.device))
    return _to(_strip_scene(scene), mesh.device), sh, shard_bvh


def render_pass_scene_sharded(scene, view, state: AccumState,
                              config: RenderConfig, mesh: Mesh2D, sh=None,
                              shard_bvh=None, shard_cbvh=None):
    """One progressive pass of the classic executor on a ("rays", "scene")
    mesh, the triangles and their trees split over "scene". The image is
    the replicated render_pass's (the same seeds per global path index), up
    to the winners of exact t-ties. Differentiable with respect to the
    shard's arrays (pass `sh` to optimise them), the materials and the
    lights. `sh` / `shard_bvh` / `shard_cbvh`: this rank's shard
    (shard_scene), cut and built when not given. The cluster kernels trace
    the shard when config.intersector is "cluster" and the scene has
    cluster tiles (or shard_cbvh is given), else the BVH4 kernels. Returns
    (new AccumState, stats), the same on every rank."""
    if config.path_regen:
        raise ValueError("render_pass_scene_sharded runs the classic "
                         "fixed-spp executor; set path_regen=False (the "
                         "regen pool is single-process)")
    _check_config(dataclasses.replace(config, scene_sharded=False))
    n = config.n_paths
    if n % mesh.shape["rays"]:
        raise ValueError(f"n_paths {n} must divide over {mesh.shape['rays']} "
                         "ray shards")
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")
    cluster = _use_cluster(scene, config, shard_cbvh)
    config = dataclasses.replace(config, scene_sharded=True)
    scene_rep, sh, tree = shard_scene(
        scene, mesh, sh, shard_cbvh if cluster else shard_bvh, cluster)
    block = n // mesh.shape["rays"]
    r = mesh.coords[0]
    dev = state.accumulator.device
    path_idx = torch.arange(r * block, (r + 1) * block, dtype=torch.int64,
                            device=dev)
    mpack22 = broadcast_over(material_pack(scene_rep.materials), mesh,
                             "scene")
    if cluster:
        pay_tiles = prepare_pay_tiles(
            tree, bake_material_rows(tree, mpack22.detach()))
        cpack = _shard_pack(sh, mpack22)
        isect = lambda o, d, alive: _shard_intersect_kernel(
            sh, tree, pay_tiles, cpack, config, o, d, alive, mesh)
        occl = lambda o, d, tmax: _shard_occluded_kernel(tree, config, o, d,
                                                         tmax, mesh)
    else:
        pack = geometry_pack(sh)
        isect = lambda o, d, alive: _shard_intersect(
            sh, tree, pack, mpack22, o, d, alive, mesh)
        occl = lambda o, d, tmax: _shard_occluded(tree, o, d, tmax, mesh)
    acc, cam_seed, stats = trace_paths(
        scene_rep, view, config, path_idx, state.sample_count,
        state.cam_seed, intersect_fn=isect, occluded_fn=occl)
    acc = sum_over(acc, mesh, "rays")
    flat = sum_over(torch.cat([stats[k].reshape(-1).to(dev)
                               for k in _STAT_KEYS]), mesh, "rays")
    state = AccumState(
        accumulator=state.accumulator + acc,
        sample_count=state.sample_count + config.spp_per_pass,
        cam_seed=cam_seed)
    telemetry.mark("end", dev)
    return state, unflatten_stats(flat, config.max_path_length)


def train_step_scene_sharded(scene, view, target, config: RenderConfig,
                             mesh: Mesh2D, param_insert, params, sh=None,
                             shard_bvh=None, shard_cbvh=None):
    """One differentiable-rendering step on the 2-D mesh: the mean squared
    error of the sharded image against `target` and its gradient with
    respect to `params` (a tensor or a dict of tensors), summed over
    "rays". param_insert(scene, sh, params) -> (scene, sh) puts them into
    the stripped scene and this rank's shard; a gradient of a per-shard
    parameter is this shard's. Returns (loss, grads) on every rank."""
    cluster = _use_cluster(scene, config, shard_cbvh)
    scene_rep, sh, tree = shard_scene(
        scene, mesh, sh, shard_cbvh if cluster else shard_bvh, cluster)
    names = sorted(params) if isinstance(params, dict) else None
    leaves = [params[k] for k in names] if names is not None else [params]
    leaves = [p.detach().requires_grad_() for p in leaves]
    p = dict(zip(names, leaves)) if names is not None else leaves[0]
    scene_p, sh_p = param_insert(scene_rep, sh, p)
    trees = dict(shard_cbvh=tree) if cluster else dict(shard_bvh=tree)
    state, _ = render_pass_scene_sharded(
        scene_p, view, AccumState.make(config, mesh.device), config, mesh,
        sh=sh_p, **trees)
    img = state.accumulator[:, :3] / float(config.spp_per_pass)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [reduce_over(torch.zeros_like(x) if g is None else g, mesh,
                         "rays", dist.ReduceOp.SUM)
             for x, g in zip(leaves, grads)]
    out = dict(zip(names, grads)) if names is not None else grads[0]
    return loss.detach(), out


def collective_bytes_per_pass(config: RenderConfig, mesh: Mesh2D,
                              live_bounces: int | None = None) -> dict:
    """The bytes one rank hands to the collectives of a forward pass whose
    row ran `live_bounces` bounces with a live lane (max_path_length by
    default), by axis and tensor, from the tensors' shapes: over "scene" a
    bounce the int64 key, the payload with (u, v) (without them on the
    cluster path, config.intersector "cluster") and the uint8 occlusion of
    the rank's n_paths / rays lanes; over "rays" a pass the [W*H, 4] f32
    accumulator and the int32 stats. An axis of one rank moves nothing."""
    n = config.n_paths // mesh.shape["rays"]
    length = config.max_path_length
    bounces = length if live_bounces is None else live_bounces
    rows = PAY_ROWS + (0 if config.intersector == "cluster" else 2)
    bounce = dict(key=8 * n, payload=4 * rows * n, occlusion=n)
    rays = dict(accumulator=config.width * config.height * 4 * 4,
                stats=4 * (2 * length + 3))
    scene_total = bounces * sum(bounce.values())
    return dict(scene=dict(per_bounce=bounce, bounces=bounces,
                           total_bytes=scene_total),
                rays=dict(tensors=rays, total_bytes=sum(rays.values())),
                total_bytes=scene_total + sum(rays.values()),
                payload_rows=PAY_ROWS)
