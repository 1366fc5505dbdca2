"""The port's two-level tree and native builder against the JAX package's.

HostScene.sync in lighthouse2_tpu_torch now builds the JAX package's
default tree: per-mesh BLASes from the native C++ SAH builder, cached, and
composed under a TLAS (bvh/tlas.py). Checked here, all on the CPU:
  - compose_two_level equals the JAX one array for array (exact) on random
    meshes instanced under random rotations, scales and translations;
  - the port's native builder (its own copy of bvh_builder.cpp, built into
    build/lighthouse2_tpu_torch/) equals lighthouse2_tpu.native's on one
    machine, array for array (exact), on the bathroom(detail=0) triangles;
  - the port's default sync("cpu") uploads every array (triangles,
    materials, lights, sky, textures and the composed BVH2) equal to the
    JAX package's default sync() (two-level, native), on cornell and
    bathroom(detail=0);
  - the plain BVH2 and BVH4 walks on a composed tree against brute force:
    t equal exactly, prim equal wherever the nearest t is unique;
  - a native build that fails raises RuntimeError with the cause (here a
    compiler that does not exist), and nothing falls back to numpy.
No JAX render is compiled.
"""
import jax  # noqa: F401  (both frameworks share the process, as in every test_torch_* file)
import numpy as np
import pytest
import torch

from lighthouse2_tpu import native as jnative
from lighthouse2_tpu.bvh import tlas as jtlas
from lighthouse2_tpu.scene import bench_scene as jbench
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch import native as tnative
from lighthouse2_tpu_torch.bvh import tlas as ttlas
from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh, build_sah_bvh_numpy
from lighthouse2_tpu_torch.bvh.traverse import bvh_intersect, device_bvh_from_flat
from lighthouse2_tpu_torch.bvh.wide import check_depth4, wide_intersect
from lighthouse2_tpu_torch.core.geometry import BIG_T, mt_comp
from lighthouse2_tpu_torch.scene import bench_scene as tbench
from lighthouse2_tpu_torch.scene import presets as tpresets
from test_torch_scene import assert_scene_equal, jax_scene_arrays

torch.set_num_threads(1)

FLAT_KEYS = ("nmin", "nmax", "left", "right", "count", "prim", "n_nodes",
             "n_prims")


def _assert_flat_equal(got, want):
    for k in FLAT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k


def _random_instances(seed=0, n_mesh=4, n_inst=7):
    """(entries for compose_two_level, world v0, v1, v2): random triangle
    soups, each instanced under a random rotation, scale and translation."""
    rng = np.random.default_rng(seed)
    meshes = []
    for m in range(n_mesh):
        c = rng.uniform(-1, 1, (20 + 15 * m, 3))
        meshes.append([(c + rng.uniform(-0.2, 0.2, c.shape)).astype(np.float32)
                       for _ in range(3)])
    entries, world, off = [], [[], [], []], 0
    for i in range(n_inst):
        mi = i % n_mesh
        q = rng.normal(size=4)
        x, y, z, w = q / np.linalg.norm(q)
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        mat = np.eye(4, dtype=np.float32)
        mat[:3, :3] = r * rng.uniform(0.5, 1.5)
        mat[:3, 3] = rng.uniform(-4, 4, 3)
        blas = build_sah_bvh_numpy(*meshes[mi])
        entries.append((blas, mat, off))
        for k in range(3):
            world[k].append(meshes[mi][k] @ mat[:3, :3].T + mat[:3, 3])
        off += meshes[mi][0].shape[0]
    return entries, [np.concatenate(w).astype(np.float32) for w in world]


def test_compose_two_level_equals_jax():
    entries, _ = _random_instances()
    got = ttlas.compose_two_level(entries)
    _assert_flat_equal(got, jtlas.compose_two_level(entries))
    bmin, bmax = entries[0][0]["nmin"], entries[0][0]["nmax"]
    for g, w in zip(ttlas.transform_aabbs(bmin, bmax, entries[3][1]),
                    jtlas.transform_aabbs(bmin, bmax, entries[3][1])):
        np.testing.assert_array_equal(g, w)


def test_native_builder_equals_jax():
    host, _ = tbench.bathroom(32, 32, detail=0)
    w = host.world_arrays(rebuild_bvh=False)["world"]
    want = jnative.build_sah_bvh_native(w["v0"], w["v1"], w["v2"])
    assert want is not None, "the JAX package could not build its native builder"
    got = tnative.build_sah_bvh_native(w["v0"], w["v1"], w["v2"])
    _assert_flat_equal(got, want)
    _assert_flat_equal(build_sah_bvh(w["v0"], w["v1"], w["v2"]), want)
    assert got["n_prims"] == w["v0"].shape[0] > 5000


def test_default_sync_equals_jax_default():
    """Cornell and bathroom(detail=0): every uploaded array equal, the
    composed BVH2 included; the BVH4 depth fits the kernels' stack."""
    for jbuild, tbuild, kw in ((jpresets.cornell_box, tpresets.cornell_box, {}),
                               (jbench.bathroom, tbench.bathroom,
                                dict(detail=0))):
        jhost, _ = jbuild(32, 32, **kw)
        thost, _ = tbuild(32, 32, **kw)
        jds = jhost.sync()
        ds = thost.sync("cpu")
        assert assert_scene_equal(ds, jax_scene_arrays(jds)) >= 70
        assert thost.build_stats == jhost.build_stats
        assert thost.build_stats["tlas_composes"] == 1
        check_depth4(ds.bvh.depth4)


def test_walks_on_the_composed_tree_match_brute_force():
    entries, (w0, w1, w2) = _random_instances(seed=1)
    flat = ttlas.compose_two_level(entries)
    bvh = device_bvh_from_flat(flat, w0, w1, w2, device="cpu")
    # rays from a shell around the scene towards random triangles' centroids
    rng = np.random.default_rng(5)
    o = rng.normal(size=(512, 3))
    o = 10 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    pick = rng.integers(0, w0.shape[0], 512)
    d = (w0[pick] + w1[pick] + w2[pick]) / 3 + rng.normal(0, 0.02, (512, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    g = bvh.tri9
    t_all, _, _, _ = mt_comp(*(o[:, i:i + 1] for i in range(3)),
                             *(d[:, i:i + 1] for i in range(3)),
                             *(g[i][None] for i in range(9)), 1e-6, BIG_T)
    t_bf, p_bf = t_all.min(1)
    unique = (t_all == t_bf[:, None]).sum(1) == 1
    hit = t_bf < BIG_T
    assert hit.sum() > 100 and unique[hit].float().mean() > 0.9
    for walk in (bvh_intersect, wide_intersect):
        t, p, _, _ = walk(o, d, bvh)
        assert torch.equal(t, t_bf), walk.__name__
        assert torch.equal(torch.where(hit, p, -1)[unique],
                           torch.where(hit, p_bf, -1)[unique]), walk.__name__
        assert (p[~hit] == -1).all()


def test_failed_native_build_raises():
    v = np.zeros((1, 3), np.float32)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.build_library(compiler="no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.build_sah_bvh_native(v, v, v, compiler="no-such-compiler")
