"""The port's copy of the pathfinding modules against the JAX package's.

Both are numpy, so every comparison is exact (array for array, float for
float) on the same inputs:
  - the navmesh of tests/test_pathfinding.py's obstacle scene, of a
    down-facing floor (no walkable cell) and of the Cornell box built from
    each package's HostScene (the shader's input path);
  - find_path, raw A* and string-pulled, and raycast on the obstacle mesh,
    with NoPathError between two islands;
  - agent trajectories: three agents steered for 60 ticks, every position
    and velocity of every tick;
  - NavMeshShader's meshes (navmesh tiles, path ribbon, agent box) added to
    each package's HostScene: every mesh array and material colour;
  - io: a navmesh saved by one package and loaded by the other.
"""
import numpy as np
import pytest
import torch

from lighthouse2_tpu import pathfinding as jpf
from lighthouse2_tpu.pathfinding.navigator import NoPathError as JNoPath
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu.scene.host_scene import HostScene as JScene
from lighthouse2_tpu_torch import pathfinding as tpf
from lighthouse2_tpu_torch.pathfinding.navigator import NoPathError as TNoPath
from lighthouse2_tpu_torch.scene import presets as tpresets
from lighthouse2_tpu_torch.scene.host_scene import HostScene as TScene

torch.set_num_threads(1)

NAV_FIELDS = ("origin", "walkable", "floor", "region")


def _obstacle_tris():
    """tests/test_pathfinding.py: 10x10 ground, a 3-high wall from x = -5
    to 3 across the middle (the gap is at x > 3)."""
    s = 5.0
    ground = np.array([[[-s, 0, -s], [s, 0, s], [s, 0, -s]],
                       [[-s, 0, -s], [-s, 0, s], [s, 0, s]]], np.float32)
    wall = jpf.shader._box_tris(np.array([-5.0, 0.0, -0.4], np.float32),
                                np.array([3.0, 3.0, 0.4], np.float32))
    return np.concatenate([ground, wall], 0)


def _cfg(pf):
    return pf.NavMeshConfig(cell_size=0.2, agent_radius=0.3,
                            agent_max_climb=0.3, min_region_area=0.2)


@pytest.fixture(scope="module")
def meshes():
    tris = _obstacle_tris()
    return (jpf.NavMeshBuilder(_cfg(jpf)).build(tris),
            tpf.NavMeshBuilder(_cfg(tpf)).build(tris))


def assert_navmesh_equal(t, j):
    for f in NAV_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert t.n_regions == j.n_regions
    assert vars(t.config) == vars(j.config)


def test_navmesh_matches_jax(meshes):
    jnm, tnm = meshes
    assert_navmesh_equal(tnm, jnm)
    assert tnm.walkable.sum() > 100 and tnm.n_regions >= 1
    s = 5.0
    down = np.array([[[-s, 0, -s], [s, 0, -s], [s, 0, s]],
                     [[-s, 0, -s], [s, 0, s], [-s, 0, s]]], np.float32)
    cfg = dict(cell_size=0.2)
    tdown = tpf.NavMeshBuilder(tpf.NavMeshConfig(**cfg)).build(down)
    assert_navmesh_equal(tdown, jpf.NavMeshBuilder(
        jpf.NavMeshConfig(**cfg)).build(down))
    assert tdown.walkable.sum() == 0
    # from each package's own Cornell HostScene (the ai debugger's input)
    jhost, _ = jpresets.cornell_box(16, 16)
    thost, _ = tpresets.cornell_box(16, 16)
    kw = dict(cell_size=0.1, agent_height=1.0, agent_radius=0.2,
              agent_max_climb=0.35)
    jc = jpf.NavMeshBuilder(jpf.NavMeshConfig(**kw)).build_from_scene(jhost)
    tc = tpf.NavMeshBuilder(tpf.NavMeshConfig(**kw)).build_from_scene(thost)
    assert_navmesh_equal(tc, jc)
    assert tc.walkable.sum() > 100


def test_find_path_matches_jax(meshes):
    jnav, tnav = (pf.NavMeshNavigator(nm) for pf, nm in zip((jpf, tpf),
                                                              meshes))
    for start, goal in (((-3.0, 0, -3.0), (-3.0, 0, 3.0)),
                        ((4.0, 0, -4.0), (-4.0, 0, 4.0)),
                        ((0.1, 0, -2.0), (0.3, 0, -1.0))):
        for smooth in (False, True):
            tp = tnav.find_path(start, goal, smooth=smooth)
            jp = jnav.find_path(start, goal, smooth=smooth)
            np.testing.assert_array_equal(tp, jp)
        assert tp.dtype == jp.dtype and len(tp) >= 2
        th, tpt = tnav.raycast(start, goal)
        jh, jpt = jnav.raycast(start, goal)
        assert th == jh
        np.testing.assert_array_equal(tpt, jpt)
    # two islands: no path on either side
    tris = np.concatenate([
        _obstacle_tris()[:2] * np.float32(0.4),
        jpf.shader._box_tris(np.array([8, 0, -2], np.float32),
                             np.array([12, 0.01, 2], np.float32))], 0)
    for pf, err in ((jpf, JNoPath), (tpf, TNoPath)):
        nm = pf.NavMeshBuilder(pf.NavMeshConfig(
            cell_size=0.2, agent_radius=0.2, min_region_area=0.1)).build(tris)
        with pytest.raises(err):
            pf.NavMeshNavigator(nm).find_path((0, 0, 0), (10.0, 0, 0))


def test_agent_trajectories_match_jax(meshes):
    runs = []
    for pf, nm in zip((jpf, tpf), meshes):
        agents = pf.NavMeshAgents(pf.NavMeshNavigator(nm), max_agents=4)
        a = agents.add_agent((-3.0, 0, -3.0))
        b = agents.add_agent((4.0, 0, -4.0))
        c = agents.add_agent((0.0, 0, 3.0))
        assert a.set_target((-3.0, 0, 3.0)) and b.set_target((-4.0, 0, 4.0))
        track = []
        for step in range(60):
            if step == 20:
                c.set_target((4.0, 0, 4.0))
            if step == 40:
                agents.remove_agent(b)
            agents.update(0.1)
            track.append([np.concatenate([x.position, x.velocity])
                          for x in (a, b, c)] + [[x.arrived for x in (a, c)]])
        runs.append(track)
    for j, t in zip(*runs):
        for x, y in zip(j, t):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert runs[1][-1][-1][0]           # agent a arrived


def test_shader_meshes_match_jax(meshes):
    out = []
    for pf, scene, nm in ((jpf, JScene(), meshes[0]),
                          (tpf, TScene(), meshes[1])):
        shader = pf.NavMeshShader(scene)
        n = shader.add_navmesh(nm)
        path = pf.NavMeshNavigator(nm).find_path((-3.0, 0, -3.0),
                                                 (-3.0, 0, 3.0))
        shader.add_path(path)
        shader.add_agent((-3.0, 0, -3.0))
        assert n >= 1 and len(shader._node_ids) == n + 2
        out.append((scene, list(shader._node_ids)))
        shader.clear()
        assert shader._node_ids == []
    (js, jids), (ts, tids) = out
    assert jids == tids and len(ts.meshes) == len(js.meshes)
    for tm, jm in zip(ts.meshes, js.meshes):
        for f in ("v0", "v1", "v2", "n0", "n1", "n2", "face_n", "mat"):
            np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                          err_msg=f)
    np.testing.assert_array_equal(
        np.stack([m.color for m in ts.materials]),
        np.stack([m.color for m in js.materials]))


def test_navmesh_io_across_packages(tmp_path, meshes):
    jnm, tnm = meshes
    jpf.save_navmesh(tmp_path / "j.npz", jnm)
    tpf.save_navmesh(tmp_path / "t.npz", tnm)
    assert_navmesh_equal(tpf.load_navmesh(tmp_path / "j.npz"), jnm)
    assert_navmesh_equal(jpf.load_navmesh(tmp_path / "t.npz"), tnm)
    back = tpf.load_navmesh(tmp_path / "t.npz")
    path = tpf.NavMeshNavigator(back).find_path((-3.0, 0, -3.0),
                                                (-3.0, 0, 3.0))
    assert path[:, 0].max() > 2.5
