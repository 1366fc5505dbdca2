"""Shading, texture, BSDF and light sampling of the port against the JAX
package, on the carried-across bathroom(detail=0) with seeded rays.

Both sides get identical numpy inputs (hits from the JAX lockstep trace,
the JAX ShadingData for the BSDF and light tests). Continuous outputs must
agree to rtol 1e-4 / atol 1e-5: the two frameworks round log2, rsqrt,
sqrt, sin and cos differently in the last bit and XLA contracts FMAs.
Discrete choices (picked light, specular flag) must agree on >= 99.9% of
lanes; a lane whose uniform sits within that rounding of a decision
boundary may legitimately flip, and continuous outputs are then compared on
the agreeing lanes only.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.bvh.traverse import bvh_intersect
from lighthouse2_tpu.render import bsdf_lambert as jbsdf
from lighthouse2_tpu.render import lights as jlights
from lighthouse2_tpu.render import shading as jshading
from lighthouse2_tpu.render import textures as jtex
from lighthouse2_tpu.scene import bench_scene as jbench
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.render import bsdf_lambert as tbsdf
from lighthouse2_tpu_torch.render import lights as tlights
from lighthouse2_tpu_torch.render import shading as tshading
from lighthouse2_tpu_torch.render import textures as ttex
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
AGREE = 0.999
N = 4096


def _close(got, want, mask=None, rtol=RTOL, atol=ATOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def scene():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jbench.bathroom(64, 64, detail=0)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    rng = np.random.default_rng(0)
    o = (np.asarray(jview.pos)[None]
         + rng.normal(scale=0.05, size=(N, 3))).astype(np.float32)
    target = rng.uniform([-3, 0, -2.2], [3, 3, 2.2], (N, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t, prim, u, v = (np.array(x) for x in bvh_intersect(
        jnp.asarray(o), jnp.asarray(d), jds.bvh))
    assert (prim >= 0).mean() > 0.95
    return dict(jds=jds, jview=jview, tds=tds, tview=tview, o=o, d=d, t=t,
                prim=prim, u=u, v=v, rng=rng)


def test_fetch_trilinear_matches(scene):
    rng = np.random.default_rng(1)
    tid = rng.integers(-1, 3, N).astype(np.int32)
    uv = rng.uniform(-2, 3, (N, 2)).astype(np.float32)
    lam = rng.uniform(-1, 6, N).astype(np.float32)
    want = jtex.fetch_trilinear(scene["jds"].textures, jnp.asarray(tid),
                                jnp.asarray(uv), jnp.asarray(lam))
    got = ttex.fetch_trilinear(scene["tds"].textures, torch.from_numpy(tid),
                               torch.from_numpy(uv), torch.from_numpy(lam))
    _close(got.numpy(), want)


def _shading(scene):
    s = scene
    args = [s["d"], s["t"], s["prim"], s["u"], s["v"]]
    jsd = jshading.get_shading_data(s["jds"], *map(jnp.asarray, args),
                                    s["jview"].spread_angle)
    tsd = tshading.get_shading_data(s["tds"], *map(torch.from_numpy, args),
                                    s["tview"].spread_angle)
    return jsd, tsd


def test_get_shading_data_matches(scene):
    jsd, tsd = _shading(scene)
    hit = scene["prim"] >= 0
    for f in dataclasses.fields(tshading.ShadingData):
        got = getattr(tsd, f.name)
        got = got.numpy() if got.dtype != torch.bool else got.numpy()
        want = np.asarray(getattr(jsd, f.name))
        if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got[hit], want[hit].astype(got.dtype),
                                          err_msg=f.name)
        else:
            _close(got, want, hit, name=f.name)


def _port_sd(jsd):
    return tshading.ShadingData(**{
        f.name: torch.from_numpy(np.array(getattr(jsd, f.name)))
        for f in dataclasses.fields(tshading.ShadingData)})


def test_bsdf_evaluate_and_sample_match(scene):
    jsd, _ = _shading(scene)
    tsd = _port_sd(jsd)
    rng = np.random.default_rng(2)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = -scene["d"]
    r3, r4 = rng.random((2, N), dtype=np.float32)
    jn, tn = jsd.n_shading, tsd.n_shading
    for a, b in zip(jbsdf.evaluate(jsd, jn, jnp.asarray(wo), jnp.asarray(wi)),
                    tbsdf.evaluate(tsd, tn, torch.from_numpy(wo),
                                   torch.from_numpy(wi))):
        _close(b.numpy(), a)
    js = jbsdf.sample(jsd, jn, jsd.n_geom, jnp.asarray(wo),
                      jnp.asarray(scene["t"]), jnp.asarray(r3), jnp.asarray(r4))
    ts = tbsdf.sample(tsd, tn, tsd.n_geom, torch.from_numpy(wo),
                      torch.from_numpy(scene["t"]), torch.from_numpy(r3),
                      torch.from_numpy(r4))
    same = ts["specular"].numpy() == np.asarray(js["specular"])
    assert same.mean() >= AGREE
    assert 0.01 < np.asarray(js["specular"]).mean() < 0.99
    for k in ("wi", "pdf", "bsdf"):
        _close(ts[k].numpy(), js[k], same, rtol=1e-3, atol=1e-4, name=k)


def test_lights_match(scene):
    jsd, _ = _shading(scene)
    s = scene
    i_pos = (s["o"] + np.where(s["prim"] >= 0, s["t"], 1.0)[:, None]
             * s["d"]).astype(np.float32)
    n = np.array(jsd.n_shading * jsd.face_dir[:, None])
    rng = np.random.default_rng(3)
    r0, r1 = rng.random((2, N), dtype=np.float32)
    jl = jlights.random_point_on_light(s["jds"].lights, jnp.asarray(r0),
                                       jnp.asarray(r1), jnp.asarray(i_pos),
                                       jnp.asarray(n))
    tl = tlights.random_point_on_light(s["tds"].lights, torch.from_numpy(r0),
                                       torch.from_numpy(r1),
                                       torch.from_numpy(i_pos),
                                       torch.from_numpy(n))
    same = tl["ltri"].numpy() == np.asarray(jl["ltri"])
    assert same.mean() >= AGREE
    assert s["tds"].lights.s_spot == 1 and s["tds"].lights.s_point == 1
    for k in ("point", "light_pdf", "pick_prob", "color"):
        _close(tl[k].numpy(), jl[k], same, name=k)

    ltri = rng.integers(0, 4, N).astype(np.int32)
    o = (i_pos + rng.normal(scale=0.5, size=(N, 3))).astype(np.float32)
    want = jlights.light_pick_prob(s["jds"].lights, jnp.asarray(ltri),
                                   jnp.asarray(o), jnp.asarray(n),
                                   jnp.asarray(i_pos))
    got = tlights.light_pick_prob(s["tds"].lights, torch.from_numpy(ltri),
                                  torch.from_numpy(o), torch.from_numpy(n),
                                  torch.from_numpy(i_pos))
    _close(got.numpy(), want)
    _close(tlights.calculate_light_pdf(
        torch.from_numpy(s["d"]), torch.from_numpy(s["t"]),
        torch.from_numpy(np.array(jsd.area)),
        torch.from_numpy(np.array(jsd.n_geom))).numpy(),
        jlights.calculate_light_pdf(jnp.asarray(s["d"]), jnp.asarray(s["t"]),
                                    jsd.area, jsd.n_geom))


def test_directional_light_matches(monkeypatch):
    """The bathroom has no directional light: sample all four types on a
    Cornell box that gets a point, a spot and a directional light."""
    monkeypatch.setenv("LH2_NO_NATIVE", "1")
    host, _ = jpresets.cornell_box(32, 32)
    host.add_point_light([0.3, 1.5, 0.2], [2.0, 2.0, 1.5])
    host.add_spot_light([-0.4, 1.8, 0.0], [3.0, 2.5, 2.0], [0.2, -1.0, 0.1])
    host.add_directional_light([0.3, -1.0, -0.2], [1.5, 1.5, 1.2])
    jds = host.sync(two_level=False)
    jl_scene = jds.lights
    tl_scene = scene_from_numpy(jax_scene_arrays(jds), "cpu")[0].lights
    assert tl_scene.s_dir == 1 and tl_scene.s_spot == 1
    rng = np.random.default_rng(4)
    i_pos = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    r0, r1 = rng.random((2, N), dtype=np.float32)
    jl = jlights.random_point_on_light(jl_scene, *map(jnp.asarray,
                                                      (r0, r1, i_pos, n)))
    tl = tlights.random_point_on_light(tl_scene, *map(torch.from_numpy,
                                                      (r0, r1, i_pos, n)))
    same = tl["ltri"].numpy() == np.asarray(jl["ltri"])
    assert same.mean() >= AGREE
    col = np.asarray(jl["color"])
    for rad in ([2.0, 2.0, 1.5], [3.0, 2.5, 2.0], [1.5, 1.5, 1.2]):
        assert (col == np.float32(rad)).all(-1).any(), rad   # each type picked
    assert (np.asarray(jl["ltri"]) >= 0).any()
    for k in ("point", "light_pdf", "pick_prob", "color"):
        _close(tl[k].numpy(), jl[k], same, name=k)
