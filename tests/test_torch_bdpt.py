"""The port's bidirectional path tracer (render/bdpt.py, the emission
sampling of render/lights.py and the "bdpt" core) against the JAX package.

  1. sample_emission and emission_pick_prob against JAX's, eagerly, on
     seeded light tables built from the same numpy arrays on both sides:
     the bathroom's counts (4 area triangles + 1 point light): every pick
     equal, every float within rtol 1e-6 (atol 1e-7 for components near
     0, where XLA and ATen may round sin / cos a last bit apart); 1,000
     emissive triangles + 8 point lights: picks equal on >= 99.9% of lanes
     (the two cumsums of 1,008 energies may add in another order, which
     moves a pick that sits on a CDF step), the floats as above on those
     lanes;
  2. the MIS chains on the three synthetic paths of tests/test_bdpt.py
     (t=3, t=4, delta gating): _eye_ratio_chain / _light_ratio_chain
     equal JAX's values and the closed-form balance weights within rtol
     1e-6, and the weights of each family sum to 1;
  3. _f_pdf for Lambert and Disney against JAX's on the seeded shading
     batch of tests/test_torch_disney.py, in float64 on both sides (the
     same formulas; in float32 the near-delta lobes move either package by
     1e-4): rtol 1e-5, atol 1e-12;
  4. one BDPT pass against JAX's render_pass_bdpt_jit, compiled once at
     XLA's optimisation level 0 (the file's one compile): a 16x16 Cornell
     box carried across as numpy arrays, spp 2, path 3, use_bvh=False on
     both sides, Lambert, clamp and roulette off as BDPTCore sets them, the
     same sample_base and cam_seed: >= 99% of accumulator pixels within
     rtol 1e-3 / atol 1e-4 (as tests/test_torch_classic.py: XLA and torch
     round transcendentals differently and one flipped decision changes a
     lane), the stats' keys, dtypes and values equal, cam_seed equal; and
     create_core("bdpt") on the CPU renders the image render_pass_bdpt
     gives;
  5. the port alone: the BVH path (the trace kernels' plain BVH4 walk on
     the CPU) equals the brute-force path on >= 99.9% of pixels (rtol
     1e-3 / atol 1e-4; a t-tie may flip a lane); the JAX module's
     debugging variables BDPT_T1_SCALE=0 and BDPT_NO_T1_CHAINS=1, set in
     the environment before the port's module is imported anew, leave the
     image bit for bit as it was (the port reads neither); a Disney BDPT
     pass is finite.
"""
import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import bdpt as jbdpt
from lighthouse2_tpu.render import bsdf_disney as jdisney
from lighthouse2_tpu.render import bsdf_lambert as jlambert
from lighthouse2_tpu.render import lights as jlights
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.render.shading import ShadingData as JSD
from lighthouse2_tpu.scene import device_scene as jdevice
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import bdpt as tbdpt
from lighthouse2_tpu_torch.render import bsdf_disney as tdisney
from lighthouse2_tpu_torch.render import bsdf_lambert as tlambert
from lighthouse2_tpu_torch.render import lights as tlights
from lighthouse2_tpu_torch.render.cores.base import create_core
from lighthouse2_tpu_torch.render.shading import ShadingData as TSD
from lighthouse2_tpu_torch.render.wavefront import AccumState, finalize
from lighthouse2_tpu_torch.scene import device_scene as tdevice
from test_torch_disney import _batch, _f64
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE, SPP, PATH = 16, 2, 3
N_LANES = 4096
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
FLOAT_KEYS = ("origin", "dir", "normal", "radiance", "pdf_pos", "pdf_dir",
              "pick_prob")


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _light_tables(rng, n_tri, n_point):
    """Area triangles and point lights as both packages' light tables."""
    v0 = rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    v1 = (v0 + rng.uniform(-0.5, 0.5, (n_tri, 3))).astype(np.float32)
    v2 = (v0 + rng.uniform(-0.5, 0.5, (n_tri, 3))).astype(np.float32)
    cr = np.cross(v1 - v0, v2 - v0)
    rad = rng.uniform(0.5, 20.0, (n_tri, 3)).astype(np.float32)
    tri = dict(v0=v0, v1=v1, v2=v2, centre=(v0 + v1 + v2) / 3, N=_unit(cr),
               radiance=rad,
               area=(0.5 * np.linalg.norm(cr, axis=-1)).astype(np.float32),
               energy=rad.sum(-1), prim=np.arange(n_tri, dtype=np.int32))
    points = [types.SimpleNamespace(
        position=rng.uniform(-2, 2, 3).astype(np.float32),
        radiance=rng.uniform(1.0, 40.0, 3).astype(np.float32))
        for _ in range(n_point)]
    jl = jdevice.build_lights_np(tri, points, [], [])
    tl = tdevice.to_device(tdevice.DeviceLights,
                           tdevice.build_lights_np(tri, points, [], []), "cpu")
    return jl, tl


def test_sample_emission_matches_jax():
    rng = np.random.default_rng(7)
    for n_tri, n_point, picks_min in ((4, 1, 1.0), (1000, 8, 0.999)):
        jl, tl = _light_tables(rng, n_tri, n_point)
        r = rng.uniform(0.0, 1.0, (4, N_LANES)).astype(np.float32)
        je = {k: np.asarray(v) for k, v in jlights.sample_emission(
            jl, *map(jnp.asarray, r)).items()}
        te = {k: v.numpy() for k, v in tlights.sample_emission(
            tl, *map(torch.from_numpy, r)).items()}
        assert set(te) == set(je)
        same = (te["ltri"] == je["ltri"]) & (te["delta_pos"] == je["delta_pos"])
        assert same.mean() >= picks_min, (n_tri, same.mean())
        assert 0 < je["delta_pos"].mean() < 1
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(te[k][same], je[k][same], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        ltri = np.concatenate([je["ltri"], [-1, 0, n_tri - 1]]).astype(
            np.int32)
        np.testing.assert_allclose(
            tlights.emission_pick_prob(tl, torch.from_numpy(ltri)).numpy(),
            np.asarray(jlights.emission_pick_prob(jl, jnp.asarray(ltri))),
            rtol=1e-6)


def _vert(xp, pdf_fwd, pdf_rev_prev=0.0, delta=False):
    return dict(pdf_fwd=xp.asarray([pdf_fwd], dtype=xp.float32),
                pdf_rev_prev=xp.asarray([pdf_rev_prev], dtype=xp.float32),
                delta=xp.asarray([delta]))


def _chain_weights(mod, xp):
    """The balance weights of tests/test_bdpt.py's three synthetic paths
    through one package's chain functions."""
    eye, light = mod._eye_ratio_chain, mod._light_ratio_chain
    a = lambda x: xp.asarray([x], dtype=xp.float32)
    z = a(0.0)
    nd = xp.asarray([False])
    out = {}
    # t=3: camera -> z1 -> light; strategies (0,3), (1,2), (2,1)
    p_c, p_z2, q_y0, q_y1 = 0.60, 0.37, 1.84, 0.90
    w_a = 1.0 / (1.0 + eye([_vert(xp, p_c), _vert(xp, p_z2)], 1, a(q_y0),
                           a(q_y1), 5, 0))
    y0 = _vert(xp, q_y0)
    w_b = 1.0 / (1.0 + eye([_vert(xp, p_c)], 0, a(q_y1), z, 5, 1)
                 + light([y0], 1, a(p_z2), z, t=2, max_eye=5, delta_light=nd))
    w_c = 1.0 / (1.0 + light([y0, _vert(xp, q_y1)], 2, a(p_c), a(p_z2), t=1,
                             max_eye=5, delta_light=nd))
    out["t3"] = [w_a, w_b, w_c]
    # t=4: camera -> z1 -> z2 -> light; (0,4), (1,3), (2,2), (3,1)
    p_c, p_z2, p_z3 = 0.60, 0.9, 0.21
    q_y0, q_y1, q_y2 = 1.3, 0.47, 0.8
    ev = [_vert(xp, p_c), _vert(xp, p_z2, q_y2), _vert(xp, p_z3)]
    y0, y1 = _vert(xp, q_y0), _vert(xp, q_y1)
    w_a = 1.0 / (1.0 + eye(ev, 2, a(q_y0), a(q_y1), 5, 0))
    w_b = 1.0 / (1.0 + eye(ev[:2], 1, a(q_y1), a(q_y2), 5, 1)
                 + light([y0], 1, a(p_z3), z, t=3, max_eye=5, delta_light=nd))
    w_c = 1.0 / (1.0 + eye(ev[:1], 0, a(q_y2), z, 5, 2)
                 + light([y0, y1], 2, a(p_z2), a(p_z3), t=2, max_eye=5,
                         delta_light=nd))
    w_d = 1.0 / (1.0 + light([y0, _vert(xp, q_y1, p_z3), _vert(xp, q_y2)], 3,
                             a(p_c), a(p_z2), t=1, max_eye=5, delta_light=nd))
    out["t4"] = [w_a, w_b, w_c, w_d]
    # a delta z2 gates (1,2) out; (2,1) survives; max_light=1 gates both
    ev = [_vert(xp, 0.5), _vert(xp, 0.5, delta=True)]
    out["delta"] = [eye(ev, 1, a(2.0), a(1.0), 5, 0),
                    eye(ev, 1, a(2.0), a(1.0), 1, 0)]
    return {k: [np.asarray(w, np.float64) for w in v] for k, v in out.items()}


def test_mis_chains_match_jax_and_the_balance_heuristic():
    jw = _chain_weights(jbdpt, jnp)
    tw = _chain_weights(tbdpt, torch)
    for k in jw:
        for got, want in zip(tw[k], jw[k]):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=k)
    for k in ("t3", "t4"):
        np.testing.assert_allclose(sum(tw[k]), 1.0, rtol=1e-6, err_msg=k)
    p_c, p_z2, q_y0, q_y1 = 0.60, 0.37, 1.84, 0.90
    p = [p_c * p_z2, p_c * q_y0, q_y0 * q_y1]
    np.testing.assert_allclose(tw["t3"], np.array(p)[:, None] / sum(p),
                               rtol=1e-6)
    p_c, p_z2, p_z3, q_y0, q_y1, q_y2 = 0.60, 0.9, 0.21, 1.3, 0.47, 0.8
    p = [p_c * p_z2 * p_z3, p_c * p_z2 * q_y0, p_c * q_y0 * q_y1,
         q_y0 * q_y1 * q_y2]
    np.testing.assert_allclose(tw["t4"], np.array(p)[:, None] / sum(p),
                               rtol=1e-6)
    np.testing.assert_allclose(tw["delta"][0], 2.0 * 1.0 / (0.5 * 0.5),
                               rtol=1e-6)
    np.testing.assert_allclose(tw["delta"][1], 0.0)


def test_f_pdf_matches_jax():
    sd, ex = _batch(3)
    sd, ex = _f64(sd), _f64(ex)
    tsd = TSD(**{k: torch.from_numpy(v) for k, v in sd.items()})
    wo, wi = torch.from_numpy(ex["wo"]), torch.from_numpy(ex["wi"])
    for bsdf, jmod, tmod in (("lambert", jlambert, tlambert),
                             ("disney", jdisney, tdisney)):
        with jax.enable_x64(True):
            jsd = JSD(**{k: jnp.asarray(v) for k, v in sd.items()})
            jf, jp = jbdpt._f_pdf(jmod, JConfig(bsdf=bsdf), jsd,
                                  jnp.asarray(ex["wo"]), jnp.asarray(ex["wi"]))
            jf, jp = np.asarray(jf), np.asarray(jp)
        tf, tp = tbdpt._f_pdf(tmod, RenderConfig(bsdf=bsdf), tsd, wo, wi)
        assert tf.dtype == torch.float64 and np.abs(jp).max() > 0
        np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5, atol=1e-12,
                                   err_msg=bsdf)
        np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-5, atol=1e-12,
                                   err_msg=bsdf)


def _config(cls, **kw):
    return cls(width=SIZE, height=SIZE, spp_per_pass=SPP, max_path_length=PATH,
               use_bvh=False, clamp_fireflies=False, russian_roulette=False,
               **kw)


@pytest.fixture(scope="module")
def cornell():
    """JAX's Cornell box (single-level numpy tree) and the port's copy."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    return dict(jds=jds, jview=jview, tds=tds, tview=tview)


def _pass(c, cfg, **kw):
    state, stats = tbdpt.render_pass_bdpt(
        c["tds"], c["tview"], AccumState.make(cfg, "cpu"), cfg, **kw)
    return state, stats


def test_bdpt_pass_matches_jax(cornell):
    c = cornell
    jcfg = _config(JConfig)
    jstate = jwf.AccumState.make(jcfg)
    step = jbdpt.render_pass_bdpt_jit.lower(
        c["jds"], c["jview"], jstate, config=jcfg).compile(
            compiler_options=FAST_COMPILE)
    jstate, jstats = step(c["jds"], c["jview"], jstate)
    cfg = _config(RenderConfig)
    state, stats = _pass(c, cfg)

    ja, ta = np.asarray(jstate.accumulator), state.accumulator.numpy()
    close = np.isclose(ta, ja, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert np.isfinite(ta).all() and ta[:, :3].mean() > 0
    assert state.sample_count == int(jstate.sample_count) == SPP
    assert state.cam_seed == int(jstate.cam_seed)
    assert set(stats) == set(jstats)
    for k, v in stats.items():
        jv = np.asarray(jstats[k])
        assert v.dtype == torch.int32 and jv.dtype == np.int32, k
        assert v.numpy().tolist() == jv.tolist(), k
    assert stats["extension_rays"].shape == (PATH,)

    core = create_core("bdpt", dataclasses.replace(
        cfg, clamp_fireflies=True, russian_roulette=True))
    core.render(c["tds"], c["tview"])
    assert core.stats["spp"] == SPP
    assert core.stats["total_rays"] == int(stats["total_extension"]) + int(
        stats["total_shadow"])
    np.testing.assert_array_equal(
        core.get_image(), finalize(state).numpy().reshape(SIZE, SIZE, 3))


def test_bdpt_port_paths_and_knobs(cornell, monkeypatch):
    c = cornell
    cfg = _config(RenderConfig)
    base = finalize(_pass(c, cfg)[0]).numpy()
    bvh = finalize(_pass(c, dataclasses.replace(cfg, use_bvh=True))[0]).numpy()
    close = np.isclose(bvh, base, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.999, close.mean()

    monkeypatch.setenv("BDPT_T1_SCALE", "0")
    monkeypatch.setenv("BDPT_NO_T1_CHAINS", "1")
    importlib.reload(tbdpt)
    np.testing.assert_array_equal(finalize(_pass(c, cfg)[0]).numpy(), base)

    disney = finalize(_pass(c, dataclasses.replace(cfg, bsdf="disney"))[0])
    assert torch.isfinite(disney).all() and disney.mean() > 0
