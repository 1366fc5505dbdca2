"""The port's wavefront renderer against the JAX package.

  - generate_eye_rays, lane by lane (rtol 1e-5 / atol 1e-6: sin, cos, atan2
    and rsqrt round differently in the last bit);
  - the slice as a whole: two regen passes on a 32x32 Cornell box, path 4,
    through the port's render_pass_regen on the CPU (the trace kernels'
    plain versions) and the JAX package's with intersector="lockstep" (its
    plain reference for the trace kernels, shading through the same gather
    path; run once, a module fixture), on the same carried-across scene
    and view; the stats carry JAX's keys, dtypes and shapes (primary_rays =
    samples_completed, int32), and the completed samples total the
    per-pixel counts;
  - render_pass_auto(path_regen=True) and _render_pass_regen_jit against
    the same JAX passes, and bit for bit against render_pass_regen (they
    run the same code);
  - the executors reject what the port does not implement (filter_enabled
    with path_regen, as JAX asserts; scene_sharded, which is
    parallel/scene_shard.py's pass).
Per-pixel accumulators are compared as the fraction of pixels within
rtol 1e-3 / atol 1e-4, required >= 99%: XLA and torch round transcendentals
differently, and one flipped Russian-roulette or BSDF decision legitimately
changes a whole lane from then on. A global max would fail on such a lane.
The image mean must agree within 1e-3 relative, and the per-pixel sample
counts and ray totals may differ only on the pixels counted as differing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import wavefront as twf
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

PIXELS_CLOSE = 0.99
MEAN_RTOL = 1e-3


@pytest.fixture(scope="module")
def cornell():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(32, 32)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    return jds, jview, tds, tview


@pytest.mark.parametrize("w,h,lens", [(64, 64, False), (40, 24, True)])
def test_generate_eye_rays_per_lane(cornell, w, h, lens):
    _, jview, _, tview = cornell
    if lens:      # aperture and barrel distortion on, not tile-ordered
        jview = jview.replace(aperture=jnp.float32(0.05),
                              distortion=jnp.float32(0.1))
        tview = dataclasses.replace(tview, aperture=torch.tensor(0.05),
                                    distortion=torch.tensor(0.1))
    jcfg = JConfig(width=w, height=h, spp_per_pass=2)
    tcfg = RenderConfig(width=w, height=h, spp_per_pass=2)
    sample = np.random.default_rng(0).integers(0, 600, jcfg.n_paths)
    want = jwf.generate_eye_rays(jview, jcfg, 0,
                                 sample_idx=jnp.asarray(sample, jnp.uint32))
    got = twf.generate_eye_rays(tview, tcfg, 0,
                                sample_idx=torch.from_numpy(sample))
    for k in ("path_idx", "pixel", "sample"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k]).astype(np.int64),
                                      err_msg=k)
    for k in ("origin", "dir"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("throughput", "bsdf_pdf", "prev_specular", "n_diffuse", "alive"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


REGEN_CFG = RenderConfig(width=32, height=32, max_path_length=4,
                         path_regen=True)


@pytest.fixture(scope="module")
def jax_regen(cornell):
    """Two passes of JAX's render_pass_regen: (final state, stats)."""
    jds, jview, _, _ = cornell
    jcfg = JConfig(width=32, height=32, max_path_length=4, path_regen=True,
                   intersector="lockstep")
    jstate, jstats = jwf.AccumState.make(jcfg), []
    for _ in range(2):
        jstate, js = jwf.render_pass_regen(jds, jview, jstate, jcfg)
        jstats.append(js)
    jax.block_until_ready(jstate.accumulator)
    return jstate, jstats


def _assert_regen_matches_jax(tstate, jstate):
    """The bounds of the module docstring on the final states."""
    assert tstate.sample_count == 2 and tstate.cam_seed == int(jstate.cam_seed)
    ja, ta = np.asarray(jstate.accumulator), tstate.accumulator.numpy()
    close = np.isclose(ta, ja, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= PIXELS_CLOSE, close.mean()
    jc, tc = np.asarray(jstate.pixel_count), tstate.pixel_count.numpy()
    assert ((jc != tc) <= ~close).all()
    ji = np.asarray(jwf.finalize(jstate))
    ti = twf.finalize(tstate).numpy()
    assert np.isfinite(ti).all() and ti.mean() > 0
    assert abs(ti.mean() - ji.mean()) <= MEAN_RTOL * abs(ji.mean())
    return close


def test_regen_slice_matches_jax_lockstep(cornell, jax_regen):
    _, _, tds, tview = cornell
    tcfg = REGEN_CFG
    jstate, jstats = jax_regen
    tstate = twf.AccumState.make(tcfg, "cpu")
    jtot = np.zeros(2, np.int64)
    ttot = np.zeros(2, np.int64)
    jdone = tdone = 0
    for js in jstats:
        tstate, ts = twf.render_pass_regen(tds, tview, tstate, tcfg)
        jtot += [int(js["total_extension"]), int(js["total_shadow"])]
        ttot += [int(ts["total_extension"]), int(ts["total_shadow"])]
        # the stats carry JAX's keys with JAX's dtypes (int32 scalars for
        # primary_rays = samples_completed, the samples completed)
        assert sorted(ts) == sorted(js)
        for k in js:
            assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), k
            assert tuple(ts[k].shape) == js[k].shape, k
        assert int(ts["primary_rays"]) == int(ts["samples_completed"])
        jdone += int(js["samples_completed"])
        tdone += int(ts["samples_completed"])
    close = _assert_regen_matches_jax(tstate, jstate)
    n_diff = int((~close).sum())

    jc, tc = np.asarray(jstate.pixel_count), tstate.pixel_count.numpy()
    assert tdone == tc.sum() and jdone == jc.sum()
    assert abs(tdone - jdone) <= np.abs(jc - tc).sum()
    assert jtot[0] == ttot[0] == 2 * 4 * 32 * 32
    assert abs(jtot[1] - ttot[1]) <= n_diff * 2 * 4


def test_regen_entry_points_match_jax(cornell, jax_regen):
    _, _, tds, tview = cornell
    cfg = REGEN_CFG
    jstate, _ = jax_regen
    out = {}
    for name, fn in (
            ("render_pass_regen", twf.render_pass_regen),
            ("render_pass_auto", twf.render_pass_auto),
            ("_render_pass_regen_jit", lambda s, v, st, c: (
                twf._render_pass_regen_jit(
                    s, v, twf.ensure_regen_state(v, st, c), c)))):
        st = twf.AccumState.make(cfg, "cpu")
        for _ in range(2):
            st, stats = fn(tds, tview, st, cfg)
        _assert_regen_matches_jax(st, jstate)
        out[name] = (st, stats)
    ref, ref_stats = out.pop("render_pass_regen")
    for name, (st, stats) in out.items():
        assert torch.equal(st.accumulator, ref.accumulator), name
        assert torch.equal(st.pixel_count, ref.pixel_count), name
        assert st.cam_seed == ref.cam_seed, name
        for k in ref_stats:
            assert torch.equal(stats[k], ref_stats[k]), (name, k)


def test_render_pass_rejects_unported_options(cornell):
    _, _, tds, tview = cornell
    for kw in (dict(path_regen=True, filter_enabled=True),
               dict(path_regen=True, scene_sharded=True)):
        cfg = RenderConfig(width=32, height=32, max_path_length=2, **kw)
        for fn in (twf.render_pass_auto, twf.render_pass_regen):
            with pytest.raises(ValueError, match="does not support"):
                fn(tds, tview, twf.AccumState.make(cfg, "cpu"), cfg)
    cfg = RenderConfig(width=32, height=32, max_path_length=2,
                       scene_sharded=True)
    for fn in (twf.render_pass, twf.render_pass_staged,
               twf.render_pass_unrolled):
        with pytest.raises(ValueError, match="does not support"):
            fn(tds, tview, twf.AccumState.make(cfg, "cpu"), cfg)
