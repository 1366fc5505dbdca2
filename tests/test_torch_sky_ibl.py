"""The port's sky IBL (render/sky.py, the sky slot of render/lights.py and the
tables HostScene.sync uploads) against the JAX package's.

  - build_sky_cdf equals the JAX function bit for bit;
  - sample_sky and sky_pdf on 8,192 seeded uniforms, on the golden 16x32
    sky and on a seeded 64x1024 sky: the row and column index of every lane
    equal JAX's (read off the radiance, every texel of the seeded sky is
    distinct) and numpy's searchsorted; directions within rtol 1e-5 / atol
    1e-6 (sin, cos and acos round differently in the last bit), pdfs within
    rtol 1e-5. The port's search materialises no [N, W] tensor (every
    intermediate is recorded by a dispatch mode);
  - the nearest-texel sample_skydome along the sampled directions and
    random ones: the same texel as JAX's on at least 99.9% of lanes (one
    rounding step of atan2 can move a direction on a texel edge across
    it);
  - random_point_on_light(sky=...), light_pick_prob(sky=...) and
    sky_pick_prob on the Cornell lights with test_sky: the picked
    area-light slot equal on every lane, values within rtol 1e-5 (atol
    1e-5 for the points, which lie 1000 units out along a sky sample;
    1e-7 for the probabilities) on at least 99.9% of lanes;
  - HostScene.set_sky + sync("cpu", two_level=False, native=False) upload
    the same scene, sky tables included, as the JAX package's
    sync(two_level=False) with LH2_NO_NATIVE=1; a colour becomes a 1x1 sky
    without tables.
JAX functions are compiled at XLA's backend optimisation level 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lighthouse2_tpu.render import lights as jlights
from lighthouse2_tpu.render import sky as jsky
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu.scene.device_scene import DeviceSky as JSky
from lighthouse2_tpu.utils import golden as jgolden
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.render import lights as tlights
from lighthouse2_tpu_torch.render import sky as tsky
from lighthouse2_tpu_torch.scene import presets as tpresets
from lighthouse2_tpu_torch.scene.device_scene import DeviceSky as TSky
from lighthouse2_tpu_torch.utils import golden as tgolden
from test_torch_scene import assert_scene_equal, jax_scene_arrays, jax_sync

torch.set_num_threads(1)

N = 8192
AGREE = 0.999
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(
        *args)


def _lanes_close(got, want, rtol, atol):
    """Fraction of lanes (rows) whose every component is close."""
    c = np.isclose(got, want, rtol=rtol, atol=atol)
    return c.reshape(c.shape[0], -1).all(-1).mean()


def _golden_sky():
    return np.asarray(tgolden.golden_scene()[0].sky_pixels)


def _seeded_sky(h=64, w=1024, seed=7):
    return np.random.default_rng(seed).uniform(
        0.05, 2.0, (h, w, 3)).astype(np.float32)


def _skies(px):
    pdf, cr, cc, e = tsky.build_sky_cdf(px)
    j = JSky(pixels=jnp.asarray(px), pdf=jnp.asarray(pdf),
             cdf_rows=jnp.asarray(cr), cdf_cond=jnp.asarray(cc),
             nee_energy=jnp.float32(e), has_ibl=True)
    t = TSky(pixels=torch.from_numpy(px), pdf=torch.from_numpy(pdf),
             cdf_rows=torch.from_numpy(cr), cdf_cond=torch.from_numpy(cc),
             nee_energy=torch.tensor(e, dtype=torch.float32), has_ibl=True)
    return j, t


class _Shapes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.numels.append(o.numel())
        return out


def test_build_sky_cdf_equals_jax():
    for px in (_golden_sky(), _seeded_sky(), np.zeros((1, 1, 3), np.float32),
               np.zeros((4, 8, 3), np.float32)):
        got, want = tsky.build_sky_cdf(px), jsky.build_sky_cdf(px)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


@pytest.mark.parametrize("which", ["golden", "seeded"])
def test_sample_sky_and_sky_pdf_match_jax(which):
    px = _golden_sky() if which == "golden" else _seeded_sky()
    h, w = px.shape[:2]
    jsk, tsk = _skies(px)
    r = np.random.default_rng(1).uniform(0.0, 1.0, (2, N)).astype(np.float32)
    want = _jit(lambda s, a, b: jsky.sample_sky(s, a, b), jsk, r[0], r[1])
    rec = _Shapes()
    with rec:
        got = tsky.sample_sky(tsk, torch.from_numpy(r[0]),
                              torch.from_numpy(r[1]))
    assert max(rec.numels) < N * w // 8, max(rec.numels)

    # the same texel on every lane: rows and columns from numpy's
    # searchsorted, radiance equal to JAX's (every seeded texel differs)
    _, cdf_rows, cdf_cond, _ = tsky.build_sky_cdf(px)
    yi = np.clip(np.searchsorted(cdf_rows, r[0], side="right"), 0, h - 1)
    xi = np.array([np.searchsorted(cdf_cond[y], v, side="right")
                   for y, v in zip(yi, r[1])]).clip(0, w - 1)
    np.testing.assert_array_equal(
        tsky.search_rows(torch.from_numpy(cdf_cond).reshape(-1),
                         torch.from_numpy(yi), w,
                         torch.from_numpy(r[1])).numpy(), xi)
    np.testing.assert_array_equal(got["radiance"].numpy(), px[yi, xi])
    np.testing.assert_array_equal(got["radiance"].numpy(),
                                  np.asarray(want["radiance"]))
    np.testing.assert_allclose(got["dir"].numpy(), np.asarray(want["dir"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["pdf"].numpy(), np.asarray(want["pdf"]),
                               rtol=1e-5)

    d = np.array(want["dir"])
    jp = _jit(lambda s, x: jsky.sky_pdf(s, x), jsk, d)
    tp = tsky.sky_pdf(tsk, torch.from_numpy(d))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    # nearest-texel lookup along the same directions and random ones
    dr = np.random.default_rng(2).standard_normal((N, 3)).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=-1, keepdims=True)
    for dd in (d, dr):
        jb = _jit(lambda s, x: jsky.sample_skydome(s, x), jsk, dd)
        tb = tsky.sample_skydome(tsk, torch.from_numpy(dd))
        assert (tb.numpy() == np.asarray(jb)).all(-1).mean() >= AGREE


def test_light_sampling_with_the_sky_matches_jax(monkeypatch):
    monkeypatch.setenv("LH2_NO_NATIVE", "1")
    host, _ = jpresets.cornell_box(16, 16)
    jpresets.test_sky(host)
    jds = host.sync(two_level=False)
    assert jds.sky.has_ibl
    tds, _ = scene_from_numpy(jax_scene_arrays(jds), "cpu")
    assert tds.sky.has_ibl

    rng = np.random.default_rng(3)
    pos = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (N, 3)).astype(
        np.float32)
    nrm = rng.standard_normal((N, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    last_n = np.roll(nrm, 1, 0)
    r = rng.uniform(0.0, 1.0, (4, N)).astype(np.float32)
    ltri = rng.integers(-1, int(jds.lights.tri_v0.shape[0]), N).astype(
        np.int32)
    o = np.roll(pos, 7, 0)

    def jfn(lights, sky, pos, nrm, o, last_n, ltri, r):
        return (jlights.random_point_on_light(lights, r[0], r[1], pos, nrm,
                                              sky=sky, r2=r[2], r3=r[3]),
                jlights.light_pick_prob(lights, ltri, o, last_n, pos,
                                        sky=sky),
                jlights.sky_pick_prob(lights, sky, o, last_n))

    want = jax.tree_util.tree_map(np.asarray, _jit(
        jfn, jds.lights, jds.sky, pos, nrm, o, last_n, ltri, r))
    t = {k: torch.from_numpy(v) for k, v in
         dict(pos=pos, nrm=nrm, o=o, last_n=last_n, ltri=ltri).items()}
    tr = torch.from_numpy(r)
    got = (tlights.random_point_on_light(tds.lights, tr[0], tr[1], t["pos"],
                                         t["nrm"], sky=tds.sky, r2=tr[2],
                                         r3=tr[3]),
           tlights.light_pick_prob(tds.lights, t["ltri"], t["o"],
                                   t["last_n"], t["pos"], sky=tds.sky),
           tlights.sky_pick_prob(tds.lights, tds.sky, t["o"], t["last_n"]))

    ls, jls = got[0], want[0]
    np.testing.assert_array_equal(ls["ltri"].numpy(), jls["ltri"])
    # every slot, the sky included, is picked on some lanes
    n_slots = int(jds.lights.tri_v0.shape[0]) + 1
    sky_lanes = ls["ltri"].numpy() < 0
    assert 0.05 < sky_lanes.mean() < 0.95
    assert len(np.unique(ls["ltri"].numpy())) == n_slots
    for k in ("point", "light_pdf", "pick_prob", "color"):
        assert _lanes_close(ls[k].numpy(), jls[k], 1e-5, 1e-5) >= AGREE, k
    for g, w in zip(got[1:], want[1:]):
        assert _lanes_close(g.numpy(), w, 1e-5, 1e-7) >= AGREE
    assert (got[2].numpy() > 0).all()


def test_set_sky_and_sync_upload_the_jax_tables(monkeypatch):
    jds, _ = jax_sync(lambda: _with_test_sky(jpresets), monkeypatch)
    host, _ = _with_test_sky(tpresets)
    ds = host.sync("cpu", two_level=False, native=False)
    assert ds.sky.has_ibl and ds.sky.pdf.shape == (8, 16)
    assert ds.sky.nee_energy.shape == ()
    assert_scene_equal(ds, jax_scene_arrays(jds))

    # the golden scene's sky, and a colour (1x1, no tables)
    jg, _ = jgolden.golden_scene()
    tg, _ = tgolden.golden_scene()
    jsk = jg.sync(two_level=False).sky
    tsk = tg.sync("cpu").sky
    for f in ("pixels", "pdf", "cdf_rows", "cdf_cond", "nee_energy"):
        np.testing.assert_array_equal(getattr(tsk, f).numpy(),
                                      np.asarray(getattr(jsk, f)), err_msg=f)
    jds1, _ = jax_sync(jpresets.single_triangle, monkeypatch, 16, 16)
    ds1 = tpresets.single_triangle(16, 16)[0].sync("cpu", two_level=False,
                                                   native=False)
    assert not ds1.sky.has_ibl and ds1.sky.pdf is None
    assert_scene_equal(ds1, jax_scene_arrays(jds1))


def _with_test_sky(presets):
    host, cam = presets.cornell_box(16, 16)
    presets.test_sky(host)
    return host, cam
