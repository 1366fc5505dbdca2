"""The classic executor and the inverse-rendering loop of the port.

  - each form of the classic pass (render_pass and render_pass_jit, also
    with path_regen=True, which neither reads as in JAX; render_pass_staged,
    render_pass_unrolled and render_pass_auto) against the JAX package's
    render_pass_jit with intersector="lockstep" (the staged form against
    JAX's render_pass_staged), two passes on the same carried-across 16x16
    Cornell box at path 4 with max_diffuse_bounces=2: bounce 1 extends
    every hit, bounce 2 extends through Russian roulette, bounce 3 ends
    every path (the diffuse budget is spent), so bounce 4 has no live lane:
    render_pass skips it, the staged and unrolled forms run it on dead
    lanes. Tolerances as in test_torch_wavefront.py: >= 99% of pixels
    within rtol 1e-3 / atol 1e-4 (XLA and torch round transcendentals
    differently, and one flipped roulette or BSDF decision changes a whole
    lane), the image mean within 1e-3 relative; cam_seed, which advances
    once per bounce, dead or not, equal. Against the port's own render_pass
    every form is equal bit for bit, stats included: the forms compute the
    same sums in the same order, and a dead bounce adds exact zeros. JAX's
    render_pass_jit is compiled once, at XLA's backend optimisation level
    0 (same arithmetic, a shorter compile); its render_pass_staged, which
    no other test reaches, at the default level (its stages are jits of
    their own: ~22 s on one core, cold);
  - optimize with torch.optim.Adam against optax.adam over 3 steps on a
    fixed quadratic. Tolerance rtol 1e-5 and, on the parameters, atol 1e-5:
    optax forms the bias corrections 1 - b^t in float32 (1 - 0.999 rounds
    to 1.0000467e-3), torch in float64, so a step of lr 0.1 differs by
    ~2e-6;
  - tests/test_grad.py's inverse-rendering test on the port alone: the
    walls' albedo is recovered, hist[-1] < 0.25 * hist[0];
  - a run cut short and resumed from its checkpoint gives the history and
    parameters of the uncut run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.params import set_material_fields
from lighthouse2_tpu_torch.diff.render import (
    load_checkpoint, make_loss, optimize, render_image)
from lighthouse2_tpu_torch.render import wavefront as twf
from lighthouse2_tpu_torch.scene.presets import cornell_box
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE, PATH, DIFFUSE = 16, 4, 2
PIXELS_CLOSE = 0.99
MEAN_RTOL = 1e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _two_passes(fn, *args):
    state, stats = args[2], []
    for _ in range(2):
        state, st = fn(*args[:2], state, args[3])
        stats.append(st)
    return state, stats


@pytest.fixture(scope="module")
def classic_passes():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    jcfg = JConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                   max_diffuse_bounces=DIFFUSE, intersector="lockstep")
    jstate = jwf.AccumState.make(jcfg)
    step = jwf.render_pass_jit.lower(jds, jview, jstate, config=jcfg).compile(
        compiler_options=FAST_COMPILE)
    jstate, jstats = _two_passes(lambda s, v, st, _: step(s, v, st), jds,
                                 jview, jstate, None)
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       max_diffuse_bounces=DIFFUSE)
    # the port's own render_pass: every form is held to it bit for bit
    ref = _two_passes(twf.render_pass, tds, tview,
                      twf.AccumState.make(cfg, "cpu"), cfg)
    return dict(jstate=jstate, jstats=jstats, jds=jds, jview=jview,
                jcfg=jcfg, tds=tds, tview=tview, cfg=cfg, ref=ref)


@pytest.fixture(scope="module")
def jax_staged(classic_passes):
    c = classic_passes
    return _two_passes(jwf.render_pass_staged, c["jds"], c["jview"],
                       jwf.AccumState.make(c["jcfg"]), c["jcfg"])


# (port form, path_regen): JAX's render_pass / render_pass_jit never read
# path_regen (only render_pass_auto routes to the regen executor), so their
# result is the classic one for either value
CLASSIC_FORMS = [("render_pass", False), ("render_pass", True),
                 ("render_pass_jit", False), ("render_pass_jit", True),
                 ("render_pass_staged", False),
                 ("render_pass_unrolled", False), ("render_pass_auto", False)]


@pytest.mark.parametrize("form,regen", CLASSIC_FORMS,
                         ids=[f"{f}-regen" if r else f
                              for f, r in CLASSIC_FORMS])
def test_classic_pass_matches_jax_lockstep(classic_passes, request, form,
                                           regen):
    c = classic_passes
    cfg = dataclasses.replace(c["cfg"], path_regen=regen)
    state, stats = _two_passes(getattr(twf, form), c["tds"], c["tview"],
                               twf.AccumState.make(cfg, "cpu"), cfg)
    ref_state, ref_stats = c["ref"]
    assert torch.equal(state.accumulator, ref_state.accumulator)
    for t, r in zip(stats, ref_stats):
        assert sorted(t) == sorted(r)
        for k in t:
            assert torch.equal(t[k], r[k]), k
    if form == "render_pass_staged":
        js, jstats = request.getfixturevalue("jax_staged")
    else:
        js, jstats = c["jstate"], c["jstats"]
    assert state.sample_count == int(js.sample_count) == 2
    assert state.pool is None and state.pixel_count is None
    assert state.cam_seed == int(js.cam_seed)

    ja, ta = np.asarray(js.accumulator), state.accumulator.numpy()
    close = np.isclose(ta, ja, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= PIXELS_CLOSE, close.mean()
    ji = np.asarray(jwf.finalize(js))
    ti = twf.finalize(state).numpy()
    assert np.isfinite(ti).all() and ti.mean() > 0
    assert abs(ti.mean() - ji.mean()) <= MEAN_RTOL * abs(ji.mean())

    n_diff = int((~close).sum())
    for t, j in zip(stats, jstats):
        te, je = t["extension_rays"].numpy(), np.asarray(j["extension_rays"])
        assert te[0] == je[0] == SIZE * SIZE
        assert np.abs(te - je).max() <= n_diff
        # bounce 2 rolls the roulette, bounce 3 ends every path
        assert 0 < te[2] < te[1] and te[3] == je[3] == 0
        assert int(t["shadow_rays"][3]) == 0
        assert abs(int(t["total_shadow"]) - int(j["total_shadow"])) \
            <= n_diff * PATH


def test_optimize_adam_matches_optax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 2.0, (6, 3)).astype(np.float32)
    b = rng.standard_normal((6, 3)).astype(np.float32)
    x0 = rng.standard_normal((6, 3)).astype(np.float32)

    jloss = lambda x: jnp.sum(jnp.asarray(a) * (x - jnp.asarray(b)) ** 2)
    opt = optax.adam(0.1)
    x, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    jhist = []
    for _ in range(3):
        val, g = jax.value_and_grad(jloss)(x)
        upd, st = opt.update(g, st, x)
        x = optax.apply_updates(x, upd)
        jhist.append(float(val))

    tloss = lambda x: (torch.from_numpy(a) * (x - torch.from_numpy(b)) ** 2
                       ).sum()
    tx, thist = optimize(tloss, torch.from_numpy(x0), steps=3, lr=0.1)
    np.testing.assert_allclose(thist, jhist, rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-5,
                               atol=1e-5)


def _albedo_problem():
    """tests/test_grad.py test_inverse_rendering_recovers_material, on the
    port: 10x10, path 2; the emissive material keeps its true radiance."""
    cfg = RenderConfig(width=10, height=10, spp_per_pass=1, max_path_length=2)
    host, cam = cornell_box(10, 10)
    ds, view = host.sync("cpu"), cam.get_view("cpu")
    true_color = ds.materials.color
    emissive = true_color.amax(-1, keepdim=True) > 1.0
    target = render_image(ds, view, cfg)
    start = torch.clamp(true_color * 0.4 + 0.2, 0.05, 0.95)
    loss = make_loss(target, view, cfg, lambda s, c: set_material_fields(
        s, color=torch.where(emissive, true_color, torch.clamp(c, 0.0, 0.98))),
        ds)
    return loss, start


def test_inverse_rendering_recovers_material():
    loss, start = _albedo_problem()
    params, hist = optimize(loss, start, steps=18, lr=8e-2)
    assert hist[-1] < 0.25 * hist[0], hist
    assert not params.requires_grad


def test_checkpoint_resume_gives_the_same_history(tmp_path):
    """Cut a 6-step run after 3 steps (its checkpoint then holds step 3),
    resume it to 6, and compare with the uncut run."""
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    loss = lambda p: ((p["x"] - b) ** 2).sum() + (p["y"] ** 4).sum()
    p0 = dict(x=torch.zeros((4, 3)), y=torch.ones(2))
    full, hist = optimize(loss, p0, steps=6, lr=0.1)

    path = str(tmp_path / "run.pkl")
    optimize(loss, p0, steps=3, lr=0.1, checkpoint_path=path,
             checkpoint_every=2)
    ck = load_checkpoint(path)
    assert ck["step"] == 3 and len(ck["history"]) == 3
    resumed, hist2 = optimize(loss, p0, steps=6, lr=0.1,
                              checkpoint_path=path, checkpoint_every=2)
    assert hist2 == hist
    for k in full:
        torch.testing.assert_close(resumed[k], full[k], rtol=0, atol=0)
    assert load_checkpoint(path)["step"] == 6
    assert not (tmp_path / "run.pkl.tmp").exists()
