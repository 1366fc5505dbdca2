"""The port's Disney BSDF (render/bsdf_disney.py) against the JAX package's.

One seeded batch of 4096 shading points covers random metallic, roughness
(an eighth of the lanes pure-specular, below 0.001), anisotropy with and
without a uv tangent frame, sheen, clearcoat, transmission (a quarter of
the lanes random, an eighth at 1), eta, absorption and back-side hits. Both
packages evaluate and sample it on the same inputs, in float64 (the same
formulas: JAX under jax.enable_x64) and in float32 (what the renderer runs):
  - float64: at least 99.9% of lanes agree in wi, pdf, bsdf and the
    specular flag within rtol 1e-4 (atol 1e-6 for components near zero;
    a lane whose lobe pick sits on a rounding boundary may take the other
    branch, so a global max is not the measure); is_specular_material
    agrees on every lane; the gradient of sum(bsdf . c) + sum(pdf . c')
    over evaluate and sample with respect to colour, roughness, metallic,
    sheen and clearcoat, torch autograd against jax.vjp, agrees on 99.9%
    of lanes within rtol 1e-3 (atol 1e-5). This pins the detach placement
    of sample: without the detaches the renormalised lobe random carries
    gradient on every lane that picks a lobe. On lanes where wi, or the
    half vector wi + wo, lies exactly in the tangent plane, the gradient
    with respect to wo, wi and the normal is finite (the JAX package's is
    NaN there: its `where` drops a branch that divides by zero, and the
    backward of the dropped branch forms 0 / 0);
  - float32: the flags and wi agree with the JAX package's float32 run;
    pdf and bsdf are held against the float64 evaluation, where the port
    may miss rtol 1e-4 on no more lanes than the JAX package's float32 run
    does. The near-delta lobes decide this: there float32 rounding moves
    either package by 1e-4 or more on a few per cent of the lanes.
Each JAX side is compiled once, at XLA's backend optimisation level 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.render import bsdf_disney as jdisney
from lighthouse2_tpu.render.shading import ShadingData as JSD
from lighthouse2_tpu_torch.render import bsdf_disney as tdisney
from lighthouse2_tpu_torch.render.shading import ShadingData as TSD

torch.set_num_threads(1)

N = 4096
AGREE = 0.999
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
GRAD_FIELDS = ("color", "roughness", "metallic", "sheen", "clearcoat")


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0.0, 1.0, s).astype(np.float32)
    n_sh = _unit(rng.standard_normal((N, 3)))
    n_geom = _unit(n_sh + 0.2 * rng.standard_normal((N, 3)))
    # half the lanes carry a uv tangent frame (anisotropy has a direction)
    has_t = rng.uniform(size=N) < 0.5
    tangent = np.where(has_t[:, None], _unit(rng.standard_normal((N, 3))),
                       0.0).astype(np.float32)
    bitangent = np.where(has_t[:, None], _unit(np.cross(n_sh, tangent + 1e-3)),
                         0.0).astype(np.float32)
    rough = u(N)
    # pure specular; below 0.001 so float32 and float64 flag the same lanes
    rough[rng.uniform(size=N) < 0.125] = 5e-4
    trans = np.where(rng.uniform(size=N) < 0.25, u(N), 0.0).astype(np.float32)
    trans[rng.uniform(size=N) < 0.125] = 1.0
    sd = dict(
        color=u(N, 3), absorption=0.5 * u(N, 3), metallic=u(N),
        subsurface=np.where(rng.uniform(size=N) < 0.25, u(N), 0.0).astype(
            np.float32),
        specular=u(N), roughness=rough, spec_tint=u(N),
        anisotropic=rng.uniform(-1, 1, N).astype(np.float32),
        sheen=u(N), sheen_tint=u(N), clearcoat=u(N), clearcoat_gloss=u(N),
        transmission=trans, eta=rng.uniform(1.1, 2.0, N).astype(np.float32),
        flags=np.zeros(N, np.int32), n_geom=n_geom, n_interp=n_sh,
        n_shading=n_sh, face_dir=np.ones(N, np.float32),
        emissive=np.zeros(N, bool), ltri=np.full(N, -1, np.int32),
        area=np.ones(N, np.float32), uv=u(N, 2), lod=np.zeros(N, np.float32),
        alpha_cutout=np.zeros(N, bool), tangent=tangent, bitangent=bitangent)
    # wo mostly above the geometric normal, an eighth below (back side)
    wo = _unit(rng.standard_normal((N, 3)))
    up = np.sum(wo * n_geom, -1) < 0
    flip = up & (rng.uniform(size=N) > 0.125)
    wo = np.where(flip[:, None], -wo, wo).astype(np.float32)
    wi = _unit(rng.standard_normal((N, 3)))
    wi = np.where((np.sum(wi * n_sh, -1) < 0)[:, None]
                  & (rng.uniform(size=N) > 0.1)[:, None], -wi, wi).astype(
                      np.float32)
    extra = dict(wo=wo, wi=wi, dist=rng.uniform(0.1, 3.0, N).astype(
        np.float32), r3=u(N), r4=u(N),
        c_eb=u(N, 3), c_ep=u(N), c_sb=u(N, 3), c_sp=u(N))
    return sd, extra


def _jax_run(sd, ex):
    def outputs(params):
        s = dataclasses.replace(sd, **params)
        eb, ep = jdisney.evaluate(s, s.n_shading, ex["wo"], ex["wi"])
        smp = jdisney.sample(s, s.n_shading, s.n_geom, ex["wo"], ex["dist"],
                             ex["r3"], ex["r4"])
        return eb, ep, smp

    def loss(params):
        eb, ep, smp = outputs(params)
        return (jnp.sum(eb * ex["c_eb"]) + jnp.sum(ep * ex["c_ep"])
                + jnp.sum(smp["bsdf"] * ex["c_sb"])
                + jnp.sum(smp["pdf"] * ex["c_sp"]))

    params = {k: getattr(sd, k) for k in GRAD_FIELDS}
    eb, ep, smp = outputs(params)
    val, vjp = jax.vjp(loss, params)
    return eb, ep, smp, vjp(jnp.ones_like(val))[0], \
        jdisney.is_specular_material(sd)


def _run_jax(sd_np, ex_np):
    jsd = JSD(**{k: jnp.asarray(v) for k, v in sd_np.items()})
    jex = {k: jnp.asarray(v) for k, v in ex_np.items()}
    run = jax.jit(_jax_run).lower(jsd, jex).compile(
        compiler_options=FAST_COMPILE)
    eb, ep, smp, grad, spec = jax.tree_util.tree_map(np.asarray,
                                                     run(jsd, jex))
    return dict(eb=eb, ep=ep, smp=smp, grad=grad, spec=spec)


def _run_torch(sd_np, ex_np):
    tsd = TSD(**{k: torch.from_numpy(v) for k, v in sd_np.items()})
    tex = {k: torch.from_numpy(v) for k, v in ex_np.items()}
    params = {k: getattr(tsd, k).clone().requires_grad_() for k in GRAD_FIELDS}
    s = dataclasses.replace(tsd, **params)
    teb, tep = tdisney.evaluate(s, s.n_shading, tex["wo"], tex["wi"])
    tsmp = tdisney.sample(s, s.n_shading, s.n_geom, tex["wo"], tex["dist"],
                          tex["r3"], tex["r4"])
    loss = ((teb * tex["c_eb"]).sum() + (tep * tex["c_ep"]).sum()
            + (tsmp["bsdf"] * tex["c_sb"]).sum()
            + (tsmp["pdf"] * tex["c_sp"]).sum())
    tgrad = torch.autograd.grad(loss, [params[k] for k in GRAD_FIELDS])
    return dict(eb=teb.detach().numpy(), ep=tep.detach().numpy(),
                smp={k: v.detach().numpy() for k, v in tsmp.items()},
                grad={k: g.numpy() for k, g in zip(GRAD_FIELDS, tgrad)},
                spec=tdisney.is_specular_material(tsd).numpy())


def _f64(d):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in d.items()}


@pytest.fixture(scope="module")
def both():
    """The batch through both packages in float64 (formula parity) and in
    float32 (what the renderer runs)."""
    sd, ex = _batch()
    with jax.enable_x64(True):
        j64 = _run_jax(_f64(sd), _f64(ex))
    return dict(j=j64, t=_run_torch(_f64(sd), _f64(ex)),
                j32=_run_jax(sd, ex), t32=_run_torch(sd, ex), sd=sd, ex=ex)


def _lanes_close(got, want, rtol, atol):
    c = np.isclose(got, want, rtol=rtol, atol=atol)
    return c.reshape(c.shape[0], -1).all(-1)


def test_batch_covers_every_lobe(both):
    sd, ex = both["sd"], both["ex"]
    spec = both["j"]["spec"]
    assert 0.05 < spec.mean() < 0.5
    transmit = ex["r4"] < sd["transmission"]
    assert 0.1 < transmit.mean() < 0.4
    assert (np.abs(sd["tangent"]).sum(-1) > 0).mean() > 0.4
    assert (np.abs(sd["anisotropic"]) > 0.5).mean() > 0.4
    # every lobe of the sample CDF is picked on some lanes
    w = [np.asarray(x) for x in jdisney._lobe_weights(
        JSD(**{k: jnp.asarray(v) for k, v in sd.items()}))]
    r3n = (ex["r4"] - sd["transmission"]) / np.maximum(
        1.0 - sd["transmission"], 1e-9)
    cdf = np.cumsum(np.stack(w, 0), 0)
    pick = (r3n[None] >= cdf[:3]).sum(0)[~transmit]
    assert np.bincount(pick, minlength=4).min() > 100


def test_evaluate_matches_jax(both):
    j, t = both["j"], both["t"]
    ok = (_lanes_close(t["eb"], j["eb"], 1e-4, 1e-6)
          & _lanes_close(t["ep"], j["ep"], 1e-4, 1e-6))
    assert ok.mean() >= AGREE, ok.mean()
    np.testing.assert_array_equal(t["spec"], j["spec"])
    assert np.isfinite(t["eb"]).all() and np.isfinite(t["ep"]).all()
    assert (t["ep"] > 0).mean() > 0.5


def test_sample_matches_jax(both):
    j, t = both["j"]["smp"], both["t"]["smp"]
    np.testing.assert_array_equal(t["specular"], j["specular"])
    ok = (_lanes_close(t["wi"], j["wi"], 1e-4, 1e-6)
          & _lanes_close(t["pdf"], j["pdf"], 1e-4, 1e-6)
          & _lanes_close(t["bsdf"], j["bsdf"], 1e-4, 1e-6))
    assert ok.mean() >= AGREE, ok.mean()
    assert (t["pdf"] > 0).mean() > 0.5


def test_gradients_match_jax_vjp(both):
    j, t = both["j"]["grad"], both["t"]["grad"]
    for k in GRAD_FIELDS:
        assert np.isfinite(t[k]).all(), k
        ok = _lanes_close(t[k], j[k], 1e-3, 1e-5)
        assert ok.mean() >= AGREE, (k, ok.mean())
        assert (np.abs(j[k]) > 0).mean() > 0.5, k

    # wi, or wi + wo, exactly in the tangent plane of n = (0, 0, 1)
    sd, ex = both["sd"], both["ex"]
    lanes = slice(0, 4)
    tsd = TSD(**{k: torch.from_numpy(v[lanes].copy()) for k, v in sd.items()})
    tsd = dataclasses.replace(
        tsd, roughness=torch.full((4,), 0.5), transmission=torch.zeros(4),
        clearcoat=torch.full((4,), 0.5), tangent=torch.zeros(4, 3),
        bitangent=torch.zeros(4, 3))
    n = torch.tensor([[0.0, 0.0, 1.0]] * 4, requires_grad=True)
    wo = torch.tensor([[0.6, 0.0, 0.8]] * 4, requires_grad=True)
    wi = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.0, -0.8],
                       [-0.6, 0.0, -0.8]], requires_grad=True)
    eb, ep = tdisney.evaluate(tsd, n, wo, wi)
    smp = tdisney.sample(tsd, n, n, wo, torch.ones(4),
                         torch.from_numpy(ex["r3"][lanes]),
                         torch.from_numpy(ex["r4"][lanes]))
    loss = eb.sum() + ep.sum() + smp["bsdf"].sum() + smp["pdf"].sum()
    for g, name in zip(torch.autograd.grad(loss, [n, wo, wi]),
                       ("n", "wo", "wi")):
        assert torch.isfinite(g).all(), (name, g)


def test_float32_port_is_as_close_to_float64_as_jax(both):
    """In float32 the near-delta lobes (GGX at roughness ~0.001, GTR1 at
    clearcoat gloss ~1) turn one rounding step into a relative change of
    1e-4 to 1e-1, in either package. Measured against the float64
    evaluation, the port misses rtol 1e-4 on no more lanes than the JAX
    package does (+0.5 points); the flags agree on every lane and wi on
    99.9% of them. Where the port's float32 gradient is not finite, the
    JAX package's is not either."""
    ref, t, j = both["t"], both["t32"], both["j32"]
    np.testing.assert_array_equal(t["spec"], j["spec"])
    np.testing.assert_array_equal(t["smp"]["specular"], j["smp"]["specular"])
    assert _lanes_close(t["smp"]["wi"], j["smp"]["wi"], 1e-4, 1e-6).mean() \
        >= AGREE
    for got, want, r in ((t["smp"]["pdf"], j["smp"]["pdf"], ref["smp"]["pdf"]),
                         (t["smp"]["bsdf"], j["smp"]["bsdf"],
                          ref["smp"]["bsdf"]),
                         (t["eb"], j["eb"], ref["eb"]),
                         (t["ep"], j["ep"], ref["ep"])):
        port_off = 1.0 - _lanes_close(got, r, 1e-4, 1e-6).mean()
        jax_off = 1.0 - _lanes_close(want, r, 1e-4, 1e-6).mean()
        assert port_off <= jax_off + 0.005, (port_off, jax_off)
        assert np.isfinite(got).all()
    for k in GRAD_FIELDS:
        bad = ~np.isfinite(t["grad"][k])
        assert (~np.isfinite(j["grad"][k])[bad]).all(), k
        assert bad.mean() < 0.01, k
