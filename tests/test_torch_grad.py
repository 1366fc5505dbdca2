"""The training slice as a whole: the port's gradients against the JAX
package's (central finite differences and the classic executor's gradients
are in test_torch_fd.py).

  - regen_value_and_grad (the headline's fwd+bwd step, bench.py:82-112)
    against jax.value_and_grad of the same loss through JAX
    trace_paths_regen with intersector="lockstep", on the same carried-across
    Cornell box at 16x16, path 2, with material colours, area-light radiance
    and per-vertex offsets as parameters. The JAX side is compiled once for
    the module, at XLA's backend optimisation level 0 to keep the compile
    short (the arithmetic is the same; only the fusion and scheduling
    differ). Bounds: the loss within 1e-4 relative; each gradient group
    within a relative L2 error of GRAD_RTOL. The two sides trace the same
    paths (the RNG is bit-exact and the traversal the same), so what is
    left is float32 rounding of transcendentals and summation order. A
    flipped Russian-roulette or BSDF decision changes a whole lane; one
    lane of the 256 moves a colour or light gradient by up to ~1/256, so
    the bounds would flag any such flip (none is expected: at path 2 no
    lane reaches a roulette test). The offset bound is looser
    because a vertex gradient sums the 1/det-scaled refine terms of only the
    lanes hitting that triangle, whose rounding does not average out.
  - the port's regen gradients are equal with remat on and off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.diff import params as jparams
from lighthouse2_tpu.render import wavefront as jwf
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
from lighthouse2_tpu_torch.render.wavefront import AccumState
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

SIZE, PATH = 16, 2
LOSS_RTOL = 1e-4
GRAD_RTOL = dict(color=1e-3, light=1e-3, offset=2e-2)
# XLA backend optimisation off: the reference compiles in about half the time
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jax_loss(p, ds, view, state, target, cfg):
    s = jparams.set_material_fields(ds, color=p["color"])
    s = jparams.set_light_radiance(s, p["light"])
    s = jparams.displace_vertices(s, p["offset"])
    acc, count, _, _, _ = jwf.trace_paths_regen(s, view, cfg, state)
    img = acc[:, :3] / jnp.maximum(count, 1.0)[:, None]
    return jnp.mean((img - target) ** 2)


@pytest.fixture(scope="module")
def slice_case():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(SIZE, SIZE)
        jds = host.sync(two_level=False)
    jview = cam.get_view()
    jcfg = JConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                   path_regen=True, intersector="lockstep")
    jstate = jwf.ensure_regen_state(jview, jwf.AccumState.make(jcfg), jcfg)
    target = np.random.default_rng(0).uniform(
        0, 0.5, (SIZE * SIZE, 3)).astype(np.float32)
    params = dict(color=np.array(jds.materials.color),
                  light=np.array(jds.lights.tri_radiance),
                  offset=np.zeros((int(jds.tris.count), 3, 3), np.float32))
    vg = jax.jit(jax.value_and_grad(_jax_loss), static_argnames=("cfg",))
    args = ({k: jnp.asarray(v) for k, v in params.items()}, jds, jview,
            jstate, jnp.asarray(target))
    compiled = vg.lower(*args, cfg=jcfg).compile(compiler_options=FAST_COMPILE)
    jloss, jgrads = compiled(*args)
    tds, tview = scene_from_numpy(jax_scene_arrays(jds, jview), "cpu")
    return dict(tds=tds, tview=tview, target=torch.from_numpy(target),
                params={k: torch.from_numpy(v) for k, v in params.items()},
                jloss=float(jloss),
                jgrads={k: np.asarray(v) for k, v in jgrads.items()})


def _port_step(c, remat):
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=PATH,
                       path_regen=True, remat=remat)
    return regen_value_and_grad(c["tds"], c["tview"],
                                AccumState.make(cfg, "cpu"), cfg,
                                c["target"], c["params"])


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_regen_value_and_grad_matches_jax(slice_case):
    loss, grads, state = _port_step(slice_case, remat=False)
    jloss = slice_case["jloss"]
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    for k, bound in GRAD_RTOL.items():
        g = grads[k].numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        err = _rel_l2(g, slice_case["jgrads"][k])
        assert err <= bound, (k, err)
    # the new state is detached from this step's graph
    assert not state.accumulator.requires_grad
    assert not any(v.requires_grad for v in state.pool[0].values())
    assert state.sample_count == 1 and float(state.pixel_count.sum()) > 0


def test_regen_grads_equal_with_and_without_remat(slice_case):
    loss0, g0, s0 = _port_step(slice_case, remat=False)
    loss1, g1, s1 = _port_step(slice_case, remat=True)
    assert float(loss0) == float(loss1)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)
    assert s0.cam_seed == s1.cam_seed
    torch.testing.assert_close(s1.accumulator, s0.accumulator, rtol=0, atol=0)
