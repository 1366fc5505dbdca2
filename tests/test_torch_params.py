"""The port's diff/params.py against the JAX package's, on the Cornell box.

Values and VJPs (random cotangents from a numpy seed on every output) of
set_material_fields, set_light_radiance and displace_vertices. Both sides
run eagerly, op by op, on the same carried-across scene. Tolerances: equal
where the function only copies; rtol 1e-5 / atol 1e-6 where it computes
(cross products, square roots and reciprocals of the displaced triangles).
After a displacement the traversal layouts are refreshed: the BVH4 rows
equal a fresh pack of the displaced triangles and the BVH4 walk finds the
same hits as the BVH2 walk on the displaced tri9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.diff import params as jparams
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.bvh.traverse import bvh_intersect
from lighthouse2_tpu_torch.bvh.wide import pack_wide
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.diff import params as tparams
from lighthouse2_tpu_torch.render.kernels.trace import trace_closest
from test_torch_scene import jax_scene_arrays

torch.set_num_threads(1)

TRI_FIELDS = ("v0", "e1", "e2", "face_n", "area", "inv_area", "tri9")


@pytest.fixture(scope="module")
def cornell():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LH2_NO_NATIVE", "1")
        host, cam = jpresets.cornell_box(16, 16)
        jds = host.sync(two_level=False)
    tds, _ = scene_from_numpy(jax_scene_arrays(jds), "cpu")
    return jds, tds


def _vjp_both(jfn, tfn, x, cots):
    """Values and VJPs of jfn / tfn at x for the list of cotangents."""
    jout, pullback = jax.vjp(jfn, jnp.asarray(x))
    (jg,) = pullback(tuple(jnp.asarray(c) for c in cots))
    xt = torch.from_numpy(x).requires_grad_()
    tout = tfn(xt)
    # a detached output carries no graph, and so no share of the VJP
    live = [(o, torch.from_numpy(c)) for o, c in zip(tout, cots)
            if o.requires_grad]
    outs, cts = zip(*live)
    (tg,) = torch.autograd.grad(outs, (xt,), cts)
    return ([np.asarray(a) for a in jout], [t.detach().numpy() for t in tout],
            np.asarray(jg), tg.numpy())


def test_set_material_fields_matches_jax(cornell):
    jds, tds = cornell
    rng = np.random.default_rng(0)
    color = rng.uniform(0, 1, np.asarray(jds.materials.color).shape
                        ).astype(np.float32)
    rough = rng.uniform(0, 1, np.asarray(jds.materials.roughness).shape
                        ).astype(np.float32)
    cots = [rng.standard_normal(color.shape).astype(np.float32)]
    jv, tv, jg, tg = _vjp_both(
        lambda c: (jparams.set_material_fields(jds, color=c).materials.color,),
        lambda c: (tparams.set_material_fields(tds, color=c).materials.color,),
        color, cots)
    np.testing.assert_array_equal(tv[0], jv[0])
    np.testing.assert_array_equal(tg, jg)
    s = tparams.set_material_fields(tds, roughness=torch.from_numpy(rough))
    np.testing.assert_array_equal(s.materials.roughness.numpy(), rough)
    assert s.materials.color is tds.materials.color


def test_set_light_radiance_matches_jax(cornell):
    jds, tds = cornell
    rng = np.random.default_rng(1)
    rad = rng.uniform(0, 20, np.asarray(jds.lights.tri_radiance).shape
                      ).astype(np.float32)
    cots = [rng.standard_normal(rad.shape).astype(np.float32),
            rng.standard_normal(rad.shape[:1]).astype(np.float32)]
    pick = lambda s: (s.lights.tri_radiance, s.lights.tri_energy)
    jv, tv, jg, tg = _vjp_both(
        lambda r: pick(jparams.set_light_radiance(jds, r)),
        lambda r: pick(tparams.set_light_radiance(tds, r)), rad, cots)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # the energy is detached: only the radiance cotangent comes back
    np.testing.assert_array_equal(jg, cots[0])
    np.testing.assert_array_equal(tg, cots[0])
    s = tparams.set_light_radiance(tds, torch.from_numpy(rad).requires_grad_())
    assert s.lights.tri_radiance.requires_grad
    assert not s.lights.tri_energy.requires_grad


def test_displace_vertices_matches_jax(cornell):
    jds, tds = cornell
    rng = np.random.default_rng(2)
    t = int(jds.tris.count)
    off = rng.uniform(-0.02, 0.02, (t, 3, 3)).astype(np.float32)
    pick = lambda s: tuple(getattr(s.tris, f) for f in TRI_FIELDS)
    cots = [rng.standard_normal(np.asarray(getattr(jds.tris, f)).shape
                                ).astype(np.float32) for f in TRI_FIELDS]
    jv, tv, jg, tg = _vjp_both(
        lambda x: pick(jparams.displace_vertices(jds, x)),
        lambda x: pick(tparams.displace_vertices(tds, x)), off, cots)
    for name, a, b in zip(TRI_FIELDS, tv, jv):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    assert np.abs(tg).max() > 0


def test_displace_vertices_refreshes_traversal_triangles(cornell):
    _, tds = cornell
    rng = np.random.default_rng(3)
    t = tds.tris.count
    off = torch.from_numpy(rng.uniform(-0.01, 0.01, (t, 3, 3)).astype(
        np.float32)).requires_grad_()
    s = tparams.displace_vertices(tds, off)
    b = s.bvh
    assert s.tris.tri9.requires_grad
    assert not (b.tri9.requires_grad or b.tri4.requires_grad)
    torch.testing.assert_close(b.tri9, s.tris.tri9.detach(), rtol=0, atol=0)
    # the same leaf order and id bits as a fresh pack; the boxes stay
    fresh = pack_wide(*(x.numpy() for x in (b.nbox, b.left, b.right, b.count,
                                            b.prim, b.tri9)), b.max_leaf)
    np.testing.assert_array_equal(b.tri4.numpy().view(np.int32),
                                  fresh["tri4"].view(np.int32))
    assert not np.array_equal(b.tri4.numpy(), tds.bvh.tri4.numpy())
    assert b.node4 is tds.bvh.node4 and b.nbox is tds.bvh.nbox
    # the BVH4 walk (trace wrapper, CPU) hits the displaced triangles as the
    # BVH2 walk does on the displaced tri9
    o = torch.from_numpy(rng.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((2048, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t4, p4, _, _ = trace_closest(o, d, 1e30, b)
    t2, p2, _, _ = bvh_intersect(o, d, b)
    torch.testing.assert_close(t4, t2, rtol=0, atol=0)
    assert (p4 >= 0).float().mean() > 0.5
    assert (p4 == p2).float().mean() > 0.99
