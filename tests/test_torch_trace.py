"""The trace kernels' plain versions against the JAX package's trace paths.

lighthouse2_tpu_torch/render/kernels/trace.py launches csrc/trace.cu for CUDA
tensors and runs the plain PyTorch version (the BVH4 walk of bvh/wide.py)
for CPU tensors, which is what runs here; chip_smoke.py holds the CUDA
kernels against the plain version on the card. Here the wrappers (and the
port's BVH2 walk, bvh/traverse.py, where the JAX lockstep's per-ray visits
are compared) are held against
  - the JAX Pallas kernels in interpret mode (trace_cluster_bvh), as
    tests/test_cluster_kernel.py runs them: prim equal, t within rtol 2e-4
    (the Pallas kernel computes t from MXU plane forms, not Moller-Trumbore);
  - the JAX lockstep traversal (bvh_intersect, bvh_occluded) on the same
    topology: prim, visits and occlusion equal, t/u/v within float32 noise;
  - build_device_bvh against JAX's (both through the native builder, one
    C++ source compiled alike): every DeviceBVH array equal; then
    bvh_intersect_counts against JAX's, its five outputs (prim and the
    per-ray step counts equal, t/u/v within the bounds above), and
    bvh_intersect / bvh_occluded called with JAX's positional arguments
    (v0, e1, e2, t_max).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.bvh.builder import build_sah_bvh_numpy as jbuild
from lighthouse2_tpu.bvh.clusters import PAY_PRIM, cut_clusters
from lighthouse2_tpu.bvh import traverse as jtraverse
from lighthouse2_tpu.bvh.traverse import (
    bvh_intersect_counts, bvh_occluded, device_bvh_from_flat as jdevice_bvh)
from lighthouse2_tpu.render.kernels.trace import trace_cluster_bvh
from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh_numpy
from lighthouse2_tpu_torch.bvh import traverse as ttraverse
from lighthouse2_tpu_torch.bvh.traverse import (
    STACK_CAP, bvh_intersect, device_bvh_from_flat)
from lighthouse2_tpu_torch.bvh.wide import STACK_CAP as STACK4_CAP
from lighthouse2_tpu_torch.core.geometry import BIG_T
from lighthouse2_tpu_torch.render.kernels.trace import (
    trace_closest, trace_occluded)

torch.set_num_threads(1)


def _scene(n_tris, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return tuple(c + rng.uniform(-0.1, 0.1, (n_tris, 3)).astype(np.float32)
                 for _ in range(3))


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32) - o    # into the scene
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def setup():
    v0, v1, v2 = _scene(500)
    flat = build_sah_bvh_numpy(v0, v1, v2)
    bvh = device_bvh_from_flat(flat, v0, v1, v2, device="cpu")
    o, d = _rays(2048)
    return dict(v=(v0, v1, v2), flat=flat, bvh=bvh, o=o, d=d)


def test_closest_matches_pallas_interpret(setup):
    v0, v1, v2 = setup["v"]
    cb = cut_clusters(jbuild(v0, v1, v2), dict(v0=v0, v1=v1, v2=v2))
    o, d = setup["o"], setup["d"]
    jt, payload = trace_cluster_bvh(jnp.asarray(o), jnp.asarray(d), cb, BIG_T,
                                    interpret=True)
    jp = np.asarray(payload[PAY_PRIM])
    jp = np.where(jp >= 0, jp.astype(np.int64), -1)
    t, prim, _, _ = trace_closest(torch.from_numpy(o), torch.from_numpy(d),
                                  BIG_T, setup["bvh"])
    np.testing.assert_array_equal(prim.numpy(), jp)
    hit = jp >= 0
    assert hit.sum() > 500
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit], rtol=2e-4)


def test_occluded_matches_pallas_interpret(setup):
    v0, v1, v2 = _scene(300, seed=4)
    cb = cut_clusters(jbuild(v0, v1, v2), dict(v0=v0, v1=v1, v2=v2))
    bvh = device_bvh_from_flat(build_sah_bvh_numpy(v0, v1, v2), v0, v1, v2,
                               device="cpu")
    o, d = _rays(1024, seed=5)
    tmax = np.full(1024, 1.5, np.float32)
    want = np.asarray(trace_cluster_bvh(jnp.asarray(o), jnp.asarray(d), cb,
                                        jnp.asarray(tmax), anyhit=True,
                                        interpret=True))
    got = trace_occluded(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tmax), bvh).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_matches_jax_lockstep(setup):
    v0, v1, v2 = setup["v"]
    jbvh = jdevice_bvh(setup["flat"], v0, v1, v2)
    o, d = setup["o"], setup["d"]
    tmax = np.random.default_rng(6).uniform(0.5, 4, o.shape[0]).astype(np.float32)
    jt, jp, ju, jv, jvis = bvh_intersect_counts(jnp.asarray(o), jnp.asarray(d),
                                                jbvh, t_max=jnp.asarray(tmax))
    t, p, u, v, st = trace_closest(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(tmax), setup["bvh"],
                                   stats=True)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    # the wrapper counts BVH4 steps; the JAX visits are BVH2 steps
    *_, st2 = bvh_intersect(torch.from_numpy(o), torch.from_numpy(d),
                            setup["bvh"], t_max=torch.from_numpy(tmax),
                            stats=True)
    np.testing.assert_array_equal(st2[0].numpy(), np.asarray(jvis))
    assert st[0].float().mean() < st2[0].float().mean()
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    # XLA's CPU backend contracts multiply-adds into FMAs and torch does
    # not; 1/det amplifies that last-bit difference on grazing hits
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=5e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=5e-5)
    occ = trace_occluded(torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tmax), setup["bvh"]).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(bvh_occluded(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tmax), jbvh)))
    np.testing.assert_array_equal(occ, p.numpy() >= 0)


def test_dead_lanes_miss(setup):
    o, d = (torch.from_numpy(a) for a in (setup["o"], setup["d"]))
    tmax = torch.where(torch.arange(o.shape[0]) % 2 == 0, BIG_T, 0.0)
    tmax[1::4] = -1.0
    t, prim, _, _ = trace_closest(o, d, tmax, setup["bvh"])
    assert (prim[1::2] == -1).all() and (prim[0::2] >= 0).any()
    assert torch.equal(t[1::2], tmax[1::2])
    occ = trace_occluded(o, d, tmax, setup["bvh"])
    assert not occ[1::2].any() and occ[0::2].any()


def _comb_bvh(depth):
    """A valid BVH whose right spine is `depth` interior nodes long."""
    rng = np.random.default_rng(7)
    n = depth + 1
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1, v2 = v0 + 0.1, v0 + np.float32([0.1, -0.1, 0.0])
    m = 2 * depth + 1
    left = np.zeros(m, np.int32)
    right = np.full(m, -1, np.int32)
    count = np.ones(m, np.int32)
    for i in range(depth):
        left[2 * i], right[2 * i], count[2 * i] = 2 * i + 1, 2 * i + 2, 0
        left[2 * i + 1] = i
    left[2 * depth] = depth
    flat = dict(nmin=np.full((m, 3), -2, np.float32),
                nmax=np.full((m, 3), 2, np.float32), left=left, right=right,
                count=count, prim=np.arange(n, dtype=np.int32))
    return device_bvh_from_flat(flat, v0, v1, v2, device="cpu")


def test_stack_capacity_is_checked(setup):
    """The wrappers check the BVH4's depth (3 * depth4 + 1 <= 64, a comb of
    BVH2 depth 2k collapses to BVH4 depth k); the BVH2 walk its own."""
    o, d = (torch.from_numpy(a[:64]) for a in (setup["o"], setup["d"]))
    limit4 = (STACK4_CAP - 1) // 3
    ok = _comb_bvh(2 * limit4)
    assert ok.depth4 == limit4
    trace_closest(o, d, BIG_T, ok)
    trace_occluded(o, d, BIG_T, ok)
    deep = _comb_bvh(2 * limit4 + 2)
    assert deep.depth4 == limit4 + 1
    with pytest.raises(ValueError, match="depth"):
        trace_closest(o, d, BIG_T, deep)
    with pytest.raises(ValueError, match="depth"):
        trace_occluded(o, d, BIG_T, deep)
    ok2 = _comb_bvh(STACK_CAP - 2)
    assert ok2.depth == STACK_CAP - 2
    bvh_intersect(o, d, ok2)
    with pytest.raises(ValueError, match="depth"):
        bvh_intersect(o, d, _comb_bvh(STACK_CAP - 1))


def test_non_cpu_tensors_never_take_the_plain_path(setup):
    """A tensor that is not on the CPU goes to the kernel route or raises:
    here (no card) a CUDA request raises, and a meta tensor is refused."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from lighthouse2_tpu_torch.convert import scene_from_numpy
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene_from_numpy({}, "cuda")
    from lighthouse2_tpu_torch.bvh import traverse as tv
    from lighthouse2_tpu_torch.render.kernels import trace as tk
    meta = lambda x: x.to("meta")
    b = setup["bvh"]
    mbvh = tv.DeviceBVH(nbox=meta(b.nbox), left=meta(b.left),
                        right=meta(b.right), count=meta(b.count),
                        prim=meta(b.prim), tri9=meta(b.tri9),
                        node4=meta(b.node4), tri4=meta(b.tri4), depth=b.depth,
                        depth4=b.depth4)
    o = torch.zeros((8, 3), device="meta")
    before = tk.trace_closest.launches
    with pytest.raises(ValueError, match="unsupported device"):
        trace_closest(o, o, 1.0, mbvh)
    with pytest.raises(ValueError, match="unsupported device"):
        trace_occluded(o, o, 1.0, mbvh)
    assert tk.trace_closest.launches == before


def test_wrappers_detach_rays_that_carry_gradients(setup):
    """Rays and tmax that require grad (a shadow tmax depends on vertex
    positions) give the same outputs as detached ones, and no autograd
    graph: traversal takes no gradient on either route."""
    o, d = (torch.from_numpy(a) for a in (setup["o"], setup["d"]))
    tmax = torch.full((o.shape[0],), 2.5)
    want_c = trace_closest(o, d, tmax, setup["bvh"])
    want_o = trace_occluded(o, d, tmax, setup["bvh"])
    og, dg, tg = (x.clone().requires_grad_() for x in (o, d, tmax))
    got_c = trace_closest(og * 1.0, dg * 1.0, tg * 1.0, setup["bvh"])
    got_o = trace_occluded(og * 1.0, dg * 1.0, tg * 1.0, setup["bvh"])
    for got, want in zip(got_c + (got_o,), want_c + (want_o,)):
        assert not got.requires_grad and got.grad_fn is None
        assert torch.equal(got, want)
    assert (want_c[1] >= 0).any() and want_o.any()


def test_build_device_bvh_and_counts_match_jax(setup):
    v0, v1, v2 = setup["v"]
    jb = jtraverse.build_device_bvh(v0, v1, v2)
    tb = ttraverse.build_device_bvh(v0, v1, v2, device="cpu")
    for f in ("nbox", "left", "right", "count", "prim", "tri9"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert tb.max_leaf == jb.max_leaf == 4
    o, d = setup["o"], setup["d"]
    tmax = np.random.default_rng(7).uniform(0.5, 4, o.shape[0]).astype(
        np.float32)
    jt, jp, ju, jv, jsteps = jtraverse.bvh_intersect_counts(
        jnp.asarray(o), jnp.asarray(d), jb, t_max=jnp.asarray(tmax))
    to, td, tm = (torch.from_numpy(a) for a in (o, d, tmax))
    t, p, u, v, steps = ttraverse.bvh_intersect_counts(to, td, tb, t_max=tm)
    assert steps.dtype == torch.int32 and (p >= 0).sum() > 150
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=5e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=5e-5)
    # JAX's positional arguments: v0, e1, e2 (accepted, not read), t_max
    e1 = torch.from_numpy(v1 - v0)
    e2 = torch.from_numpy(v2 - v0)
    hit = bvh_intersect(to, td, tb, torch.from_numpy(v0), e1, e2, tm)
    for a, b in zip(hit, (t, p, u, v)):
        assert torch.equal(a, b)
    occ = ttraverse.bvh_occluded(to, td, tm, tb, torch.from_numpy(v0), e1, e2)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(jtraverse.bvh_occluded(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jb)))
    # device_bvh_from_flat takes max_leaf fifth, as JAX's
    again = device_bvh_from_flat(build_sah_bvh_numpy(v0, v1, v2), v0, v1, v2,
                                 4, device="cpu")
    assert again.max_leaf == 4
