"""The port's refine_hit / refine_hit_rows against the JAX package.

The forward is the Moller-Trumbore re-test of the hit triangle (det cutoff
1e-6); the backward is its VJP with NaN/inf zeroed and each lane's gradient
clipped to +-1e4 (_REFINE_GRAD_LIMIT), a jax.custom_vjp in JAX and a
torch.autograd.Function in the port. The JAX side runs eagerly, op by op, so
neither side contracts multiply-adds.

The fixture holds regular hits, grazing rays, near-degenerate triangles and
lanes whose origins lie ~1e36 away, where the raw VJP overflows. Tolerances:
  - forward (t, u, v, ok): equal;
  - VJP: exactly equal where JAX's value sits at the clip (+-1e4) or was
    zeroed (the raw VJP is not finite); elsewhere within rtol 1e-4 of the
    larger of the value and the lane's largest raw component, plus atol
    1e-6. A lane's VJP sums products of its largest terms, and cancellation
    leaves its small components with the rounding of those terms, which the
    two frameworks' autodiff rules round in a different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.bvh.traverse import (
    _REFINE_GRAD_LIMIT, refine_hit as jrefine_hit,
    refine_hit_rows as jrefine_rows)
from lighthouse2_tpu_torch.bvh.traverse import (
    REFINE_GRAD_LIMIT, _refine_tuv_impl, refine_hit, refine_hit_rows)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _rays_and_rows(n=512, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    v0, e1, e2 = (f32(rng.uniform(-1, 1, (n, 3))) for _ in range(3))
    b = f32(rng.uniform(0.05, 0.45, (n, 2)))
    target = v0 + b[:, :1] * e1 + b[:, 1:] * e2
    o = f32(rng.uniform(-3, 3, (n, 3)))
    d = target - o
    k = n // 8
    # grazing: the direction almost in the triangle's plane
    nrm = np.cross(e1[:k], e2[:k])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dg = d[:k] - (d[:k] * nrm).sum(-1, keepdims=True) * nrm
    d[:k] = dg + nrm * f32(rng.uniform(1e-4, 1e-2, (k, 1))) * np.linalg.norm(
        dg, axis=-1, keepdims=True)
    o[:k] = target[:k] - d[:k]
    # near-degenerate: e2 almost parallel to e1
    e2[k:2 * k] = e1[k:2 * k] * 0.7 + f32(rng.uniform(-1e-3, 1e-3, (k, 3)))
    # origins ~1e36 away: the raw VJP overflows to inf / NaN
    o[k:k + 8] = v0[k:k + 8] + f32([1e36, -1e36, 5e35])
    d = f32(d / np.linalg.norm(d, axis=-1, keepdims=True))
    g9 = f32(np.concatenate([v0.T, e1.T, e2.T], 0))
    prim = np.arange(n, dtype=np.int32)
    prim[-4:] = -1
    cot = f32(rng.standard_normal((3, n)))
    return f32(o), d, g9, prim, cot


@pytest.fixture(scope="module")
def case():
    o, d, g9, prim, cot = _rays_and_rows()
    out, pullback = jax.vjp(
        lambda a, b, c: jrefine_rows(a, b, jnp.asarray(prim), c)[:3],
        *(jnp.asarray(x) for x in (o, d, g9)))
    jgrads = [np.asarray(g) for g in pullback(tuple(jnp.asarray(c)
                                                    for c in cot))]
    jok = np.asarray(jrefine_rows(*(jnp.asarray(x) for x in (o, d)),
                                  jnp.asarray(prim), jnp.asarray(g9))[3])
    return dict(o=o, d=d, g9=g9, prim=prim, cot=cot,
                jout=[np.asarray(x) for x in out], jgrads=jgrads, jok=jok)


def _port(case):
    ins = [torch.from_numpy(case[k]).requires_grad_() for k in ("o", "d", "g9")]
    t, u, v, ok = refine_hit_rows(ins[0], ins[1], torch.from_numpy(case["prim"]),
                                  ins[2])
    grads = torch.autograd.grad((t, u, v), ins,
                                tuple(torch.from_numpy(c) for c in case["cot"]))
    return [x.detach().numpy() for x in (t, u, v)], ok.numpy(), \
        [g.numpy() for g in grads]


def _raw_vjp(case):
    """The unclipped VJP of the same forward, by plain autograd."""
    ins = [torch.from_numpy(case[k]).requires_grad_() for k in ("o", "d", "g9")]
    return [g.numpy() for g in torch.autograd.grad(
        _refine_tuv_impl(*ins)[:3], ins,
        tuple(torch.from_numpy(c) for c in case["cot"]))]


def test_refine_forward_matches_jax(case):
    out, ok, _ = _port(case)
    for got, want in zip(out, case["jout"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ok, case["jok"])
    assert ok.sum() > 300 and (~ok).sum() > 4


def test_refine_vjp_matches_jax_and_clips(case):
    assert REFINE_GRAD_LIMIT == _REFINE_GRAD_LIMIT
    _, _, grads = _port(case)
    raw = _raw_vjp(case)
    fired_zero = fired_clip = 0
    for name, got, want, r in zip(("o", "d", "g9"), grads, case["jgrads"],
                                  raw):
        lane_axis = 0 if name == "g9" else 1          # g9 is [9, N]
        bad = ~np.isfinite(r)
        big = np.isfinite(r) & (np.abs(r) > REFINE_GRAD_LIMIT)
        fired_zero += bad.sum()
        fired_clip += big.sum()
        # the clip and the zeroing, as the backward defines them
        np.testing.assert_array_equal(got[bad], 0.0, err_msg=name)
        np.testing.assert_array_equal(
            got[big], np.sign(r[big]) * REFINE_GRAD_LIMIT, err_msg=name)
        # against JAX: exact at the clip and where zeroed ...
        at = (np.abs(want) == REFINE_GRAD_LIMIT) | bad
        np.testing.assert_array_equal(got[at], want[at], err_msg=name)
        # ... and within the lane-scaled tolerance elsewhere
        scale = np.abs(np.where(bad, 0.0, r)).max(lane_axis, keepdims=True)
        tol = RTOL * np.maximum(np.abs(want), scale) + ATOL
        off = np.abs(got - want) > tol
        assert not off.any(), (name, np.argwhere(off)[:5])
    assert fired_zero > 0 and fired_clip > 0, (fired_zero, fired_clip)


def test_refine_clips_each_lane_before_the_gather_sums():
    """64 grazing rays hit triangle 0; each lane's gradient is clipped at
    1e4 before the gather's backward sums the lanes, so the triangle's
    gradient exceeds 1e4, equals the sum of the per-lane clipped rows, and
    equals JAX's."""
    rng = np.random.default_rng(3)
    n = 64
    tri9 = np.zeros((9, 4), np.float32)
    tri9[:, :] = np.float32([0, 0, 0, 1, 0, 0, 0, 1, 0])[:, None]
    tri9[0, 1:] = np.float32([2.0, 4.0, 6.0])          # three other triangles
    b = rng.uniform(0.1, 0.4, (n, 2)).astype(np.float32)
    target = np.stack([b[:, 0], b[:, 1], np.zeros(n, np.float32)], -1)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d[:, 2] = -rng.uniform(2e-6, 2e-5, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (target - 0.5 * d).astype(np.float32)
    prim = np.zeros(n, np.int32)
    cot = rng.standard_normal((3, n)).astype(np.float32)

    tri = torch.from_numpy(tri9).requires_grad_()
    t, u, v, ok = refine_hit(torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(prim), tri)
    assert ok.all()
    (g_tri,) = torch.autograd.grad((t, u, v), (tri,),
                                   tuple(torch.from_numpy(c) for c in cot))
    rows = torch.from_numpy(tri9[:, prim]).requires_grad_()
    t2, u2, v2, _ = refine_hit_rows(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(prim), rows)
    (g_rows,) = torch.autograd.grad((t2, u2, v2), (rows,),
                                    tuple(torch.from_numpy(c) for c in cot))
    assert g_rows.abs().max() == REFINE_GRAD_LIMIT       # clipped per lane
    # the gather's backward and sum(1) add the 64 lanes in other orders:
    # allow their rounding, one float32 ulp of the largest possible sum
    sum_ulp = n * REFINE_GRAD_LIMIT * 2.0 ** -23
    torch.testing.assert_close(g_tri[:, 0], g_rows.sum(1), rtol=1e-6,
                               atol=sum_ulp)
    assert g_tri.abs().max() > 2 * REFINE_GRAD_LIMIT
    assert (g_tri[:, 1:] == 0).all()

    _, pullback = jax.vjp(lambda x: jrefine_hit(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(prim), x)[:3],
        jnp.asarray(tri9))
    (j_tri,) = pullback(tuple(jnp.asarray(c) for c in cot))
    np.testing.assert_allclose(g_tri.numpy(), np.asarray(j_tri), rtol=1e-5,
                               atol=sum_ulp)
