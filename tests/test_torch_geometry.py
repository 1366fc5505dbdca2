"""The port's geometry and sampling warps against the JAX package.

Same seeded numpy inputs through both; float32 results must agree to
rtol 1e-5 / atol 1e-6: XLA and torch evaluate sqrt, rsqrt, sin and cos with
different last-bit rounding, and nothing here amplifies that. Boolean hit
masks must agree except on lanes within that rounding of an edge. Where a
value is a quotient by a determinant or a slab distance 1/d (the ray
tests), t, u and v may differ by rtol 1e-4, as in test_mt_comp_matches;
the 4x4 transforms by atol 1e-5 (a matrix product's sums in another order,
values of order 10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core import geometry as jg
from lighthouse2_tpu.core import sampling as js
from lighthouse2_tpu_torch.core import geometry as tg
from lighthouse2_tpu_torch.core import sampling as ts

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N = 20_000


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_mt_comp_matches():
    rng = np.random.default_rng(0)
    d = _unit(rng, N)
    v0 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    # aim most rays at a point of their triangle (barycentrics may leave it)
    ab = rng.uniform(-0.1, 0.6, (N, 2)).astype(np.float32)
    target = v0 + ab[:, :1] * e1 + ab[:, 1:] * e2
    o = (target - rng.uniform(0.2, 3, (N, 1)) * d).astype(np.float32)
    tmax = rng.uniform(0.5, 5, N).astype(np.float32)
    cols = [a[:, k] for a in (o, d, v0, e1, e2) for k in range(3)]
    jt, ju, jv, jh = jg.mt_comp(*map(jnp.asarray, cols), 1e-6,
                                jnp.asarray(tmax))
    tt, tu, tv, th = tg.mt_comp(*map(torch.from_numpy, cols), 1e-6,
                                torch.from_numpy(tmax))
    jh, th = np.asarray(jh), th.numpy()
    assert (jh == th).mean() >= 0.9999 and jh.sum() > N // 20
    both = jh & th
    _close(tt.numpy()[both], np.asarray(jt)[both], rtol=1e-4)
    _close(tu.numpy(), np.asarray(ju), rtol=1e-4, atol=1e-5)
    _close(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


def test_onb_safe_origin_consistent_normal_match():
    rng = np.random.default_rng(1)
    n = _unit(rng, N)
    d = _unit(rng, N)
    o = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    alpha = rng.uniform(0, 0.8, N).astype(np.float32)
    for a, b in zip(jg.onb(jnp.asarray(n)), tg.onb(torch.from_numpy(n))):
        _close(b.numpy(), a, atol=1e-5)
    _close(tg.safe_origin(torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(n), 1e-4).numpy(),
           jg.safe_origin(jnp.asarray(o), jnp.asarray(d), jnp.asarray(n),
                          jnp.float32(1e-4)))
    # consistent_normal is fed what shading feeds it: d against the normal
    d_in = np.where((d * n).sum(-1, keepdims=True) > 0, -d, d)
    _close(tg.consistent_normal(torch.from_numpy(d_in), torch.from_numpy(n),
                                torch.from_numpy(alpha)).numpy(),
           jg.consistent_normal(jnp.asarray(d_in), jnp.asarray(n),
                                jnp.asarray(alpha)), atol=1e-5)
    _close(tg.normalize(torch.from_numpy(o)).numpy(),
           jg.normalize(jnp.asarray(o)))


@pytest.mark.parametrize("name", ["cosine_hemisphere", "uniform_sphere",
                                  "uniform_hemisphere"])
def test_warps_match(name):
    rng = np.random.default_rng(2)
    r0, r1 = rng.random((2, N), dtype=np.float32)
    _close(getattr(ts, name)(torch.from_numpy(r0), torch.from_numpy(r1)).numpy(),
           getattr(js, name)(jnp.asarray(r0), jnp.asarray(r1)), atol=1e-5)


def test_cone_barycentrics_triangle_match():
    rng = np.random.default_rng(3)
    r0, r1, c = rng.random((3, N), dtype=np.float32)
    _close(ts.uniform_cone(torch.from_numpy(r0), torch.from_numpy(r1),
                           torch.from_numpy(c)).numpy(),
           js.uniform_cone(jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(c)),
           atol=1e-5)
    r0[:2] = (0.0, np.float32(1.0) - np.float32(2 ** -24))
    for a, b in zip(js.random_barycentrics(jnp.asarray(r0)),
                    ts.random_barycentrics(torch.from_numpy(r0))):
        _close(b.numpy(), a)
    for a, b in zip(js.sample_triangle_simple(jnp.asarray(r0), jnp.asarray(r1)),
                    ts.sample_triangle_simple(torch.from_numpy(r0),
                                              torch.from_numpy(r1))):
        _close(b.numpy(), a)


def _helper_inputs(name, rng):
    """Seeded inputs of each core/geometry.py helper, as numpy arrays."""
    f32 = lambda a: np.asarray(a, np.float32)
    u = lambda *shape: f32(rng.uniform(-1, 1, shape))
    if name in ("length",):
        return (f32(rng.normal(size=(N, 3)) * 3),)
    if name == "refract":
        n = _unit(rng, N)
        d = _unit(rng, N)
        d = np.where((d * n).sum(-1, keepdims=True) > 0, -d, d)
        return d, n, f32(rng.uniform(0.5, 1.8, N))
    if name == "fresnel_dielectric_exact":
        return f32(rng.uniform(-0.1, 1.1, N)), f32(rng.uniform(0.5, 2.0, N))
    if name == "schlick_fresnel":
        return (f32(rng.uniform(0, 1, N)), f32(rng.uniform(1, 1.5, N)),
                f32(rng.uniform(1, 2.5, N)))
    if name == "world_to_tangent":
        return u(N, 3), _unit(rng, N)
    if name == "intersect_tri":
        d = _unit(rng, N)
        v0, e1, e2 = u(N, 3), u(N, 3), u(N, 3)
        ab = f32(rng.uniform(-0.1, 0.6, (N, 2)))
        o = f32(v0 + ab[:, :1] * e1 + ab[:, 1:] * e2
                - rng.uniform(0.2, 3, (N, 1)) * d)
        return o, d, v0, e1, e2, 1e-6, f32(rng.uniform(0.5, 5, N))
    if name == "intersect_aabb":
        d = _unit(rng, N)
        c = u(N, 3)
        h = f32(rng.uniform(0.05, 0.5, (N, 3)))
        o = f32(c - rng.uniform(0.5, 3, (N, 1)) * d + 0.3 * u(N, 3))
        return o, f32(1.0 / d), c - h, c + h, f32(rng.uniform(0.5, 5, N))
    m = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    m[:, :3, :] = u(N, 3, 4) * 4
    return m, u(N, 3) * 3          # transform_point / transform_vector


GEOMETRY_HELPERS = ["length", "refract", "fresnel_dielectric_exact",
                    "schlick_fresnel", "world_to_tangent", "intersect_tri",
                    "intersect_aabb", "transform_point", "transform_vector"]


@pytest.mark.parametrize("name", GEOMETRY_HELPERS)
def test_geometry_helpers_match(name):
    args = _helper_inputs(name, np.random.default_rng(4))
    conv = lambda a, f: f(a) if isinstance(a, np.ndarray) else a
    want = getattr(jg, name)(*(conv(a, jnp.asarray) for a in args))
    got = getattr(tg, name)(*(conv(a, torch.from_numpy) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    if name.startswith("intersect"):
        jh, th = want[-1], got[-1]
        assert (jh == th).mean() >= 0.9999 and 0 < jh.sum() < N
        both = jh & th
        for g, w in zip(got[:-1], want[:-1]):
            _close(g[both], w[both], rtol=1e-4, atol=1e-5)
        return
    for g, w in zip(got, want):
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, atol=1e-5 if name.startswith("transform")
                   else ATOL)
