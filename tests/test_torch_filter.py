"""The port's SVGF + TAA filter functions against the JAX package's, run
eagerly on the same seeded images.

The G-buffers are a plane seen through a camera, with a band of miss
pixels (world position 1e30, depth 0, normal 0, albedo 1, as the classic
executor leaves them) and a nearer block with another normal and albedo;
the camera pans between frames, so some pixels reproject off-screen and
some land on the miss band. Tolerance everywhere: rtol 1e-4 / atol 1e-5 on
floats (the port sums a stencil's taps in another order, and XLA and ATen
round a few transcendentals differently); the integer history and the
`consistent` mask, which sit on thresholds a last-bit difference can flip,
equal on >= 99.9% of pixels.
  - svgf_filter over 4 frames, two static and two with the panning camera
    (prev_view given), each side carrying its own state: the colour and
    every FilterState field of every frame; reproject_history's outputs on
    the last frame;
  - atrous_pass for phases 1-3 and _neighborhood_clamp on noisy inputs;
  - taa with the Mitchell and the bilinear history read over 3 frames of a
    panning camera, then unsharpen;
  - the view maths: jittered_view's 4 phases, project_to_view (misses and
    points behind the camera included), _bilinear_taps and _mitchell_taps
    (weights, and indices wherever the weight is not 0), _mitchell_weight
    and _shift.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.render import filter as jf
from lighthouse2_tpu.scene.camera import Camera as JCamera
from lighthouse2_tpu_torch.core.types import ViewPyramid
from lighthouse2_tpu_torch.render import filter as tf

torch.set_num_threads(1)

H, W = 24, 32
RTOL, ATOL = 1e-4, 1e-5
INT_AGREE = 0.999


def views(xs):
    """JAX views of a camera panning along x, and the port's copies."""
    out = []
    for x in xs:
        c = JCamera(pixel_count=(W, H))
        c.aspect_ratio = W / H
        c.look_at(np.float32([x, 0.3, -5.0]), np.float32([x * 0.5, 0.0, 0.0]))
        jv = c.get_view()
        tv = ViewPyramid(**{f.name: torch.from_numpy(np.array(getattr(
            jv, f.name))) for f in dataclasses.fields(ViewPyramid)})
        out.append((jv, tv))
    return out


def gbuffer(jv, seed):
    """Primary-hit buffers of the plane z = 0 (a nearer block on part of
    it) through view jv, rows 0-2 missing, plus noisy direct / indirect."""
    rng = np.random.default_rng(seed)
    u = (np.arange(W, dtype=np.float32)[None, :, None] + 0.5) / W
    v = (np.arange(H, dtype=np.float32)[:, None, None] + 0.5) / H
    p1 = np.asarray(jv.p1)
    pos = np.asarray(jv.pos)
    d = p1 + u * (np.asarray(jv.p2) - p1) + v * (np.asarray(jv.p3) - p1) - pos
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = -pos[2] / d[..., 2]
    block = (np.abs(pos[0] + t * d[..., 0] - 0.5) < 0.6)
    t = np.where(block, t - 1.0, t)
    wp = pos + t[..., None] * d
    normal = np.where(block[..., None], np.float32([0.6, 0.0, -0.8]),
                      np.float32([0.0, 0.0, -1.0]))
    albedo = np.where(block[..., None], np.float32([0.2, 0.6, 0.3]),
                      np.float32([0.7, 0.7, 0.7]))
    miss = np.zeros((H, W), bool)
    miss[:3] = True
    wp[miss] = 1e30
    normal[miss] = 0.0
    albedo[miss] = 1.0
    t[miss] = 0.0
    direct = (0.5 + 0.3 * rng.standard_normal((H, W, 3))).clip(0, None)
    indirect = (0.2 + 0.2 * rng.standard_normal((H, W, 3))).clip(0, None)
    direct[5, 7] = 40.0                          # a firefly for the clamps
    return [x.astype(np.float32) for x in
            (direct, indirect, albedo, normal, t, wp)]


def both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


def close(t, j, msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def agree(t, j):
    return (t.numpy() == np.asarray(j)).mean()


def test_svgf_frames_match_jax():
    vs = views([0.0, 0.0, 0.25, 0.6])
    jst, tst = jf.FilterState.make(H, W), tf.FilterState.make(H, W, "cpu")
    for f, (jv, tv) in enumerate(vs):
        jin, tin = both(gbuffer(jv, f))
        prev = vs[f - 1] if f >= 2 else (None, None)
        jc, jst = jf.svgf_filter(*jin, jst, prev_view=prev[0])
        tc, tst = tf.svgf_filter(*tin, tst, prev_view=prev[1])
        close(tc, jc, f"colour {f}")
        for k in ("moments", "shading", "world_pos"):
            close(getattr(tst, k), getattr(jst, k), f"{k} {f}")
        assert tst.history.dtype == torch.int32
        assert agree(tst.history, jst.history) >= INT_AGREE, f
    hist = tst.history.numpy()
    assert 0 < (hist > 0).mean() < 1 and hist.max() >= 2
    assert np.isfinite(tc.numpy()).all()

    # reproject_history itself, on the last frame's inputs and state
    ddx = torch.abs(tin[4] - tf._shift(tin[4], 0, 1)).numpy()
    ddy = torch.abs(tin[4] - tf._shift(tin[4], 1, 0)).numpy()
    allowed = np.maximum(0.05, ddx + ddy)
    jr = jf.reproject_history(jst, jin[5], jin[3], jnp.asarray(allowed),
                              vs[2][0])
    tr = tf.reproject_history(tst, tin[5], tin[3], torch.from_numpy(allowed),
                              vs[2][1])
    close(tr[0], jr[0], "moments")
    close(tr[1], jr[1], "shading")
    assert agree(tr[2], jr[2]) >= INT_AGREE
    assert agree(tr[3], jr[3]) >= INT_AGREE
    assert 0 < tr[3].float().mean() < 1


def test_atrous_and_neighborhood_clamp_match_jax():
    (jv, _), = views([0.1])
    rng = np.random.default_rng(7)
    arrays = gbuffer(jv, 3)
    moments = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    history = rng.integers(0, 4, (H, W)).astype(np.int32)
    dep = arrays[4]
    ddxy = np.stack([np.abs(dep - np.roll(dep, -1, 1)),
                     np.abs(dep - np.roll(dep, -1, 0))], -1)
    jin, tin = both([arrays[0], arrays[1], arrays[2], arrays[3], dep, ddxy,
                     moments, history])
    for phase in (1, 2, 3):
        jo = jf.atrous_pass(*jin, phase)
        to = tf.atrous_pass(*tin, phase)
        for a, b in zip(to, jo):
            close(a, b, f"phase {phase}")
    prev = rng.uniform(0, 2, (2, H, W, 3)).astype(np.float32)
    jo = jf._neighborhood_clamp(None, jin[0], jin[1], *map(jnp.asarray, prev))
    to = tf._neighborhood_clamp(None, tin[0], tin[1],
                                *map(torch.from_numpy, prev))
    for a, b in zip(to, jo):
        close(a, b, "clamp")


@pytest.mark.parametrize("mitchell", [True, False])
def test_taa_and_unsharpen_match_jax(mitchell):
    vs = views([0.0, 0.2, 0.45])
    jst, tst = jf.TAAState.make(H, W), tf.TAAState.make(H, W, "cpu")
    prev = (None, None)
    for f, (jv, tv) in enumerate(vs):
        arrays = gbuffer(jv, 10 + f)
        jin, tin = both([arrays[0] * arrays[2], arrays[5]])
        jo, jst = jf.taa(jin[0], jst, world_pos=jin[1], prev_view=prev[0],
                         mitchell=mitchell)
        to, tst = tf.taa(tin[0], tst, world_pos=tin[1], prev_view=prev[1],
                         mitchell=mitchell)
        close(to, jo, f"taa {f}")
        close(tst.prev, jst.prev, f"state {f}")
        close(tf.unsharpen(to), jf.unsharpen(jo), f"unsharpen {f}")
        prev = (jv, tv)
    assert np.isfinite(to.numpy()).all()
    # the static read (no reprojection) too
    jo, _ = jf.taa(jin[0], jst)
    to, _ = tf.taa(tin[0], tst)
    close(to, jo, "static")


def test_view_maths_match_jax():
    (jv, tv), = views([0.3])
    for f in range(4):
        jj, jxy = jf.jittered_view(jv, f, W, H)
        tj, txy = tf.jittered_view(tv, f, W, H)
        assert jxy == txy
        for k in ("pos", "p1", "p2", "p3"):
            np.testing.assert_array_equal(getattr(tj, k).numpy(),
                                          np.asarray(getattr(jj, k)), k)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, 3, (6, 40, 3)).astype(np.float32)
    pts[0, :5] = 1e30                       # misses
    pts[1, :5, 2] = -9.0                    # behind the camera
    jp = jf.project_to_view(jnp.asarray(pts), jv, W, H)
    tp = tf.project_to_view(torch.from_numpy(pts), tv, W, H)
    fin = np.isfinite(np.asarray(jp[0]))
    np.testing.assert_array_equal(np.isfinite(tp[0].numpy()), fin)
    for a, b in zip(tp[:2], jp[:2]):
        np.testing.assert_allclose(a.numpy()[fin], np.asarray(b)[fin],
                                   rtol=RTOL, atol=1e-3)
    np.testing.assert_array_equal(tp[2].numpy(), np.asarray(jp[2]))
    assert 0 < tp[2].float().mean() < 1

    px = np.concatenate([rng.uniform(-4, W + 4, 300), [np.nan, 1e30, -1e30]]
                        ).astype(np.float32)
    py = np.concatenate([rng.uniform(-4, H + 4, 300), [1.5, np.nan, 2.0]]
                        ).astype(np.float32)
    for jtaps, ttaps in ((jf._bilinear_taps, tf._bilinear_taps),
                         (jf._mitchell_taps, tf._mitchell_taps)):
        jl = list(jtaps(jnp.asarray(px), jnp.asarray(py), W, H))
        ti, tw = ttaps(torch.from_numpy(px), torch.from_numpy(py), W, H)
        assert ti.shape[0] == len(jl)
        for k, (jidx, jw) in enumerate(jl):
            jw = np.asarray(jw)
            got = tw[k].numpy()
            both_nan = np.isnan(got) & np.isnan(jw)
            np.testing.assert_allclose(got[~both_nan], jw[~both_nan],
                                       rtol=RTOL, atol=ATOL)
            live = ~both_nan & (jw != 0)
            np.testing.assert_array_equal(ti[k].numpy()[live],
                                          np.asarray(jidx)[live])
            assert ((ti[k] >= 0) & (ti[k] < W * H)).all()
    x = np.linspace(-3, 3, 61).astype(np.float32)
    close(tf._mitchell_weight(torch.from_numpy(x)),
          jf._mitchell_weight(jnp.asarray(x)))
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for dy, dx in ((0, 1), (-2, 3), (4, -4)):
        np.testing.assert_array_equal(
            tf._shift(torch.from_numpy(img), dy, dx).numpy(),
            np.asarray(jf._shift(jnp.asarray(img), dy, dx)))
