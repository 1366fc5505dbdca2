"""The port's RNG and blue-noise sampler against the JAX package, bit-exact.

lighthouse2_tpu_torch/core/rng.py carries uint32 in int64 and masks after
every multiply, shift and add; these tests feed the same numpy seeds to both
packages and require identical bits. The per-pass seeds of AccumState are
0-d tensors, as JAX's device scalars: their dtypes and the camera seed's
advance over one regen pass are held to JAX's (eager jnp, no compile).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core import bluenoise as jbn
from lighthouse2_tpu.core import rng as jrng
from lighthouse2_tpu.core.types import RenderConfig as JRenderConfig
from lighthouse2_tpu.render.wavefront import AccumState as JAccumState
from lighthouse2_tpu_torch.core import bluenoise as tbn
from lighthouse2_tpu_torch.core import rng as trng
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import wavefront as twf
from lighthouse2_tpu_torch.scene.presets import cornell_box

torch.set_num_threads(1)

N_SEEDS = 200_000


def _seeds(seed=0):
    s = np.random.default_rng(seed).integers(0, 2 ** 32, N_SEEDS,
                                             dtype=np.uint64)
    s[:4] = (0, 1, 0x7FFFFFFF, 0xFFFFFFFF)
    return s.astype(np.uint32)


def _j(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("name", ["wang_hash", "xorshift32"])
def test_hashes_bit_exact(name):
    s = _seeds()
    want = _j(getattr(jrng, name)(jnp.asarray(s)))
    got = getattr(trng, name)(_t(s)).numpy()
    np.testing.assert_array_equal(got, want)


def test_random_float_bit_exact():
    s = _seeds(1)
    js, jf = jrng.random_float(jnp.asarray(s))
    ts, tf = trng.random_float(_t(s))
    np.testing.assert_array_equal(ts.numpy(), _j(js))
    assert tf.dtype == torch.float32
    np.testing.assert_array_equal(tf.numpy().view(np.uint32),
                                  np.asarray(jf).view(np.uint32))


def test_seed_functions_bit_exact():
    rng = np.random.default_rng(2)
    path_idx = rng.integers(0, 2 ** 32, N_SEEDS, dtype=np.uint64).astype(np.uint32)
    other = rng.integers(0, 2 ** 32, N_SEEDS, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        trng.path_seed(_t(path_idx), _t(other)).numpy(),
        _j(jrng.path_seed(jnp.asarray(path_idx), jnp.asarray(other))))
    np.testing.assert_array_equal(
        trng.raygen_seed(_t(path_idx), _t(other)).numpy(),
        _j(jrng.raygen_seed(jnp.asarray(path_idx), jnp.asarray(other))))


def test_frame_r0_bit_exact():
    """The camera seed as a Python int (frame_r0 also takes AccumState's
    0-d tensor, below) with per-lane path lengths, as the regen executor
    calls it."""
    path_len = np.random.default_rng(3).integers(1, 17, 4096).astype(np.uint32)
    j_seed, t_seed = jnp.uint32(jrng.CAM_RNG_SEED), trng.CAM_RNG_SEED
    for _ in range(20):
        j_seed, j_r0 = jrng.frame_r0(j_seed, jnp.asarray(path_len))
        t_seed, t_r0 = trng.frame_r0(t_seed, _t(path_len))
        assert t_seed == int(j_seed)
        np.testing.assert_array_equal(t_r0.numpy(), _j(j_r0))


def test_generate_mask_bit_exact_small():
    np.testing.assert_array_equal(tbn.generate_mask(n=16, seed=5),
                                  jbn.generate_mask(n=16, seed=5))


def test_bluenoise_mask_and_sample_bit_exact():
    mask = tbn.get_mask()
    np.testing.assert_array_equal(mask, jbn.get_mask())
    rng = np.random.default_rng(4)
    n = 50_000
    x = rng.integers(0, 1024, n)
    y = rng.integers(0, 1024, n)
    s = rng.integers(0, 300, n)
    d = rng.integers(0, 70, n)
    want = np.asarray(jbn.sample(jnp.asarray(mask), jnp.asarray(x, jnp.int32),
                                 jnp.asarray(y, jnp.int32),
                                 jnp.asarray(s, jnp.uint32),
                                 jnp.asarray(d, jnp.int32)))
    got = tbn.sample(torch.from_numpy(mask), torch.from_numpy(x),
                     torch.from_numpy(y), torch.from_numpy(s),
                     torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_accum_state_seeds_are_device_scalars_as_jax():
    """AccumState.make: the accumulator and sample_count have JAX's dtypes
    and shapes; cam_seed is the 0-d int64 that carries JAX's uint32, with
    its value."""
    kw = dict(width=8, height=8, max_path_length=2)
    j = JAccumState.make(JRenderConfig(**kw))
    t = twf.AccumState.make(RenderConfig(**kw), "cpu")
    for name in ("accumulator", "sample_count"):
        jx, tx = getattr(j, name), getattr(t, name)
        assert str(tx.dtype) == f"torch.{jx.dtype}", name
        assert tuple(tx.shape) == jx.shape, name
    assert j.cam_seed.dtype == jnp.uint32 and j.cam_seed.shape == ()
    assert t.cam_seed.dtype == torch.int64 and t.cam_seed.dim() == 0
    assert int(t.cam_seed) == int(j.cam_seed) == trng.CAM_RNG_SEED
    assert int(t.sample_count) == int(j.sample_count) == 0


def test_regen_pass_advances_cam_seed_as_jax():
    """After one regen pass of path L the port's cam_seed is JAX's
    rng.frame_r0 applied L times from jnp.uint32(CAM_RNG_SEED) (one draw a
    bounce); sample_count is int32 and advanced by spp on the device."""
    path = 3
    cfg = RenderConfig(width=16, height=16, spp_per_pass=2,
                       max_path_length=path, path_regen=True)
    scene, cam = cornell_box(16, 16)
    cpu = torch.device("cpu")
    state, _ = twf.render_pass_regen(scene.sync(cpu), cam.get_view(cpu),
                                     twf.AccumState.make(cfg, cpu), cfg)
    seed = jnp.uint32(jrng.CAM_RNG_SEED)
    for li in range(path):
        seed, _ = jrng.frame_r0(seed, jnp.uint32(li + 1))
    assert state.cam_seed.dtype == torch.int64 and state.cam_seed.dim() == 0
    assert int(state.cam_seed) == int(seed)
    assert state.sample_count.dtype == torch.int32
    assert state.sample_count.dim() == 0
    assert int(state.sample_count) == cfg.spp_per_pass
