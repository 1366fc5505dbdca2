"""The port's RNG and blue-noise sampler against the JAX package, bit-exact.

lighthouse2_tpu_torch/core/rng.py carries uint32 in int64 and masks after
every multiply, shift and add; these tests feed the same numpy seeds to both
packages and require identical bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthouse2_tpu.core import bluenoise as jbn
from lighthouse2_tpu.core import rng as jrng
from lighthouse2_tpu_torch.core import bluenoise as tbn
from lighthouse2_tpu_torch.core import rng as trng

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
    """Host-side camera seed (a Python int in the port) with per-lane path
    lengths, as the regen executor calls it."""
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
