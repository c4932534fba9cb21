"""The port's threefry PRNG (``ops/prng.py``) against ``jax.random``.

Tolerance: none. Keys, splits and uniform draws are bit-identical to JAX's
default ``threefry2x32`` implementation with ``jax_threefry_partitionable``
(the default of the JAX the package pins), for the calls the estimator's
path makes: ``PRNGKey(seed)`` per keyframe check, ``split(key, 5)`` over the
DA candidates and ``uniform(key, (n_hyp, K))`` for the RANSAC draws.
"""

import jax
import numpy as np
import pytest
import torch

from srba_slam_tpu_torch.ops import prng

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

SEEDS = (0, 7, 8, 12345, 2**31 + 3, 2**32 - 1)


def test_jax_uses_the_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    ref = np.asarray(jax.random.PRNGKey(seed)).view(np.int32).astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", (2, 5, 7))
def test_split_matches_jax(seed, n):
    ref = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)).astype(np.int64)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), n).numpy(), ref)
    # a split of a split: the keys the DA cascade hands each candidate
    ref2 = np.asarray(jax.random.split(jax.random.split(jax.random.PRNGKey(seed), n)[n - 1], 3))
    got2 = prng.split(prng.split(prng.PRNGKey(seed), n)[n - 1], 3)
    np.testing.assert_array_equal(got2.numpy(), ref2.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (3, 5), (128, 512), (300, 512), (7, 3, 11)])
def test_uniform_matches_jax(seed, shape):
    jkey = jax.random.split(jax.random.PRNGKey(seed), 5)[2]
    ref = np.asarray(jax.random.uniform(jkey, shape))
    got = prng.uniform(prng.split(prng.PRNGKey(seed), 5)[2], shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("seed", (0, 7, 2**31, 2**32 - 1))
def test_prng_key_from_a_device_seed_matches_jax(seed):
    """A seed given as an int64 scalar tensor (a captured check's input)
    builds the key on its device: JAX's words, and the host route's."""
    ref = np.asarray(jax.random.PRNGKey(seed)).view(np.int32).astype(np.int64) & 0xFFFFFFFF
    got = prng.PRNGKey(torch.tensor(seed, dtype=torch.int64))
    assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, prng.PRNGKey(seed))


def test_seed_outside_32_bits_is_refused():
    with pytest.raises(ValueError):
        prng.PRNGKey(2**32)
    with pytest.raises(ValueError):
        prng.check_seed(-1)
    assert prng.check_seed(2**32 - 1) == 2**32 - 1
