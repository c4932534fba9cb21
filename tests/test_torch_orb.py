"""Bits and upright ORB descriptors in the port against the JAX package.

Tolerances:
* bit packing, popcounts and descriptors: none (integer results). The
  descriptors are compared on the SAME blurred image, JAX's, fed to both.
* gauss_blur7: within 1 grey level at under 1e-4 of pixels. The 7-tap f32
  sums round at .5 differently from XLA's convolution at a few pixels in
  10^5, whatever the summation order; that is the only allowed difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops import bits as jbits
from srba_slam_tpu.ops.orb import _PATTERN_OPENCV
from srba_slam_tpu.ops.orb import describe as jdescribe
from srba_slam_tpu.ops.orb import gauss_blur7 as jblur
from srba_slam_tpu.ops.pallas_fast import orb_descriptors_pallas
from srba_slam_tpu_torch.ops import bits, hopper_fast
from srba_slam_tpu_torch.ops.orb import (PATTERN_OFFSETS, describe, gauss_blur7,
                                         upright_descriptors)

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)


def _as_i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def test_bits_match_jax(rng):
    words = rng.integers(0, 2**32, (7, 8), dtype=np.uint64).astype(np.uint32)
    words[0, :] = 0xFFFFFFFF  # every sign bit set
    got_bits = bits.unpack_bits(_as_i32(words)).numpy()
    np.testing.assert_array_equal(got_bits, np.asarray(jbits.unpack_bits(jnp.asarray(words))))
    repacked = bits.pack_bits(torch.from_numpy(got_bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(repacked, words)
    np.testing.assert_array_equal(bits.popcount_desc(_as_i32(words)).numpy(),
                                  np.asarray(jbits.popcount_desc(jnp.asarray(words))))


def test_pattern_matches_jax():
    np.testing.assert_array_equal(
        PATTERN_OFFSETS, np.rint(_PATTERN_OPENCV).astype(np.int32).reshape(256, 4))


def test_gauss_blur7_within_one(rng):
    img = rng.integers(0, 256, (200, 320)).astype(np.uint8)
    ref = np.asarray(jblur(jnp.asarray(img, jnp.float32)))
    got = gauss_blur7(torch.from_numpy(img)).numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= 1.0
    assert (diff > 0).mean() < 1e-4


@pytest.fixture(scope="module")
def pallas_case():
    """tests/test_pallas_fast.py's bit-plane case: random images, their JAX
    blur, margin-safe keypoints, and the JAX TPU kernel's descriptors
    (interpret mode), which must equal JAX describe()'s."""
    rng = np.random.default_rng(0)
    n, h, w, k = 2, 123, 300, 64
    imgs = rng.integers(0, 255, (n, h, w)).astype(np.float32)
    ys = rng.integers(16, h - 16, (n, k)).astype(np.int32)
    xs = rng.integers(16, w - 16, (n, k)).astype(np.int32)
    valid = rng.random((n, k)) < 0.9
    jimgs = jnp.asarray(imgs)
    blurred = jax.vmap(jblur)(jimgs)
    jkp = (jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(valid))
    ref = np.asarray(orb_descriptors_pallas(blurred, *jkp, tile_h=32, interpret=True))
    ref_describe = np.asarray(jax.vmap(lambda im, y, x, v: jdescribe(
        im, y, x, v, oriented=False, patch_safe=True)[0])(jimgs, *jkp))
    np.testing.assert_array_equal(ref, ref_describe)
    return np.array(blurred), ys, xs, valid, ref


@pytest.mark.parametrize("route", ["describe", "wrapper"])
def test_descriptors_match_pallas_interpret(pallas_case, route):
    """Upright descriptors bit-exact against the JAX TPU kernel on JAX's
    blurred images, through the plain function and the K2 wrapper."""
    blurred, ys, xs, valid, ref = pallas_case
    tb = torch.from_numpy(blurred)
    args = (torch.from_numpy(ys), torch.from_numpy(xs), torch.from_numpy(valid))
    if route == "wrapper":
        before = hopper_fast.orb_descriptors.launches
        got = hopper_fast.orb_descriptors(tb, *args, margin=16)
        assert hopper_fast.orb_descriptors.launches == before
    else:
        got = upright_descriptors(tb, *args)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    assert not got.numpy()[~valid].any()


def test_describe_on_own_blur(rng):
    """describe() = gauss_blur7 + upright_descriptors; with the port's own
    blur the bits may differ from JAX only where the blur did."""
    img = rng.integers(0, 255, (123, 300)).astype(np.float32)
    ys = torch.from_numpy(rng.integers(16, 107, 48).astype(np.int32))
    xs = torch.from_numpy(rng.integers(16, 284, 48).astype(np.int32))
    valid = torch.ones(48, dtype=torch.bool)
    desc, theta = describe(torch.from_numpy(img), ys, xs, valid, oriented=False)
    np.testing.assert_array_equal(
        desc.numpy(), upright_descriptors(gauss_blur7(torch.from_numpy(img)), ys, xs, valid).numpy())
    assert not theta.any()
    with pytest.raises(NotImplementedError):
        describe(torch.from_numpy(img), ys, xs, valid, oriented=True)


def test_orb_wrapper_checks():
    blurred = torch.zeros((1, 64, 64))
    ys = torch.full((1, 4), 20, dtype=torch.int32)
    valid = torch.ones((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        hopper_fast.orb_descriptors(blurred, ys, ys, valid, margin=15)
    with pytest.raises(TypeError):
        hopper_fast.orb_descriptors(blurred, ys.long(), ys, valid)
    with pytest.raises(ValueError):
        hopper_fast.orb_descriptors(blurred, ys, ys[:, :2], valid)
