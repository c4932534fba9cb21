"""K3: the FAST score map without suppression, against the JAX package's
Pallas kernel ``fast_score_map_pallas``, run in interpret mode on the CPU
as ``tests/test_pallas_fast.py`` runs it (the same shapes and ``tile_h``).

Tolerance: none. The wrapper ``hopper_fast.fast_score_map`` takes its plain
version ``ops/fast.py`` ``fast_score_map`` for CPU tensors, and both are
bit-exact against the Pallas kernel; the CUDA kernel is held bit-exact
against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops.pallas_fast import fast_score_map_pallas
from srba_slam_tpu_torch.ops import cuda_build, hopper_fast
from srba_slam_tpu_torch.ops.fast import fast_score_map

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("shape,th,tile_h", [((200, 320), 12.0, 64), ((123, 300), 8.0, 32)])
@pytest.mark.parametrize("kind", ["uniform", "plateau"])
def test_fast_score_map_matches_pallas(shape, th, tile_h, kind):
    rng = np.random.default_rng(3)
    if kind == "uniform":
        img = rng.uniform(0, 255, shape).astype(np.float32)
    else:
        img = (rng.integers(0, 8, shape) * 30).astype(np.float32)
    ref = np.asarray(fast_score_map_pallas(jnp.asarray(img), th, margin=16, tile_h=tile_h,
                                           interpret=True))
    got = fast_score_map(torch.from_numpy(img), th, margin=16).numpy()
    np.testing.assert_array_equal(got, ref)
    wrapped = hopper_fast.fast_score_map(torch.from_numpy(img), th, margin=16).numpy()
    np.testing.assert_array_equal(wrapped, ref)


def test_wrapper_takes_uint8_and_batches_on_the_cpu():
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (3, 123, 300)).astype(np.uint8)
    before = hopper_fast.fast_score_map.launches
    got = hopper_fast.fast_score_map(torch.from_numpy(imgs), 8.0)
    assert hopper_fast.fast_score_map.launches == before  # no kernel on the CPU
    assert got.dtype == torch.float32 and got.shape == imgs.shape
    for i in range(3):
        ref = np.asarray(fast_score_map_pallas(jnp.asarray(imgs[i]), 8.0, margin=16,
                                               tile_h=32, interpret=True))
        np.testing.assert_array_equal(got[i].numpy(), ref)


@pytest.mark.parametrize("margin", [3, 4])
def test_least_margins_on_a_batch_match_pallas(margin):
    """The margins that leave the circle of an inner pixel touching the
    border, on a [3, H, W] uint8 batch (each image through the Pallas
    kernel on its own)."""
    rng = np.random.default_rng(margin)
    imgs = rng.integers(0, 256, (3, 40, 150)).astype(np.uint8)
    imgs[1] = imgs[1] // 30 * 30                    # a plateau: score == th occurs
    got = hopper_fast.fast_score_map(torch.from_numpy(imgs), 30.0, margin=margin).numpy()
    for i in range(3):
        ref = np.asarray(fast_score_map_pallas(jnp.asarray(imgs[i]), 30.0, margin=margin,
                                               tile_h=32, interpret=True))
        np.testing.assert_array_equal(got[i], ref)
        assert ref[margin].any() and not ref[margin - 1].any()


@pytest.mark.parametrize("margin", [0, 1, 2])
def test_margins_under_the_circle_wrap_as_the_jax_map(margin):
    """Under a margin of 3 a pixel near a border keeps the score of a circle
    that wraps to the opposite border; the JAX package's score map
    (``ops/fast.py``, the one it runs at such margins) rolls the same way."""
    from srba_slam_tpu.ops.fast import fast_score_map as jax_fast_score_map

    rng = np.random.default_rng(10 + margin)
    imgs = rng.integers(0, 256, (2, 40, 150)).astype(np.uint8)
    got = hopper_fast.fast_score_map(torch.from_numpy(imgs), 30.0, margin=margin).numpy()
    for i in range(2):
        ref = np.asarray(jax_fast_score_map(jnp.asarray(imgs[i], jnp.float32), 30.0,
                                            margin=margin))
        np.testing.assert_array_equal(got[i], ref)
        assert ref[margin].any() and ref[:, margin].any()


@pytest.mark.parametrize("n,h,w,grid", [
    (1, 370, 1226, (10, 12, 1)),          # one KITTI image: 120 blocks, one an SM
    (2, 370, 1226, (10, 12, 2)),          # a stereo pair: 240, two an SM
    (1, 9, 140, (2, 1, 1)),               # smaller than one tile
])
def test_kernel_launch_is_the_sources(n, h, w, grid):
    """K3's grid, as chip_smoke.py times the launch floor at it, from the
    tile and block that csrc/fast_score.cu is built for."""
    with open(os.path.join(cuda_build.CSRC_DIR, "fast_score.cu")) as f:
        src = f.read()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
             for k in ("BX", "BY", "TH")}
    assert hopper_fast.fast_score_launch(n, h, w) == (grid, (const["BX"], const["BY"], 1))
    assert -(-h // const["TH"]) == grid[1] and -(-w // const["BX"]) == grid[0]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    img = torch.zeros((40, 50), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hopper_fast.fast_score_map(img, 8.0, margin=-1)
    with pytest.raises(TypeError):
        hopper_fast.fast_score_map(img.to(torch.int32), 8.0)
    with pytest.raises(ValueError):
        hopper_fast.fast_score_map(img[None, None], 8.0)
    with pytest.raises(ValueError):
        hopper_fast.fast_score_map(img.t(), 8.0)
