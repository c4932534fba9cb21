"""Detection in the port (FAST, NMS, grid top-K) against the JAX package.

Tolerance: none. FAST scores are mins and maxes of one f32 difference, the
NMS key rounds as score - f32(eps) * f32(y*W + x) in both, and top-K ties
go to the lower cell index in both, so every output is compared bit for
bit. The JAX side runs as its own tests run it on the CPU: the XLA
functions, and the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops.fast import fast_score_map as jfast
from srba_slam_tpu.ops.nms import grid_topk as jgrid_topk
from srba_slam_tpu.ops.nms import local_max_suppress as jlms
from srba_slam_tpu.ops.pallas_fast import fast_nms_pallas
from srba_slam_tpu_torch.ops import hopper_fast
from srba_slam_tpu_torch.ops.fast import fast_score_map
from srba_slam_tpu_torch.ops.nms import grid_topk, local_max_suppress


@pytest.mark.parametrize("kind", ["uniform_f32", "uint8"])
def test_fast_score_map_matches_jax(rng, kind):
    if kind == "uint8":
        img = rng.integers(0, 256, (200, 320)).astype(np.uint8)
    else:
        img = rng.uniform(0, 255, (200, 320)).astype(np.float32)
    ref = np.asarray(jfast(jnp.asarray(img), 12.0, margin=16))
    got = fast_score_map(torch.from_numpy(img), 12.0, margin=16).numpy()
    assert (ref > 0).sum() > 100
    np.testing.assert_array_equal(got, ref)


def test_local_max_suppress_matches_jax(rng):
    # quantized scores: many equal neighbours, so the key's tiebreak decides
    score = (rng.integers(0, 4, (200, 320)) * 25).astype(np.float32)
    ref = np.asarray(jlms(jnp.asarray(score), radius=2))
    got = local_max_suppress(torch.from_numpy(score), radius=2).numpy()
    np.testing.assert_array_equal(got, ref)


def test_fast_nms_matches_pallas_interpret(rng):
    """The port's K1 wrapper on CPU tensors (its plain version) against the
    JAX TPU kernel in interpret mode, at an unaligned geometry."""
    imgs = rng.integers(0, 255, (3, 123, 300)).astype(np.float32)
    ref = np.asarray(fast_nms_pallas(jnp.asarray(imgs), 12.0, margin=16, tile_h=32,
                                     interpret=True))
    before = hopper_fast.fast_nms.launches
    got = hopper_fast.fast_nms(torch.from_numpy(imgs), 12.0, margin=16, radius=2)
    assert hopper_fast.fast_nms.launches == before  # CPU tensors never launch
    np.testing.assert_array_equal(got.numpy(), ref)
    # the uint8 frame gives the same bits as its f32 cast
    got_u8 = hopper_fast.fast_nms(torch.from_numpy(imgs.astype(np.uint8)), 12.0)
    np.testing.assert_array_equal(got_u8.numpy(), ref)


def test_grid_topk_plateau_kitti_geometry(rng):
    """Bench geometry 2x370x1226 on a quantized plateau image: NMS keys round
    to equal values on plateaus and top-K sees many tied scores."""
    imgs = (rng.integers(0, 8, (2, 370, 1226)) * 30).astype(np.float32)
    jimgs = jnp.asarray(imgs)
    js = jax.vmap(lambda im: jlms(jfast(im, 20.0, margin=16), radius=2))(jimgs)
    jout = jax.vmap(lambda s: jgrid_topk(s, cell=5, k=512))(js)
    s = hopper_fast.fast_nms(torch.from_numpy(imgs), 20.0, margin=16, radius=2)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    out = grid_topk(s, cell=5, k=512)
    for name, a, b in zip(("ys", "xs", "scores", "valid"), out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    sc = out[2].numpy()
    assert len(np.unique(sc[0])) < 50  # the selection really rests on ties


def test_grid_topk_tie_order():
    """jax.lax.top_k puts the lower index first on ties; torch.topk does not
    promise that. On [3, 5, 5, 1, 5] the winners are cells 1, 2, 4."""
    score = np.array([[3.0, 5.0, 5.0, 1.0, 5.0]], np.float32)
    ys, xs, sc, valid = grid_topk(torch.from_numpy(score), cell=1, k=3)
    jys, jxs, jsc, jvalid = jgrid_topk(jnp.asarray(score), cell=1, k=3)
    assert xs.tolist() == [1, 2, 4]
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_fast_nms_wrapper_checks():
    img = torch.zeros((1, 64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hopper_fast.fast_nms(img, 10.0, margin=4, radius=2)  # margin < 3 + radius
    with pytest.raises(TypeError):
        hopper_fast.fast_nms(img.to(torch.int32), 10.0)
    with pytest.raises(ValueError):
        hopper_fast.fast_nms(img[0], 10.0)                  # not [N, H, W]
