"""The rest of ``ops/orb.py`` in the port against the JAX package, on the CPU.

Tolerances:
* the seeded "gaussian" pattern table, the IC_Angle disc offsets: equal.
* ``box_blur5``: bit-equal on uint8-valued images (sums of integers, one
  division).
* ``orientations``: the moments are exact integer sums on uint8-valued
  images, so only ``atan2``'s last bits may differ: within 1e-6 rad.
* ``describe(theta_override=θ of JAX)``: bit-exact for both patterns (each
  on the JAX package's blur of the image), also for keypoints within 16 px
  of a border (``patch_safe=False`` there) and on a batch.
* ``describe(oriented=True)`` free-running: descriptor rows that differ
  from JAX's are counted and stay under 2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops import orb as jorb
from srba_slam_tpu_torch.ops import orb

torch.set_num_threads(1)

H, W, K = 123, 300, 96


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    ys = rng.integers(0, H, K).astype(np.int32)
    xs = rng.integers(0, W, K).astype(np.int32)
    ys[:8], xs[:8] = (3, 5, 15, H - 4, H - 16, 60, 60, 0), (3, 290, 15, 8, W - 4, 2, W - 3, 0)
    valid = rng.random(K) < 0.9
    valid[:8] = True
    return img, ys, xs, valid


@pytest.fixture
def jax_blurs(monkeypatch):
    """The port blurs with the JAX package's functions: shared blurred input."""
    def via(fn):
        def run(img):
            f = fn
            for _ in range(img.dim() - 2):
                f = jax.vmap(f)
            return torch.from_numpy(np.array(f(jnp.asarray(img.numpy(), jnp.float32))))
        return run

    monkeypatch.setattr(orb, "gauss_blur7", via(jorb.gauss_blur7))
    monkeypatch.setattr(orb, "box_blur5", via(jorb.box_blur5))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_pattern_tables_equal():
    np.testing.assert_array_equal(orb._make_pattern(), jorb._make_pattern())
    np.testing.assert_array_equal(orb.PATTERN_GAUSSIAN, jorb._PATTERN)
    np.testing.assert_array_equal(orb._make_pattern(3), jorb._make_pattern(3))
    np.testing.assert_array_equal(orb._disc_offsets(15), jorb._disc_offsets(15))
    np.testing.assert_array_equal(orb._DISC, jorb._DISC)
    assert np.abs(orb.PATTERN_GAUSSIAN).max() <= 14 and orb.PATTERN_GAUSSIAN.shape == (256, 2, 2)


def test_box_blur5_bit_equal(case):
    img = case[0]
    np.testing.assert_array_equal(orb.box_blur5(torch.from_numpy(img)).numpy(),
                                  np.asarray(jorb.box_blur5(jnp.asarray(img))))
    batch = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    np.testing.assert_array_equal(orb.box_blur5(batch)[1].numpy(),
                                  np.asarray(jorb.box_blur5(jnp.asarray(img[::-1]))))


def test_orientations_within_1e6(case):
    img, ys, xs, _ = case
    ref = np.asarray(jorb.orientations(*_j(img, ys, xs)))
    got = orb.orientations(*_t(img, ys, xs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.ptp(ref) > 3.0        # the angles cover the circle


@pytest.mark.parametrize("pattern", ["opencv", "gaussian"])
def test_describe_bit_exact_under_theta_override(case, jax_blurs, pattern):
    img, ys, xs, valid = case
    theta = np.asarray(jorb.orientations(*_j(img, ys, xs)))
    ref, ref_theta = jorb.describe(*_j(img, ys, xs, valid), oriented=True, pattern=pattern,
                                   theta_override=jnp.asarray(theta), patch_safe=False)
    got, got_theta = orb.describe(*_t(img, ys, xs, valid), oriented=True, pattern=pattern,
                                  theta_override=torch.from_numpy(theta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).view(np.int32))
    np.testing.assert_array_equal(got_theta.numpy(), np.asarray(ref_theta))
    assert not got.numpy()[~valid].any() and got.numpy()[valid].any()


@pytest.mark.parametrize("pattern", ["opencv", "gaussian"])
@pytest.mark.parametrize("oriented", [False, True])
def test_describe_near_borders_matches_jax_general_path(case, jax_blurs, pattern, oriented):
    """``patch_safe=False`` in JAX clips each sample; so does the port,
    which has no such argument. Free-running angles: differing rows are counted."""
    img, ys, xs, valid = case
    ref, _ = jorb.describe(*_j(img, ys, xs, valid), oriented=oriented, pattern=pattern,
                           patch_safe=False)
    got, theta = orb.describe(*_t(img, ys, xs, valid), oriented=oriented, pattern=pattern)
    rows = (got.numpy() != np.asarray(ref).view(np.int32)).any(1)
    print(f"{pattern} oriented={oriented}: {int(rows.sum())} of {K} rows differ from JAX's")
    if oriented:
        assert rows.sum() <= 0.02 * K
        assert theta.any()
    else:
        assert not rows.any()
        assert not theta.any()


def test_describe_on_a_batch_equals_per_image(case):
    img, ys, xs, valid = case
    imgs = np.stack([img, img.T.copy().reshape(-1)[: H * W].reshape(H, W)])
    single = [orb.describe(*_t(im, ys, xs, valid), oriented=True) for im in imgs]
    desc, theta = orb.describe(torch.from_numpy(imgs), *(torch.from_numpy(np.stack([a, a]))
                                                         for a in (ys, xs, valid)), oriented=True)
    for i in range(2):
        assert torch.equal(desc[i], single[i][0]) and torch.equal(theta[i], single[i][1])
