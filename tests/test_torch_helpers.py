"""The small helpers of the port against the JAX package's, on seeded inputs.

Tolerances: integer results (bytes, words, Hamming distances) equal; SE(3)
helpers within 1e-5 (f32 trigonometry); ``compute_dispersion`` within 1e-3
relative (a sum of a few hundred f32 squares); the synthetic window problem
equal (numpy in both); ``compare.py`` reports the same differences.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops import bits as jbits
from srba_slam_tpu.ops import hamming as jhamming
from srba_slam_tpu.utils import compare as jcompare
from srba_slam_tpu.utils import se3 as jse3
from srba_slam_tpu.utils import stats as jstats
from srba_slam_tpu.utils import synthworld as jsynth
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.ops import bits, hamming
from srba_slam_tpu_torch.utils import compare, host_numpy, se3, stats, synthworld
from srba_slam_tpu_torch.utils.camera import StereoCamera

torch.set_num_threads(1)


def _words(rng, *shape):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w[0] = 0xFFFFFFFF
    return w


def test_bytes_and_words_match_jax(rng):
    by = rng.integers(0, 256, (9, 32)).astype(np.uint8)
    by[0] = 255
    ref = np.asarray(jbits.pack_bytes_to_words(jnp.asarray(by)))
    got = bits.pack_bytes_to_words(torch.from_numpy(by))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(ref.view(np.uint8), by)            # little-endian words
    back = bits.words_to_bytes(got)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), np.asarray(jbits.words_to_bytes(jnp.asarray(ref))))
    np.testing.assert_array_equal(back.numpy(), by)


def test_hamming_pairs_and_unpacked_match_jax(rng):
    a, b = _words(rng, 20, 8), _words(rng, 20, 8)
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    np.testing.assert_array_equal(hamming.hamming_pairs(ta, tb).numpy(),
                                  np.asarray(jhamming.hamming_pairs(jnp.asarray(a), jnp.asarray(b))))
    ref = np.asarray(jhamming.hamming_matrix_unpacked(jbits.unpack_bits(jnp.asarray(a)),
                                                      jbits.unpack_bits(jnp.asarray(b[:7]))))
    got = hamming.hamming_matrix_unpacked(bits.unpack_bits(ta), bits.unpack_bits(tb[:7]))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), hamming.hamming_matrix(ta, tb[:7]).numpy())
    np.testing.assert_array_equal(np.diagonal(hamming.hamming_matrix(ta, tb).numpy()),
                                  hamming.hamming_pairs(ta, tb).numpy())


@pytest.mark.parametrize("name", ["relative", "transform_points", "inverse_transform_points",
                                  "rotation_angle", "translation_norm", "ypr_roundtrip",
                                  "identity"])
def test_se3_helpers_match_jax(rng, name):
    a = (rng.normal(size=(5, 6)) * [0.4, 0.4, 0.4, 2, 2, 2]).astype(np.float32)
    b = (rng.normal(size=(5, 6)) * [0.4, 0.4, 0.4, 2, 2, 2]).astype(np.float32)
    pts = rng.normal(size=(5, 11, 3)).astype(np.float32) * 4
    ta, tb, tp = map(torch.from_numpy, (a, b, pts))
    ja, jb, jp = map(jnp.asarray, (a, b, pts))
    if name == "identity":
        assert torch.equal(se3.identity(), torch.zeros(6)) and se3.identity().dtype == torch.float32
        np.testing.assert_array_equal(se3.identity().numpy(), np.asarray(jse3.identity()))
        return
    if name == "ypr_roundtrip":
        ypr = (rng.uniform(-1.2, 1.2, (7, 3))).astype(np.float32)
        R = se3.rotmat_from_ypr(torch.from_numpy(ypr))
        np.testing.assert_allclose(R.numpy(), np.asarray(jse3.rotmat_from_ypr(jnp.asarray(ypr))),
                                   atol=1e-6)
        np.testing.assert_allclose(se3.ypr_from_rotmat(R).numpy(), ypr, atol=1e-5)
        np.testing.assert_allclose(se3.ypr_from_rotmat(R).numpy(),
                                   np.asarray(jse3.ypr_from_rotmat(jnp.asarray(R.numpy()))),
                                   atol=1e-6)
        return
    args = {"relative": ((ta, tb), (ja, jb)), "transform_points": ((ta, tp), (ja, jp)),
            "inverse_transform_points": ((ta, tp), (ja, jp)), "rotation_angle": ((ta,), (ja,)),
            "translation_norm": ((ta,), (ja,))}[name]
    got = getattr(se3, name)(*args[0]).numpy()
    ref = np.asarray(getattr(jse3, name)(*args[1]))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if name == "inverse_transform_points":
        np.testing.assert_allclose(se3.inverse_transform_points(ta, se3.transform_points(ta, tp))
                                   .numpy(), pts, atol=1e-4)


def test_compute_dispersion_matches_jax(rng):
    xs = rng.integers(0, 1226, 300).astype(np.int32)
    ys = rng.integers(0, 370, 300).astype(np.int32)
    valid = rng.random(300) < 0.7
    ref = jstats.compute_dispersion(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(valid))
    got = stats.compute_dispersion(*map(torch.from_numpy, (xs, ys, valid)))
    np.testing.assert_allclose([float(g) for g in got], [float(r) for r in ref], rtol=1e-3)
    exact = np.sqrt(((xs[valid] - xs[valid].mean()) ** 2).sum())
    np.testing.assert_allclose(float(got[0]), exact, rtol=1e-3)      # not divided by N


def test_make_ba_window_problem_equals_jax():
    kw = dict(C=8, L=64, O=256, n_cams=6, n_lms=50)
    jwin, jgt = jsynth.make_ba_window_problem(JCam.kitti(), np.random.default_rng(4), **kw)
    twin, tgt = synthworld.make_ba_window_problem(StereoCamera.kitti(),
                                                  np.random.default_rng(4), **kw)
    np.testing.assert_array_equal(tgt, jgt)
    for name in twin._fields:
        a = getattr(twin, name)
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jwin, name)), err_msg=name)


def test_compare_helpers_equal_jax(rng):
    ys, xs = rng.integers(0, 100, (2, 30))
    valid = rng.random(30) < 0.5
    for mod in (compare, jcompare):
        assert mod.compare_keypoint_lists(ys, xs, valid, ys.copy(), xs.copy(), valid.copy())
        assert not mod.compare_keypoint_lists(ys, xs, valid, ys, xs + 1, valid)
        assert mod.compare_match_lists(ys, valid, xs, ys.copy(), valid.copy(), xs.copy())
        assert not mod.compare_match_lists(ys, valid, xs, ys, ~valid, xs)
    # tensors on any device compare like arrays
    assert compare.compare_keypoint_lists(torch.from_numpy(ys), torch.from_numpy(xs),
                                          torch.from_numpy(valid), ys, xs, valid)

    @dataclasses.dataclass
    class O:
        a: int = 1
        b: list = dataclasses.field(default_factory=lambda: [1.0, 2.0])

    assert compare.compare_options(O(), O()) == jcompare.compare_options(O(), O()) == []
    assert compare.compare_options(O(), O(a=2, b=[1.0, 3.0])) == \
        jcompare.compare_options(O(), O(a=2, b=[1.0, 3.0]))
    assert host_numpy(torch.arange(3)).tolist() == host_numpy([0, 1, 2]).tolist() == [0, 1, 2]
