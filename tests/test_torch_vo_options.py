"""The VO frontend's options in the port against the JAX package, on the CPU.

Small camera (320x200), rendered frames, inputs from seeded numpy.

What is held, and how tightly:
* ``_octave_budget``: equal lists, and the same ValueError.
* ``_avgpool2``: bit-equal on uint8-valued images down to three octaves.
* ``extract_and_match`` at ``n_levels`` 2 and 3, margins 3 and 8, with
  ``rect_maps``, with ``robust_1to1``: every integer field of FrameFeatures
  identical (keypoints, their order, octaves, descriptor words, match
  indices and masks), ``pts3d`` and scores within 1e-5. Both packages blur
  with the JAX package's ``gauss_blur7`` here (the port's differs from it by
  1 grey level at a few pixels in 10^5, tests/test_torch_orb.py), and the
  ``rect_maps`` case feeds both JAX's remapped frames, so that everything
  downstream can be compared bit for bit.
* ``oriented=True``: keypoints identical; descriptor rows that differ are
  counted and stay under 2% (an angle that differs in its last bit moves a
  rotated sample across a rounding boundary).
* ``filter_fund_matrix``: identical track_idx, track_valid and inliers on
  JAX's features; the filter removes at least one match of the case.
* a 5-frame engine run at ``n_octaves=2`` with each package's own blur:
  as tests/test_torch_vo.py at one octave (counts within 2%, poses 1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.config import VOOptions as JOptions
from srba_slam_tpu.models import vo as jvo
from srba_slam_tpu.ops import matching as jmatching
from srba_slam_tpu.ops import rectify as jrectify
from srba_slam_tpu.ops.orb import gauss_blur7 as jblur
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch import StereoCamera, StereoVOEngine, VOOptions
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.ops import hopper_fast, matching, orb, rectify
from torch_parity_inputs import CAPACITY, SMALL_CAM, small_frames

torch.set_num_threads(1)

INT_FIELDS = ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
              "m_r_idx", "m_valid", "octave")
DIST = [-0.28, 0.07, 2e-4, 2e-5, 0.0]


def _jax_blur(img: torch.Tensor) -> torch.Tensor:
    x = jnp.asarray(img.numpy(), jnp.float32)
    fn = jblur
    for _ in range(x.ndim - 2):
        fn = jax.vmap(fn)
    return torch.from_numpy(np.array(fn(x)))


@pytest.fixture
def shared_blur(monkeypatch):
    """Both packages blur with the JAX package's gauss_blur7."""
    monkeypatch.setattr(orb, "gauss_blur7", _jax_blur)
    monkeypatch.setattr(hopper_fast, "gauss_blur7", _jax_blur)


def _assert_features_equal(got, ref, fields=INT_FIELDS):
    for name in fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got.score_l.numpy(), np.asarray(ref.score_l), atol=1e-5)
    np.testing.assert_allclose(got.pts3d.numpy(), np.asarray(ref.pts3d), rtol=1e-5, atol=1e-5)


def _both(left, right, jkw=None, **kw):
    ref = jvo.extract_and_match(jnp.asarray(left), jnp.asarray(right), JCam(**SMALL_CAM),
                                jnp.float32(12.0), jnp.int32(60), k=CAPACITY,
                                **{**kw, **(jkw or {})})
    got = vo.extract_and_match(left, right, StereoCamera(**SMALL_CAM), 12.0, 60, k=CAPACITY,
                               device="cpu", **kw)
    return got, jax.device_get(ref)


@pytest.mark.parametrize("h,w,cell,k,n", [(200, 320, 5, 256, 1), (200, 320, 5, 256, 2),
                                          (200, 320, 5, 256, 3), (370, 1226, 5, 512, 3),
                                          (64, 64, 5, 140, 3), (480, 752, 7, 1000, 4)])
def test_octave_budget_matches_jax(h, w, cell, k, n):
    assert vo._octave_budget(h, w, cell, k, n) == jvo._octave_budget(h, w, cell, k, n)
    assert sum(vo._octave_budget(h, w, cell, k, n)) == k


def test_octave_budget_error_matches_jax():
    with pytest.raises(ValueError) as je:
        jvo._octave_budget(40, 40, 5, 512, 2)
    with pytest.raises(ValueError) as te:
        vo._octave_budget(40, 40, 5, 512, 2)
    assert str(te.value) == str(je.value)


def test_avgpool2_bit_equal_on_uint8_frames():
    left, _ = small_frames()[0][0]
    a = torch.from_numpy(left).to(torch.float32)
    b = jnp.asarray(left, jnp.float32)
    for _ in range(3):
        a, b = vo._avgpool2(a), jvo._avgpool2(b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert a.shape == (25, 40)
    odd = torch.arange(35.0).reshape(5, 7)
    assert vo._avgpool2(odd).shape == (2, 3)


@pytest.mark.parametrize("kw", [dict(n_levels=2), dict(n_levels=3), dict(margin=3),
                                dict(margin=8), dict(margin=8, n_levels=2),
                                dict(robust_1to1=True), dict(margin=2)],
                         ids=["levels2", "levels3", "margin3", "margin8", "margin8_levels2",
                              "robust_1to1", "margin2"])
def test_extract_and_match_options_match_jax(shared_blur, kw):
    left, right = small_frames()[0][3]
    got, ref = _both(left, right, **kw)
    _assert_features_equal(got, ref)
    assert int(got.m_valid.sum()) > 60
    if kw.get("n_levels", 1) > 1:
        assert sorted(got.octave.unique().tolist()) == list(range(kw["n_levels"]))
        assert bool((got.m_valid & (got.octave > 0)).any())
    if "margin" in kw:
        m = kw["margin"]
        near = (got.ys_l < 16) | (got.xs_l < 16) | (got.ys_l >= 200 - 16) | (got.xs_l >= 320 - 16)
        assert bool((near & got.valid_l).any()), "no keypoint within 16 px of a border"
        assert int(got.ys_l[got.valid_l].min()) >= m


def test_margin3_takes_the_score_map_wrapper(monkeypatch):
    """Margins 3 and 4 go through K3's wrapper and a separate suppression;
    5 and up through K1's."""
    calls = []
    for name in ("fast_nms", "fast_score_map"):
        fn = getattr(vo, name)
        monkeypatch.setattr(vo, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n),
                                                                       _fn(*a, **k))[1])
    left, right = small_frames()[0][0]
    for margin, want in ((3, "fast_score_map"), (4, "fast_score_map"), (5, "fast_nms"),
                         (16, "fast_nms")):
        calls.clear()
        vo.extract_and_match(left, right, StereoCamera(**SMALL_CAM), 12.0, 60, k=CAPACITY,
                             margin=margin, device="cpu")
        assert calls == [want], (margin, calls)


def _maps(mod, **kw):
    c = SMALL_CAM
    return tuple(mod.build_maps(c["width"], c["height"], c[f"fx_{e}"], c[f"fy_{e}"],
                                c[f"cx_{e}"], c[f"cy_{e}"], dist=DIST, **kw) for e in "lr")


def test_rect_maps_match_jax(shared_blur, monkeypatch):
    """With both packages fed JAX's remapped frames, the rectified frontend
    is identical; the port's own remap is held in tests/test_torch_rectify.py."""
    jmaps, tmaps = _maps(jrectify), _maps(rectify, device="cpu")
    monkeypatch.setattr(vo, "remap_bilinear", lambda img, maps: torch.from_numpy(np.array(
        jrectify.remap_bilinear(jnp.asarray(img.numpy()),
                                jrectify.RectifyMaps(jnp.asarray(maps.map_y.numpy()),
                                                     jnp.asarray(maps.map_x.numpy()))))))
    left, right = small_frames()[0][3]
    got, ref = _both(left, right, jkw=dict(rect_maps=jmaps), rect_maps=tmaps)
    _assert_features_equal(got, ref)
    plain, _ = _both(left, right)
    assert not torch.equal(plain.xs_l, got.xs_l)        # the remap moved the keypoints


def test_rect_maps_with_own_remap_close_to_jax():
    """The port's own remap and blur in front of the same frontend: the
    same frame within a few keypoints."""
    left, right = small_frames()[0][3]
    got, ref = _both(left, right, jkw=dict(rect_maps=_maps(jrectify), n_levels=2),
                     rect_maps=_maps(rectify, device="cpu"), n_levels=2)
    n_ref = int(np.asarray(ref.m_valid).sum())
    assert abs(int(got.m_valid.sum()) - n_ref) <= 0.05 * n_ref
    same = (got.ys_l.numpy() == np.asarray(ref.ys_l)) & (got.xs_l.numpy() == np.asarray(ref.xs_l))
    assert same.mean() > 0.9


def test_oriented_matches_jax_up_to_counted_rows(shared_blur):
    left, right = small_frames()[0][3]
    got, ref = _both(left, right, oriented=True)
    _assert_features_equal(got, ref, fields=("ys_l", "xs_l", "valid_l", "ys_r", "xs_r",
                                             "valid_r", "octave"))
    differing = 0
    for name in ("desc_l", "desc_r"):
        rows = (getattr(got, name).numpy() != np.asarray(getattr(ref, name)).view(np.int32)).any(1)
        differing += int(rows.sum())
    print(f"oriented: {differing} of {2 * CAPACITY} descriptor rows differ from JAX's")
    assert differing <= 0.02 * 2 * CAPACITY
    upright, _ = _both(left, right)
    assert not torch.equal(upright.desc_l, got.desc_l)


def _jax_frame(i, **kw):
    left, right = small_frames()[0][i]
    return jvo.extract_and_match(jnp.asarray(left), jnp.asarray(right), JCam(**SMALL_CAM),
                                 jnp.float32(12.0), jnp.int32(60), k=CAPACITY, **kw)


def test_filter_fund_matrix_identical_inliers():
    """The filter draws from PRNGKey(0); the port's generator gives JAX's
    bits, so the same matches survive. Wrong matches are planted by
    swapping descriptor rows of the previous frame."""
    jprev, jcur = _jax_frame(0), _jax_frame(2)
    desc = np.array(jprev.desc_l)
    rows = np.nonzero(np.asarray(jprev.m_valid))[0]
    swap = rows[:: 6]
    desc[swap] = desc[np.roll(swap, 1)]
    jprev = jprev._replace(desc_l=jnp.asarray(desc))
    o = VOOptions()
    kw = dict(kernel_param=o.kernel_param, residual_threshold=o.residual_threshold,
              min_mod=o.min_mod_out_vector, max_iters_initial=o.initial_max_iters,
              max_iters=o.max_iters, min_inliers=o.bad_tracking_th, max_incr_cost=o.max_incr_cost)
    out = {}
    for flt in (False, True):
        ref = jvo.track_and_solve(jprev, jcur, JCam(**SMALL_CAM), jnp.zeros(6, jnp.float32),
                                  jnp.int32(60), filter_fund_matrix=flt, **kw)
        got = vo.track_and_solve(vo.frame_features_from_numpy(jax.device_get(jprev), "cpu"),
                                 vo.frame_features_from_numpy(jax.device_get(jcur), "cpu"),
                                 StereoCamera(**SMALL_CAM), torch.zeros(6), 60,
                                 filter_fund_matrix=flt, **kw)
        np.testing.assert_array_equal(got.track_idx.numpy(), np.asarray(ref.track_idx))
        np.testing.assert_array_equal(got.track_valid.numpy(), np.asarray(ref.track_valid))
        np.testing.assert_array_equal(got.pose.inliers.numpy(), np.asarray(ref.pose.inliers))
        np.testing.assert_allclose(got.pose.pose.numpy(), np.asarray(ref.pose.pose), atol=1e-4)
        out[flt] = int(got.track_valid.sum())
    assert 15 <= out[True] < out[False], out


def test_robust_1to1_stereo_match_matches_jax():
    """``stereo_match(..., robust_1to1=True)`` on JAX's features: the same
    indices, distances and mask, and strictly fewer matches than without
    it under a wide gate (30 rows, distance 90), where a right feature is
    often the best of a left one whose own best is another."""
    f = jax.device_get(_jax_frame(1))
    desc_r = np.array(f.desc_r)
    t = vo.frame_features_from_numpy(f, "cpu")
    counts = {}
    for robust in (False, True):
        ref = jmatching.stereo_match(
            jnp.asarray(f.desc_l), jnp.asarray(desc_r), f.ys_l, f.xs_l, f.ys_r, f.xs_r,
            f.valid_l, f.valid_r, max_y_diff=30.0, orb_max_distance=90, min_disparity=0.1,
            oct_l=f.octave, oct_r=f.octave, robust_1to1=robust)
        got = matching.stereo_match(
            t.desc_l, torch.from_numpy(desc_r.view(np.int32)), t.ys_l, t.xs_l, t.ys_r, t.xs_r,
            t.valid_l, t.valid_r, max_y_diff=30.0, orb_max_distance=90, min_disparity=0.1,
            oct_l=t.octave, oct_r=t.octave, robust_1to1=robust)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
        np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
        counts[robust] = int(got.valid.sum())
    assert 0 < counts[True] < counts[False], counts


def test_vo_engine_two_octaves_matches_jax():
    frames, _ = small_frames()
    opts = dict(fast_th=12, n_feats=256, n_octaves=2)
    jeng = jvo.StereoVOEngine(JCam(**SMALL_CAM), JOptions(**opts), capacity=CAPACITY)
    teng = StereoVOEngine(StereoCamera(**SMALL_CAM), VOOptions(**opts), capacity=CAPACITY,
                          device="cpu")
    for left, right in frames[:5]:
        a = jeng.process_stereo_pair(left, right)
        b = teng.process_stereo_pair(left, right)
        assert a.valid == b.valid
        for f in ("num_stereo_matches", "tracked_from_last_frame"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= 0.02 * max(x, 1), (f, x, y)
        np.testing.assert_allclose(b.pose_increment, a.pose_increment, atol=1e-3)
    assert a.valid and a.tracked_from_last_frame > 80
    assert sorted(teng.last_frame().octave.unique().tolist()) == [0, 1]
