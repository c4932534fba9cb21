"""The port's VO slice (stereo frames -> pose increments) against the JAX package.

At the small camera of tests/test_vo.py, over 5 rendered frames.

Tolerances:
* engine over frames: identical ``valid``; stereo-match and tracked counts
  within 2%; pose increments within 1e-3. The port's gauss_blur7 differs
  from JAX's by 1 at a few pixels in 10^5, which can flip a few descriptor
  bits and so a few matches; all else is exact or f32 rounding.
* track_and_solve on identical inputs (both fed the JAX frames' features
  through ``frame_features_from_numpy``): identical track_idx, track_valid
  and inliers; iters within +-1; pose within 1e-4 (the 6x6 normal sums run
  in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.config import VOOptions as JOptions
from srba_slam_tpu.models import vo as jvo
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch import StereoCamera, StereoVOEngine, VOOptions
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.utils import se3_np
from srba_slam_tpu_torch.utils.synthworld import PlaneScene

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

CAM_KW = dict(fx_l=180.0, fy_l=180.0, cx_l=160.0, cy_l=100.0, fx_r=180.0, fy_r=180.0,
              cx_r=160.0, cy_r=100.0, baseline=0.54, width=320, height=200)
OPTS = dict(fast_th=12, n_feats=256)
CAPACITY = 256


@pytest.fixture(scope="module")
def frames():
    scene = PlaneScene(np.random.default_rng(11))
    cam = StereoCamera(**CAM_KW)
    inc = np.array([0.0, 0.01, 0.0, 0.05, 0.0, 0.12])
    pose = np.zeros(6)
    out = []
    for _ in range(5):
        out.append(scene.render(cam, pose.astype(np.float32)))
        pose = se3_np.compose(pose, inc)
    return out


def _engines():
    return (jvo.StereoVOEngine(JCam(**CAM_KW), JOptions(**OPTS), capacity=CAPACITY),
            StereoVOEngine(StereoCamera(**CAM_KW), VOOptions(**OPTS), capacity=CAPACITY,
                           device="cpu"))


def _assert_close(a, b):
    assert a.valid == b.valid
    for f in ("num_stereo_matches", "tracked_from_last_frame"):
        x, y = getattr(a, f), getattr(b, f)
        assert abs(x - y) <= 0.02 * max(x, 1), (f, x, y)
    np.testing.assert_allclose(b.pose_increment, a.pose_increment, atol=1e-3)


def test_vo_engine_matches_jax(frames):
    jeng, teng = _engines()
    for left, right in frames:
        a = jeng.process_stereo_pair(left, right)
        b = teng.process_stereo_pair(left, right)
        _assert_close(a, b)
    assert a.valid and a.tracked_from_last_frame > 100


def _jax_frame(left, right):
    return jvo.extract_and_match(jnp.asarray(left), jnp.asarray(right), JCam(**CAM_KW),
                                 jnp.float32(OPTS["fast_th"]), jnp.int32(60), k=CAPACITY)


def test_track_and_solve_exact_on_jax_features(frames):
    jprev, jcur = _jax_frame(*frames[0]), _jax_frame(*frames[1])
    o = VOOptions(**OPTS)
    kw = dict(kernel_param=o.kernel_param, residual_threshold=o.residual_threshold,
              min_mod=o.min_mod_out_vector, max_iters_initial=o.initial_max_iters,
              max_iters=o.max_iters, min_inliers=o.bad_tracking_th,
              max_incr_cost=o.max_incr_cost)
    ref = jvo.track_and_solve(jprev, jcur, JCam(**CAM_KW), jnp.zeros(6, jnp.float32),
                              jnp.int32(60), **kw)
    prev = vo.frame_features_from_numpy(jax.device_get(jprev), "cpu")
    cur = vo.frame_features_from_numpy(jax.device_get(jcur), "cpu")
    got = vo.track_and_solve(prev, cur, StereoCamera(**CAM_KW), torch.zeros(6), 60, **kw)
    np.testing.assert_array_equal(got.track_idx.numpy(), np.asarray(ref.track_idx))
    np.testing.assert_array_equal(got.track_valid.numpy(), np.asarray(ref.track_valid))
    np.testing.assert_array_equal(got.pose.inliers.numpy(), np.asarray(ref.pose.inliers))
    assert bool(got.pose.valid) and bool(ref.pose.valid)
    assert abs(int(got.pose.iters) - int(ref.pose.iters)) <= 1
    np.testing.assert_allclose(got.pose.pose.numpy(), np.asarray(ref.pose.pose), atol=1e-4)


def test_engine_continues_from_jax_state(frames):
    """The port engine takes over the JAX engine's state (previous frame's
    features, its track IDs, last increment, ID counter) mid-sequence."""
    jeng, teng = _engines()
    for left, right in frames[:2]:
        jeng.process_stereo_pair(left, right)
    prev, ids, inc, next_id = jeng.get_state()
    teng.set_state((vo.frame_features_from_numpy(jax.device_get(prev), "cpu"),
                    ids, np.asarray(inc), next_id))
    for left, right in frames[2:]:
        _assert_close(jeng.process_stereo_pair(left, right),
                      teng.process_stereo_pair(left, right))
    assert teng._next_id >= next_id


@pytest.mark.parametrize("opt", ["n_octaves", "orb_oriented", "filter_fund_matrix",
                                 "rect_maps"])
def test_unported_paths_raise(frames, opt):
    kw = dict(OPTS)
    if opt == "n_octaves":
        kw[opt] = 2
    elif opt != "rect_maps":
        kw[opt] = True
    eng = StereoVOEngine(StereoCamera(**CAM_KW), VOOptions(**kw), capacity=CAPACITY)
    if opt == "rect_maps":
        eng.rect_maps = (object(), object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        for left, right in frames[:2]:
            eng.process_stereo_pair(left, right)
