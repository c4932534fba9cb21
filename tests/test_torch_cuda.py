"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: none for the kernels, which are bit-exact against their plain
versions, nor for the VO engine's integer results and the estimator's
keyframe decisions, which equal the CPU path's. Poses agree within 1e-4
(the f32 solves sum in another order on the card).
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu_torch import (
    GeneralOptions, SRBAStereoSLAMEstimator, SRBAStereoSLAMOptions, StereoCamera,
    StereoVOEngine, VOOptions,
)
from srba_slam_tpu_torch.ops import hopper_fast
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain
from srba_slam_tpu_torch.ops.nms import grid_topk
from srba_slam_tpu_torch.ops.orb import gauss_blur7, upright_descriptors
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.framesource import SyntheticSource
from srba_slam_tpu_torch.utils.synthworld import PlaneScene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_nms_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    for shape, th in (((2, 200, 320), 12.0), ((3, 123, 300), 8.0)):
        imgs = torch.from_numpy(rng.integers(0, 8, shape) * 30).to(dtype).to(cuda)
        before = hopper_fast.fast_nms.launches
        got = hopper_fast.fast_nms(imgs, th)
        assert hopper_fast.fast_nms.launches == before + 1
        assert torch.equal(got, hopper_fast.fast_nms_plain(imgs, th))


def test_orb_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 123, 300)).astype(np.uint8)).to(cuda)
    blurred = gauss_blur7(imgs)
    ys, xs, _, valid = grid_topk(hopper_fast.fast_nms(imgs, 12.0), cell=5, k=300)
    got = hopper_fast.orb_descriptors(blurred, ys, xs, valid)
    assert torch.equal(got, upright_descriptors(blurred, ys, xs, valid))
    # keypoints near the borders: every sample is clipped the same way
    ys_edge = torch.from_numpy(rng.integers(0, 123, (2, 40)).astype(np.int32)).to(cuda)
    xs_edge = torch.from_numpy(rng.integers(0, 300, (2, 40)).astype(np.int32)).to(cuda)
    ok = torch.ones((2, 40), dtype=torch.bool, device=cuda)
    assert torch.equal(hopper_fast.orb_descriptors(blurred, ys_edge, xs_edge, ok),
                       upright_descriptors(blurred, ys_edge, xs_edge, ok))


SMALL_CAM = dict(fx_l=180.0, fy_l=180.0, cx_l=160.0, cy_l=100.0, fx_r=180.0, fy_r=180.0,
                 cx_r=160.0, cy_r=100.0, baseline=0.54, width=320, height=200)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_fast_score_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    for shape, th in (((200, 320), 12.0), ((123, 300), 8.0), ((2, 370, 1226), 20.0)):
        imgs = torch.from_numpy(rng.integers(0, 8, shape) * 30).to(dtype).to(cuda)
        before = hopper_fast.fast_score_map.launches
        got = hopper_fast.fast_score_map(imgs, th)
        assert hopper_fast.fast_score_map.launches == before + 1
        assert got.shape == imgs.shape
        assert torch.equal(got, fast_score_map_plain(imgs, th))


def test_vo_engine_cuda_matches_cpu(cuda):
    cam = StereoCamera(**SMALL_CAM)
    scene = PlaneScene(np.random.default_rng(11))
    engines = [StereoVOEngine(cam, VOOptions(fast_th=12, n_feats=256), capacity=256,
                              device=d) for d in (cuda, "cpu")]
    for i in range(3):
        left, right = scene.render(cam, np.array([0, 0, 0, 0.04 * i, 0, 0.12 * i], np.float32))
        a, b = (e.process_stereo_pair(left, right) for e in engines)
        assert (a.valid, a.num_stereo_matches, a.tracked_from_last_frame) == \
            (b.valid, b.num_stereo_matches, b.tracked_from_last_frame)
        np.testing.assert_allclose(a.pose_increment, b.pose_increment, atol=1e-4)


def test_estimator_cuda_matches_cpu(cuda):
    """The small-geometry sequence of tests/test_estimator.py, 20 frames."""
    cam = StereoCamera(**SMALL_CAM)
    frames = list(SyntheticSource(cam, n_frames=30, seed=11, step=0.12))[:20]
    ests = []
    for device in (cuda, "cpu"):
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True, camera=cam, n_feats=256, detect_fast_th=12,
            adaptive_th_min_matches=40, max_translation=0.5, max_rotation=10.0,
            updated_matches_th=40, vo_id_tracking_th=30, srba_submap_size=5,
            srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
        est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=12, n_feats=256),
                                      capacity=256, max_kfs=64, device=device)
        est.initialize()
        for left, right in frames:
            est.step(left, right)
        ests.append(est)
    a, b = ests
    assert decisions(a.step_log) == decisions(b.step_log)
    assert a.store.n_kfs == b.store.n_kfs >= 3
    n = a.store.n_kfs
    np.testing.assert_allclose(a.rba.kf_global[:n], b.rba.kf_global[:n], atol=1e-4)
