"""The benchmark's torch renderer against the port's numpy street scene.

Runs on the CPU at a small image size: the texture, the path and the frames
of ``render.Drive`` against ``utils/synthworld.py`` ``StreetScene`` and
``utils/framesource.py`` ``SyntheticSource`` from the same seed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import render


@pytest.fixture(scope="module")
def small_drive():
    eye = render.Camera(fx=140.0, fy=140.0, cx=80.5, cy=36.2, width=160, height=72)
    return render.Drive((eye, eye), baseline=0.54, n_frames=6, seed=5, step=0.8, device="cpu",
                        keep_lane=False)


def _original(n_frames=6, seed=5, step=0.8):
    from srba_slam_tpu_torch.utils.camera import StereoCamera
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource

    cam = StereoCamera(fx_l=140.0, fy_l=140.0, cx_l=80.5, cy_l=36.2, fx_r=140.0, fy_r=140.0,
                       cx_r=80.5, cy_r=36.2, baseline=0.54, width=160, height=72)
    return SyntheticSource(cam, n_frames=n_frames, seed=seed, step=step, scene="street")


def test_path_and_texture_match_numpy(small_drive):
    src = _original()
    np.testing.assert_allclose(small_drive.poses, src.gt_poses, rtol=0, atol=1e-12)
    tex = small_drive.tex.numpy()
    ref = src.scene.tex
    assert tex.shape == ref.shape
    # the same blobs in the same order in float32; exp may round apart in the last bit
    assert np.abs(tex - ref).max() < 1e-3
    np.testing.assert_array_equal(small_drive.bz, src.scene.bz)
    np.testing.assert_array_equal(small_drive.bscale, src.scene.bscale)


def test_frames_match_numpy(small_drive):
    src = _original()
    lefts, rights = small_drive.render(range(6))
    for f, (left, right) in enumerate(src):
        for ours, ref in ((lefts[f].numpy(), left), (rights[f].numpy(), right)):
            diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
            assert diff.max() <= 1
            assert (diff > 0).mean() < 1e-3


def test_kept_lane_stays_in_the_street():
    """A long path with the steering stays near the centre line; without
    it the random walk of the heading carries it off."""
    kept = render.path_poses(1101, 2718281828, 0.8, keep_lane=True)
    free = render.path_poses(1101, 2718281828, 0.8, keep_lane=False)
    assert np.abs(kept[:, 3]).max() < 1.5 and np.abs(kept[:, 4]).max() < 0.5
    assert np.abs(free[:, 3]).max() > 3 * np.abs(kept[:, 3]).max()
    # forward about 0.8 m a frame
    assert abs(kept[-1, 5] / 1100 - 0.8) < 0.01


def test_distorted_eye_remaps_to_pinhole():
    """A raw frame of an eye with radial-tangential distortion, undistorted
    by the program's map arithmetic, is the pinhole frame."""
    dist = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)
    pin = render.Camera(fx=230.0, fy=228.0, cx=184.0, cy=124.0, width=376, height=240)
    raw = render.Camera(**{**pin.__dict__, "dist": dist})
    args = dict(baseline=0.11, n_frames=2, seed=3, step=0.022, device="cpu")
    img_pin = render.Drive((pin, pin), **args).render(range(1))[0][0].to(torch.float32)
    img_raw = render.Drive((raw, raw), **args).render(range(1))[0][0].to(torch.float32)
    from slam_bench.reference import frontend

    maps = frontend.build_maps(pin.width, pin.height, pin.fx, pin.fy, pin.cx, pin.cy, dist)
    back = frontend.remap_bilinear(img_raw, maps)
    inner = (slice(10, -10), slice(10, -10))
    # most pixels come back to within a level; resampling moves edges
    assert (back - img_pin)[inner].abs().median() < 0.5
    assert (img_raw - img_pin)[inner].abs().mean() > 3 * (back - img_pin)[inner].abs().mean()
