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


# ------------------------------------------------------------------- circuit
SMALL_CIRCUIT = dict(block_m=[64, 32], corner_m=10)


@pytest.fixture(scope="module")
def circuit_drive():
    eye = render.Camera(fx=140.0, fy=140.0, cx=80.5, cy=36.2, width=160, height=72)
    c = render.Circuit(SMALL_CIRCUIT["block_m"], SMALL_CIRCUIT["corner_m"])
    return render.Drive((eye, eye), baseline=0.54, n_frames=int(2 * c.length / 0.8) + 1,
                        seed=2**31 + 77, step=0.8, device="cpu", circuit=SMALL_CIRCUIT)


def test_circuit_centre_line_closes():
    c = render.Circuit([160, 80], 20)
    assert c.length == pytest.approx(2 * 120 + 2 * 40 + 2 * np.pi * 20)
    s = np.linspace(0.0, c.length, 2001)
    x, z, psi = c.at(s)
    # continuous, a step of arc length apart, and back at the start
    gaps = np.hypot(np.diff(x), np.diff(z))
    assert np.allclose(gaps, c.length / 2000, rtol=1e-3)
    assert abs(x[-1]) < 1e-9 and abs(z[-1]) < 1e-9
    assert x.min() == pytest.approx(0.0) and x.max() == pytest.approx(80.0)
    assert z.min() == pytest.approx(-20.0) and z.max() == pytest.approx(140.0)
    # each point of the line is its own nearest point, at the line's heading
    for i in range(0, 2000, 37):
        off, head, _k = c.nearest(x[i], z[i])
        assert abs(off) < 1e-9 and abs(render._wrap(head - psi[i])) < 1e-9


def test_circuit_comes_back_to_its_start(circuit_drive):
    """After one lap the camera passes within 1.5 m and 3 degrees of its
    first pose, and it keeps to the centre line all the way."""
    c, poses = circuit_drive.circuit, circuit_drive.poses
    lap = int(c.length / 0.8)
    assert max(abs(c.nearest(p[3], p[5])[0]) for p in poses) < 1.0
    assert np.abs(poses[:, 4]).max() < 0.5
    near = lap - 10 + int(np.argmin(np.linalg.norm(poses[lap - 10:lap + 10, 3:], axis=1)))
    assert np.linalg.norm(poses[near, 3:]) < 1.5
    R = render.so3_exp(poses[near, :3])
    assert np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))) < 3.0


def test_circuit_lap_two_renders_lap_one(circuit_drive):
    """A frame of lap 2 at a pose of lap 1 is lap 1's frame, byte for byte:
    the scene is one lap's, seen again."""
    drv = circuit_drive
    f1, f2 = 30, 30 + int(drv.circuit.length / 0.8)
    kept = drv.poses[f2].copy()
    drv.poses[f2] = drv.poses[f1]
    try:
        again = drv.render(range(f2, f2 + 1))
    finally:
        drv.poses[f2] = kept
    first = drv.render(range(f1, f1 + 1))
    for a, b in zip(first, again):
        assert torch.equal(a, b) and a.float().std() > 20


def _least_angle_on_straights(drv, normals, reach=20.0):
    """The least angle, in degrees, between a board's plane and the ray to
    its centre, over the boards within ``reach`` metres in front of the
    camera and inside its field of view, at every frame on a straight."""
    eye = drv.eyes[0]
    least = 90.0
    n3 = np.stack([normals[:, 0], np.zeros(len(normals)), normals[:, 1]], -1)
    for p in drv.poses:
        if drv.circuit.nearest(p[3], p[5])[2]:
            continue
        cc = (drv.board_c - p[3:]) @ render.so3_exp(p[:3])
        z = cc[:, 2]
        seen = (z > 0.5) & (np.abs(cc[:, 0] / z) < eye.cx / eye.fx) \
            & (np.linalg.norm(cc, axis=1) < reach)
        ray = cc / np.linalg.norm(cc, axis=1, keepdims=True) @ render.so3_exp(p[:3]).T
        ang = np.degrees(np.arcsin(np.abs((ray * n3).sum(1))))
        if seen.any():
            least = min(least, float(ang[seen].min()))
    return least


def test_circuit_boards_face_the_road(circuit_drive):
    """On a straight no board in view is seen edge-on: each faces the
    direction of travel at its place. Boards all facing +z, as on the
    straight street, would be seen edge-on on the block's short sides."""
    drv = circuit_drive
    assert _least_angle_on_straights(drv, drv.board_n) > 25.0
    facing_z = np.tile([0.0, 1.0], (len(drv.board_n), 1))
    assert _least_angle_on_straights(drv, facing_z) < 10.0


def test_left_circuit_is_the_right_one_mirrored():
    """``turn: left`` mirrors the block in x = 0: the same line, headings
    and curvature of the other sign, and a drive that keeps to it, comes
    back to its start after a lap and sees its boards face on."""
    right = render.Circuit([160, 80], 20)
    left = render.Circuit([160, 80], 20, "left")
    s = np.linspace(0.0, right.length, 2001)
    (xr, zr, pr), (xl, zl, pl) = right.at(s), left.at(s)
    assert np.array_equal(xl, -xr) and np.array_equal(zl, zr) and np.array_equal(pl, -pr)
    for i in range(0, 2000, 37):
        off, head, k = left.nearest(xl[i] + 0.3 * np.cos(pl[i]), zl[i] - 0.3 * np.sin(pl[i]))
        k_r = right.nearest(xr[i], zr[i])[2]
        assert off == pytest.approx(0.3) and abs(render._wrap(head - pl[i])) < 1e-9 and k == -k_r
    with pytest.raises(ValueError):
        render.Circuit([160, 80], 20, "straight")
    eye = render.Camera(fx=140.0, fy=140.0, cx=80.5, cy=36.2, width=160, height=72)
    c = render.Circuit(SMALL_CIRCUIT["block_m"], SMALL_CIRCUIT["corner_m"], "left")
    drv = render.Drive((eye, eye), baseline=0.54, n_frames=int(1.2 * c.length / 0.8),
                       seed=2**31 + 77, step=0.8, device="cpu",
                       circuit=dict(SMALL_CIRCUIT, turn="left"))
    poses, lap = drv.poses, int(c.length / 0.8)
    assert max(abs(c.nearest(p[3], p[5])[0]) for p in poses) < 1.0
    assert poses[lap // 2, 3] < -10.0     # the block lies to the left of the start
    near = lap - 10 + int(np.argmin(np.linalg.norm(poses[lap - 10:lap + 10, 3:], axis=1)))
    assert np.linalg.norm(poses[near, 3:]) < 1.5
    R = render.so3_exp(poses[near, :3])
    assert np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))) < 3.0
    assert _least_angle_on_straights(drv, drv.board_n) > 25.0
