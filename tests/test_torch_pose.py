"""SE(3) algebra and the robust pose solve in the port against the JAX package.

Tolerances:
* se3: 1e-5 absolute on float32 results (a few ulps of values of order 1-5;
  sin/cos/atan2 round differently in the two libraries). Near theta = pi,
  1e-3: the rotation vector is ill-conditioned there.
* solve_pose: identical inliers and valid; iters within +-1; pose within
  1e-4. The 6x6 normal sums run in another order, which moves each GN step
  by ulps and can move the min_mod stop by one iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops.robust_lm import solve_pose as jsolve
from srba_slam_tpu.utils import se3 as jse3
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.ops.robust_lm import solve_pose
from srba_slam_tpu_torch.utils import se3, se3_np
from srba_slam_tpu_torch.utils.camera import StereoCamera


def random_poses(rng, n, max_angle=2.8):
    w = rng.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(0.0, max_angle, (n, 1))
    t = rng.normal(size=(n, 3)) * 5.0
    return np.concatenate([w, t], axis=-1).astype(np.float32)


CASES = {
    "exp_R": lambda m, a, b: m.exp(a)[0],
    "so3_log": lambda m, a, b: m.so3_log(m.so3_exp(a[..., :3])),
    "hat": lambda m, a, b: m.hat(a[..., :3]),
    "compose": lambda m, a, b: m.compose(a, b),
    "inverse": lambda m, a, b: m.inverse(a),
    "quat": lambda m, a, b: m.quat_from_rotmat(m.so3_exp(a[..., :3])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_se3_matches_jax(rng, case):
    a, b = random_poses(rng, 64), random_poses(rng, 64)
    a[0] = 0.0                     # identity: the small-angle branches
    a[1, :3] = [1e-8, -1e-9, 1e-8]
    f = CASES[case]
    ref = np.asarray(f(jse3, jnp.asarray(a), jnp.asarray(b)))
    got = f(se3, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_so3_log_near_pi(rng):
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    w = (axes * (np.pi - 1e-3)).astype(np.float32)
    ref = np.asarray(jse3.so3_log(jse3.so3_exp(jnp.asarray(w))))
    got = se3.so3_log(se3.so3_exp(torch.from_numpy(w))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got, w, atol=1e-2)


CAM_KW = dict(fx_l=180.0, fy_l=180.0, cx_l=160.0, cy_l=100.0, fx_r=180.0, fy_r=180.0,
              cx_r=160.0, cy_r=100.0, baseline=0.54, width=320, height=200)


def _problem(rng, n=200, outlier_frac=0.15):
    """Points in front of the previous camera, their stereo pixels in the
    current one under a known increment, pixel noise, gross outliers and
    padded (invalid) rows."""
    pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(4, 25, n)], -1)
    true = np.array([0.01, -0.02, 0.005, 0.1, -0.05, -0.6])
    R = se3_np.so3_exp(true[:3])
    x = pts @ R.T + true[3:]
    c = CAM_KW
    obs = np.stack([c["cx_l"] + c["fx_l"] * x[:, 0] / x[:, 2],
                    c["cy_l"] + c["fy_l"] * x[:, 1] / x[:, 2],
                    c["cx_r"] + c["fx_r"] * (x[:, 0] - c["baseline"]) / x[:, 2]], -1)
    obs += rng.normal(0, 0.3, obs.shape)
    out = rng.random(n) < outlier_frac
    obs[out] += rng.uniform(-60, 60, (int(out.sum()), 3))
    valid = rng.random(n) < 0.9
    return pts.astype(np.float32), obs.astype(np.float32), valid, true


@pytest.mark.parametrize("seed", [1, 2])
def test_solve_pose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts, obs, valid, true = _problem(rng)
    init = np.zeros(6, np.float32)
    kw = dict(kernel_param=3.0, residual_threshold=15.0, min_mod=1e-3,
              max_iters_initial=30, max_iters=30, min_inliers=5, max_incr_cost=3)
    ref = jsolve(jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid), JCam(**CAM_KW),
                 initial_pose=jnp.asarray(init), **kw)
    got = solve_pose(torch.from_numpy(pts), torch.from_numpy(obs), torch.from_numpy(valid),
                     StereoCamera(**CAM_KW), initial_pose=torch.from_numpy(init), **kw)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert bool(got.valid) == bool(ref.valid) is True
    assert int(got.num_inliers) == int(ref.num_inliers)
    assert abs(int(got.iters) - int(ref.iters)) <= 1
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.pose.numpy(), true, atol=0.02)
    np.testing.assert_allclose(float(got.mean_residual), float(ref.mean_residual), rtol=1e-3)


def test_solve_pose_too_few_inliers():
    rng = np.random.default_rng(3)
    pts, obs, _valid, _ = _problem(rng, n=20)
    valid = np.zeros(20, bool)
    valid[:3] = True
    init = np.full(6, 0.01, np.float32)
    got = solve_pose(torch.from_numpy(pts), torch.from_numpy(obs), torch.from_numpy(valid),
                     StereoCamera(**CAM_KW), initial_pose=torch.from_numpy(init))
    ref = jsolve(jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(valid), JCam(**CAM_KW),
                 initial_pose=jnp.asarray(init))
    assert bool(got.valid) == bool(ref.valid) is False
    np.testing.assert_array_equal(got.pose.numpy(), init)
