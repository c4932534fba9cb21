"""The lane-batched pose solve and VO step of the port against the JAX
package's vmapped functions, on the CPU.

* ``solve_pose`` at L = 5 lanes against ``jax.vmap`` of the JAX
  ``solve_pose``: lanes that stop at different iterations, a lane that
  stops on ``max_incr_cost`` (at 1 here: the initial pose puts the points
  50 m deep, where the first GN step overshoots; with 3, the steps after
  it follow f32 roundoff, and the JAX and torch solves part ways),
  a lane whose normal matrix is not positive definite in f32 (sixteen
  copies of one point: rank 3 plus a damping below f32 resolution; torch's
  ``cholesky_ex`` reports it, JAX's ``cholesky`` returns NaNs) and an
  all-invalid lane. Contract of tests/test_torch_pose.py: inliers and
  validity equal, iters within +-1, pose within 1e-4 (the 6x6 normal sums
  run in another order).
* Lane j of the batch is the one-lane call on lane j's inputs, and the
  result does not depend on how often the host reads the exit test
  (``GN_EXIT_EVERY`` 1, 4 or max_iters): both exactly, since a lane past
  its exit keeps its whole carry.
* The host reads of one solve (``Tensor.item``, ``__bool__``, ``__int__``,
  ``__float__``) stay at most 2 x (ceil(max_iters / E) + 1), whatever L.
* ``track_and_solve`` of 3 sequences with one ORB threshold each against
  the JAX function vmapped over the sequences (≙ the JAX fleet's solve),
  and ``batched_vo_step`` at B = 3 against the JAX one: integer outputs
  equal, poses within 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.models import vo as jvo
from srba_slam_tpu.ops.orb import gauss_blur7 as jblur
from srba_slam_tpu.ops.robust_lm import solve_pose as jsolve
from srba_slam_tpu.parallel import batch as jbatch
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models import vo
from srba_slam_tpu_torch.ops import hopper_fast, orb, robust_lm
from srba_slam_tpu_torch.parallel import batch
from srba_slam_tpu_torch.utils import se3_np
from srba_slam_tpu_torch.utils.camera import StereoCamera

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

CAM_KW = dict(fx_l=180.0, fy_l=180.0, cx_l=160.0, cy_l=100.0, fx_r=180.0, fy_r=180.0,
              cx_r=160.0, cy_r=100.0, baseline=0.54, width=320, height=200)
SOLVE_KW = dict(kernel_param=3.0, residual_threshold=15.0, min_mod=1e-3,
                max_iters_initial=30, max_iters=30, min_inliers=5, max_incr_cost=1)
N_PTS = 64
POSE_TOL = 1e-4


def _project(pts, pose):
    c = CAM_KW
    x = pts @ se3_np.so3_exp(pose[:3]).T + pose[3:]
    return np.stack([c["cx_l"] + c["fx_l"] * x[:, 0] / x[:, 2],
                     c["cy_l"] + c["fy_l"] * x[:, 1] / x[:, 2],
                     c["cx_r"] + c["fx_r"] * (x[:, 0] - c["baseline"]) / x[:, 2]], -1)


def _scene(seed):
    """Points in front of the previous camera, their stereo pixels under a
    known increment, pixel noise, 15% gross outliers, 10% invalid rows."""
    rng = np.random.default_rng(seed)
    n = N_PTS
    pts = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(4, 25, n)], -1)
    obs = _project(pts, np.array([0.01, -0.02, 0.005, 0.1, -0.05, -0.6]))
    obs += rng.normal(0, 0.3, obs.shape)
    out = rng.random(n) < 0.15
    obs[out] += rng.uniform(-60, 60, (int(out.sum()), 3))
    return pts, obs, rng.random(n) < 0.9


def _lanes():
    """Five lanes: (pts [N,3], obs [N,3], valid [N], initial pose [6])."""
    lanes = []
    for seed, init in ((0, [0, 0, 0, 0, 0, 0]), (2, [0, 0, 0, 0, 0, 5]),
                       (1, [0, 0, 0, 3, 0, 50])):
        pts, obs, valid = _scene(seed)
        lanes.append((pts, obs, valid, np.array(init, np.float64)))
    one = np.tile([[1.0, 0.5, 1.0]], (N_PTS, 1))          # not positive definite
    lanes.append((one, _project(one, np.zeros(6)), np.ones(N_PTS, bool), np.zeros(6)))
    pts, obs, _ = _scene(3)                              # all invalid
    lanes.append((pts, obs, np.zeros(N_PTS, bool), np.full(6, 0.01)))
    return [(p.astype(np.float32), o.astype(np.float32), v, i.astype(np.float32))
            for p, o, v, i in lanes]


def _stack(lanes):
    return [np.stack(parts) for parts in zip(*lanes)]


def _port(pts, obs, valid, init):
    return robust_lm.solve_pose(torch.from_numpy(pts), torch.from_numpy(obs),
                                torch.from_numpy(valid), StereoCamera(**CAM_KW),
                                initial_pose=torch.from_numpy(init), **SOLVE_KW)


@pytest.fixture(scope="module")
def jax_lanes():
    pts, obs, valid, init = _stack(_lanes())
    fn = jax.vmap(lambda p, o, v, i: jsolve(p, o, v, JCam(**CAM_KW), initial_pose=i,
                                            **SOLVE_KW))
    return jax.device_get(fn(*(jnp.asarray(a) for a in (pts, obs, valid, init))))


def test_solve_pose_lanes_match_vmapped_jax(jax_lanes):
    lanes = _lanes()
    got = _port(*_stack(lanes))
    ref = jax_lanes
    np.testing.assert_array_equal(got.inliers.numpy(), ref.inliers)
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.num_inliers.numpy(), ref.num_inliers)
    assert np.abs(got.iters.numpy() - ref.iters).max() <= 1
    np.testing.assert_allclose(got.pose.numpy(), ref.pose, atol=POSE_TOL, rtol=0)
    # the lanes are what the docstring says they are
    assert got.valid.tolist() == [True, True, True, True, False]
    assert len(set(got.iters.tolist())) >= 3              # lanes exit apart
    no_incr = robust_lm.solve_pose(
        *(torch.from_numpy(a) for a in lanes[2][:3]), StereoCamera(**CAM_KW),
        initial_pose=torch.from_numpy(lanes[2][3]), **dict(SOLVE_KW, max_incr_cost=1 << 30))
    assert int(no_incr.iters) != int(got.iters[2])        # max_incr_cost bit
    assert int(got.iters[3]) == 0 and int(got.num_inliers[3]) == N_PTS  # Cholesky failed
    np.testing.assert_array_equal(got.pose[4].numpy(), lanes[4][3])


@pytest.mark.parametrize("exit_every", [1, 4, SOLVE_KW["max_iters"]])
def test_lanes_equal_one_lane_calls_at_any_exit_period(monkeypatch, exit_every):
    lanes = _lanes()
    monkeypatch.setattr(robust_lm, "GN_EXIT_EVERY", exit_every)
    got = _port(*_stack(lanes))
    for j, lane in enumerate(lanes):
        one = _port(*lane)
        for name, a, b in zip(got._fields, got, one):
            assert torch.equal(a[j], b), (j, name)
    monkeypatch.setattr(robust_lm, "GN_EXIT_EVERY", 4)
    base = _port(*_stack(lanes))
    for name, a, b in zip(got._fields, got, base):
        assert torch.equal(a, b), name


def _count_host_reads(monkeypatch) -> list:
    reads = [0]
    for name in ("item", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


@pytest.mark.parametrize("n_lanes", [1, 5])
def test_solve_pose_host_reads_are_bounded(monkeypatch, n_lanes):
    args = _stack(_lanes()[:n_lanes])
    reads = _count_host_reads(monkeypatch)
    out = _port(*args)
    monkeypatch.undo()
    bound = 2 * (math.ceil(SOLVE_KW["max_iters"] / robust_lm.GN_EXIT_EVERY) + 1)
    assert 0 < reads[0] <= bound, (reads[0], bound)
    assert out.pose.shape == (n_lanes, 6)


def _jax_blur(img: torch.Tensor) -> torch.Tensor:
    fn = jblur
    for _ in range(img.dim() - 2):
        fn = jax.vmap(fn)
    return torch.from_numpy(np.array(fn(jnp.asarray(img.numpy(), jnp.float32))))


@pytest.fixture
def shared_blur(monkeypatch):
    # the port's blur differs from XLA's in the last bit at a few pixels
    # (tests/test_torch_orb.py): both sides blur with JAX's here
    monkeypatch.setattr(orb, "gauss_blur7", _jax_blur)
    monkeypatch.setattr(hopper_fast, "gauss_blur7", _jax_blur)


SMALL = dict(fx_l=90.0, fy_l=90.0, cx_l=80.0, cy_l=48.0, fx_r=90.0, fy_r=90.0, cx_r=80.0,
             cy_r=48.0, baseline=0.5, width=160, height=96)


def _frames(seed, b=3, h=96, w=160):
    rng = np.random.default_rng(seed)
    lefts = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    return lefts, np.roll(lefts, -3, axis=-1)


def test_track_and_solve_lanes_match_vmapped_jax(shared_blur):
    """Three sequences, each at its own ORB threshold (the fleet's case)."""
    k = 64
    # one scene in all three lanes: only the threshold differs
    (l0, r0), (l1, r1) = (tuple(np.repeat(a, 3, axis=0) for a in _frames(5, b=1))
                          for _ in range(2))
    # the second frame moved a row, under pixel noise: descriptor distances
    # spread, so the three thresholds keep different matches
    noise = np.random.default_rng(6).normal(0, 25, l1.shape[1:]).astype(np.float32)
    l1 = np.clip(np.roll(l1, 1, axis=-2) + noise, 0, 255)
    r1 = np.clip(np.roll(r1, 1, axis=-2) + np.roll(noise, -3, axis=-1), 0, 255)
    orb_th = np.array([35, 50, 90], np.int32)
    init = np.zeros((3, 6), np.float32)
    jcam = JCam(**SMALL)

    def jfeat(lefts, rights):
        return jax.vmap(lambda a, b: jvo.extract_and_match(a, b, jcam, 8.0, 60, k=k))(
            jnp.asarray(lefts), jnp.asarray(rights))

    jprev, jcur = jfeat(l0, r0), jfeat(l1, r1)
    jout = jax.device_get(jax.vmap(lambda p, c, i, o: jvo.track_and_solve(p, c, jcam, i, o))(
        jprev, jcur, jnp.asarray(init), jnp.asarray(orb_th)))
    tf = [vo.frame_features_from_numpy(jax.device_get(f), "cpu") for f in (jprev, jcur)]
    got = vo.track_and_solve(tf[0], tf[1], StereoCamera(**SMALL), torch.from_numpy(init),
                             torch.from_numpy(orb_th.astype(np.float32)))
    np.testing.assert_array_equal(got.track_idx.numpy(), jout.track_idx)
    np.testing.assert_array_equal(got.track_valid.numpy(), jout.track_valid)
    np.testing.assert_array_equal(got.pose.valid.numpy(), jout.pose.valid)
    np.testing.assert_array_equal(got.pose.inliers.numpy(), jout.pose.inliers)
    np.testing.assert_allclose(got.pose.pose.numpy(), jout.pose.pose, atol=POSE_TOL)
    tracked = got.track_valid.sum(-1).tolist()
    assert tracked[0] < tracked[1] < tracked[2] and tracked[0] > 10, tracked
    for j in range(3):                            # lane j = the one-sequence call
        one = vo.track_and_solve(*(type(f)(*(a[j] for a in f)) for f in tf),
                                 StereoCamera(**SMALL), torch.from_numpy(init[j]),
                                 int(orb_th[j]))
        assert torch.equal(one.track_idx, got.track_idx[j])
        assert torch.equal(one.pose.pose, got.pose.pose[j])


def test_batched_vo_step_b3_matches_jax(shared_blur):
    lefts, rights = _frames(9)
    init = np.zeros((3, 6), np.float32)
    k = 64
    jprev, tprev = jbatch.empty_features(3, k), batch.empty_features(3, k, device="cpu")
    mesh = jbatch.make_mesh(1)
    for step in range(2):
        jout = jax.device_get(jbatch.batched_vo_step(
            mesh, jnp.asarray(lefts), jnp.asarray(rights), jprev, jnp.asarray(init),
            JCam(**SMALL), fast_th=8.0, k=k))
        tout = batch.batched_vo_step(batch.make_mesh(devices=["cpu"]), lefts, rights, tprev,
                                     init, StereoCamera(**SMALL), fast_th=8.0, k=k)
        for name in ("xs_l", "ys_l", "m_valid", "m_r_idx"):
            np.testing.assert_array_equal(getattr(tout[0], name).numpy(),
                                          np.asarray(getattr(jout[0], name)), err_msg=name)
        np.testing.assert_array_equal(tout[2].numpy(), jout[2])
        np.testing.assert_allclose(tout[1].numpy(), jout[1], atol=POSE_TOL)
        np.testing.assert_allclose(float(tout[3]), float(jout[3]), atol=POSE_TOL)
        jprev, tprev = jout[0], tout[0]
        lefts, rights = np.roll(lefts, 1, axis=-1), np.roll(rights, 1, axis=-1)
    assert bool(tout[2].all())
