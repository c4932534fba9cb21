"""The port's batched loop against the JAX package's, on the CPU.

``perform_stereo_slam_batched`` on the small-geometry sequence of
tests/test_batch_mode.py (320x200, seed 11, step 0.12, its estimator
options), both with ``solve_sync = True`` (every window solve lands right
after its insertion). The contracts of
tests/test_batch_mode.py, held across the packages:

* 25 frames at batch 6: the per-frame keyframe decisions identical, and
  identical to the port's own per-frame run; keyframe poses within 1e-4
  (f32 solves that sum in another order);
* the same frames with frames 9-13 darkened to 5%: the adaptive retry
  re-scans batch tails (from mid-batch, and nested); decisions and the final
  FAST/ORB thresholds identical;
* 10 frames at batch 4 (1 + 4 + 4 + 1): a ragged last batch, every frame
  logged, decisions identical;
* ``max_num_kfs = 2`` at batch 5: the run stops at the frame JAX's stops
  at, keeps the rest of that batch and the batches staged after it for the
  next call, and the next call continues to the per-frame run's decisions;
* a checkpoint written by the port after a batched run, resumed in batched
  mode by the port and by the JAX package: identical decisions.
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu.utils import checkpoint as jcheckpoint
from srba_slam_tpu_torch.models import estimator as estimator_mod
from srba_slam_tpu_torch.utils import checkpoint
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.framesource import SyntheticSource
from test_torch_estimator import SMALL, _run
from torch_parity_inputs import SMALL_CAM

torch.set_num_threads(1)

POSE_TOL = 1e-4


def _frames(n: int, dark: bool = False):
    frames = list(SyntheticSource(StereoCamera(**SMALL_CAM), n_frames=n, seed=11, step=0.12))
    if dark:
        frames = [(left * 0.05, right * 0.05) if 9 <= i < 14 else (left, right)
                  for i, (left, right) in enumerate(frames)]
    return frames


def _batched(frames, port: bool, batch: int, **general):
    est = _run(SMALL, [], port)[0]
    for key, val in general.items():
        setattr(est.general, key, val)
    est.perform_stereo_slam_batched(frames, batch=batch)
    est.rba.flush()
    return est


@pytest.fixture(scope="module")
def normal():
    frames = _frames(25)
    return _batched(frames, False, 6), _batched(frames, True, 6), frames


@pytest.fixture(scope="module")
def dark():
    frames = _frames(25, dark=True)
    return _batched(frames, False, 6), _batched(frames, True, 6)


def test_batched_matches_jax_batched_and_port_per_frame(normal):
    j, t, frames = normal
    assert j.store.n_kfs >= 3
    assert decisions(t.step_log) == decisions(j.step_log)
    assert len(t.step_log) == len(frames) and t.frame_idx == len(frames) - 1
    n = j.store.n_kfs
    np.testing.assert_array_equal(t.store.match_ids[:n], j.store.match_ids[:n])
    np.testing.assert_allclose(t.rba.kf_global[:n], j.rba.kf_global[:n], atol=POSE_TOL)
    per_frame, _ = _run(SMALL, frames, port=True)
    assert decisions(per_frame.step_log) == decisions(t.step_log)
    np.testing.assert_allclose(per_frame.rba.kf_global[:n], t.rba.kf_global[:n], atol=1e-6)


def test_batched_retry_tails_match_jax(dark, monkeypatch):
    j, t = dark
    assert t.store.n_kfs == j.store.n_kfs
    assert (t.vo.fast_th, t.vo.orb_th) == (j.vo.fast_th, j.vo.orb_th)
    assert decisions(t.step_log) == decisions(j.step_log)
    # the retry really re-scanned tails: more scans than batches
    scans = []
    scan = estimator_mod.vo_scan
    monkeypatch.setattr(estimator_mod, "vo_scan",
                        lambda lefts, *a, **k: (scans.append(len(lefts)), scan(lefts, *a, **k))[1])
    again = _batched(_frames(25, dark=True), True, 6)
    assert decisions(again.step_log) == decisions(t.step_log)
    assert len(scans) > 4 and min(scans) < 6, scans      # a tail from mid-batch


def test_ragged_last_batch_matches_jax():
    frames = _frames(10)
    j, t = _batched(frames, False, 4), _batched(frames, True, 4)
    assert len(t.step_log) == 10 and t.store.n_kfs >= 1
    assert decisions(t.step_log) == decisions(j.step_log)


def test_max_num_kfs_stops_at_the_frame_and_keeps_the_rest(normal):
    frames = _frames(25)
    j = _batched(frames, False, 5, max_num_kfs=2)
    t = _batched(frames, True, 5, max_num_kfs=2)
    assert t.store.n_kfs == j.store.n_kfs == 2
    assert decisions(t.step_log) == decisions(j.step_log)
    stop = t.frame_idx
    assert t.step_log[-1].inserted_kf == 1 and stop < len(frames) - 5
    # frame 0 bootstraps, then batches of 5 from frame 1: the rest of the
    # stop frame's batch, and the batches the frame uploader staged after
    # it, wait for the next call, in order
    batch_end = 1 + 5 * ((stop - 1) // 5 + 1)
    n_stash = len(t._stashed_frames)
    assert n_stash >= batch_end - stop - 1
    assert (n_stash - (batch_end - stop - 1)) % 5 == 0 or stop + 1 + n_stash == len(frames)
    for (a, b), (c, d) in zip(t._stashed_frames, frames[stop + 1:stop + 1 + n_stash],
                              strict=True):
        assert a is c and b is d
    t.general.max_num_kfs = 0
    t.perform_stereo_slam_batched(frames[stop + 1 + n_stash:], batch=5)
    _j, t_full, _frames_ = normal
    assert decisions(t.step_log) == decisions(t_full.step_log)


def test_checkpoint_after_batched_run_resumes_like_jax(normal, tmp_path):
    frames = _frames(25)
    t = _batched(frames[:13], True, 6)
    path = str(tmp_path / "batched.npz")
    checkpoint.save_state(t, path)
    resumed = []
    for port in (False, True):
        est = _run(SMALL, [], port)[0]
        (checkpoint if port else jcheckpoint).load_state(est, path)
        assert est.frame_idx == 12
        est.perform_stereo_slam_batched(frames[13:], batch=6)
        resumed.append(est)
    j, r = resumed
    assert len(r.step_log) == len(frames) - 13 == len(j.step_log)
    assert decisions(r.step_log) == decisions(j.step_log)
    assert r.store.n_kfs == j.store.n_kfs and r.store.n_kfs > t.store.n_kfs
