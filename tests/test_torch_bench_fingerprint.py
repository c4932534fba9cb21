"""The committed JAX fingerprint of the bench workload, and the port against it.

``srba_slam_tpu_torch/data/jax_bench_steplog.json`` holds the JAX package's
per-frame run (``step()`` with ``solve_sync = True``) of ``bench.py``'s
estimator over its 81-frame street sequence (``utils/bench_workload.py``).
``chip_smoke.py`` holds the port's run on the card against it, because the
card has no jax. Both tests here are slow (minutes on the CPU), so they are
not in tier-1:

* the JAX run, made again, still gives the committed file: its keyframe
  decisions exactly, its poses and ATE within 1e-5;
* the port's CPU run makes the same keyframe decisions on every frame, and
  its aligned ATE is inside the JAX gate (0.5 m,
  ``tests/test_kitti_geometry_ate.py``);
* the JAX package's batched loop (``perform_stereo_slam_batched``, batch 8)
  makes the per-frame run's decisions, its poses and ATE within 1e-5, so
  ``chip_smoke.py``'s batched phase holds the port's batched run to the
  same file; the port's batched CPU run makes them too.

Regenerate the file with ``python tests/test_torch_bench_fingerprint.py --write``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from srba_slam_tpu_torch.utils import bench_workload as bw  # noqa: E402

POSE_TOL = 1e-5
ATE_GATE_M = 0.5


def _fingerprint(est, frames_sha, gt_poses) -> dict:
    from srba_slam_tpu_torch.utils.evaluation import ate_rmse

    n = est.store.n_kfs
    kf_global = np.asarray(est.rba.kf_global[:n], np.float64).copy()
    final = np.asarray(est.finalize(), np.float64)
    kf_frames = [r.frame_idx for r in est.step_log if r.inserted_kf is not None]
    ate = ate_rmse(est.final_poses_cam[:, 3:], gt_poses[kf_frames][:, 3:], align=True)
    return {
        "workload": {"options": bw.OPTIONS, "vo_options": bw.VO_OPTIONS,
                     "capacity": bw.CAPACITY, "max_kfs": bw.MAX_KFS,
                     "source": bw.SOURCE, "frame0_left_sha256": frames_sha},
        "decision_fields": ["frame_idx", *bw.DECISION_FIELDS],
        "decisions": bw.decisions(est.step_log),
        "n_kfs": n,
        "n_checks": sum(1 for r in est.step_log if r.kf_check),
        "kf_frames": kf_frames,
        "kf_global": kf_global.tolist(),
        "final_poses_cam": np.asarray(est.final_poses_cam, np.float64).tolist(),
        "final_poses": final.tolist(),
        "ate_m": float(ate),
    }


def _frames():
    from srba_slam_tpu_torch.utils.camera import StereoCamera
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource

    src = SyntheticSource(StereoCamera.kitti(), **bw.SOURCE)
    frames = list(src)
    sha = hashlib.sha256(np.ascontiguousarray(frames[0][0]).tobytes()).hexdigest()
    return frames, sha, src.gt_poses


def jax_fingerprint(batch: int = 1) -> dict:
    """The JAX package's run of the bench workload: per frame, or through
    its batched loop at ``batch`` frames a scan."""
    from srba_slam_tpu.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator
    from srba_slam_tpu.utils.camera import StereoCamera

    frames, sha, gt = _frames()
    cam = StereoCamera.kitti()
    est = SRBAStereoSLAMEstimator(
        GeneralOptions(), SRBAStereoSLAMOptions(camera=cam, **bw.OPTIONS),
        VOOptions(**bw.VO_OPTIONS), capacity=bw.CAPACITY, max_kfs=bw.MAX_KFS)
    est.initialize()
    est.solve_sync = True
    if batch > 1:
        est.perform_stereo_slam_batched(frames, batch=batch)
    else:
        for left, right in frames:
            est.step(left, right)
    return _fingerprint(est, sha, gt)


def port_fingerprint(device: str = "cpu", batch: int = 1) -> dict:
    """The port's run of the same workload on ``device``, per frame or at
    ``batch`` frames a scan."""
    from srba_slam_tpu_torch.models.estimator import bench_estimator

    frames, sha, gt = _frames()
    est = bench_estimator(device)
    if batch > 1:
        est.perform_stereo_slam_batched(frames, batch=batch)
    else:
        for left, right in frames:
            est.step(left, right)
    return _fingerprint(est, sha, gt)


@pytest.mark.slow
def test_committed_fingerprint_matches_jax():
    got = jax_fingerprint()
    ref = bw.load_fingerprint()
    assert got["workload"] == ref["workload"]
    assert got["decisions"] == ref["decisions"]
    for key in ("kf_global", "final_poses_cam"):
        np.testing.assert_allclose(got[key], ref[key], atol=POSE_TOL)
    assert abs(got["ate_m"] - ref["ate_m"]) <= POSE_TOL


@pytest.mark.slow
def test_port_cpu_matches_fingerprint():
    ref = bw.load_fingerprint()
    got = port_fingerprint("cpu")
    assert got["workload"] == ref["workload"]
    assert got["decisions"] == ref["decisions"]
    assert got["ate_m"] < ATE_GATE_M


@pytest.mark.slow
def test_jax_batched_run_matches_fingerprint():
    got = jax_fingerprint(batch=8)
    ref = bw.load_fingerprint()
    assert got["workload"] == ref["workload"]
    assert got["decisions"] == ref["decisions"]
    for key in ("kf_global", "final_poses_cam"):
        np.testing.assert_allclose(got[key], ref[key], atol=POSE_TOL)
    assert abs(got["ate_m"] - ref["ate_m"]) <= POSE_TOL


@pytest.mark.slow
def test_port_cpu_batched_matches_fingerprint():
    ref = bw.load_fingerprint()
    got = port_fingerprint("cpu", batch=8)
    assert got["decisions"] == ref["decisions"]
    assert got["ate_m"] < ATE_GATE_M


if __name__ == "__main__":
    if "--write" not in sys.argv:
        sys.exit("usage: python tests/test_torch_bench_fingerprint.py --write")
    import jax

    jax.config.update("jax_platforms", "cpu")
    fp = jax_fingerprint()
    os.makedirs(os.path.dirname(bw.FINGERPRINT), exist_ok=True)
    with open(bw.FINGERPRINT, "w") as f:
        json.dump(fp, f, indent=1)
        f.write("\n")
    print(f"wrote {bw.FINGERPRINT}: {fp['n_kfs']} keyframes, {fp['n_checks']} checks, "
          f"ATE {fp['ate_m']:.4f} m")
