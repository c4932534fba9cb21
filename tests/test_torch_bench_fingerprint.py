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

``srba_slam_tpu_torch/data/jax_bench_pipeline.json`` holds the JAX
package's runs of the same workload with its default schedule, as its
``bench.py`` drives it (``bw.SCHEDULES``: 21 frames, then 60 in a second
call, at batch 20 and 8, with ``solve_flush_before_insert``, and the
device-resident loop in chunks of 60 and of 8), so ``chip_smoke.py``'s
phase 15 and ``srba_slam_tpu_torch/bench.py`` hold the port's run of each
to the JAX run of the same schedule, and not only to the strict one.
Slow tests:

* the JAX runs, made again, still give the committed file (decisions
  exactly, poses and ATE within 1e-5);
* the port's CPU run of each schedule makes the JAX run's decisions, its
  keyframe poses within 1e-3 of JAX's (the pipelined tolerance of
  tests/test_torch_pipeline.py), its ATE inside the gate.

Regenerate the files with ``python tests/test_torch_bench_fingerprint.py
--write`` (the strict one) or ``--write-pipeline``.
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
    frames, sha, gt = _frames()
    est = _jax_estimator()
    est.solve_sync = True
    if batch > 1:
        est.perform_stereo_slam_batched(frames, batch=batch)
    else:
        for left, right in frames:
            est.step(left, right)
    return _fingerprint(est, sha, gt)


def _jax_estimator():
    from srba_slam_tpu.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
    from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator
    from srba_slam_tpu.utils.camera import StereoCamera

    est = SRBAStereoSLAMEstimator(
        GeneralOptions(), SRBAStereoSLAMOptions(camera=StereoCamera.kitti(), **bw.OPTIONS),
        VOOptions(**bw.VO_OPTIONS), capacity=bw.CAPACITY, max_kfs=bw.MAX_KFS)
    est.initialize()
    return est


def _run_schedule(est, name: str, frames, device_loop):
    """``name`` of ``bw.SCHEDULES`` on ``est`` over ``frames``: the
    warm-up call, then the rest (``device_loop(est, rest)`` for the
    device-resident loop); the solves in flight land at the end."""
    batch, mid, chunk = bw.SCHEDULES[name]
    est.solve_flush_before_insert = mid
    w = bw.WARMUP_FRAMES
    est.perform_stereo_slam_batched(frames[:w], batch=batch)
    est.rba.flush()
    if chunk:
        device_loop(est, frames[w:], chunk)
    else:
        est.perform_stereo_slam_batched(frames[w:], batch=batch)
    est.rba.flush()


def _chunks(rest, to_device, c):
    return [(to_device(np.stack([f[0] for f in rest[i:i + c]])),
             to_device(np.stack([f[1] for f in rest[i:i + c]])))
            for i in range(0, len(rest), c)]


def _jax_device_loop(est, rest, chunk):
    """The device-resident loop of the JAX package's ``bench.py`` over the
    frames ``rest``, in chunks of ``chunk``."""
    import jax.numpy as jnp

    from test_torch_pipeline import jax_device_loop

    jax_device_loop(est, _chunks(rest, jnp.asarray, chunk))


def jax_pipeline_fingerprint() -> dict:
    """The JAX package's run of each of ``bw.SCHEDULES`` (its default
    pipelined solves and deferred checks)."""
    frames, sha, gt = _frames()
    runs = {}
    for name in bw.SCHEDULES:
        est = _jax_estimator()
        _run_schedule(est, name, frames, _jax_device_loop)
        runs[name] = _fingerprint(est, sha, gt)
    return {"workload": runs[name]["workload"], "warmup_frames": bw.WARMUP_FRAMES,
            "dev_chunk": bw.DEV_CHUNK, "schedules": {k: list(v) for k, v in bw.SCHEDULES.items()},
            "runs": {k: {f: v for f, v in r.items() if f != "workload"}
                     for k, r in runs.items()}}


def port_schedule_fingerprint(name: str, device: str = "cpu") -> dict:
    """The port's run of ``name`` of ``bw.SCHEDULES`` on ``device``."""
    import torch

    from srba_slam_tpu_torch.models.estimator import bench_estimator

    frames, sha, gt = _frames()
    est = bench_estimator(device)
    _run_schedule(est, name, frames, lambda e, rest, chunk: e.perform_stereo_slam_device(
        _chunks(rest, lambda a: torch.from_numpy(a).to(device), chunk)))
    return _fingerprint(est, sha, gt)


def port_fingerprint(device: str = "cpu", batch: int = 1) -> dict:
    """The port's run of the same workload on ``device``, per frame or at
    ``batch`` frames a scan."""
    from srba_slam_tpu_torch.models.estimator import bench_estimator

    frames, sha, gt = _frames()
    est = bench_estimator(device, solve_sync=True)
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


@pytest.mark.slow
def test_committed_pipeline_fingerprint_matches_jax():
    got = jax_pipeline_fingerprint()
    ref = bw.load_fingerprint(bw.PIPELINE_FINGERPRINT)
    assert got["workload"] == ref["workload"]
    assert got["schedules"] == ref["schedules"]
    for name, run in ref["runs"].items():
        assert got["runs"][name]["decisions"] == run["decisions"], name
        for key in ("kf_global", "final_poses_cam"):
            np.testing.assert_allclose(got["runs"][name][key], run[key], atol=POSE_TOL)
        assert abs(got["runs"][name]["ate_m"] - run["ate_m"]) <= POSE_TOL


@pytest.mark.slow
@pytest.mark.parametrize("name", list(bw.SCHEDULES))
def test_port_cpu_schedule_matches_jax(name):
    ref = bw.load_fingerprint(bw.PIPELINE_FINGERPRINT)["runs"][name]
    got = port_schedule_fingerprint(name)
    strict = np.asarray(bw.load_fingerprint()["kf_global"])[:, 3:]
    d_port = np.max(np.linalg.norm(np.asarray(got["kf_global"])[:, 3:] - strict, axis=1))
    d_jax = np.max(np.linalg.norm(np.asarray(ref["kf_global"])[:, 3:] - strict, axis=1))
    print(f"{name}: keyframe positions from the strict run: port {d_port:.6f} m, "
          f"JAX {d_jax:.6f} m; port against JAX max "
          f"{np.abs(np.asarray(got['kf_global']) - np.asarray(ref['kf_global'])).max():.3e}; "
          f"ATE port {got['ate_m']:.6f} m, JAX {ref['ate_m']:.6f} m")
    assert got["decisions"] == ref["decisions"]
    np.testing.assert_allclose(got["kf_global"], ref["kf_global"], atol=1e-3)
    assert got["ate_m"] < ATE_GATE_M


if __name__ == "__main__":
    if not {"--write", "--write-pipeline"} & set(sys.argv):
        sys.exit("usage: python tests/test_torch_bench_fingerprint.py --write|--write-pipeline")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--write-pipeline" in sys.argv:
        fp = jax_pipeline_fingerprint()
        with open(bw.PIPELINE_FINGERPRINT, "w") as f:
            json.dump(fp, f, indent=1)
            f.write("\n")
        print(f"wrote {bw.PIPELINE_FINGERPRINT}: " + ", ".join(
            f"{k} {r['n_kfs']} keyframes, ATE {r['ate_m']:.4f} m" for k, r in fp["runs"].items()))
        sys.exit(0)
    fp = jax_fingerprint()
    os.makedirs(os.path.dirname(bw.FINGERPRINT), exist_ok=True)
    with open(bw.FINGERPRINT, "w") as f:
        json.dump(fp, f, indent=1)
        f.write("\n")
    print(f"wrote {bw.FINGERPRINT}: {fp['n_kfs']} keyframes, {fp['n_checks']} checks, "
          f"ATE {fp['ate_m']:.4f} m")
