"""Trajectory evaluation: ATE / RPE against ground truth.

The reference only *emits* ``out_kf_poses.txt`` for external evaluation
(src/CSRBAStereoSLAMEstimator.cpp:977-987); the metric named in BASELINE.json
(ATE RMSE on KITTI) needs in-repo tooling, so it lives here: Umeyama/Horn
SE(3) alignment + absolute trajectory error and relative pose error, plus a
loader for the ``kf x y z yaw pitch roll`` trajectory format.
"""

from __future__ import annotations

import numpy as np


def load_kf_poses(path: str) -> np.ndarray:
    """Read an out_kf_poses.txt file -> positions [N, 3]."""
    rows = np.loadtxt(path).reshape(-1, 7)
    return rows[:, 1:4]


def align_se3(est: np.ndarray, gt: np.ndarray):
    """Horn/Umeyama closed-form rigid alignment (no scale): returns (R, t)
    minimizing || (R est + t) - gt ||."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    H = (est - mu_e).T @ (gt - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (positions, optional SE(3) alignment)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        R, t = align_se3(est, gt)
        est = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe_translation(est_xyz: np.ndarray, gt_xyz: np.ndarray, delta: int = 1):
    """Relative pose error over `delta`-step windows (translation drift)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def load_gt(path: str):
    """Load a ground-truth trajectory; auto-detects the format.

    Returns (xyz [N,3], per_frame): 12 columns = KITTI ``poses.txt``
    (flattened 3x4 [R|t]; translation at columns 3, 7, 11 — per-frame),
    7 columns = ``out_kf_poses.txt`` (kf x y z yaw pitch roll —
    keyframe-indexed), otherwise the first 3 columns are taken as xyz
    (per-frame)."""
    gt = np.atleast_2d(np.loadtxt(path))
    if gt.shape[1] == 12:
        return gt[:, (3, 7, 11)], True
    if gt.shape[1] == 7:
        return gt[:, 1:4], False
    return gt[:, :3], True


def evaluate_files(est_path: str, gt_path: str,
                   frames_path: str | None = None) -> dict:
    """One-command ATE/RPE check of a finished run: compare an
    ``out_kf_poses.txt`` trajectory against ground truth.

    For PER-FRAME ground truth (KITTI ``poses.txt``), keyframes are
    associated with the ground-truth row of the frame they were inserted
    at via the ``kf_frames.txt`` sidecar the estimator's ``finalize``
    writes next to the trajectory (pass ``frames_path`` to override; the
    sidecar is auto-discovered in ``est_path``'s directory). Returns
    {"ate_rmse", "rpe_1", "n"}; this makes BASELINE.json's ≤1% ATE-delta
    criterion a single command the day real KITTI data is mounted.
    """
    import os

    est_rows = np.atleast_2d(np.loadtxt(est_path)).reshape(-1, 7)
    est_xyz = est_rows[:, 1:4]
    kf_ids = est_rows[:, 0].astype(int)
    gt_xyz, per_frame = load_gt(gt_path)
    if per_frame:
        if frames_path is None:
            cand = os.path.join(os.path.dirname(os.path.abspath(est_path)),
                                "kf_frames.txt")
            frames_path = cand if os.path.exists(cand) else None
        if frames_path is None:
            raise FileNotFoundError(
                "per-frame ground truth needs the kf->frame map: no "
                "kf_frames.txt found next to the trajectory (written by "
                "finalize); pass frames_path explicitly")
        fmap = {int(k): int(f) for k, f in
                np.atleast_2d(np.loadtxt(frames_path)).reshape(-1, 2)}
        sel = [(i, fmap[k]) for i, k in enumerate(kf_ids)
               if k in fmap and fmap[k] < len(gt_xyz)]
        est_sel = est_xyz[[i for i, _ in sel]]
        gt_sel = gt_xyz[[f for _, f in sel]]
    else:
        n = min(len(est_xyz), len(gt_xyz))
        est_sel, gt_sel = est_xyz[:n], gt_xyz[:n]
    if len(est_sel) < 3:
        raise ValueError(f"only {len(est_sel)} associated poses; need >= 3")
    return dict(
        ate_rmse=ate_rmse(est_sel, gt_sel),
        rpe_1=rpe_translation(est_sel, gt_sel, delta=1),
        n=len(est_sel),
    )


def main(argv=None):
    """CLI: ``python -m srba_slam_tpu_torch.utils.evaluation <out_kf_poses.txt>
    <gt> [--frames kf_frames.txt]`` — prints one JSON line with ATE RMSE
    (SE(3)-aligned) and 1-step RPE."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="srba_slam_tpu_torch.utils.evaluation")
    ap.add_argument("trajectory", help="out_kf_poses.txt from a run")
    ap.add_argument("ground_truth",
                    help="KITTI poses.txt / out_kf_poses.txt / Nx3 xyz")
    ap.add_argument("--frames", default=None,
                    help="kf_frames.txt sidecar (auto-discovered next to "
                         "the trajectory when omitted)")
    args = ap.parse_args(argv)
    out = evaluate_files(args.trajectory, args.ground_truth, args.frames)
    print(json.dumps({"ate_rmse_m": round(out["ate_rmse"], 6),
                      "rpe_1_m": round(out["rpe_1"], 6),
                      "n_poses": out["n"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
