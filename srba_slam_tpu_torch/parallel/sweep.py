"""Feature-budget sweeps: the VO frontend at several capacities.

Counterpart of ``srba_slam_tpu/parallel/sweep.py``. The reference runs one
configuration at a time; a sweep runs the same frames through the VO at
each feature budget (e.g. 500/1000/2000 keypoints a frame) and reports the
matches, tracks and trajectory of each.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from srba_slam_tpu_torch.models.vo import extract_and_match, track_frame
from srba_slam_tpu_torch.utils import se3_np
from srba_slam_tpu_torch.utils.camera import StereoCamera


@dataclass
class SweepResult:
    n_feats: int
    mean_stereo_matches: float
    mean_tracked: float
    trajectory: np.ndarray          # [T, 6]
    drift: float                    # final position error vs gt (if given)


def feature_budget_sweep(frames, cam: StereoCamera, budgets=(512, 1024, 2048),
                         fast_th: float = 20.0, gt_poses=None, device="cuda"):
    """Run the VO frontend at several feature budgets over the same frames
    on ``device``; one :class:`SweepResult` per budget."""
    th = float(np.float32(fast_th))
    results = []
    for k in budgets:
        prev = None
        pose = np.zeros(6)
        traj = [pose.copy()]
        n_matches, n_tracked = [], []
        inc = torch.zeros(6, dtype=torch.float32, device=device)
        for left, right in frames:
            cur = extract_and_match(left, right, cam, th, 60, k=int(k), device=device)
            if prev is not None:
                out = track_frame(prev, cur, cam, inc, 60)
                t_val, p, ok, m_valid = (t.cpu().numpy() for t in (
                    out.track_valid, out.pose.pose, out.pose.valid, cur.m_valid))
                n_matches.append(int(m_valid.sum()))
                n_tracked.append(int(t_val.sum()))
                if bool(ok):
                    pose = se3_np.compose(pose, se3_np.inverse(p.astype(np.float64)))
                    inc = out.pose.pose
                traj.append(pose.copy())
            prev = cur
        traj = np.stack(traj)
        drift = (
            float(np.linalg.norm(traj[-1, 3:] - gt_poses[len(traj) - 1, 3:]))
            if gt_poses is not None else float("nan")
        )
        results.append(SweepResult(
            n_feats=int(k),
            mean_stereo_matches=float(np.mean(n_matches)) if n_matches else 0.0,
            mean_tracked=float(np.mean(n_tracked)) if n_tracked else 0.0,
            trajectory=traj,
            drift=drift,
        ))
    return results
