"""Headless visualization (≙ the reference's CDisplayWindow3D GUI).

The reference shows a live 3D window with the camera frustum, SRBA map and
BoW query-score bars (src/CSRBAStereoSLAMEstimator.cpp:1262-1338,
show_kf_numbers at utils.cpp:101-151). The port's own copy of
``srba_slam_tpu/utils/viz.py`` (numpy and, inside the function, matplotlib):
a headless run renders to files instead, a top-down trajectory/map PNG here
and the PLY scene export in ``utils/debug_dumps.py``.
"""

from __future__ import annotations

import numpy as np


def render_map_png(path: str, poses: np.ndarray, landmarks=None,
                   gt_poses=None, query_scores=None, query_score_th=None,
                   plane=(0, 1)):
    """Top-down map: trajectory, landmarks, optional ground truth and the
    latest BoW query-score bars with the 'lost camera?' threshold line
    (≙ show_kf_numbers, reference utils.cpp:101-151).

    ``plane`` selects the two translation components to plot. The default
    (0, 1) = world x-y is the ground plane of ROBOT-frame trajectories
    (the sensor extrinsic's axis swap puts forward in world x, lateral in
    world y, height in world z — estimator.finalize outputs these); pass
    (0, 2) for raw camera-frame poses (x-z)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False

    a0, a1 = plane
    fig, axes = plt.subplots(
        1, 2 if query_scores is not None else 1,
        figsize=(11, 6) if query_scores is not None else (7, 6),
    )
    ax = axes[0] if query_scores is not None else axes
    if landmarks is not None and len(landmarks):
        lm = np.asarray(landmarks)
        ax.scatter(lm[:, a0], lm[:, a1], s=1, c="0.75", label="landmarks")
    ax.plot(poses[:, 3 + a0], poses[:, 3 + a1], "r.-", lw=1.2, ms=4,
            label="keyframes")
    if gt_poses is not None:
        ax.plot(gt_poses[:, 3 + a0], gt_poses[:, 3 + a1], "g--", lw=1,
                label="ground truth")
    ax.set_xlabel("xyz"[a0] + " [m]")
    ax.set_ylabel("xyz"[a1] + " [m]")
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title("srba_slam_tpu_torch map (top-down)")
    if query_scores is not None:
        axes[1].bar(range(len(query_scores)), query_scores, color="#4477aa")
        if query_score_th is not None:
            axes[1].axhline(query_score_th, color="#cc3311", lw=1.2,
                            label=f"query_score_th={query_score_th}")
            axes[1].legend(loc="best", fontsize=8)
        axes[1].set_title("BoW query scores (last keyframe check)")
        axes[1].set_xlabel("keyframe id")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True
