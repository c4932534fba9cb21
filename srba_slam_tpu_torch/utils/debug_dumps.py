"""Debug artifact dumps (≙ the reference's ``debug=true`` instrumentation).

With debug enabled the reference writes per-keyframe inspection files:
raw inter-frame matches (``if_raw_match*``, src/CSRBAStereoSLAMEstimator.cpp:
1455-1473), post-filter matches with status (``if_match_after*``,
:1649-1721), DA distances (``da_dist*``, :566-616), SRBA input observations
(``da_info_*.txt``, :750-764), loop-closure correspondences
(``loop_closure_info_*.txt``, :676-727) and per-KF keypoints/matches
(CStereoSLAMKF::saveInfoToFiles, src/CStereoSLAMKF.cpp:60-110). Same file
shapes and names here as the JAX package writes
(``srba_slam_tpu/utils/debug_dumps.py``), driven by the ``debug`` flag in
APP_OPTIONS. Tensors are copied to the host as they are dumped; nothing here
runs unless the flag is set.
"""

from __future__ import annotations

import os

import numpy as np

from srba_slam_tpu_torch.utils import host_numpy


class DebugDumper:
    def __init__(self, out_dir: str, enabled: bool = True):
        self.out_dir = out_dir
        self.enabled = enabled
        if enabled:
            os.makedirs(out_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def dump_kf(self, kf_id: int, frame, ids: np.ndarray):
        """≙ CStereoSLAMKF::saveInfoToFiles: keypoints, descriptors, matches."""
        if not self.enabled:
            return
        m_valid = host_numpy(frame.m_valid)
        with open(self._path(f"kf_{kf_id:04d}_keypoints.txt"), "w") as f:
            ys_l, xs_l = host_numpy(frame.ys_l), host_numpy(frame.xs_l)
            ys_r, xs_r = host_numpy(frame.ys_r), host_numpy(frame.xs_r)
            for i in np.nonzero(host_numpy(frame.valid_l))[0]:
                f.write(f"L {i} {xs_l[i]} {ys_l[i]}\n")
            for i in np.nonzero(host_numpy(frame.valid_r))[0]:
                f.write(f"R {i} {xs_r[i]} {ys_r[i]}\n")
        with open(self._path(f"kf_{kf_id:04d}_matches.txt"), "w") as f:
            m_r = host_numpy(frame.m_r_idx)
            for i in np.nonzero(m_valid)[0]:
                f.write(f"{i} {m_r[i]} {ids[i]}\n")

    def dump_da(self, kf_id: int, similar: list, da):
        """≙ if_match_after* / da_dist*: per-candidate statuses + distances."""
        if not self.enabled:
            return
        self.dump_da_host(kf_id, similar, host_numpy(da.status),
                          host_numpy(da.other_idx), host_numpy(da.tracked_count))

    def dump_da_host(self, kf_id: int, similar: list, status, oidx, tracked):
        if not self.enabled:
            return
        with open(self._path(f"da_info_{kf_id:04d}.txt"), "w") as f:
            for s, other_kf in enumerate(similar):
                f.write(f"# candidate {other_kf} tracked {tracked[s]}\n")
                # every feature that found a raw match (status != sNON_TRACKED=1)
                for i in np.nonzero(status[s] != 1)[0]:
                    f.write(f"{other_kf} {i} {oidx[s, i]} {status[s, i]}\n")

    def dump_if_raw_match(self, this_id: int, other_id: int,
                          this_x, this_y, oth_x, oth_y,
                          raw_oidx, distance, m_valid, big: float = 1e8):
        """≙ ``if_raw_match_kf%04d_with_kf%04d.txt`` (reference
        .cpp:1455-1473): one row per raw brute-force Hamming match, BEFORE
        the filter cascade — other-KF left px, this-KF left px, distance."""
        if not self.enabled:
            return
        name = f"if_raw_match_kf{this_id:04d}_with_kf{other_id:04d}.txt"
        with open(self._path(name), "w") as f:
            f.write("% OTHER_LX OTHER_LY THIS_LX THIS_LY DISTANCE\n")
            for i in np.nonzero(m_valid & (distance < big))[0]:
                o = int(raw_oidx[i])
                f.write(f"{oth_x[o]:.2f} {oth_y[o]:.2f} "
                        f"{this_x[i]:.2f} {this_y[i]:.2f} "
                        f"{distance[i]:.2f}\n")

    def dump_if_match_after(self, this_id: int, other_id: int, status,
                            this_x, this_y, oth_x, oth_y,
                            raw_oidx, distance, m_valid, big: float = 1e8):
        """≙ ``if_match_after_kf%04d_with_kf%04d.txt`` (reference
        .cpp:1649-1721): per raw match, the post-cascade STATUS (reference
        enum values — sTRACKED=0 .. sREJ_CONSISTENCY=6) plus this/other
        left px and the match distance."""
        if not self.enabled:
            return
        name = f"if_match_after_kf{this_id:04d}_with_kf{other_id:04d}.txt"
        with open(self._path(name), "w") as f:
            f.write("%STATUS THIS_LU THIS_LV OTHER_LU OTHER_LV DISTANCE\n")
            for i in np.nonzero(m_valid & (distance < big))[0]:
                o = int(raw_oidx[i])
                f.write(f"{int(status[i])} {this_x[i]:.2f} {this_y[i]:.2f} "
                        f"{oth_x[o]:.2f} {oth_y[o]:.2f} "
                        f"{distance[i]:.2f}\n")

    def dump_da_dist(self, kf_id: int, dists: np.ndarray):
        """≙ ``da_dist_kf%04d.txt`` (reference .cpp:566-616): during
        feature-ID propagation, one row per stereo match of the new KF —
        the winning tracked match's distance, or 0.00 for a new feature
        (the reference writes tracked rows with ``%2.f`` and new rows as
        literal ``0.00``; both are written here as %.2f)."""
        if not self.enabled:
            return
        with open(self._path(f"da_dist_kf{kf_id:04d}.txt"), "w") as f:
            for v in dists:
                f.write(f"{v:.2f}\n")

    def dump_posechange_outliers(self, kf_id: int, idxs, residuals):
        """≙ ``posechange_outliers_kf%04d.txt`` (reference .cpp:2236-2251):
        per change-in-pose outlier (residual > residual_th), the this-KF
        match index and its residual. The reference writes the file once
        per similar-KF cascade call (last candidate's file survives);
        callers here pass the same last-candidate rows."""
        if not self.enabled:
            return
        with open(self._path(f"posechange_outliers_kf{kf_id:04d}.txt"),
                  "w") as f:
            for i, r in zip(idxs, residuals):
                f.write(f"{int(i)} {r:.2f}\n")

    def dump_loop_closure(self, kf_id: int, lc_with: int, tracked: int):
        """≙ loop_closure_info_*.txt."""
        if not self.enabled:
            return
        with open(self._path(f"loop_closure_info_{kf_id:04d}.txt"), "w") as f:
            f.write(f"{kf_id} {lc_with} {tracked}\n")


def export_scene_ply(path: str, poses: np.ndarray, landmarks=None):
    """Final map/trajectory export (≙ final_global_path.3DScene,
    reference .cpp:960-974) as a standard PLY point cloud: trajectory
    vertices in red, landmarks (if given) in gray."""
    pts = [(*p[3:6], 255, 40, 40) for p in poses]
    if landmarks is not None and len(landmarks):
        pts += [(*lm, 160, 160, 160) for lm in landmarks]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for x, y, z, r, g, b in pts:
            f.write(f"{x:.4f} {y:.4f} {z:.4f} {r} {g} {b}\n")
