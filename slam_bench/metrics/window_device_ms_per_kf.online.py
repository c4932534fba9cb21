"""Device ms of the window-solve group programs' replays per keyframe
inserted in the traced window."""

NAME = "window_device_ms_per_kf.online"
UNIT = "ms"
BETTER = "lower"
LAYER = "insertion (models/srba.py, ops/window_ba.py)"
SOURCE = "device_trace"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    return sum(t["window_ms"]) / t["kfs"] if t["window_ms"] and t["kfs"] else None
