"""Device ms of the window-solve group programs' replays per keyframe
inserted in the traced window."""

NAME = "window_device_ms_per_kf.logs"
UNIT = "ms"
BETTER = "lower"
LAYER = "insertion (models/srba.py, ops/window_ba.py)"
SOURCE = "device_trace"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return sum(t["window_ms"]) / t["kfs"] if t["window_ms"] and t["kfs"] else None
