"""Mean device ms of a keyframe check program's replay (the one-check
program), CUDA events around each replay."""

NAME = "check_device_ms.online"
UNIT = "ms"
BETTER = "lower"
LAYER = "keyframe check (models/data_association.py, models/bow.py)"
SOURCE = "device_trace"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    return sum(t["check_ms"]) / len(t["check_ms"]) if t["check_ms"] else None
