"""Mean device ms of a keyframe check program's replay (a fused group's
slot program), CUDA events around each replay."""

NAME = "check_device_ms.logs"
UNIT = "ms"
BETTER = "lower"
LAYER = "keyframe check (models/data_association.py, models/bow.py)"
SOURCE = "device_trace"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return sum(t["check_ms"]) / len(t["check_ms"]) if t["check_ms"] else None
