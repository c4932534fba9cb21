"""Device ms of the VO programs' replays (the batched scan graph) over the
traced window's frames: CUDA events around each replay."""

NAME = "vo_device_ms_per_frame.logs"
UNIT = "ms/frame"
BETTER = "lower"
LAYER = "VO engine (models/vo.py)"
SOURCE = "device_trace"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return sum(t["vo_ms"]) / t["frames"] if t["vo_ms"] and t["frames"] else None
