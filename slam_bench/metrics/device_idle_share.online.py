"""The share of the traced window in which no span of device work was open:
the union of the program replays' and eager groups' CUDA-event spans."""

NAME = "device_idle_share.online"
UNIT = "%"
BETTER = "lower"
LAYER = "device (H100)"
SOURCE = "device_trace"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] else None
