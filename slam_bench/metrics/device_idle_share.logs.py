"""The share of the traced window in which no span of device work was open:
the union of the program replays' and eager groups' CUDA-event spans."""

NAME = "device_idle_share.logs"
UNIT = "%"
BETTER = "lower"
LAYER = "device (H100)"
SOURCE = "device_trace"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] else None
