"""K1's share of its roofline at the cell's scan shape (a batch's left and
right frames), timed on the card alone after the window (roofline.py)."""

NAME = "fast_nms_roofline.logs"
UNIT = "%"
BETTER = "higher"
LAYER = "kernels (csrc/fast_nms.cu K1, csrc/orb_describe.cu K2, via ops/hopper_fast.py)"
SOURCE = "device_trace"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    k = t.get("kernels")
    return k["k1"] if k else None
