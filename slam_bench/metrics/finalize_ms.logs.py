"""Mean host-clock ms of finalize() (pose graph and output files) per log
that ends inside the window, synchronized before and after."""

NAME = "finalize_ms.logs"
UNIT = "ms"
BETTER = "lower"
LAYER = "epilogue (ops/posegraph.py, finalize)"
SOURCE = "host_clock"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    xs = t["finalize_ms"]
    return sum(xs) / len(xs) if xs else None
