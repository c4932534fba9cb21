"""Host seconds of program warm-ups and captures inside the window, summed
over kinds (cuda_graphs.KIND_STATS): the per-session check and row programs."""

NAME = "capture_s_in_window.logs"
UNIT = "s"
BETTER = "lower"
LAYER = "programs (ops/cuda_graphs.py)"
SOURCE = "program_counter"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return t["capture_s"]
