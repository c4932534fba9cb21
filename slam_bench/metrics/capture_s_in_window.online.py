"""Host seconds of program warm-ups and captures inside the window, summed
over kinds (cuda_graphs.KIND_STATS): the per-session check and row programs."""

NAME = "capture_s_in_window.online"
UNIT = "s"
BETTER = "lower"
LAYER = "programs (ops/cuda_graphs.py)"
SOURCE = "program_counter"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    return t["capture_s"]
