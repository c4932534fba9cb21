"""torch.cuda.max_memory_allocated over the window, reset at its start."""

NAME = "peak_mem_gb.online"
UNIT = "GB"
BETTER = "lower"
LAYER = "device (H100)"
SOURCE = "program_counter"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    return t["peak_window_bytes"] / 1e9 if t["peak_window_bytes"] else None
