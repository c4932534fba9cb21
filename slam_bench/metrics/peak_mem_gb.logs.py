"""torch.cuda.max_memory_allocated over the window, reset at its start."""

NAME = "peak_mem_gb.logs"
UNIT = "GB"
BETTER = "lower"
LAYER = "device (H100)"
SOURCE = "program_counter"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return t["peak_window_bytes"] / 1e9 if t["peak_window_bytes"] else None
