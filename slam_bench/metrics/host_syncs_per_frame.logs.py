"""Host synchronizations per frame over the traced window: torch's
set_sync_debug_mode("warn") warns once per synchronizing call."""

NAME = "host_syncs_per_frame.logs"
UNIT = "syncs/frame"
BETTER = "lower"
LAYER = "estimator host walk and pipeline (models/estimator.py)"
SOURCE = "program_counter"
MOVES = "fps"
WORKLOADS = ["kitti00-logs-b8"]


def read(t: dict):
    return t["syncs"] / t["frames"] if t["frames"] else None
