"""Median host us of a program call that replayed, from its entry to its
return (``ops/cuda_graphs.py`` ``program``: the key looked up, the inputs
copied in, the graph launched, the outputs cloned), over the program's
trace of the window."""

NAME = "program_launch_host_us.online"
UNIT = "us"
BETTER = "lower"
LAYER = "programs (ops/cuda_graphs.py)"
SOURCE = "host_clock"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    xs = sorted((r.t1 - r.t0) * 1e6 for r in getattr(t["tracer"].eager, "replays", None) or ())
    return xs[(len(xs) - 1) // 2] if xs else None
