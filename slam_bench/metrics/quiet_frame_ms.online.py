"""Median host-clock ms of a step() whose frame has no keyframe check and
no insertion: the VO pass and the walk that every frame pays."""

NAME = "quiet_frame_ms.online"
UNIT = "ms"
BETTER = "lower"
LAYER = "VO engine (models/vo.py)"
SOURCE = "host_clock"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    xs = sorted(t["quiet_ms"])
    return xs[(len(xs) - 1) // 2] if xs else None
