"""Host ms blocked in reads of the card per frame over the traced window:
the program's own ``read`` spans (each host read on the step path, from
the call to the copy's return), summed."""

NAME = "read_wait_ms_per_frame.online"
UNIT = "ms"
BETTER = "lower"
LAYER = "estimator host walk and pipeline (models/estimator.py)"
SOURCE = "host_clock"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    spans = getattr(t["tracer"].eager, "host", None) or ()
    s = [x.t1 - x.t0 for x in spans if x.name == "read" and x.t1 is not None]
    return sum(s) * 1e3 / t["frames"] if s and t["frames"] else None
