"""Host ms of the window groups' dispatch per keyframe inserted in the
traced window: the program's own ``window dispatch`` spans
(``SRBAEngine._dispatch_queued``: the gather tables built, the upload
packed and pinned, each group's program launched), summed."""

NAME = "window_dispatch_host_ms_per_kf.online"
UNIT = "ms"
BETTER = "lower"
LAYER = "insertion (models/srba.py, ops/window_ba.py)"
SOURCE = "host_clock"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    spans = getattr(t["tracer"].eager, "host", None) or ()
    s = [x.t1 - x.t0 for x in spans if x.name == "window dispatch" and x.t1 is not None]
    return sum(s) * 1e3 / t["kfs"] if s and t["kfs"] else None
