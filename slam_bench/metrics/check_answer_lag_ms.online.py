"""Mean ms from a keyframe check's end on the card to its answer on the
host: for each ``check`` span of the program's trace, from the end event
of the check program's replay under it (on the trace's anchor axis) to
the return of the last ``read`` under it (the read that also brings back
the window solves launched after the check)."""

NAME = "check_answer_lag_ms.online"
UNIT = "ms"
BETTER = "lower"
LAYER = "keyframe check (models/data_association.py, models/bow.py)"
SOURCE = "device_trace"
MOVES = "frame_pose_p95_ms"
WORKLOADS = ["kitti00-online-b1"]


def read(t: dict):
    tr = t["tracer"].eager
    spans = getattr(tr, "host", None)
    if not spans or getattr(tr, "anchor", None) is None:
        return None
    # the check span each span lies under (a parent's id is below its child's)
    under = []
    for x in spans:
        under.append(x.id if x.name == "check" else
                     (under[x.parent] if x.parent is not None else None))
    ends, answers = {}, {}
    for r in tr.replays:
        c = under[r.parent] if r.parent is not None else None
        if r.kind == "check" and c is not None and r.end is not None:
            ends[c] = r.end
    for x in spans:
        c = under[x.id]
        if x.name == "read" and c is not None and x.t1 is not None:
            answers[c] = max(answers.get(c, x.t1), x.t1)
    lags = [tr.host_ms(answers[c]) - tr.device_ms(e) for c, e in ends.items() if c in answers]
    return sum(lags) / len(lags) if lags else None
