"""The host's launches in one per-frame VO pass, and in one row write and
one loop-closure re-check, on their programs against the same calls made
eagerly, under torch.profiler.

The bench workload's VO engine steps over its street frames with its
programs on (``models/vo.py`` ``FRAME_PROGRAMS``), so that the frame and
the track programs are captured; then one pass (``process_stereo_pair``:
the frame's upload, the frontend, the track, the one copy out) is traced
eagerly (the flag off) and one on the programs, each call traced alone
(``utils/kernel_timing.py`` ``profile_calls``, after an untraced call):
the kernel launches, graph launches and copies the host issues. The same
for a keyframe store's and a BoW database's row write
(``models/keyframe.py``, ``models/bow.py`` ``ROW_PROGRAMS``) and for the
re-check of the last frame's row against the first's
(``models/data_association.py`` ``RECHECK_PROGRAM``). A pass on its
programs should launch no kernel and two graphs, a row write or a
re-check no kernel and one graph. Traces of captured programs can upset
later profiler sessions in the process (ROADMAP Queue 3), so the eager
calls are traced first and this runs in a process of its own. Run from the
root of the repository on a card:

    python -m srba_slam_tpu_torch.tools.frame_launches

(~30 s). Prints one JSON object.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from srba_slam_tpu_torch.models import bow, data_association, keyframe, vo
from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.utils import kernel_timing as kt

KINDS = ("frame", "track", "kf_row", "bow_row", "recheck")
# each program's flag: (module, name)
FLAGS = {"pass": ((vo, "FRAME_PROGRAMS"),), "kf_row": ((keyframe, "ROW_PROGRAMS"),),
         "bow_row": ((bow, "ROW_PROGRAMS"),),
         "recheck": ((data_association, "RECHECK_PROGRAM"),)}


def _counts(fn) -> list[int]:
    """Kernel launches, graph launches and copies of one call of ``fn``."""
    evs = kt.profile_calls(fn)
    return [kt.launch_count(evs), sum(e.count for e in evs if "GraphLaunch" in e.key),
            sum(e.count for e in evs if e.key == "cudaMemcpyAsync")]


def measure(est, frames) -> dict:
    """Step ``est``'s VO engine over ``frames`` (at least 8 (left, right)
    pairs) with the programs on, then count one call of each of a pass, a
    store row write, a database row write and a re-check, eager against
    program. Returns {"pass eager": [kernels, graphs, copies], ...,
    "captures"}."""
    eng = est.vo
    for left, right in frames[:2]:
        eng.process_stereo_pair(left, right)
    rest = iter(frames[2:])
    feats = []

    def one_pass():
        eng.process_stereo_pair(*next(rest))
        feats.append(eng.last_frame())

    store = keyframe.KeyframeStore(max_kfs=8, capacity=eng.capacity, device=eng.device)
    one_pass()
    desc = feats[0].desc_l[feats[0].m_valid].cpu().numpy()
    db = bow.BoWDatabase(bow.Vocabulary.train(desc, k=8, L=2, seed=0), max_kfs=8,
                         device=eng.device)
    store.write_row(feats[0], 0)
    store.write_row(feats[0], 1)
    db.write_row(feats[0].desc_l, feats[0].m_valid, 0)
    data_association.recheck_candidate(store.arrays, 1, 0, eng.cam, np.zeros(6, np.float32), 0)
    calls = {
        "pass": one_pass,
        "kf_row": lambda: store.write_row(feats[-1], 1),
        "bow_row": lambda: db.write_row(feats[-1].desc_l, feats[-1].m_valid, 1),
        "recheck": lambda: data_association.recheck_candidate(
            store.arrays, 1, 0, eng.cam, np.zeros(6, np.float32), 3, init_gate_budget_m=0.5),
    }
    out = {}
    try:
        for route in ("eager", "program"):
            for name, fn in calls.items():
                for module, flag in FLAGS[name]:
                    setattr(module, flag, route == "program")
                out[f"{name} {route}"] = _counts(fn)
    finally:
        for flags in FLAGS.values():
            for module, flag in flags:
                setattr(module, flag, True)
    out["captures"] = {k: cuda_graphs.capture_stats(k)["captures"] for k in KINDS}
    return out


def main(argv=None) -> int:
    from srba_slam_tpu_torch.models.estimator import bench_estimator
    from srba_slam_tpu_torch.utils import bench_workload as bw
    from srba_slam_tpu_torch.utils.camera import StereoCamera
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource

    frames = list(SyntheticSource(StereoCamera.kitti(), **{**bw.SOURCE, "n_frames": 9}))
    torch.cuda.init()
    print(json.dumps(measure(bench_estimator("cuda"), frames)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
