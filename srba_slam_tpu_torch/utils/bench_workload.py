"""The bench workload: ``bench.py``'s estimator over its synthetic sequence.

One definition of the configuration the JAX package's ``bench.py``
(``_build_workload``/``_build_estimator``) runs, shared by the port's
``chip_smoke.py`` and the parity tests: KITTI geometry (1226x370), a
500-feature budget at capacity 512, the street scene (seed 11, 0.8 m per
frame) over ``WARMUP_FRAMES + TIMED_FRAMES`` = 81 frames, no vocabulary
file (so the fallback ``voc_train_frames`` training runs).

``FINGERPRINT`` is the JAX package's per-frame run of this workload
(``step()`` with ``solve_sync = True``): the per-frame keyframe decisions,
the keyframe poses and the ATE. The card has no jax, so a run of the port
there is held against this file; ``tests/test_torch_bench_fingerprint.py``
regenerates it with the JAX package and fails if it went stale.
"""

from __future__ import annotations

import json
import os

OPTIONS = dict(
    orb_adaptive_fast_th=True,
    n_feats=500, detect_fast_th=20,
    adaptive_th_min_matches=100,
    max_translation=2.0, max_rotation=25.0,
    updated_matches_th=60, vo_id_tracking_th=40,
    srba_submap_size=10, srba_max_tree_depth=4,
    srba_max_optimize_depth=5,
    srba_kernel_param=1.5,
    da_filter_by_direction=True,
    residual_th=30.0,
)
VO_OPTIONS = dict(fast_th=20, n_feats=500)
CAPACITY = 512
MAX_KFS = 128
SOURCE = dict(n_frames=81, seed=11, step=0.8, scene="street")

FINGERPRINT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "data", "jax_bench_steplog.json")

# The JAX package's default schedule on the same workload, as its bench.py
# runs it: WARMUP_FRAMES frames in a first call, then the rest in a second;
# name -> (batch, solve_flush_before_insert, chunk). With chunk 0 the second
# call is the batched loop at ``batch``; otherwise it is the device-resident
# loop over chunks of ``chunk`` frames already on the device, each one scan
# chained from the one before (bench.py's at DEV_CHUNK, and its bounded-lag
# point at 8). PIPELINE_FINGERPRINT holds the JAX package's run of each
# (decisions, keyframe poses, ATE).
WARMUP_FRAMES = 21
DEV_CHUNK = 60
SCHEDULES = {"pipelined b20": (20, False, 0), "pipelined b8": (8, False, 0),
             "flush-before-insert b8": (8, True, 0), "device-resident": (20, False, DEV_CHUNK),
             "device-resident b8": (20, False, 8)}
PIPELINE_FINGERPRINT = os.path.join(os.path.dirname(FINGERPRINT), "jax_bench_pipeline.json")

DECISION_FIELDS = ("kf_check", "inserted_kf", "loop_closure_with", "lc_rejected_with")


def decisions(step_log) -> list[list]:
    """Per frame ``[frame_idx, kf_check, inserted_kf, loop_closure_with,
    lc_rejected_with]`` of an estimator's ``step_log`` (JAX or port)."""
    out = []
    for r in step_log:
        row = [int(r.frame_idx)]
        for name in DECISION_FIELDS:
            v = getattr(r, name)
            row.append(v if v is None or isinstance(v, bool) else int(v))
        out.append(row)
    return out


def load_fingerprint(path: str = FINGERPRINT) -> dict:
    with open(path) as f:
        return json.load(f)
