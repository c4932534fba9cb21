#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, and check it.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py            # add --profile for the estimator's kernel time

Phases, each printing one line; any failure raises and the exit code is
not 0 (there is no CPU fallback):

1. device    - the card (``nvidia-smi`` name and power limit), CUDA, nvcc;
2. build     - compiles the kernels of ``srba_slam_tpu_torch/csrc`` from the
               checkout, one nvcc per source, all started together
               (``ops/cuda_build.py``), and times the build;
3. K1        - ``fast_nms`` kernel against its plain torch version on the
               card, bit-exact (``torch.equal``), on a rendered KITTI-size
               street stereo pair (uint8), a quantized plateau image (f32,
               threshold 20) and an unaligned 3x123x300 random batch; then at
               every NMS radius it is built for (0-5, margin 3 + r) with one
               threshold for the pair and one per image;
4. K2        - ``orb_descriptors`` kernel (the blur fused in) against its
               plain version ``upright_descriptors(gauss_blur7(frames))``,
               bit-exact, at the K=512 keypoints K1 gives on the street pair;
5. slice     - ``StereoVOEngine`` on the card over the first 30 frames of
               the bench workload (KITTI geometry, street scene, seed 11,
               capacity 512). K1 and K2 launch exactly once per frame. The
               first 5 frames also run on the port's CPU path and must agree:
               identical validity, counts and integer features, pose
               increments within 1e-4 rad / 1e-3 m. Then
               ``extract_and_match`` of the street pair, 5 calls under
               torch.profiler: the frontend's kernel launches and device µs
               per call (a trace that misses K1 or K2 is taken again, at
               most 3 times, then reported as not traced; the wrappers'
               counts must show both launched);
6. K3        - ``fast_score_map`` kernel against its plain version,
               bit-exact, on the street left image (uint8), the plateau pair
               (f32, threshold 20) and an odd-size 123x300 image, and on the
               street and plateau pairs at per-image thresholds; then timed
               on the street left image and on the street pair, each beside
               the launch floor (an empty kernel at K3's grid and block), and
               on the pair beside K1's device time from phase 3. The
               estimator's default margin of 16 never reaches K3, and no
               config key or CLI flag sets the margin: ``margin`` is an
               argument of the library's ``extract_and_match`` only, and
               the margin-3 frontend of phase 8 is what launches K3;
7. estimator - ``SRBAStereoSLAMEstimator`` on the card over the 81-frame
               bench workload, under ``torch.use_deterministic_algorithms``,
               with the strict solve schedule (``solve_sync``, as the
               fingerprint was made), then ``finalize``. K1 and K2 launch once per VO pass (the
               adaptive retry re-runs frames); the per-frame keyframe
               decisions equal the JAX package's per-frame run, committed as
               ``srba_slam_tpu_torch/data/jax_bench_steplog.json``; the frames
               up to the second insertion after KF0 also run on the port's
               CPU path with the same decisions and keyframe poses within
               1e-4 rad / 1e-3 m; the aligned ATE of the final keyframe poses
               is under 0.5 m (the JAX package's gate,
               tests/test_kitti_geometry_ate.py); the four output files exist;
               ``gauss_blur7`` never runs on a CUDA tensor (K2 blurs inside);
               the host syncs torch reports (``set_sync_debug_mode("warn")``)
               per frame and per keyframe check; each check one replay of
               the one-check program (``CHECK_GRAPHS``): section ``queryDB``
               ms per check, with and without its capture; the inputs of
               every check are kept for phase 12;
8. options   - the frontend's options at KITTI geometry: (a) K1, K2 and K3
               (margins 3, 2 and 0: under 3 the circle wraps at the borders)
               ``torch.equal`` to their plain versions on the f32
               octave-1 and octave-2 images of the street pair (in quarters
               and sixteenths) and on a rendered 752x480 pair remapped with
               the EuRoC demo's distortion rows, K2 at the per-octave K of
               two and three levels and at keypoints 3-15 px from a border,
               each timed device-only beside its bytes bound; (b)
               ``extract_and_match`` with ``n_levels=2``, with ``rect_maps``,
               with ``margin=3``, ``margin=2`` and with ``oriented=True``: the card's
               FrameFeatures equal the CPU path's on every integer field,
               ``pts3d`` within 1e-4 (oriented: keypoints equal; descriptor
               rows that differ, from the last bit of an angle, are counted
               and held under 2%); then the margin-3 frontend over the 30
               slice frames, the path that launches K3; (c) the VO engine
               over the 30 frames at ``n_octaves=2``: K1 and K2 twice a
               frame, all frames valid, the translation error inside phase
               5's gate, per-frame median ms beside phase 5's;
9. cli       - ``python -m srba_slam_tpu_torch``'s ``main`` in this process on
               the card with ``demo/config_euroc_example.ini`` (752x480,
               unrectified: the remap in front of K1 and K2) over
               ``--synthetic 60`` at the default ``--batch`` (8 on the card):
               exit code 0, the seven output files, one pose row per
               keyframe, K1 and K2 once per scan and for the bootstrap frame;
               ``--batch 1`` writes the same ``kf_frames.txt``;
               ``--synthetic 20 --fleet 2`` exits 0 and writes ``seq0/`` and
               ``seq1/``. Then ``--synthetic 30 --checkpoint``, and the
               checkpoint resumed into a fresh estimator on the card and one
               on the CPU: both step frames 30-59 to equal keyframe
               decisions. With PIL present, 10 rendered pairs go to PNG files
               and the CLI reads them through whichever loader builds;
10. batched  - the bench estimator through ``perform_stereo_slam_batched``
               at batch 8 over the 81 frames, under
               ``torch.use_deterministic_algorithms``, with the strict solve
               schedule (its keyframe checks deferred): decisions equal the
               committed JAX fingerprint (the JAX package's batch-8 run makes
               its per-frame run's decisions), ATE under 0.5 m, K1 and K2 once
               per scan dispatch (retry tails included: each scan is one
               replay of its batch length's CUDA graph), once for each
               graph's capture (its eager warm-up) and for the bootstrap
               frame; total s and fps beside phase 7's; host syncs per frame
               and per check; K1 and K2 device-only
               at one scan's ``[16,370,1226]`` uint8 beside the bytes bound
               and the launch floor; the scan graphs captured (host s, pool
               MB, K1/K2 launches a replay); one scan of 8 and one of a
               retry tail's length as the graph against the eager scan
               (``vo.SCAN_GRAPHS`` off): every output equal bit for bit,
               host ms to dispatch and to finish (launches a frame:
               after phase 15);
11. fleet    - ``FleetSLAM`` over four bench-workload street sequences
               (seeds 11, 48, 85, 122; 30 frames each; one vocabulary) on the
               card, four runs in turns: its lockstep attempts and check
               groups as CUDA-graph programs, eagerly (``parallel/batch.py``
               ``FLEET_GRAPHS`` off) twice, as programs again: every run
               bit-equal to the first (decisions, step results, keyframe
               store and BoW rows, keyframe poses); the first against each
               sequence's solo ``step()`` run on the card: decisions equal,
               keyframe poses within 1e-4 rad / 1e-3 m; K1 and K2 once per
               lockstep attempt (and per bootstrap frame and attempt
               program's warm-up); the aggregate frames/s of each run
               (the programs' also without their captures) beside the solo
               runs'; host syncs per step and per check group; an attempt
               of four and the largest check group as programs against
               eager calls: bits, dispatch / done ms in turns; the programs
               captured (count, s, pool MB, MB held); the launches of an
               attempt, a check group and a batched step, eager against
               programs, in a process of its own
               (``tools/fleet_launches.py``: a program call must launch no
               kernel and one graph a shard); K1 device-only at
               ``[8,370,1226]`` with four thresholds, and K2 there;
12. check    - one keyframe check of phase 7's run whose five candidates are
               all valid (its first loop-closure check where one has five):
               the five candidates as one batch (``query_and_associate``)
               against the schedule before, five one-lane cascades in turn
               (the same code, one key each), under deterministic algorithms:
               equal outputs, host ms median and max over 10 calls, kernel
               launches (torch.profiler) and host syncs of each; each stage
               of the batch alone (BoW query, RANSAC, Horn seed, GN solve);
               ``solve_pose`` at L = 5 against five L = 1 calls, and at exit-
               test periods 1, 2, 4, 8 and 12, beside a VO solve (L = 1);
               then the check as CUDA-graph programs against
               ``CHECK_GRAPHS`` off: the one-check program and a fused
               group of three slot programs, every output bit for bit,
               host ms to dispatch and until done in turns, capture s,
               pool MB, the bytes a replay copies and holds, and the
               launches a check (kernels, graphs, copies) under
               torch.profiler in a process of its own (a program call: 0
               kernels, 1 graph); the launch counts above from sessions
               with CUDA activity only;
13. insertion - where an insertion's and the epilogue's time goes: the
               bench estimator of phase 7 again over the 81 frames (strict
               schedule, each window a group of one, on the group's eager
               route, ``WBA_GROUP_PROGRAMS`` off; its decisions equal the
               fingerprint), each part of an insertion
               timed alone, synchronized around it (``define_new_keyframe``'s
               host work, the group's one upload, ``assembly_plan`` (the
               tables on the host), ``optimize_window``, the group's read,
               ``_commit_one``, ``spanning_tree(0)``, ``on_commit``,
               ``bow.insert``, ``store.append``); every window solved again,
               whole and with ``max_iters=0`` (stage 1), at its bucket's
               shapes; the LM blocks as CUDA graphs against eager blocks in
               turns, equal bit for bit, and by exit period; launches and
               syncs of the largest window's solve. Then the windows in the
               engine's groups (by bucket, at most 4) through the group
               programs (``window_ba.solve_window_group``): each equal bit for
               bit to its eager route and each slot to its one-window solve;
               the bench estimator again with the programs (decisions equal
               the fingerprint, ``define_kf_ms`` median and mean, programs
               captured in the run); the programs' capture s and pool MB.
               The pose graph of phase 7's ``finalize``, one program
               (``PG_PROGRAM``): its first call split into warm-up, capture
               and the rest, later calls on the same inputs, the program
               equal bit for bit to its parts launched from the host
               (``PG_PROGRAM`` off) and to eager iterations, in turns against
               the former and against the dense-``jacfwd`` loop it replaced
               (poses within 1e-3); one iteration split in its parts; the
               host syncs of one call; the launches of a group call and of a
               pose-graph call, eager against program, under torch.profiler
               in a process of its own (a program call: 0 kernels, 1 graph);
14. mesh     - the sharded paths over a mesh of 4 devices: 4 distinct cards
               where the machine has them, else ``cuda:0`` 4 times (a
               repeated card runs its shards one after the other: no time
               of it is a scaling number). (a) ``batched_vo_step`` on 4
               street pairs, one a shard, twice: features bit-equal to the
               one-card step, each shard's step one program replay
               bit-equal to the eager step, one K1 and one K2 launch a
               shard a step (and a warm-up); (b) phase 11's four sequences
               on the mesh, each estimator on its shard's device, with the
               programs and eagerly: bit-equal, each sequence's decisions
               equal its solo run and phase 11's fleet, keyframe poses
               within 1e-4 rad / 1e-3 m, K1 and K2 once per shard per
               attempt, aggregate frames/s beside phase 11's, host syncs,
               the programs captured; (c) the loop-closure-bucket window (C=32,
               L=8192, O=16384) sharded over the mesh against the unsharded
               solve, max |dpose| under 1e-3, both times; phase 13's
               windows through ``SRBAEngine(mesh=)`` against the engine
               without a mesh, window poses within 1e-3; each sharded solve
               on its programs (rounds of a program a shard and one on the
               lead, ``window_ba.WBA_SHARD_PROGRAMS``) equal bit for bit to
               its eager LM blocks, dispatch / done ms in turns, a call
               under ``set_sync_debug_mode("error")``, each engine bucket's
               programs captured once, the launches of a call (0 kernels;
               one graph a shard and one on the lead a round) under
               torch.profiler in a process of its own; (d)
               ``parallel/multichip.py`` ``dryrun_multichip`` on the same
               devices (its two sharded windows on the programs, equal to
               their eager blocks);
15. pipeline - the JAX package's default schedule on the bench workload:
               window solves pipelined in groups, keyframe checks deferred
               and fused per batch, one read of the host a batch. (a)
               ``perform_stereo_slam_batched`` at batch 20 (the JAX bench's)
               and at 8: 21 warm-up frames, then the 60 timed, each run
               on the harness's ``bench._warmed`` and ``bench._Timed``
               (``srba_slam_tpu_torch/bench.py``): decisions
               equal the fingerprint, ATE under 0.5 m, keyframe positions
               within 1e-3 m of the JAX package's run of the same schedule
               (``utils/bench_workload.py`` ``PIPELINE_FINGERPRINT``) and
               within 0.15 m of phase 10's strict run (the JAX package's
               scheduling gate); over the timed part: reads (``to_host``)
               and host syncs a batch, predictions, misses, demotions and
               replays, window groups and their sizes, fused check groups;
               total s and frames/s
               beside phase 10's; (b) ``solve_flush_before_insert`` at
               batch 8: the same checks, no farther from strict than
               pipelined; (c) the device-resident loops (the 60 frames on
               the card in one chunk of 60, one scan, and in chunks of 8):
               the same checks but the distance to strict, which is
               printed beside the JAX run's; (a)-(c) again with the eager
               scan, and again with the eager check (``CHECK_GRAPHS`` off,
               each run gated on the JAX run of its schedule): the same
               decisions and keyframe poses bit for bit, frames/s beside
               the graph's, and the scan graphs and check programs captured
               inside each timed part; a b20 scan as the graph against the
               eager scan (bits, dispatch ms);
               (d) phase 13's windows in groups by bucket through
               ``solve_window_group``: the program equal to the eager group
               and to eager LM blocks, each slot equal to its one-window
               solve, dispatch / done ms of the program and the eager group
               in turns, beside the one-window solves; (e) one fused check group
               of (a) again under ``set_sync_debug_mode("error")`` (no host
               sync; its slot programs captured first), equal bit for bit
               to the eager group, each slot equal to the one-check path on
               the same rows;
16. bench    - the port's bench harness, ``srba_slam_tpu_torch/bench.py``
               ``run(repeats=1, dev_repeats=1, bounded_repeats=2)`` on the
               frames rendered above (the protocol of the JAX package's
               bench.py, every timed repeat gated on the JAX run of its
               schedule), its line printed as ``[bench] {...}``: K1 and K2
               launched in its timed parts, the card line, a busy share
               (spans of CUDA events, no CUPTI) and a CPU anchor (measured
               in its subprocess, since a fresh checkout has no cached
               anchor), the scan graphs, the check programs and the window
               programs it captured (the checks' and the windows' expected
               none inside a timed part); a scan of 60 (the
               device-resident chunk) as the graph against the eager scan;
               then ``parallel/multichip.py``
               ``entry()`` once. ``entry``'s outputs and its example
               frontend equal the same call with ``device="cpu"`` (the
               features' integer fields, m_valid and num_inliers exact, the
               pose within 1e-4), and so does its step on street frames 0-1.

After phases 11, 14, 15 and 16, following ``gc.collect()`` and
``torch.cuda.empty_cache()``, a ``[memory]`` line: the live captured
programs by kind (an estimator's or a fleet's check programs are freed
with its tensors) and ``torch.cuda.memory_reserved``.

Between phases 15 and 16, the scan's launches a frame at B = 8, 20 and
60, eager against graph, under torch.profiler in a process of its own
(``phase_scan_launches``), as phase 12's check launches: this process
traces no captured program (a scan's or a check's) and no conditional
node with CPU activity (ROADMAP Queue 3: a trace of a program has been
followed by an illegal memory access). Then
one JSON line with, per kernel: its launches over the driven paths
(``launches_by_path``: the estimator run, the margin-3 frontend, the
two-octave engine, the CLI run, the batched run, the fleet run, the
mesh runs of phase 14 (a) and (b), the runs of phase 15 (a)-(c) and
phase 16's bench run and ``entry()`` call, each counted from 0;
``on_main_path`` says whether one of the paths a user of the entry points
can reach, all but the margin-3 frontend, launched it); its
largest error against the plain version; ``ms`` and ``plain_ms``, the time
of one call of the wrapper and of the plain version (CUDA events around the
call, so the wrapper's host work is included; median of 20); ``device_ms``,
the card's time alone (100 launches in one CUDA graph, replayed between
events; ``profiler_us`` is torch.profiler's duration of the same kernel as a
cross-check); ``bound_ms``, the least time for the call's bytes or f32
operations at the H100's published peaks (the operations that these inputs
need: for K1 and K3 a pixel that a cheap bound on its FAST score rules out
is charged the bound only), ``bound_by`` which of the two, and
``bound_share`` = bound_ms / device_ms; ``library_ms``, null: no single
PyTorch call computes these functions. The last line is
``{"ok": true, "device": {...}}``. float32 matrix products and convolutions
run without TF32 (both flags are set off below).
"""

from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from srba_slam_tpu_torch import (  # noqa: E402
    SRBAStereoSLAMEstimator, StereoCamera, StereoVOEngine, VOOptions, bench, load_config,
)
from srba_slam_tpu_torch.__main__ import main as cli_main  # noqa: E402
from srba_slam_tpu_torch.models import data_association as da_mod  # noqa: E402
from srba_slam_tpu_torch.models import estimator as estimator_mod  # noqa: E402
from srba_slam_tpu_torch.models import srba as srba_mod  # noqa: E402
from srba_slam_tpu_torch.models import vo as vo_mod  # noqa: E402
from srba_slam_tpu_torch.models.estimator import bench_estimator  # noqa: E402
from srba_slam_tpu_torch.models.vo import _avgpool2, _octave_budget, extract_and_match  # noqa: E402
from srba_slam_tpu_torch.ops import (  # noqa: E402
    cuda_build, cuda_graphs, hopper_fast, orb, posegraph, prng, robust_lm, window_ba,
)
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain  # noqa: E402
from srba_slam_tpu_torch.ops.hopper_fast import (  # noqa: E402
    fast_nms, fast_nms_plain, fast_score_map, orb_descriptors, orb_descriptors_plain,
)
from srba_slam_tpu_torch.ops.nms import grid_topk, local_max_suppress  # noqa: E402
from srba_slam_tpu_torch.ops.rectify import build_maps, remap_bilinear  # noqa: E402
from srba_slam_tpu_torch.parallel import batch as batch_mod  # noqa: E402
from srba_slam_tpu_torch.parallel import fleet as fleet_mod  # noqa: E402
from srba_slam_tpu_torch.parallel.batch import (  # noqa: E402
    batched_vo_step, empty_features, make_mesh,
)
from srba_slam_tpu_torch.parallel.multichip import dryrun_multichip, entry  # noqa: E402
from srba_slam_tpu_torch.tools import fleet_launches  # noqa: E402
from srba_slam_tpu_torch.utils import bench_workload as bw  # noqa: E402
from srba_slam_tpu_torch.utils import kernel_timing as kt  # noqa: E402
from srba_slam_tpu_torch.utils import se3_np  # noqa: E402
from srba_slam_tpu_torch.utils.checkpoint import load_state  # noqa: E402
from srba_slam_tpu_torch.utils.synthworld import make_ba_window_problem  # noqa: E402
from srba_slam_tpu_torch.utils.evaluation import ate_rmse  # noqa: E402
from srba_slam_tpu_torch.utils.framesource import SyntheticSource  # noqa: E402

DEV = "cuda"
CARD = ""            # nvidia-smi's name and power limit (phase 1)
N_SLICE_FRAMES = 30
N_CPU_FRAMES = 5
POSE_TOL_RAD = 1e-4
POSE_TOL_M = 1e-3
ATE_GATE_M = bench.ATE_GATE_M
TIMING_REPS = 20
FRONTEND_PROFILE_REPS = 5
FRONTEND_KERNELS = ("fast_nms_kernel", "orb_describe_kernel")
OUTPUT_FILES = ("out_kf_poses.txt", "time_new_kf.txt", "profiler.csv", "final_graph.dot")
CLI_FILES = (*OUTPUT_FILES, "kf_frames.txt", "final_global_path.ply", "map_viewer.html")
EUROC_INI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo",
                         "config_euroc_example.ini")
N_CLI_FRAMES = 60
N_RESUME_AT = 30
# the paths a user of the entry points can reach (phase_options' margin-3
# frontend is reached through the library's extract_and_match only)
USER_PATHS = ("estimator", "two_octave_engine", "cli", "batched", "fleet", "mesh", "pipeline",
              "bench")
BATCH = 8
FLEET_SEEDS = (11, 48, 85, 122)
N_FLEET_FRAMES = 30
N_FLEET_CLI_FRAMES = 20
N_FLEET_LAUNCH_FRAMES = 8
ORIENTED_ROWS_TOL = 0.02
CHECK_REPS = 10
EXIT_PERIODS = (1, 2, 4, 8, 12)
INSERTION_PARTS = ("define_new_keyframe", "upload", "assembly_plan", "optimize_window",
                   "copy_out", "_commit_one", "spanning_tree(0)", "on_commit", "bow.insert",
                   "store.append")
SPLIT_REPS = 2
MESH_SIZE = 4
LC_BUCKET = dict(C=32, L=8192, O=16384, n_cams=30, n_lms=5000, pose_noise=0.03, px_noise=0.3)
SHARDED_TOL = 1e-3
SHARD_REPS = 3          # phase 14 (c): calls a route a turn
# phase 15: the JAX package's bench loop (bench.py: 21 warm-up frames at
# batch 20, the device-resident loop in chunks of 60 and of 8) and its
# scheduling gate (tests/test_batch_mode.py: pipelined keyframe poses within
# 0.15 m of the strict schedule's)
PIPE_WARMUP = bw.WARMUP_FRAMES
PIPE_POSE_GATE_M = 0.15
# keyframe positions against the JAX package's run of the same schedule:
# the CPU's tolerance for pipelined runs (tests/test_torch_pipeline.py)
PIPE_JAX_GATE_M = bench.PIPE_JAX_GATE_M
PALLAS = "srba_slam_tpu/ops/pallas_fast.py"
# f32 operations per pixel that the FAST score needs on given inputs (see
# _fast_work): none within the margin, where the output is 0; 21 for an
# inner pixel whose compass-pair bound decides it (4 differences, 4 + 4
# pairwise min/max, 3 + 3 to reduce them, the negation and the max, the
# compare); 180 for one that needs the whole score (16 differences, 64 for
# the min/max of the 16 3-tap windows, 96 for the 16 arcs' min/max and their
# reductions, the threshold). K1 adds, for a pixel that keeps a score, the
# key (2) and its separable 5x5 max and compare (9)
COMPASS_OPS_PER_PX = 21
FAST_SCORE_OPS_PER_PX = 180
NMS_OPS_PER_PX = 11
# per distinct sampled point of K2: the separable blur's 7 + 7 products and
# 7 + 7 sums; per valid keypoint: 256 compares
ORB_BLUR_OPS_PER_POINT = 28


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median over ``reps`` calls of ``fn`` of its time on the card (CUDA
    events around each call), after 3 warm-up calls."""
    for _ in range(3):
        fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _times(kernel: str, call, plain, n_bytes: float, n_ops: float) -> dict:
    """A kernel's times at one input: per call of the wrapper and of the
    plain version (CUDA events, wrapper host work included), device-only
    (CUDA graph), torch.profiler's duration of the kernel, and its bound."""
    device_ms = kt.graph_ms(call)
    bound, bound_by = kt.bound_ms(n_bytes, n_ops)
    return {"ms": cuda_ms(call), "plain_ms": cuda_ms(plain), "device_ms": device_ms,
            "profiler_us": kt.profiler_kernel_us(call, kernel), "bound_ms": bound,
            "bound_by": bound_by, "bound_share": bound / device_ms, "library_ms": None,
            "bytes": n_bytes, "ops": n_ops}


def _us(x) -> str:
    return "not traced" if x is None else f"{x:.2f} us"


def _fmt(t: dict) -> str:
    return (f"device-only {t['device_ms'] * 1e3:.2f} us (CUDA graph of 100; torch.profiler "
            f"{_us(t['profiler_us'])}) | bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({t['bytes'] / 1e6:.3f} MB, {t['ops'] / 1e6:.1f} M f32 ops), share "
            f"{t['bound_share']:.3f} | per call with the wrapper {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms")


def p95(xs) -> float:
    srt = sorted(xs)
    return srt[min(len(srt) - 1, int(np.ceil(0.95 * len(srt))) - 1)]


class SyncCount:
    """Host synchronizations that torch makes on the card while the context
    is open: ``torch.cuda.set_sync_debug_mode("warn")`` warns once per
    synchronizing call (a device-to-host copy, ``.item()``, an SVD's info
    check), and ``n`` counts the warnings so far."""

    def __enter__(self):
        self.n = 0
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, *args, **kwargs):
            if "synchroniz" in str(message):
                self.n += 1
            else:
                shown(message, category, *args, **kwargs)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)


def _count_calls_syncs(obj, name: str, syncs: SyncCount) -> list:
    """Wrap ``obj.name`` so each call's host syncs are appended to the
    returned list."""
    counts, run = [], getattr(obj, name)

    def counted(*a, **k):
        n0 = syncs.n
        out = run(*a, **k)
        counts.append(syncs.n - n0)
        return out

    setattr(obj, name, counted)
    return counts


def _med(xs) -> str:
    return f"{statistics.median(xs):g}" if xs else "n/a"


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    global CARD
    CARD = smi
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[-1]
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} | torch.version.cuda {torch.version.cuda} | nvcc {nvcc} | "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32} | CPU threads {torch.get_num_threads()}")


def phase_build():
    t0 = time.perf_counter()
    cuda_build.load()
    dt = time.perf_counter() - t0
    with open(cuda_build.library_path() + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {dt:.3f} s -> {cuda_build.library_path()} | ptxas: {' ; '.join(ptxas)}")


def _street_and_plateau(frames):
    rng = np.random.default_rng(0)
    street = torch.from_numpy(np.stack(frames[0])).to(DEV)                # [2,370,1226] u8
    plateau = torch.from_numpy(
        rng.integers(0, 8, (2, 370, 1226)).astype(np.float32) * 30.0).to(DEV)
    return rng, street, plateau


def _fast_work(imgs, th: float, margin: int = 16) -> tuple[int, int, int]:
    """What the FAST score needs on ``imgs`` [H, W] or [N, H, W]: (inner
    pixels whose compass-pair bound is at or under ``th``, so that no score
    is needed; inner pixels whose bound passes; pixels that keep a score).
    The bound is the score's formula over the four pairs of neighbouring
    compass taps (12, 3, 6 and 9 o'clock): every 9-tap arc holds such a
    pair, so the bound is at least the score. f32 torch, as ops/fast.py."""
    x = imgs.float().reshape(-1, *imgs.shape[-2:])
    h, w = x.shape[-2:]
    centre = x[:, margin:h - margin, margin:w - margin]
    d = [x[:, margin + dy:h - margin + dy, margin + dx:w - margin + dx] - centre
         for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    bound = torch.stack([torch.maximum(torch.minimum(a, b), -torch.maximum(a, b))
                         for a, b in zip(d, d[1:] + d[:1])]).amax(0)
    passes = bound > th
    kept = fast_score_map_plain(x, th, margin=margin)[:, margin:h - margin, margin:w - margin] > 0
    check(not (kept & ~passes).any(), "a pixel keeps a score its compass bound rules out")
    n_pass = int(passes.sum())
    return centre.numel() - n_pass, n_pass, int(kept.sum())


def phase_k1(frames) -> dict:
    rng, street, plateau = _street_and_plateau(frames)
    unaligned = torch.from_numpy(rng.integers(0, 255, (3, 123, 300)).astype(np.uint8)).to(DEV)
    worst = 0.0
    parts = []
    for name, imgs, th in (("street", street, 20.0), ("plateau", plateau, 20.0),
                           ("unaligned", unaligned, 12.0)):
        got = fast_nms(imgs, th, margin=16, radius=2)
        ref = fast_nms_plain(imgs, th, margin=16, radius=2)
        sync()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, ref), f"K1 differs from its plain version on {name}: max {err}")
        parts.append(f"{name} {tuple(imgs.shape)} {imgs.dtype} equal, {int((ref > 0).sum())} kept")
    # every NMS radius K1 is built for, at its least margin, with one
    # threshold for the pair and one per image
    for radius in hopper_fast.KERNEL_NMS_RADII:
        for name, imgs in (("street", street), ("plateau", plateau)):
            for thr in (20.0, torch.tensor([20.0, 10.0], device=DEV)):
                got = fast_nms(imgs, thr, margin=3 + radius, radius=radius)
                ref = fast_nms_plain(imgs, thr, margin=3 + radius, radius=radius)
                err = float((got - ref).abs().max())
                worst = max(worst, err)
                check(torch.equal(got, ref), f"K1 differs from its plain version on {name} at "
                      f"radius {radius}, thresholds {thr}: max {err}")
    radii = hopper_fast.KERNEL_NMS_RADII
    parts.append(f"NMS radii {radii[0]}-{radii[-1]} at margin 3 + r on street and plateau, "
                 "one threshold and one per image (20, 10): equal")
    px = street.numel()
    n_fail, n_pass, n_kept = _fast_work(street, 20.0)
    times = _times("fast_nms_kernel", lambda: fast_nms(street, 20.0),
                   lambda: fast_nms_plain(street, 20.0),
                   n_bytes=px * street.element_size() + px * 4,
                   n_ops=(n_fail * COMPASS_OPS_PER_PX + n_pass * FAST_SCORE_OPS_PER_PX
                          + n_kept * NMS_OPS_PER_PX))
    print(f"[K1 fast_nms] bit-exact: {'; '.join(parts)} | at 2x370x1226 u8: {n_pass} of "
          f"{n_fail + n_pass} inner pixels pass the compass bound ({n_pass / (n_fail + n_pass):.3f}), "
          f"{n_kept} keep a score | {_fmt(times)}")
    return {"name": "fast_nms", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/fast_nms.cu",
            "replaces": f"{PALLAS}:197", "max_abs_err": worst, **times}


def _orb_work(imgs, ys, xs, valid) -> tuple[int, int, int, int]:
    """What K2 must touch for these keypoints: (distinct sampled points,
    distinct frame pixels under their 7x7 blur supports, bytes, f32
    operations). Sample coordinates clip into the image as the kernel's."""
    n, h, w = imgs.shape
    off = torch.as_tensor(orb.PATTERN_OFFSETS, dtype=torch.int64, device=imgs.device)
    img_idx = torch.arange(n, device=imgs.device)[:, None, None]
    pts = []
    for dy, dx in ((off[:, 0], off[:, 1]), (off[:, 2], off[:, 3])):
        yy = (ys[..., None].long() + dy).clamp(0, h - 1)
        xx = (xs[..., None].long() + dx).clamp(0, w - 1)
        pts.append(((img_idx * h + yy) * w + xx)[valid])
    points = torch.unique(torch.cat(pts).flatten())
    r = torch.arange(-3, 4, device=imgs.device)
    py = (points // w % h)[:, None, None] + r[None, :, None]
    px = (points % w)[:, None, None] + r[None, None, :]
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    support = torch.unique((((points // (h * w))[:, None, None] * h + py) * w + px)[inside])
    n_kp = ys.numel()
    n_bytes = support.numel() * imgs.element_size() + n_kp * (4 + 4 + 1) + n_kp * 8 * 4
    n_ops = points.numel() * ORB_BLUR_OPS_PER_POINT + int(valid.sum()) * 256
    return points.numel(), support.numel(), n_bytes, n_ops


def phase_k2(frames) -> dict:
    street = torch.from_numpy(np.stack(frames[0])).to(DEV)
    ys, xs, _sc, valid = grid_topk(fast_nms(street, 20.0), cell=5, k=512)
    got = orb_descriptors(street, ys, xs, valid)
    ref = orb_descriptors_plain(street, ys, xs, valid)
    sync()
    err = float((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    check(torch.equal(got, ref), f"K2 differs from its plain version: max word diff {err}")
    n_valid = int(valid.sum())
    check(n_valid > 0 and bool((got[valid] != 0).any()), "K2: no valid keypoint has bits set")
    n_points, n_support, n_bytes, n_ops = _orb_work(street, ys, xs, valid)
    times = _times("orb_describe_kernel",
                   lambda: orb_descriptors(street, ys, xs, valid),
                   lambda: orb_descriptors_plain(street, ys, xs, valid), n_bytes, n_ops)
    print(f"[K2 orb_descriptors] blur fused in; bit-exact at {tuple(got.shape)}, {n_valid} valid "
          f"keypoints | {n_points} distinct sampled points, {n_support} distinct frame pixels "
          f"under their 7x7 supports | {_fmt(times)}")
    return {"name": "orb_descriptors", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/orb_describe.cu",
            "replaces": f"{PALLAS}:297", "max_abs_err": err, **times}


def _k3_times(imgs, k1_device_ms: float | None = None) -> tuple[dict, str]:
    """K3's times on the street image(s) ``imgs`` at threshold 20, beside
    the device time of an empty kernel at K3's grid and block (the launch
    floor), and K1's device time on the same frames where given."""
    n, h, w = (1, *imgs.shape) if imgs.dim() == 2 else imgs.shape
    px = imgs.numel()
    n_fail, n_pass, _n_kept = _fast_work(imgs, 20.0)
    times = _times("fast_score_kernel", lambda: fast_score_map(imgs, 20.0),
                   lambda: fast_score_map_plain(imgs, 20.0),
                   n_bytes=px * imgs.element_size() + px * 4,
                   n_ops=n_fail * COMPASS_OPS_PER_PX + n_pass * FAST_SCORE_OPS_PER_PX)
    grid, block = hopper_fast.fast_score_launch(n, h, w)
    floor_ms = kt.launch_floor_ms(grid, block)
    line = (f"at {'x'.join(map(str, imgs.shape))} u8: {n_pass} of {n_fail + n_pass} inner pixels "
            f"pass the compass bound | grid {grid} of {block} | "
            f"{_fmt(times)} | launch floor (empty kernel, same grid, CUDA graph) "
            f"{floor_ms * 1e3:.2f} us")
    if k1_device_ms is not None:
        line += (f" | K1 on the same pair {k1_device_ms * 1e3:.2f} us (phase 3): K3/K1 "
                 f"{times['device_ms'] / k1_device_ms:.3f}")
    return times, line


def phase_k3(frames, k1_device_ms: float) -> dict:
    rng, street, plateau = _street_and_plateau(frames)
    left = street[0].contiguous()                                         # [370,1226] u8
    odd = torch.from_numpy(rng.integers(0, 255, (123, 300)).astype(np.uint8)).to(DEV)
    worst = 0.0
    parts = []
    for name, img, th in (("street left", left, 20.0), ("plateau", plateau, 20.0),
                          ("odd", odd, 8.0)):
        got = fast_score_map(img, th, margin=16)
        ref = fast_score_map_plain(img, th, margin=16)
        sync()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        check(got.shape == img.shape and torch.equal(got, ref),
              f"K3 differs from its plain version on {name}: max {err}")
        parts.append(f"{name} {tuple(img.shape)} {img.dtype} equal, {int((ref > 0).sum())} > th")
    for name, imgs in (("street", street), ("plateau", plateau)):
        for margin in (16, 2):
            thr = torch.tensor([20.0, 10.0], device=DEV)
            got = fast_score_map(imgs, thr, margin=margin)
            ref = fast_score_map_plain(imgs, thr, margin=margin)
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, ref), f"K3 differs from its plain version on {name} at "
                  f"per-image thresholds (20, 10), margin {margin}: max {err}")
    parts.append("street and plateau pairs at per-image thresholds (20, 10), margins 16 and 2: "
                 "equal")
    times, one = _k3_times(left)
    _pair_times, pair = _k3_times(street, k1_device_ms)
    print(f"[K3 fast_score_map] bit-exact: {'; '.join(parts)} | {one}")
    print(f"[K3 fast_score_map] {pair}")
    return {"name": "fast_score_map", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/fast_score.cu",
            "replaces": f"{PALLAS}:71", "max_abs_err": worst, **times}


def _int_fields_differing(a, b) -> list[str]:
    names = ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
             "m_r_idx", "m_valid")
    return [n for n in names if not torch.equal(getattr(a, n).cpu(), getattr(b, n).cpu())]


def _reset_launches():
    for fn in (fast_nms, orb_descriptors, fast_score_map):
        fn.launches = 0


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in (fast_nms, orb_descriptors, fast_score_map)}


def _captures(kind: str = "vo_scan") -> int:
    """The CUDA graphs of ``kind`` captured so far (``ops/cuda_graphs.py``
    ``program``: each batch length's scan once, a capture's warm-up
    launching K1 and K2 once more; ``"check"``: each check program once)."""
    return cuda_graphs.capture_stats(kind)["captures"]


def _graph_programs(b_list=None) -> str:
    """The captured scan graphs (of batch lengths ``b_list``, else all):
    batch, host seconds of warm-up and capture, MB of the graph's pool and
    of its GN steps' pools, K1/K2 launches a replay."""
    rows = []
    for p in cuda_graphs.programs():
        b = p["key"][1]
        if p["key"][0] == "vo_scan" and (b_list is None or b in b_list):
            rows.append(f"B={b} {p['capture_s']:.3f} s, pool {p['pool_bytes'] / 2**20:.1f} MB "
                        f"(steps {p['body_bytes'] / 2**20:.1f} MB), launches a replay "
                        f"{p['launches']}")
    return "; ".join(rows) or "none"


def _check_programs() -> str:
    """The captured check programs (``models/data_association.py``: the
    fused group's slot program and the strict path's one-check program, one
    per key): which, K, M, debug, host seconds of warm-up and capture, MB of
    the graph's pool and of its loops' steps, the bytes a replay copies (its
    inputs in, its blob out) and the bytes it holds in place (the store, the
    database, the vocabulary)."""
    rows = [f"{p['key'][1]} (K {p['key'][2][0]}, M {p['key'][3][0]}, debug {p['key'][7]}) "
            f"{p['capture_s']:.3f} s, pool {p['pool_bytes'] / 2**20:.1f} MB (steps "
            f"{p['body_bytes'] / 2**20:.1f} MB, {p['steps']} captured), copies "
            f"{p['copy_bytes'] / 1e3:.1f} kB a replay, holds {p['held_bytes'] / 1e6:.3f} MB"
            for p in cuda_graphs.programs() if p["key"][0] == "check"]
    return "; ".join(rows) or "none"


def _scan_fns(frames, b: int):
    """The scan of street frames 1..b chained from frame 0's features at
    FAST 20 / ORB 60 (tensors, as the estimator passes them), as a call of
    the CUDA-graph replay (the default) and one of the eager scan
    (``vo.SCAN_GRAPHS`` off)."""
    cam = StereoCamera.kitti()
    prev = extract_and_match(*frames[0], cam, 20.0, 60, device=DEV)
    lefts = torch.from_numpy(np.stack([f[0] for f in frames[1:1 + b]])).to(DEV)
    rights = torch.from_numpy(np.stack([f[1] for f in frames[1:1 + b]])).to(DEV)
    init = torch.zeros(6, device=DEV)
    fast, orb_t = torch.full((b,), 20.0, device=DEV), torch.full((), 60.0, device=DEV)

    def graph():
        with cuda_graphs.no_exit_reads():
            return vo_mod.vo_scan(lefts, rights, prev, init, cam, fast, orb_t, device=DEV)

    return graph, _flag_off(vo_mod, "SCAN_GRAPHS", graph)


def _dispatch_done(graph, eager, reps: int = 5) -> dict:
    """Host ms of ``graph`` (a program's call) and ``eager`` (the same call
    eagerly) in turns (eager, graph, graph, eager; ``reps`` calls each):
    {"graph": (dispatch, done), "eager": (...)}, medians of the ms until
    the call returns and until the card is done."""
    times = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        fn = graph if name == "graph" else eager
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            sync()
            times[name].append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    return {n: (statistics.median(t[0] for t in v), statistics.median(t[1] for t in v))
            for n, v in times.items()}


def _scan_ab(frames, b: int) -> str:
    """One scan of B frames (:func:`_scan_fns`) as the graph replay
    against the eager scan: every output equal bit for bit; then, the
    graph captured, in turns (eager, graph, graph, eager, 5 calls each),
    the host ms until ``vo_scan`` returns (the dispatch) and until the card
    is done, medians."""
    graph, eager = _scan_fns(frames, b)
    caps = _captures()
    t0 = time.perf_counter()
    out_g = graph()
    sync()
    first_s = time.perf_counter() - t0
    out_e = eager()
    leaves_g, leaves_e = (pytree.tree_leaves(o) for o in (out_g, out_e))
    check(len(leaves_g) == len(leaves_e) and all(
        torch.equal(x, y) for x, y in zip(leaves_g, leaves_e)),
        f"scan of {b}: the graph replay differs from the eager scan")
    med = _dispatch_done(graph, eager)
    return (f"B={b}: graph = eager bit for bit on all {len(leaves_g)} outputs | first graph "
            f"call {first_s:.3f} s ({_captures() - caps} captured) | dispatch / done ms, "
            f"medians in turns: eager {med['eager'][0]:.3f} / {med['eager'][1]:.3f}, graph "
            f"{med['graph'][0]:.3f} / {med['graph'][1]:.3f}")


def _scan_launch_counts(fn) -> tuple[int, int, int]:
    """The kernel launches, graph launches and copies that the host issues
    in one call of ``fn`` (after a warm-up call), from torch.profiler."""
    evs = kt.profile_calls(fn)
    return (kt.launch_count(evs), sum(e.count for e in evs if "GraphLaunch" in e.key),
            sum(e.count for e in evs if e.key == "cudaMemcpyAsync"))


def scan_launches_child(path: str) -> None:
    """:func:`phase_scan_launches`'s process: the street frames saved at
    ``path``; every eager scan traced before the first graph scan, and
    nothing traced after the graph scans. Prints one JSON object."""
    data = np.load(path)
    frames = [(f[0], f[1]) for f in data]
    batches = (BATCH, bw.SCHEDULES[bench.HEADLINE][0], bw.DEV_CHUNK)
    fns = {b: _scan_fns(frames, b) for b in batches}
    eager = {b: _scan_launch_counts(fns[b][1]) for b in batches}
    graph = {b: _scan_launch_counts(fns[b][0]) for b in batches}
    print(json.dumps({"eager": eager, "graph": graph, "captures": _captures()}))


def phase_scan_launches(frames) -> None:
    """The scan's launches a frame at the batches of phases 10, 15 and 16,
    eager against graph: the kernel launches, graph launches and copies
    that the host issues in one call, under torch.profiler with CPU and
    CUDA activity, in a process of its own (:func:`scan_launches_child`):
    a trace of a captured program has been followed by sessions that lost
    kernel records and by an illegal memory access (ROADMAP Queue 3), so
    this process traces none. A graph call must launch no kernel and one
    graph."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, np.stack([np.stack(f[:2]) for f in frames[:1 + bw.DEV_CHUNK]]))
        code = f"import chip_smoke; chip_smoke.scan_launches_child({path!r})"
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    check(proc.returncode == 0, f"the scan-launches process exited with {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = []
    for b in got["eager"]:
        e, g = got["eager"][b], got["graph"][b]
        check(g[0] == 0 and g[1] == 1, f"a graph scan of {b} launched {g[0]} kernels and "
              f"{g[1]} graphs")
        rows.append(f"B={b}: eager {'/'.join(f'{c / int(b):.2f}' for c in e)} {tuple(e)}, "
                    f"graph {'/'.join(f'{c / int(b):.2f}' for c in g)} {tuple(g)}")
    print("[scan launches] a frame, torch.profiler in a process of its own (kernel launches / "
          "graph launches / copies; a call in brackets): " + "; ".join(rows)
          + f" | {got['captures']} graphs captured there")


def phase_slice(cam, frames, gt_poses):
    def engine(device):
        return StereoVOEngine(cam, VOOptions(fast_th=20, n_feats=500), capacity=512,
                              device=device)

    eng = engine(DEV)
    results, feats, ms = [], [], []
    _reset_launches()
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        res = eng.process_stereo_pair(left, right)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = (fast_nms.launches, orb_descriptors.launches)
        check(launches == (i + 1, i + 1),
              f"frame {i}: kernel launch counts {launches}, expected {i + 1} each")
        results.append(res)
        if i < N_CPU_FRAMES:
            feats.append(eng.last_frame())
    counts = _launches()

    cpu = engine("cpu")
    for i, (left, right) in enumerate(frames[:N_CPU_FRAMES]):
        a, b = results[i], cpu.process_stereo_pair(left, right)
        check((a.valid, a.num_stereo_matches, a.tracked_from_last_frame)
              == (b.valid, b.num_stereo_matches, b.tracked_from_last_frame),
              f"frame {i}: CUDA {a} vs CPU {b}")
        diff = _int_fields_differing(feats[i], cpu.last_frame())
        check(not diff, f"frame {i}: FrameFeatures fields {diff} differ between CUDA and CPU")
        d = np.abs(a.pose_increment.astype(np.float64) - b.pose_increment)
        check(d[:3].max() <= POSE_TOL_RAD and d[3:].max() <= POSE_TOL_M,
              f"frame {i}: pose increments differ by {d} (tol {POSE_TOL_RAD} rad, {POSE_TOL_M} m)")

    check(all(r.valid for r in results), f"invalid VO frames: "
          f"{[i for i, r in enumerate(results) if not r.valid]}")
    est = np.zeros(6)
    for r in results[1:]:
        est = se3_np.compose(est, se3_np.inverse(r.pose_increment.astype(np.float64)))
    t_err = float(np.linalg.norm(est[3:] - gt_poses[len(frames) - 1][3:]))
    path = float(np.sum(np.linalg.norm(np.diff(gt_poses[:len(frames), 3:], axis=0), axis=1)))
    check(t_err < 0.05 * path, f"translation error {t_err} m over a {path} m path")
    front = _frontend_profile(cam, *frames[0])
    slice_ms = statistics.median(ms)
    print(f"[slice] {len(frames)} frames 370x1226 on CUDA: per-frame median "
          f"{statistics.median(ms):.3f} ms, p95 {p95(ms):.3f} ms, first {ms[0]:.3f} ms | "
          f"launches {counts} | first {N_CPU_FRAMES} frames match the CPU path | "
          f"stereo matches median {int(np.median([r.num_stereo_matches for r in results]))}, "
          f"tracked median {int(np.median([r.tracked_from_last_frame for r in results[1:]]))} | "
          f"translation error at frame {len(frames)}: {t_err:.4f} m over {path:.2f} m")
    if front["traced"]:
        print(f"[frontend] extract_and_match of the street pair (frame 0), "
              f"{FRONTEND_PROFILE_REPS} calls under torch.profiler, per call: "
              f"{front['launches']:.1f} kernel launches, device {front['device_us']:.1f} us, "
              f"of which K1 {front['fast_nms_kernel']:.1f} us and "
              f"K2 {front['orb_describe_kernel']:.1f} us (the blur inside K2)")
    else:
        print(f"[frontend] torch.profiler traced K1 and K2 in none of "
              f"{kt.PROFILE_ATTEMPTS} attempts, though the wrappers launched them "
              f"{front['wrapper_launches']}: the frontend's device time is not measured")
    return slice_ms


def _frontend_profile(cam, left, right) -> dict:
    """The frontend's launches and device µs per call for one stereo pair,
    as the VO engine of phase 5 calls it. The wrappers' counts must show K1
    and K2 launched; a trace that holds neither is reported, not failed."""
    opts = VOOptions(fast_th=20, n_feats=500)
    before = (fast_nms.launches, orb_descriptors.launches)
    evs = kt.profile_until(lambda: extract_and_match(
        left, right, cam, 20.0, int(opts.orb_max_distance), k=512, cell=opts.min_distance,
        max_y_diff=opts.max_y_diff, device=DEV), FRONTEND_KERNELS, FRONTEND_PROFILE_REPS)
    launched = (fast_nms.launches - before[0], orb_descriptors.launches - before[1])
    check(min(launched) > 0, f"the frontend launched K1, K2 {launched} times under the profiler")
    if evs is None:
        return {"traced": False, "wrapper_launches": launched}
    dev = kt.device_events(evs)
    out = {"traced": True, "launches": kt.launch_count(evs) / FRONTEND_PROFILE_REPS,
           "device_us": sum(e.self_device_time_total for e in dev) / FRONTEND_PROFILE_REPS}
    for name in FRONTEND_KERNELS:
        out[name] = sum(e.self_device_time_total
                        for e in dev if name in e.key) / FRONTEND_PROFILE_REPS
    return out


def _count_vo_passes(est) -> list:
    """Wrap the estimator's VO engine so each pass is counted."""
    passes = [0]
    run = est.vo.process_stereo_pair

    def counted(left, right):
        passes[0] += 1
        return run(left, right)

    est.vo.process_stereo_pair = counted
    return passes


def _run_estimator(device, frames, snapshot_at=None, syncs=None):
    """Step the bench estimator over ``frames``; returns it with per-frame
    host ms (synchronized), the keyframe poses after frame ``snapshot_at``,
    and with a ``SyncCount`` the host syncs of each frame and of each
    keyframe check. The strict solve schedule: the fingerprint's."""
    est = bench_estimator(device, solve_sync=True)
    passes = _count_vo_passes(est)
    check_syncs = _count_calls_syncs(est, "_kf_check", syncs) if syncs else []
    ms, frame_syncs, snap = [], [], None
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        n0 = syncs.n if syncs else 0
        est.step(left, right)
        if syncs:
            frame_syncs.append(syncs.n - n0)
        if device != "cpu":
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == snapshot_at:
            snap = est.rba.kf_global[: est.store.n_kfs].copy()
    return est, passes[0], ms, snap, frame_syncs, check_syncs


def _capture_checks():
    """Record the inputs of every keyframe check the estimator makes (the
    store and the BoW database as they were, copied on the card); returns
    the records and the function that puts the original back."""
    records, run = [], estimator_mod.query_and_associate_packed

    def capturing(frame, arrays, db, leaf_bits, weights, n_kfs, cam, seed, debug=False, **kw):
        records.append(dict(frame=frame, arrays=type(arrays)(*(a.clone() for a in arrays)),
                            db=db.clone(), leaf_bits=leaf_bits, weights=weights,
                            n_kfs=n_kfs, cam=cam, key=prng.PRNGKey(seed, device=db.device),
                            seed=seed, kw=kw))
        return run(frame, arrays, db, leaf_bits, weights, n_kfs, cam, seed, debug=debug, **kw)

    estimator_mod.query_and_associate_packed = capturing

    def restore():
        estimator_mod.query_and_associate_packed = run

    return records, restore


def _five_valid(rec) -> bool:
    cur = vo_mod.FrameFeatures(*(a[None] for a in rec["frame"]))
    cand_valid = da_mod.bow_candidates(cur, rec["db"][None], rec["leaf_bits"],
                                       rec["weights"], rec["n_kfs"])[3]
    return bool(cand_valid.all())


def _pick_check(steps, records) -> dict:
    """Phase 12's check: the first loop-closure check of the run whose five
    candidates are all valid, else the first check with five valid ones."""
    frames = [r for r in steps if r.kf_check]
    check(len(frames) == len(records), f"{len(records)} checks recorded, {len(frames)} in "
                                       f"the step log")
    lc = [i for i, r in enumerate(frames) if r.loop_closure_with is not None]
    for i in lc + list(range(len(frames))):
        if _five_valid(records[i]):
            rec = dict(records[i], frame_idx=frames[i].frame_idx,
                       lc=frames[i].loop_closure_with)
            return rec
    raise RuntimeError("no keyframe check of the run had five valid candidates")


def phase_estimator(frames, gt_poses, profile: bool) -> dict:
    fp = bw.load_fingerprint()
    check(fp["workload"]["source"] == bw.SOURCE and fp["workload"]["options"] == bw.OPTIONS,
          "the committed JAX fingerprint is of another workload")
    check(len(frames) == len(fp["decisions"]), f"{len(frames)} frames, fingerprint has "
          f"{len(fp['decisions'])}")
    sha = hashlib.sha256(np.ascontiguousarray(frames[0][0]).tobytes()).hexdigest()
    n_cpu = fp["kf_frames"][2] + 1      # KF0 and two insertions after it

    torch.use_deterministic_algorithms(True)
    blur_calls, unguard = _count_blur_calls()
    records, uncapture = _capture_checks()
    _reset_launches()
    check_caps = cuda_graphs.capture_stats("check")
    with SyncCount() as syncs:
        est, n_passes, ms, snap, frame_syncs, check_syncs = _run_estimator(
            DEV, frames, snapshot_at=n_cpu - 1, syncs=syncs)
    uncapture()
    counts = _launches()
    check(blur_calls["cuda"] == 0,
          f"gauss_blur7 ran {blur_calls['cuda']} times on CUDA tensors: K2 must blur inside")
    check(counts["fast_nms"] == n_passes and counts["orb_descriptors"] == n_passes,
          f"K1/K2 launches {counts} over {n_passes} VO passes")
    got = bw.decisions(est.step_log)
    diff = [(a, b) for a, b in zip(fp["decisions"], got) if a != b]
    check(not diff, f"decisions differ from the JAX fingerprint at {len(diff)} frames: "
                    f"{diff[:5]} (JAX, port)")
    with tempfile.TemporaryDirectory() as out_dir:
        pg_calls, unrecord = _record_calls(estimator_mod, "optimize_pose_graph")
        t0 = time.perf_counter()
        est.finalize(out_dir=out_dir)
        finalize_ms = (time.perf_counter() - t0) * 1e3
        unrecord()
        sizes = {f: os.path.getsize(os.path.join(out_dir, f)) for f in OUTPUT_FILES
                 if os.path.exists(os.path.join(out_dir, f))}
    check(len(sizes) == len(OUTPUT_FILES) and all(sizes.values()),
          f"finalize wrote {sizes}, expected non-empty {OUTPUT_FILES}")
    torch.use_deterministic_algorithms(False)
    kf_frames = [r.frame_idx for r in est.step_log if r.inserted_kf is not None]
    final = est.final_poses_cam
    check(final.shape == (len(kf_frames), 6) and np.isfinite(final).all(),
          f"final poses {final.shape}, finite {np.isfinite(final).all()}")
    ate = ate_rmse(final[:, 3:], gt_poses[kf_frames][:, 3:], align=True)
    check(ate < ATE_GATE_M, f"aligned ATE {ate} m >= {ATE_GATE_M} m")
    jax_final = np.asarray(fp["final_poses_cam"])
    d_jax = np.abs(final - jax_final)

    cpu, _n_cpu_passes, cpu_ms, cpu_snap, _fs, _cs = _run_estimator(
        "cpu", frames[:n_cpu], snapshot_at=n_cpu - 1)
    unguard()
    check(bw.decisions(cpu.step_log) == got[:n_cpu],
          f"frames 0-{n_cpu - 1}: CUDA and CPU decisions differ")
    check(snap.shape == cpu_snap.shape, f"{snap.shape} vs {cpu_snap.shape} keyframes")
    d = np.abs(snap - cpu_snap)
    check(d[:, :3].max() <= POSE_TOL_RAD and d[:, 3:].max() <= POSE_TOL_M,
          f"keyframe poses after frame {n_cpu - 1} differ between CUDA and CPU by {d.max(0)}")

    steps = est.step_log
    ins = [r.define_kf_ms for r in steps if r.inserted_kf not in (None, 0)]
    chk = [m for m, r in zip(ms, steps) if r.kf_check]
    quiet = [m for m, r in zip(ms, steps) if not r.kf_check and r.frame_idx > 0]
    n_lc = sum(r.loop_closure_with is not None for r in steps)
    n_rej = sum(r.lc_rejected_with is not None for r in steps)
    sections = "; ".join(f"{k} {s.count}x {s.mean * 1e3:.3f} ms"
                         for k, s in sorted(est.profiler.sections.items()))
    print(f"[estimator] {len(frames)} frames 370x1226 on CUDA, deterministic algorithms: "
          f"per-frame median {statistics.median(ms):.3f} ms, p95 {p95(ms):.3f} ms, "
          f"first {ms[0]:.3f} ms, total {sum(ms) / 1e3:.3f} s | frames without a check "
          f"median {statistics.median(quiet):.3f} ms, with a check median "
          f"{statistics.median(chk):.3f} ms | per insertion (define_kf_ms) median "
          f"{statistics.median(ins):.3f} ms, mean {statistics.mean(ins):.3f} ms | "
          f"finalize {finalize_ms:.3f} ms | {est.store.n_kfs} KFs, "
          f"{sum(r.kf_check for r in steps)} checks, {n_lc} LCs, {n_rej} LCs rejected | "
          f"VO passes {n_passes}, launches {counts}, gauss_blur7 on CUDA tensors "
          f"{blur_calls['cuda']}x (on CPU tensors {blur_calls['cpu']}x, the CPU comparison) | "
          f"decisions equal the JAX fingerprint "
          f"(frame0 sha256 {'matches' if sha == fp['workload']['frame0_left_sha256'] else 'DIFFERS'}) "
          f"| frames 0-{n_cpu - 1} equal the CPU path ({sum(cpu_ms) / 1e3:.3f} s there), "
          f"KF poses within "
          f"{d[:, :3].max():.2e} rad / {d[:, 3:].max():.2e} m | ATE {ate:.6f} m "
          f"(JAX {fp['ate_m']:.6f} m), final poses vs JAX max {d_jax[:, :3].max():.2e} rad / "
          f"{d_jax[:, 3:].max():.2e} m | files {sizes}")
    print(f"[estimator] profiler sections: {sections}")
    q = est.profiler.sections["queryDB"]
    caps = {k: v - check_caps[k] for k, v in cuda_graphs.capture_stats("check").items()}
    print(f"[estimator checks] each keyframe check one replay of the one-check program "
          f"(CHECK_GRAPHS): section queryDB {q.count} checks, mean {q.mean * 1e3:.3f} ms, "
          f"{(q.total - caps['capture_s']) / max(q.count, 1) * 1e3:.3f} ms without the "
          f"{caps['captures']} capture(s) ({caps['capture_s']:.3f} s of warm-up and capture) "
          f"| {_check_programs()}")
    quiet_syncs = [n for n, r in zip(frame_syncs, steps) if not r.kf_check and r.frame_idx > 0]
    chk_syncs = [n for n, r in zip(frame_syncs, steps) if r.kf_check]
    print(f"[estimator syncs] host syncs (torch sync debug warnings) over the {len(frames)} "
          f"frames: {syncs.n}, per frame median {_med(frame_syncs)} (without a check "
          f"{_med(quiet_syncs)}, with a check {_med(chk_syncs)}); inside the keyframe check "
          f"(query, cascade, one copy out) median {_med(check_syncs)}, max "
          f"{max(check_syncs, default=0)} over {len(check_syncs)} checks")
    picked = _pick_check(steps, records)
    del records
    if profile:
        _profile_estimator(frames, sum(ms))
    return counts, sum(ms) / 1e3, picked, pg_calls[0]


def _record_calls(module, name: str):
    """Record the arguments and the host ms (synchronized) of every call of
    ``module.name``; returns the records and the function that puts the
    original back."""
    calls, run = [], getattr(module, name)

    def recording(*a, **k):
        sync()
        t0 = time.perf_counter()
        out = run(*a, **k)
        sync()
        calls.append(dict(args=a, kw=k, ms=(time.perf_counter() - t0) * 1e3))
        return out

    setattr(module, name, recording)

    def restore():
        setattr(module, name, run)

    return calls, restore


def _count_blur_calls():
    """Count ``gauss_blur7`` calls by the device of their input, in every
    module of the port that holds the function; returns the counts and the
    function that puts the original back."""
    calls = {"cuda": 0, "cpu": 0}
    original = orb.gauss_blur7

    def counted(img):
        calls["cuda" if img.is_cuda else "cpu"] += 1
        return original(img)

    holders = [m for name, m in list(sys.modules.items())
               if name.startswith("srba_slam_tpu_torch") and getattr(m, "gauss_blur7", None)
               is original]
    for m in holders:
        m.gauss_blur7 = counted

    def restore():
        for m in holders:
            m.gauss_blur7 = original

    return calls, restore


def _profile_estimator(frames, untraced_ms: float):
    """The estimator run again under torch.profiler: device kernel time
    against the untraced run's wall time (``untraced_ms``; the traced run's
    own, which the tracer lengthens at every launch, beside it), and the
    kernels that take most of it. CUDA activity only, and the checks eager
    (``CHECK_GRAPHS`` off): a trace of a captured program has been followed
    by an illegal memory access (ROADMAP Queue 3). The kernels inside the
    conditional nodes of loops made before the session are not recorded
    (the same), so the device time is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _flag_off(da_mod, "CHECK_GRAPHS", lambda: _run_estimator(DEV, frames))()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    evs = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in evs if e.device_type.name == "CUDA")
    top = sorted((e for e in evs if e.device_type.name == "CUDA"),
                 key=lambda e: -e.self_device_time_total)[:8]
    launches = sum(e.count for e in evs if e.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    syncs = sum(e.count for e in evs if e.key == "cudaStreamSynchronize")
    copies = sum(e.count for e in evs if e.key == "cudaMemcpyAsync")
    dev_ms = dev_us / 1e3
    print(f"[profile] estimator {len(frames)} frames under torch.profiler: wall {wall_ms:.1f} ms, "
          f"device kernel time {dev_ms:.1f} ms, busy share {dev_ms / untraced_ms:.4f} of the "
          f"untraced run's {untraced_ms:.1f} ms ({dev_ms / wall_ms:.4f} of the traced wall; reading "
          f"the trace took {time.perf_counter() - t0:.1f} s) | "
          f"cudaLaunchKernel {launches}, cudaMemcpyAsync {copies}, "
          f"cudaStreamSynchronize {syncs} | top kernels: "
          + "; ".join(f"{e.key[:60]} {e.count}x {e.self_device_time_total / 1e3:.2f} ms"
                      for e in top))


def _px_bound_us(imgs) -> float:
    """The bytes bound, in µs, of a kernel that reads ``imgs`` once and
    writes one f32 a pixel."""
    return kt.bound_ms(imgs.numel() * (imgs.element_size() + 4), 0.0)[0] * 1e3


def _options_kernels(street, euroc_pair, euroc_maps) -> list[str]:
    """Phase 8 (a): the kernels at the shapes and types the options give
    them, each ``torch.equal`` to its plain version and timed device-only."""
    o1 = _avgpool2(street.to(torch.float32))
    o2 = _avgpool2(o1)
    remapped = torch.stack([remap_bilinear(euroc_pair[i], euroc_maps[i]) for i in range(2)])
    check(tuple(o1.shape) == (2, 185, 613) and tuple(o2.shape) == (2, 92, 306)
          and tuple(remapped.shape) == (2, 480, 752), f"{o1.shape} {o2.shape} {remapped.shape}")
    check(bool((o1 * 4 == torch.round(o1 * 4)).all()) and bool((o1 != torch.round(o1)).any()),
          "the octave-1 image is not in quarters")
    check(bool((remapped != torch.round(remapped)).any()), "the remapped pair is integer-valued")
    k3, k2 = _octave_budget(370, 1226, 5, 512, 3), _octave_budget(370, 1226, 5, 512, 2)
    lines = []
    for name, imgs, ks in (("octave 1", o1, (k2[1], k3[1])), ("octave 2", o2, (k3[2],)),
                           ("remapped EuRoC", remapped, (500,))):
        check(imgs.dtype == torch.float32, f"{name}: {imgs.dtype}")
        got, ref = fast_nms(imgs, 20.0), fast_nms_plain(imgs, 20.0)
        check(torch.equal(got, ref), f"K1 differs from its plain version on {name}")
        for margin in (0, 2, 3):
            got3 = fast_score_map(imgs, 20.0, margin=margin)
            check(torch.equal(got3, fast_score_map_plain(imgs, 20.0, margin=margin)),
                  f"K3 (margin {margin}) differs from its plain version on {name}")
        parts = [f"K1 {kt.graph_ms(lambda: fast_nms(imgs, 20.0)) * 1e3:.2f} us, K3 at margin 3 "
                 f"{kt.graph_ms(lambda: fast_score_map(imgs, 20.0, margin=3)) * 1e3:.2f} us, at "
                 f"margin 2 (the halo wrapped) "
                 f"{kt.graph_ms(lambda: fast_score_map(imgs, 20.0, margin=2)) * 1e3:.2f} us "
                 f"(bytes bound {_px_bound_us(imgs):.2f} us, launch floor "
                 f"{kt.launch_floor_ms(*hopper_fast.fast_score_launch(*imgs.shape)) * 1e3:.2f} us), "
                 f"{int((ref > 0).sum())} kept"]
        near_total = 0
        for k, scores in [(k, got) for k in ks] + [(ks[0], local_max_suppress(got3, radius=2))]:
            ys, xs, _sc, valid = grid_topk(scores, cell=5, k=k)
            d = orb_descriptors(imgs, ys, xs, valid)
            check(torch.equal(d, orb_descriptors_plain(imgs, ys, xs, valid)),
                  f"K2 differs from its plain version on {name} at K={k}")
            h, w = imgs.shape[-2:]
            near = valid & ((ys < 16) | (xs < 16) | (ys >= h - 16) | (xs >= w - 16))
            if scores is got:
                check(not bool(near.any()), f"{name}: a margin-16 keypoint near a border")
                _pts, _sup, n_bytes, _ops = _orb_work(imgs, ys, xs, valid)
                parts.append(f"K2 at K={k} ({int(valid.sum())} valid) "
                             f"{kt.graph_ms(lambda: orb_descriptors(imgs, ys, xs, valid)) * 1e3:.2f}"
                             f" us (bytes bound {kt.bound_ms(n_bytes, 0.0)[0] * 1e3:.3f} us)")
            else:
                near_total = int(near.sum())
                check(near_total > 0, f"{name}: no margin-3 keypoint within 16 px of a border")
        lines.append(f"{name} {tuple(imgs.shape)} f32: all equal | " + ", ".join(parts)
                     + f" | K2 equal at {near_total} keypoints 3-15 px from a border")
    return lines


def _assert_same_features(a, b, what: str, oriented: bool = False):
    """The card's FrameFeatures ``a`` against the CPU path's ``b``."""
    check(torch.equal(a.octave.cpu(), b.octave), f"{what}: octaves differ")
    diff = _int_fields_differing(a, b)
    if not oriented:
        check(not diff, f"{what}: FrameFeatures fields {diff} differ between CUDA and CPU")
        err = float((a.pts3d.cpu() - b.pts3d).abs().max())
        check(err <= 1e-4, f"{what}: pts3d differ by {err}")
        return 0
    bad = [n for n in diff if n in ("ys_l", "xs_l", "valid_l", "ys_r", "xs_r", "valid_r")]
    check(not bad, f"{what}: keypoint fields {bad} differ between CUDA and CPU")
    rows = sum(int((getattr(a, n).cpu() != getattr(b, n)).any(1).sum())
               for n in ("desc_l", "desc_r"))
    total = a.desc_l.shape[0] * 2
    check(rows <= ORIENTED_ROWS_TOL * total, f"{what}: {rows} of {total} descriptor rows differ")
    moved = int((a.m_valid.cpu() != b.m_valid).sum())
    check(moved <= ORIENTED_ROWS_TOL * total, f"{what}: {moved} stereo matches differ")
    return rows


def _euroc_rig():
    """The EuRoC demo rig: its camera, one rendered 752x480 pair on the
    card, and its rectification maps on the card and on the CPU."""
    _gen, opts, _vo = load_config(EUROC_INI)
    cam = opts.camera
    left, right = next(iter(SyntheticSource(cam, n_frames=1, step=0.5)))

    def maps(device):
        return (build_maps(cam.width, cam.height, cam.fx_l, cam.fy_l, cam.cx_l, cam.cy_l,
                           dist=opts.camera_dist_l, device=device),
                build_maps(cam.width, cam.height, cam.fx_r, cam.fy_r, cam.cx_r, cam.cy_r,
                           dist=opts.camera_dist_r, device=device))

    check(any(opts.camera_dist_l) and any(opts.camera_dist_r), "the demo rig has no distortion")
    return cam, (left, right), maps(DEV), maps("cpu")


def phase_options(cam, frames, gt_poses, slice_ms: float) -> dict:
    street = torch.from_numpy(np.stack(frames[0])).to(DEV)
    ecam, epair, emaps, emaps_cpu = _euroc_rig()
    for line in _options_kernels(street, torch.from_numpy(np.stack(epair)).to(DEV), emaps):
        print(f"[options kernels] {line}")

    def frontend(device, pair=frames[0], c=cam, **kw):
        return extract_and_match(*pair, c, 20.0, 60, k=512, device=device, **kw)

    said = []
    for what, kw_cuda, kw_cpu in (
            ("n_levels=2", dict(n_levels=2), None), ("n_levels=3", dict(n_levels=3), None),
            ("margin=3", dict(margin=3), None), ("margin=2", dict(margin=2), None),
            ("rect_maps", dict(pair=epair, c=ecam, rect_maps=emaps),
             dict(pair=epair, c=ecam, rect_maps=emaps_cpu)),
            ("oriented", dict(oriented=True), None)):
        a, b = frontend(DEV, **kw_cuda), frontend("cpu", **(kw_cpu or kw_cuda))
        rows = _assert_same_features(a, b, what, oriented=what == "oriented")
        said.append(f"{what}: {int(a.m_valid.sum())} stereo matches"
                    + (f", {rows} of {2 * 512} descriptor rows differ" if what == "oriented"
                       else ", equal"))
    print(f"[options frontend] CUDA against the CPU path, street frame 0 (rect_maps: a rendered "
          f"752x480 pair): {'; '.join(said)}")

    _reset_launches()
    for left, right in frames:
        frontend(DEV, pair=(left, right), margin=3)
    sync()
    margin3 = _launches()
    check(margin3 == {"fast_nms": 0, "orb_descriptors": len(frames),
                      "fast_score_map": len(frames)},
          f"margin-3 frontend over {len(frames)} frames launched {margin3}")

    eng = StereoVOEngine(cam, VOOptions(fast_th=20, n_feats=500, n_octaves=2), capacity=512,
                         device=DEV)
    results, ms = [], []
    _reset_launches()
    for left, right in frames:
        t0 = time.perf_counter()
        results.append(eng.process_stereo_pair(left, right))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    octaves = _launches()
    check(octaves == {"fast_nms": 2 * len(frames), "orb_descriptors": 2 * len(frames),
                      "fast_score_map": 0}, f"two-octave engine launched {octaves}")
    check(all(r.valid for r in results), "invalid VO frames at two octaves: "
          f"{[i for i, r in enumerate(results) if not r.valid]}")
    est = np.zeros(6)
    for r in results[1:]:
        est = se3_np.compose(est, se3_np.inverse(r.pose_increment.astype(np.float64)))
    t_err = float(np.linalg.norm(est[3:] - gt_poses[len(frames) - 1][3:]))
    path = float(np.sum(np.linalg.norm(np.diff(gt_poses[:len(frames), 3:], axis=0), axis=1)))
    check(t_err < 0.05 * path, f"two octaves: translation error {t_err} m over {path} m")
    n_oct1 = int((eng.last_frame().m_valid & (eng.last_frame().octave == 1)).sum())
    med = statistics.median(ms)
    print(f"[options engine] {len(frames)} frames 370x1226 at n_octaves=2 on CUDA: per-frame "
          f"median {med:.3f} ms, p95 {p95(ms):.3f} ms ({med / slice_ms:.3f}x phase 5's "
          f"{slice_ms:.3f} ms) | launches {octaves} | margin-3 frontend over the same frames: "
          f"launches {margin3} | stereo matches median "
          f"{int(np.median([r.num_stereo_matches for r in results]))} ({n_oct1} of the last "
          f"frame's at octave 1), tracked median "
          f"{int(np.median([r.tracked_from_last_frame for r in results[1:]]))} | translation "
          f"error at frame {len(frames)}: {t_err:.4f} m over {path:.2f} m")
    return {"margin3_frontend": margin3, "two_octave_engine": octaves}


def _kernel_line(imgs, thr, k: int = 512) -> str:
    """K1 at ``thr`` and K2 at the keypoints K1 gives on ``imgs`` [N, H,
    W] u8: each ``torch.equal`` to its plain version, then device-only
    (CUDA graph) beside its bytes bound and the launch floor at its grid."""
    n, h, w = imgs.shape
    scores = fast_nms(imgs, thr)
    check(torch.equal(scores, fast_nms_plain(imgs, thr)),
          f"K1 differs from its plain version at {tuple(imgs.shape)}")
    ys, xs, _sc, valid = grid_topk(scores, cell=5, k=k)
    desc = orb_descriptors(imgs, ys, xs, valid)
    check(torch.equal(desc, orb_descriptors_plain(imgs, ys, xs, valid)),
          f"K2 differs from its plain version at {tuple(imgs.shape)}")
    k1 = kt.graph_ms(lambda: fast_nms(imgs, thr))
    k2 = kt.graph_ms(lambda: orb_descriptors(imgs, ys, xs, valid))
    k1_floor = kt.launch_floor_ms(*hopper_fast.fast_nms_launch(n, h, w))
    _pts, _sup, k2_bytes, k2_ops = _orb_work(imgs, ys, xs, valid)
    k2_bound, k2_by = kt.bound_ms(k2_bytes, k2_ops)
    return (f"K1 {k1 * 1e3:.2f} us (bytes bound {_px_bound_us(imgs):.2f} us, launch floor "
            f"{k1_floor * 1e3:.2f} us at grid {hopper_fast.fast_nms_launch(n, h, w)[0]}, "
            f"{int((scores > 0).sum())} kept), K2 at K={k} ({int(valid.sum())} valid) "
            f"{k2 * 1e3:.2f} us (bound {k2_bound * 1e3:.3f} us by {k2_by}); both equal their "
            f"plain versions")


def phase_batched(frames, gt_poses, per_frame_s: float) -> tuple[dict, dict]:
    """Phase 10: the bench estimator through perform_stereo_slam_batched,
    with the strict solve schedule (the fingerprint's). Returns the
    launches and what phase 15 compares with: the keyframe poses and the
    total seconds."""
    fp = bw.load_fingerprint()
    scans = []
    scan = estimator_mod.vo_scan

    def counted_scan(lefts, *a, **k):
        scans.append(len(lefts))
        return scan(lefts, *a, **k)

    torch.use_deterministic_algorithms(True)
    est = bench_estimator(DEV, solve_sync=True)
    estimator_mod.vo_scan = counted_scan
    _reset_launches()
    caps, caps_s = _captures(), cuda_graphs.capture_stats("vo_scan")["capture_s"]
    try:
        with SyncCount() as syncs:
            check_syncs = _count_calls_syncs(est, "_kf_check", syncs)
            t0 = time.perf_counter()
            est.perform_stereo_slam_batched(frames, batch=BATCH)
            sync()
            wall = time.perf_counter() - t0
    finally:
        estimator_mod.vo_scan = scan
    counts = _launches()
    caps, caps_s = _captures() - caps, cuda_graphs.capture_stats("vo_scan")["capture_s"] - caps_s
    torch.use_deterministic_algorithms(False)
    n_batches = len(est.lat["batches"])
    # frame 0 bootstraps through step(): one VO pass; then K1 and K2 once a
    # scan's replay, and once more for each graph's capture (its warm-up)
    n = len(scans) + 1 + caps
    check(counts == {"fast_nms": n, "orb_descriptors": n, "fast_score_map": 0},
          f"batched run: launches {counts} over {len(scans)} scans, the bootstrap frame and "
          f"{caps} scan graph captures")
    got = bw.decisions(est.step_log)
    diff = [(a, b) for a, b in zip(fp["decisions"], got) if a != b]
    check(len(got) == len(frames) and not diff,
          f"batched decisions differ from the JAX fingerprint at {len(diff)} frames: {diff[:5]}")
    kf_frames = [r.frame_idx for r in est.step_log if r.inserted_kf is not None]
    est.finalize()
    strict_kf = est.rba.kf_global[:est.store.n_kfs].copy()
    final = est.final_poses_cam
    ate = ate_rmse(final[:, 3:], gt_poses[kf_frames][:, 3:], align=True)
    check(np.isfinite(final).all() and ate < ATE_GATE_M, f"batched: aligned ATE {ate} m")
    d_jax = np.abs(final - np.asarray(fp["final_poses_cam"]))
    imgs = torch.from_numpy(np.stack([f[0] for f in frames[1:1 + BATCH]]
                                     + [f[1] for f in frames[1:1 + BATCH]])).to(DEV)
    print(f"[batched] {len(frames)} frames 370x1226 on CUDA at batch {BATCH}, strict solve "
          f"schedule, deterministic "
          f"algorithms: total {wall:.3f} s, {len(frames) / wall:.2f} fps (phase 7 per-frame: "
          f"{per_frame_s:.3f} s, {len(frames) / per_frame_s:.2f} fps; ratio "
          f"{per_frame_s / wall:.3f}) | {n_batches} batches, {len(scans)} scan dispatches "
          f"(tails {[b for b in scans if b != BATCH]}), launches {counts}: K1 and K2 once per "
          f"scan replay + the bootstrap frame + {caps} captures' warm-ups | decisions equal "
          f"the JAX fingerprint (the JAX "
          f"package's batch-8 run makes the per-frame run's decisions, "
          f"tests/test_torch_bench_fingerprint.py) | {est.store.n_kfs} KFs, "
          f"{sum(r.kf_check for r in est.step_log)} checks | ATE {ate:.6f} m, final poses vs "
          f"JAX max {d_jax[:, :3].max():.2e} rad / {d_jax[:, 3:].max():.2e} m")
    print(f"[batched syncs] host syncs (torch sync debug warnings): {syncs.n} over "
          f"{len(frames)} frames ({syncs.n / len(frames):.2f} a frame, "
          f"{syncs.n / max(n_batches, 1):.2f} a batch); synchronous checks (miss replays) "
          f"{len(check_syncs)}, syncs inside each median {_med(check_syncs)}")
    print(f"[batched kernels] one scan's images [{2 * BATCH},370,1226] u8 at threshold 20: "
          + _kernel_line(imgs, 20.0))
    tails = sorted({b for b in scans if b != BATCH})
    print(f"[batched scan graphs] {caps} captured in the run ({caps_s:.3f} s of warm-up and "
          f"capture): {_graph_programs()} | "
          + _scan_ab(frames, BATCH) + " | a retry tail's length: "
          + _scan_ab(frames, tails[0] if tails else BATCH - 3))
    print(f"[batched check graphs] {_check_programs()}")
    return counts, dict(kf_global=strict_kf, wall=wall, syncs=syncs.n, batches=n_batches)


FLEET_KINDS = ("fleet_attempt", "fleet_check")


def _fleet_run(seqs, voc, mesh, graphs: bool) -> dict:
    """One ``FleetSLAM`` run over ``seqs`` on fresh bench estimators, each on
    its shard's device of ``mesh``, with the parallel layer's programs
    (``graphs``) or eagerly (``FLEET_GRAPHS`` off), under deterministic
    algorithms: its estimators, wall s, the pending count of each shard
    attempt, the attempts and check groups it recorded, K1-K3 launches,
    host syncs (all, and inside each check group with its read), and the
    programs captured in it (count and host s) by kind."""
    per = len(seqs) // len(mesh.devices)
    ests = []
    for i in range(len(seqs)):
        est = bench_estimator(mesh.devices[i // per])
        est.initialize(vocabulary=voc)
        ests.append(est)
    flt = fleet_mod.FleetSLAM(ests, mesh=mesh)
    rec, calls = fleet_launches.record_calls(flt)
    caps = {k: cuda_graphs.capture_stats(k) for k in FLEET_KINDS}
    keep, batch_mod.FLEET_GRAPHS = batch_mod.FLEET_GRAPHS, graphs
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    _reset_launches()
    try:
        with SyncCount() as syncs:
            query_syncs = _count_calls_syncs(flt, "_check_group", syncs)
            pull_syncs = _count_calls_syncs(flt, "_pull_group", syncs)
            t0 = time.perf_counter()
            flt.run(seqs)
            sync()
            wall = time.perf_counter() - t0
    finally:
        batch_mod.FLEET_GRAPHS = keep
        torch.use_deterministic_algorithms(deterministic)
    captured = {k: {n: cuda_graphs.capture_stats(k)[n] - caps[k][n]
                    for n in ("captures", "capture_s")} for k in FLEET_KINDS}
    return dict(ests=ests, wall=wall, sizes=[len(a[1]) for a in rec["attempts"]], rec=rec,
                calls=calls, launches=_launches(), syncs=syncs.n,
                check_syncs=[a + b for a, b in zip(query_syncs, pull_syncs)],
                captured=captured, capture_s=sum(c["capture_s"] for c in captured.values()))


def _same_fleet_runs(a: dict, b: dict, what: str) -> None:
    """Two fleet runs over the same sequences: every decision, step result,
    threshold, DA seed, keyframe store and BoW row, last frame and keyframe
    pose bit for bit."""
    for i, (x, y) in enumerate(zip(a["ests"], b["ests"])):
        same = (bw.decisions(x.step_log) == bw.decisions(y.step_log)
                and [(r.vo_valid, r.n_stereo_matches, r.tracked_from_last_kf)
                     for r in x.step_log] == [(r.vo_valid, r.n_stereo_matches,
                                               r.tracked_from_last_kf) for r in y.step_log]
                and (x.vo.fast_th, x.vo.orb_th, x._da_seed) == (y.vo.fast_th, y.vo.orb_th,
                                                                 y._da_seed)
                and x.store.n_kfs == y.store.n_kfs
                and np.array_equal(x.store.match_ids, y.store.match_ids)
                and all(torch.equal(p, q) for p, q in zip(x.store.arrays, y.store.arrays))
                and torch.equal(x.bow._db, y.bow._db)
                and all(torch.equal(p, q) for p, q in zip(x.vo.last_frame(),
                                                          y.vo.last_frame())))
        x.rba.flush(), y.rba.flush()
        n = x.store.n_kfs
        same = same and np.array_equal(x.rba.kf_global[:n], y.rba.kf_global[:n])
        check(same, f"{what}: sequence {i} differs")


def _fleet_programs() -> str:
    """The captured fleet programs by kind: count, host s of warm-up and
    capture (range), pool MB (range, and summed), MB held."""
    rows = []
    for kind in (*FLEET_KINDS, "batched_step"):
        ps = [p for p in cuda_graphs.programs() if p["key"][0] == kind]
        if ps:
            cap = [p["capture_s"] for p in ps]
            pool = [p["pool_bytes"] / 2**20 for p in ps]
            rows.append(f"{kind}: {len(ps)} captured, {min(cap):.3f}-{max(cap):.3f} s, pool "
                        f"{min(pool):.1f}-{max(pool):.1f} MB ({sum(pool):.1f} MB in all), "
                        f"holds {max(p['held_bytes'] for p in ps) / 1e6:.3f} MB at most")
    return "; ".join(rows) or "none"


def _fleet_launches() -> str:
    """The launches of one lockstep attempt (all four sequences pending),
    one check group (the largest of 8 frames) and one ``batched_vo_step``
    (a mesh of the card four times), eager against programs, under
    torch.profiler in a process of its own (``tools/fleet_launches.py``;
    this process traces no program: ROADMAP Queue 3). A program call of an
    attempt or a check group must launch no kernel and one graph; the
    batched step one graph a shard."""
    proc = subprocess.run([sys.executable, "-m", "srba_slam_tpu_torch.tools.fleet_launches",
                           "--seeds", ",".join(map(str, FLEET_SEEDS)),
                           "--frames", str(N_FLEET_LAUNCH_FRAMES)],
                          capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    check(proc.returncode == 0, f"the fleet-launches process exited with {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("attempt", "check"):
        check(got[f"{name} program"][:2] == [0, 1], f"a {name} program call launched "
              f"{got[f'{name} program'][0]} kernels and {got[f'{name} program'][1]} graphs")
    check(got["step program"][1] == got["shards"], f"a batched step launched "
          f"{got['step program'][1]} graphs over {got['shards']} shards")
    return (f"launches a call (kernel launches / graph launches / copies), torch.profiler in "
            f"a process of its own: an attempt of {got['attempt n']} sequences eager "
            f"{tuple(got['attempt eager'])}, program {tuple(got['attempt program'])}; a check "
            f"group of {got['check q']} eager {tuple(got['check eager'])}, program "
            f"{tuple(got['check program'])}; batched_vo_step over {got['shards']} shards of "
            f"the card eager {tuple(got['step eager'])}, programs "
            f"{tuple(got['step program'])} (its kernels the lead's gather and means)")


def phase_fleet(cam) -> tuple[dict, dict]:
    """Phase 11: FleetSLAM over four bench-workload street sequences on the
    card (a mesh of the one card) against each sequence's solo step() run,
    its lockstep attempts and check groups as CUDA-graph programs and
    eagerly (``FLEET_GRAPHS`` off) in turns, the same bits. Returns the
    launches of the first run with programs and what phase 14 reuses: the
    sequences, the vocabulary, that run and its frames/s."""
    seqs = [list(SyntheticSource(cam, n_frames=N_FLEET_FRAMES, seed=seed, step=bw.SOURCE["step"],
                                 scene=bw.SOURCE["scene"])) for seed in FLEET_SEEDS]
    torch.use_deterministic_algorithms(True)
    # one vocabulary for all: trained on a scratch estimator over sequence
    # 0's first voc_train_frames frames, as the CLI's --fleet does
    scratch = bench_estimator(DEV)
    for left, right in seqs[0][:max(1, scratch.opts.voc_train_frames)]:
        scratch.step(left, right)
    scratch.ensure_vocabulary()
    voc = scratch.bow.voc

    solo, solo_s = [], 0.0
    for frames in seqs:
        est = bench_estimator(DEV)
        est.initialize(vocabulary=voc)
        t0 = time.perf_counter()
        for left, right in frames:
            est.step(left, right)
        sync()
        solo_s += time.perf_counter() - t0
        solo.append(est)
    torch.use_deterministic_algorithms(False)
    mesh = make_mesh(devices=[DEV])
    runs = [_fleet_run(seqs, voc, mesh, graphs) for graphs in (True, False, False, True)]
    for r in runs[1:]:
        _same_fleet_runs(runs[0], r, "fleet programs against the eager fleet")
    n_seq = len(seqs)
    for r, graphs in zip(runs, (True, False, False, True)):
        # the first frame bootstraps each sequence through step(); then one
        # K1 and one K2 launch per lockstep attempt over all pending
        # sequences (a replay of its program: one more for each program's
        # warm-up)
        n = len(r["sizes"]) + n_seq + r["captured"]["fleet_attempt"]["captures"]
        check(r["launches"] == {"fast_nms": n, "orb_descriptors": n, "fast_score_map": 0},
              f"fleet ({'programs' if graphs else 'eager'}): launches {r['launches']} over "
              f"{len(r['sizes'])} lockstep attempts")
        check(graphs or r["capture_s"] == 0, "the eager fleet captured a program")
        # one check program a group size on the one card
        check(r["captured"]["fleet_check"]["captures"] <= n_seq,
              f"{r['captured']['fleet_check']['captures']} check programs for {n_seq} sequences")
    check(len(runs[0]["sizes"]) >= N_FLEET_FRAMES - 1, f"{len(runs[0]['sizes'])} attempts")
    worst_rad = worst_m = 0.0
    kfs = []
    for i, (f, s) in enumerate(zip(runs[0]["ests"], solo)):
        check(bw.decisions(f.step_log) == bw.decisions(s.step_log),
              f"fleet sequence {i} (seed {FLEET_SEEDS[i]}): decisions differ from its solo run")
        n = s.store.n_kfs
        check(f.store.n_kfs == n >= 2, f"sequence {i}: {f.store.n_kfs} vs {n} keyframes")
        s.rba.flush()
        d = np.abs(f.rba.kf_global[:n] - s.rba.kf_global[:n])
        worst_rad, worst_m = max(worst_rad, d[:, :3].max()), max(worst_m, d[:, 3:].max())
        kfs.append(n)
    check(worst_rad <= POSE_TOL_RAD and worst_m <= POSE_TOL_M,
          f"fleet keyframe poses differ from the solo runs by {worst_rad} rad / {worst_m} m")
    n_frames = n_seq * N_FLEET_FRAMES
    fps = [n_frames / r["wall"] for r in runs]
    first = runs[0]
    print(f"[fleet] {n_seq} street sequences (seeds {FLEET_SEEDS}) x {N_FLEET_FRAMES} frames "
          f"370x1226 on CUDA, one vocabulary, deterministic algorithms, in turns programs / "
          f"eager / eager / programs: {' / '.join('%.3f' % r['wall'] for r in runs)} s, "
          f"{' / '.join('%.2f' % x for x in fps)} frames/s aggregate (the programs' runs "
          f"without their captures, {runs[0]['capture_s']:.3f} / {runs[3]['capture_s']:.3f} s: "
          f"{n_frames / (runs[0]['wall'] - runs[0]['capture_s']):.2f} / "
          f"{n_frames / (runs[3]['wall'] - runs[3]['capture_s']):.2f}; the four solo runs "
          f"{solo_s:.3f} s, {n_frames / solo_s:.2f} frames/s) | programs = eager bit for bit "
          f"(decisions, step results, store and BoW rows, keyframe poses) in all four runs | "
          f"{len(first['sizes'])} lockstep attempts, launches {first['launches']}: K1 and K2 "
          f"once per attempt + one bootstrap frame a sequence + "
          f"{first['captured']['fleet_attempt']['captures']} program warm-ups | every "
          f"sequence's decisions equal its solo run; keyframes {kfs}; KF poses within "
          f"{worst_rad:.2e} rad / {worst_m:.2e} m")
    n_checks = sum(r.kf_check for e in first["ests"] for r in e.step_log)
    print(f"[fleet syncs] host syncs (torch sync debug warnings), programs / eager: "
          f"{first['syncs']} / {runs[1]['syncs']} over {n_frames} frames "
          f"({first['syncs'] / N_FLEET_FRAMES:.2f} / {runs[1]['syncs'] / N_FLEET_FRAMES:.2f} "
          f"a lockstep step); {len(first['check_syncs'])} check groups for {n_checks} "
          f"sequence checks, syncs inside each (query, cascade, one copy out) median "
          f"{_med(first['check_syncs'])} / {_med(runs[1]['check_syncs'])}, max "
          f"{max(first['check_syncs'], default=0)} / {max(runs[1]['check_syncs'], default=0)}")
    # one attempt with all four pending and the largest check group of the
    # last run, as programs against eager calls on the same state, in turns
    attempt, check_group = runs[3]["calls"]
    a_args = next(a for a in runs[3]["rec"]["attempts"] if len(a[1]) == n_seq)
    c_args = max(runs[3]["rec"]["checks"], key=lambda c: len(c[2]))
    rows = []
    for name, fn in ((f"attempt of {n_seq}", lambda: attempt(*a_args)[1:]),
                     (f"check group of {len(c_args[2])}", lambda: check_group(*c_args))):
        eager = _flag_off(batch_mod, "FLEET_GRAPHS", fn)
        same = all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(fn()),
                                                      pytree.tree_leaves(eager())))
        check(same, f"the fleet's {name}: the program differs from the eager call")
        med = _dispatch_done(fn, eager)
        rows.append(f"{name}: program = eager bit for bit | dispatch / done ms, medians in "
                    f"turns: eager {med['eager'][0]:.3f} / {med['eager'][1]:.3f}, program "
                    f"{med['graph'][0]:.3f} / {med['graph'][1]:.3f}")
    print("[fleet programs] " + " || ".join(rows) + f" | programs: {_fleet_programs()} | "
          + _fleet_launches())
    first_frames = [s[1] for s in seqs]
    imgs = torch.from_numpy(np.stack([f[0] for f in first_frames]
                                     + [f[1] for f in first_frames])).to(DEV)
    thr = torch.tensor([20.0, 15.0, 10.0, 5.0] * 2, device=DEV)
    print(f"[fleet kernels] one lockstep frontend's images [{2 * n_seq},370,1226] u8 at "
          f"per-image thresholds {[float(t) for t in thr]}: " + _kernel_line(imgs, thr))
    return first["launches"], dict(seqs=seqs, voc=voc, solo=solo, run=first, fps=fps[0],
                                   wall=first["wall"], attempts=len(first["sizes"]))


def _host_ms(fn, reps: int = CHECK_REPS) -> tuple[float, float]:
    """Median and max over ``reps`` calls of ``fn`` of host ms, each call
    ending in a synchronize (after one warm-up call)."""
    fn()
    sync()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), max(ms)


def _schedule_counts(fn) -> dict:
    """One call of ``fn``: kernel launches and cudaStreamSynchronize calls
    under torch.profiler with CUDA activity only (``fn`` may launch loops
    with conditional nodes: no CPU activity over those, ROADMAP Queue 3),
    and the host syncs torch reports."""
    evs = kt.profile_calls(fn, cuda_only=True)
    with SyncCount() as syncs:
        fn()
    sync()
    return {"launches": kt.launch_count(evs), "syncs": syncs.n,
            "graphs": sum(e.count for e in evs if e.key == "cudaGraphLaunch"),
            "stream_syncs": sum(e.count for e in evs if e.key == "cudaStreamSynchronize")}


def _serial_check(rec):
    """The check as the port scheduled it before its candidates became
    lanes: the BoW query, then the five candidates one after another, each
    a one-lane cascade with its own key (the same code, L = 1)."""
    kw = rec["kw"]
    cur = vo_mod.FrameFeatures(*(a[None] for a in rec["frame"]))
    top_s, top_i, cand, cand_valid = da_mod.bow_candidates(
        cur, rec["db"][None], rec["leaf_bits"], rec["weights"], rec["n_kfs"])
    keys = prng.split(rec["key"], cand.shape[1])
    others = [a[cand[0].long()] for a in rec["arrays"]]
    init = torch.zeros((1, 6), dtype=torch.float32, device=DEV)
    lanes = [da_mod._da_single(
        cur, tuple(a[j:j + 1] for a in others), cand_valid[0, j:j + 1], init, rec["cam"],
        keys[j:j + 1], kw["max_orb_distance_da"], kw["residual_th"],
        kw["max_y_diff_epipolar"], kw["filter_by_direction"], kw["use_fund_matrix"],
        kw["use_change_pose"], kw["kernel_param"],
        filter_by_orb_distance=kw["filter_by_orb_distance"], ransac_n_hyp=kw["ransac_n_hyp"])
        for j in range(cand.shape[1])]
    (status, oidx, tracked, pose, pose_ok, mean_res, raw, bd,
     res) = (torch.cat(parts) for parts in zip(*lanes))
    valid = cand_valid[0]
    return top_s[0], top_i[0], cand[0], da_mod.DAResult(
        status, oidx, torch.where(valid, tracked, 0), pose, pose_ok & valid, mean_res, raw,
        bd, res)


def _batched_check(rec):
    return da_mod.query_and_associate(rec["frame"], rec["arrays"], rec["db"], rec["leaf_bits"],
                                      rec["weights"], rec["n_kfs"], rec["cam"], rec["key"],
                                      **rec["kw"])


def _capture_args(module, name: str, fn) -> list:
    """The positional and keyword arguments of every call of
    ``module.name`` while ``fn`` runs."""
    calls, run = [], getattr(module, name)

    def capturing(*a, **k):
        calls.append((a, k))
        return run(*a, **k)

    setattr(module, name, capturing)
    try:
        fn()
    finally:
        setattr(module, name, run)
    return calls


def _same_solve(a, b) -> float:
    """Largest pose difference of two PoseSolveResults whose integer and
    boolean fields are equal."""
    for name in ("inliers", "num_inliers", "iters", "valid"):
        check(torch.equal(getattr(a, name), getattr(b, name)),
              f"solve_pose L=5 and five L=1 calls differ in {name}")
    return float((a.pose - b.pose).abs().max())


def _exit_period_ms(fn) -> dict:
    """``fn``'s host ms (median) at each period of the GN exit test."""
    keep, out = robust_lm.GN_EXIT_EVERY, {}
    try:
        for e in EXIT_PERIODS:
            robust_lm.GN_EXIT_EVERY = e
            out[e] = round(_host_ms(fn)[0], 3)
    finally:
        robust_lm.GN_EXIT_EVERY = keep
    return out


def _flag_off(module, name: str, fn):
    """``fn`` with ``module.name`` (a graphs flag) set False."""
    def run():
        keep = getattr(module, name)
        setattr(module, name, False)
        try:
            return fn()
        finally:
            setattr(module, name, keep)
    return run


def _in_turns(fn_a, fn_b, reps: int = CHECK_REPS) -> tuple[float, float]:
    """Host ms medians of two functions timed in turns (a, b, b, a)."""
    a1, b1, b2, a2 = (_host_ms(f, reps)[0] for f in (fn_a, fn_b, fn_b, fn_a))
    return statistics.median([a1, a2]), statistics.median([b1, b2])


_CHECK_REC = ("frame", "arrays", "db", "leaf_bits", "weights", "n_kfs", "cam", "seed", "kw")


def _group_fns(g: dict, restore: bool = True):
    """A fused check group ``g`` (``fused_checks_batch``'s arguments by
    name, the options as ``kw``) as slot programs (the default) and eagerly
    (``da_mod.CHECK_GRAPHS`` off), each route on a copy of its store and
    database of its own, with ``restore`` set back in place before each
    call (the same tensors: the same program key). Returns ((graph,
    eager), the routes' copies, the snapshot)."""
    snap = [t.clone() for t in list(g["arrays"]) + [g["db"]]]
    parts = {route: [t.clone() for t in snap] for route in ("graph", "eager")}

    def on(route):
        def call():
            held = parts[route]
            for a, b in zip(held, snap if restore else ()):
                a.copy_(b)
            return da_mod.fused_checks_batch(
                g["feats"], type(g["arrays"])(*held[:-1]), held[-1], g["leaf_bits"],
                g["weights"], g["js"], g["rows"], g["valids"], g["cam"], g["seeds"], **g["kw"])[0]
        return call

    return (on("graph"), _flag_off(da_mod, "CHECK_GRAPHS", on("eager"))), parts, snap


def _check_fns(rec, restore: bool = True):
    """Phase 12's check as programs and eagerly: the one-check path on the
    check's inputs, and a fused group of three slots (the check's frame
    written at rows n_kfs .. n_kfs + 2, seeds seed .. seed + 2, five padded
    slots, :func:`_group_fns`). Returns ((one_graph, one_eager),
    (group_graph, group_eager), the group routes' stores and databases)."""
    kw, n = dict(rec["kw"]), rec["n_kfs"]
    check(n + 3 <= rec["arrays"].desc_l.shape[0], f"no room for 3 rows after {n}")
    one_args = (rec["frame"], rec["arrays"], rec["db"], rec["leaf_bits"], rec["weights"], n,
                rec["cam"], rec["seed"])

    def one():
        return da_mod.query_and_associate_packed(*one_args, **kw)[0]

    pad = da_mod.CHECK_SLOTS - 3
    group, parts, _snap = _group_fns(dict(
        feats=vo_mod.stack_features([rec["frame"]] * 3), arrays=rec["arrays"], db=rec["db"],
        leaf_bits=rec["leaf_bits"], weights=rec["weights"], js=[0, 1, 2] + [0] * pad,
        rows=[n, n + 1, n + 2] + [0] * pad, valids=[True] * 3 + [False] * pad, cam=rec["cam"],
        seeds=[rec["seed"] + i for i in range(3)] + [rec["seed"]] * pad, kw=kw), restore)
    return (one, _flag_off(da_mod, "CHECK_GRAPHS", one)), group, parts


def check_launches_child(path: str) -> None:
    """:func:`_check_launches`' process: phase 12's check inputs saved at
    ``path``; the eager check and group traced before the programs. Prints
    one JSON object: per call, kernel launches, graph launches and copies."""
    rec = torch.load(path, weights_only=False)
    (one_g, one_e), (grp_g, grp_e), _parts = _check_fns(rec, restore=False)
    got = {name: _scan_launch_counts(fn) for name, fn in (("one eager", one_e),
                                                          ("group eager", grp_e),
                                                          ("one graph", one_g),
                                                          ("group graph", grp_g))}
    print(json.dumps(dict(got, captures=_captures("check"))))


def _check_launches(rec) -> str:
    """The launches of one check, eager against its program: the kernel
    launches, graph launches and copies the host issues in one call under
    torch.profiler (CPU and CUDA activity), in a process of its own, as
    :func:`phase_scan_launches` (this process traces no conditional-node
    graph: ROADMAP Queue 3). A program call must launch no kernel and one
    graph; the group of three, three graphs."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "check.pt")
        torch.save({k: rec[k] for k in _CHECK_REC}, path)
        code = f"import chip_smoke; chip_smoke.check_launches_child({path!r})"
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    check(proc.returncode == 0, f"the check-launches process exited with {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    check(got["one graph"][:2] == [0, 1], f"a one-check program call launched "
          f"{got['one graph'][0]} kernels and {got['one graph'][1]} graphs")
    check(got["group graph"][:2] == [0, 3], f"a group of three slot programs launched "
          f"{got['group graph'][0]} kernels and {got['group graph'][1]} graphs")
    per = {k: [c / (3 if k.startswith("group") else 1) for c in v] for k, v in got.items()
           if k != "captures"}
    return ("launches a check (kernel launches / graph launches / copies; a call in "
            "brackets), torch.profiler in a process of its own: " + "; ".join(
                f"{k} {'/'.join(f'{c:.2f}' for c in per[k])} {tuple(got[k])}" for k in per)
            + f" | {got['captures']} check programs captured there")


def _check_ab(rec) -> None:
    """Phase 12's check as CUDA-graph programs against the eager check
    (:func:`_check_fns`): every output equal bit for bit (the blobs, and
    for the group the written store and database); the first program call
    (its capture); in turns (eager, graph, graph, eager; 5 calls each) the
    host ms until the call returns (the dispatch) and until the card is
    done, medians; the programs' capture s, pool MB and the bytes they copy
    and hold; the launches a check (:func:`_check_launches`)."""
    (one_g, one_e), (grp_g, grp_e), parts = _check_fns(rec)
    rows = []
    for name, graph, eager in (("one-check", one_g, one_e), ("group of 3", grp_g, grp_e)):
        caps = _captures("check")
        t0 = time.perf_counter()
        out_g = graph()
        sync()
        first_s = time.perf_counter() - t0
        out_e = eager()
        leaves_g, leaves_e = pytree.tree_leaves(out_g), pytree.tree_leaves(out_e)
        same = len(leaves_g) == len(leaves_e) and all(torch.equal(x, y)
                                                      for x, y in zip(leaves_g, leaves_e))
        if name != "one-check":
            same = same and all(torch.equal(x, y) for x, y in zip(parts["graph"],
                                                                   parts["eager"]))
        check(same, f"phase 12's {name}: the program differs from the eager check")
        med = _dispatch_done(graph, eager)
        rows.append(f"{name}: program = eager bit for bit ({len(leaves_g)} blobs"
                    + (", the store and the database" if name != "one-check" else "")
                    + f") | first program call {first_s:.3f} s ({_captures('check') - caps} "
                    f"captured) | dispatch / done ms, medians in turns: eager "
                    f"{med['eager'][0]:.3f} / {med['eager'][1]:.3f}, program "
                    f"{med['graph'][0]:.3f} / {med['graph'][1]:.3f}")
    print(f"[check program] the check of frame {rec['frame_idx']} as CUDA-graph programs "
          f"against CHECK_GRAPHS off: " + " || ".join(rows) + f" | programs: "
          f"{_check_programs()} | " + _check_launches(rec))


def phase_check(cam, frames, rec) -> None:
    """Phase 12: one keyframe check of phase 7's run with five valid
    candidates, as one batch of five lanes against the schedule before it
    (five one-lane cascades), in this call, under deterministic algorithms;
    the check's split between its stages; solve_pose at L = 5 against five
    L = 1 calls, and at each period of its exit test."""
    torch.use_deterministic_algorithms(True)
    batched, serial = (lambda: _batched_check(rec)), (lambda: _serial_check(rec))
    a, b = batched(), serial()
    for x, y, name in zip(a[:3], b[:3], ("scores", "ids", "candidates")):
        check(torch.equal(x, y), f"the two schedules' {name} differ")
    for name in ("status", "other_idx", "tracked_count", "pose_valid", "raw_oidx"):
        check(torch.equal(getattr(a[3], name), getattr(b[3], name)),
              f"the two schedules' {name} differ")
    ok = a[3].pose_valid
    d_pose = float((a[3].pose - b[3].pose)[ok].abs().max()) if bool(ok.any()) else 0.0
    check(d_pose <= POSE_TOL_RAD, f"the two schedules' poses differ by {d_pose}")
    t_a, t_b = _host_ms(batched), _host_ms(serial)
    c_a, c_b = _schedule_counts(batched), _schedule_counts(serial)

    # the stages of the batched check, each called alone on its inputs
    stages = {}
    for name in ("bow_candidates", "ransac_fundamental", "_horn_seed", "solve_pose"):
        (args, kwargs), = _capture_args(da_mod, name, batched)
        stages[name] = (args, kwargs, _host_ms(lambda: getattr(da_mod, name)(*args, **kwargs)),
                        _schedule_counts(lambda: getattr(da_mod, name)(*args, **kwargs)))
    args, kwargs = stages["solve_pose"][:2]

    def one_lane_solves():
        return [da_mod.solve_pose(*(x[j:j + 1] for x in args[:3]), args[3],
                                  **dict(kwargs, initial_pose=kwargs["initial_pose"][j:j + 1]))
                for j in range(args[0].shape[0])]

    five = da_mod.solve_pose(*args, **kwargs)
    ones = robust_lm.PoseSolveResult(*(torch.cat(p) for p in zip(*one_lane_solves())))
    d_solve = _same_solve(five, ones)
    t_ones = _host_ms(one_lane_solves)
    da_periods = _exit_period_ms(lambda: da_mod.solve_pose(*args, **kwargs))

    # a VO pose solve (30/30 iterations, one lane) of the bench frames 40-41
    eng = StereoVOEngine(cam, VOOptions(fast_th=20, n_feats=500), capacity=512, device=DEV)
    eng.process_stereo_pair(*frames[40])
    ((vargs, vkw),) = _capture_args(vo_mod, "solve_pose",
                                    lambda: eng.process_stereo_pair(*frames[41]))
    vo_iters = int(vo_mod.solve_pose(*vargs, **vkw).iters)
    vo_periods = _exit_period_ms(lambda: vo_mod.solve_pose(*vargs, **vkw))

    # the GN blocks as CUDA graphs (the default) against eager blocks
    e = _flag_off(robust_lm, "GN_GRAPHS", batched)()
    for name, x, y in zip(a[3]._fields, a[3], e[3]):
        check(torch.equal(x, y), f"the check's {name} differs between graph and eager blocks")
    da_solve = (lambda: da_mod.solve_pose(*args, **kwargs))
    vo_solve = (lambda: vo_mod.solve_pose(*vargs, **vkw))
    for fn in (da_solve, vo_solve):
        for name, x, y in zip(robust_lm.PoseSolveResult._fields, fn(),
                              _flag_off(robust_lm, "GN_GRAPHS", fn)()):
            check(torch.equal(x, y), f"solve_pose's {name} differs between graph and eager")
    turns = {name: _in_turns(_flag_off(robust_lm, "GN_GRAPHS", fn), fn) for name, fn in
             (("check", batched), ("da_solve", da_solve), ("vo_solve", vo_solve))}
    c_e = _schedule_counts(_flag_off(robust_lm, "GN_GRAPHS", batched))
    torch.use_deterministic_algorithms(False)

    def fmt(t, c):
        return (f"median {t[0]:.3f} ms, max {t[1]:.3f} ms ({CHECK_REPS} calls), "
                f"{c['launches']} kernel launches and {c['graphs']} graph launches, "
                f"{c['syncs']} host syncs ({c['stream_syncs']} cudaStreamSynchronize)")

    what = (f"loop closure with KF {rec['lc']}" if rec["lc"] is not None
            else "no loop closure; the first check with five valid candidates")
    print(f"[check] the keyframe check of frame {rec['frame_idx']} of phase 7 ({what}; "
          f"{rec['n_kfs']} KFs stored), deterministic algorithms | five candidates as one "
          f"batch (query_and_associate): {fmt(t_a, c_a)} | five one-lane cascades in turn "
          f"(the schedule before): {fmt(t_b, c_b)} | batch / serial median "
          f"{t_a[0] / t_b[0]:.3f} | equal outputs: scores, candidates, status, other_idx, "
          f"tracked {a[3].tracked_count.tolist()}, pose validity; poses within {d_pose:.2e}")
    print("[check stages] each stage of the batched check alone, on its inputs: "
          + "; ".join(f"{name} {t[0]:.3f} ms ({c['launches']} kernel and {c['graphs']} graph "
                      f"launches, {c['syncs']} syncs)"
                      for name, (_a, _k, t, c) in stages.items())
          + f" | the rest (Hamming matching, filters 1-2, gathers, the depth gate) "
          f"{t_a[0] - sum(v[2][0] for v in stages.values()):.3f} ms of the check's "
          f"{t_a[0]:.3f}")
    print(f"[solve] the check's GN solve (12/12 iterations): L = 5 one call "
          f"{stages['solve_pose'][2][0]:.3f} ms against five L = 1 calls {t_ones[0]:.3f} ms "
          f"(equal inliers, iters and validity, poses within {d_solve:.2e}); median ms by "
          f"exit-test period E (GN_EXIT_EVERY {robust_lm.GN_EXIT_EVERY}): L = 5 {da_periods}; "
          f"a VO solve of frames 40-41 (L = 1, 30/30, {vo_iters} stage-2 iterations) "
          f"{vo_periods}")
    print("[graphs] GN blocks replayed as CUDA graphs (GN_GRAPHS, the default) against eager "
          "blocks, in turns (eager, graph, graph, eager), median ms: "
          + "; ".join(f"{name} eager {ms_e:.3f}, graphs {ms_g:.3f} ({ms_g / ms_e:.3f}x)"
                      for name, (ms_e, ms_g) in turns.items())
          + f" | the check eagerly: {c_e['launches']} launches, {c_e['syncs']} host syncs "
          f"({c_e['stream_syncs']} cudaStreamSynchronize) | outputs equal bit for bit")
    torch.use_deterministic_algorithms(True)
    _check_ab(rec)
    torch.use_deterministic_algorithms(False)



def _split_run(frames):
    """The bench estimator over ``frames`` (the strict solve schedule: each
    window a group of one, landed at its insertion; the group solved on
    its eager route, ``WBA_GROUP_PROGRAMS`` off, so that its parts run from
    the host) with each part of an insertion timed on the host clock,
    synchronized before and after the part, and every window solve
    recorded. ``assembly_plan`` builds a window's gather tables on the host
    (``window_ba.packed_plan_arrays``), ``upload`` is the group's one
    pinned copy (``window_ba.group_upload``), ``copy_out`` the group's read
    at its commit."""
    est = bench_estimator(DEV, solve_sync=True)
    rba = est.rba
    parts = {name: [] for name in INSERTION_PARTS}
    solves, entries = [], []

    def timing(fn, name, keep=lambda a: True):
        def wrapped(*a, **k):
            if not keep(a):
                return fn(*a, **k)
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            parts[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    run_dispatch, run_opt = rba._dispatch_queued, srba_mod.optimize_window
    run_plan, run_upload = window_ba.packed_plan_arrays, window_ba.group_upload
    run_host = srba_mod.to_host

    def dispatch():
        entries.extend(q["entry"] for q in rba._queued)
        return run_dispatch()

    def copy_out(tensors):
        sync()
        t0 = time.perf_counter()
        out = run_host(tensors)
        parts["copy_out"].append((time.perf_counter() - t0) * 1e3)
        return out

    def opt(win, cam, **kw):
        sync()
        t0 = time.perf_counter()
        out = run_opt(win, cam, **kw)
        sync()
        parts["optimize_window"].append((time.perf_counter() - t0) * 1e3)
        solves.append((win, cam, kw))
        return out

    rba._dispatch_queued = dispatch
    srba_mod.optimize_window, srba_mod.to_host = opt, copy_out
    window_ba.packed_plan_arrays = timing(run_plan, "assembly_plan")
    window_ba.group_upload = timing(run_upload, "upload")
    rba.define_new_keyframe = timing(rba.define_new_keyframe, "define_new_keyframe")
    rba._commit_one = timing(rba._commit_one, "_commit_one")
    rba.spanning_tree = timing(rba.spanning_tree, "spanning_tree(0)", lambda a: a[0] == 0)
    rba.on_commit = timing(rba.on_commit, "on_commit")
    bow_cls, store_cls = estimator_mod.BoWDatabase, estimator_mod.KeyframeStore
    run_insert, run_append = bow_cls.insert, store_cls.append
    bow_cls.insert = timing(run_insert, "bow.insert")     # the database is made at frame 0
    store_cls.append = timing(run_append, "store.append")
    keep_programs, window_ba.WBA_GROUP_PROGRAMS = window_ba.WBA_GROUP_PROGRAMS, False
    try:
        for left, right in frames:
            est.step(left, right)
    finally:
        window_ba.WBA_GROUP_PROGRAMS = keep_programs
        srba_mod.optimize_window, srba_mod.to_host = run_opt, run_host
        window_ba.packed_plan_arrays, window_ba.group_upload = run_plan, run_upload
        bow_cls.insert, store_cls.append = run_insert, run_append
    n_ins = sum(r.inserted_kf not in (None, 0) for r in est.step_log)
    return est, parts, solves, entries, n_ins, run_opt


def _window_shape(win) -> tuple:
    return (win.cam_pose.shape[0], win.lm_pos.shape[0], win.obs_px.shape[0])


def _pg_inputs(args):
    poses, node_valid, eu, ev, rel, edge_valid = args
    n = poses.shape[0]
    free = node_valid & (torch.arange(n, device=poses.device) != 0)
    return (poses, eu.long(), ev.long(), rel, edge_valid.to(torch.float32),
            free[:, None].to(torch.float32), torch.repeat_interleave(free, 6))


def _dense_pose_graph(args, max_iters: int, init_lambda: float = 1e-4):
    """The pose graph as the port ran it before its Jacobian went per edge:
    each iteration the dense ``[6E, 6N]`` Jacobian (``posegraph.dense_jacobian``),
    ``J.T @ J``, the Cholesky, eagerly."""
    poses, eu, ev, rel, w, freef, free6 = _pg_inputs(args)
    eye = torch.eye(free6.shape[0], dtype=torch.float32, device=poses.device)

    def cost_of(q):
        r = posegraph._residuals(q, eu, ev, rel, w)
        return torch.sum(r * r)

    cost = cost_of(poses)
    lam = torch.tensor(init_lambda, dtype=torch.float32, device=poses.device)
    for _ in range(max_iters):
        J = posegraph.dense_jacobian(poses, eu, ev, rel, w, freef)
        r0 = posegraph._residuals(poses, eu, ev, rel, w).reshape(-1)
        H = J.T @ J
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
        H = torch.where(free6[:, None] & free6[None, :], H, 0.0)
        H = H + torch.diag(torch.where(free6, 0.0, 1.0))
        g = torch.where(free6, J.T @ r0, 0.0)
        L, info = torch.linalg.cholesky_ex(H)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = torch.all(torch.isfinite(delta)) & (info == 0)
        new = posegraph._apply_delta(poses, torch.where(ok, delta, 0.0).reshape(-1, 6) * freef)
        new_cost = cost_of(new)
        accept = ok & (new_cost < cost)
        poses = torch.where(accept, new, poses)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9), torch.clamp(lam * 8.0, max=1e4))
    return poses, cost


def _iteration_split(args) -> dict:
    """Device ms (CUDA events) of the parts of one pose-graph iteration:
    the dense Jacobian and ``J.T @ J`` (the form before), the per-edge
    Jacobian and the normal equations summed from its blocks (the form
    now), and the Cholesky with its two triangular solves."""
    poses, eu, ev, rel, w, freef, free6 = _pg_inputs(args)
    J = posegraph.dense_jacobian(poses, eu, ev, rel, w, freef)
    H = torch.where(free6[:, None] & free6[None, :], J.T @ J, 0.0) \
        + torch.diag(torch.where(free6, 1e-9, 1.0))
    g = torch.where(free6, J.T @ posegraph._residuals(poses, eu, ev, rel, w).reshape(-1), 0.0)
    seen, run = [], posegraph._normal_equations
    posegraph._normal_equations = lambda k, q: (seen.append(k), run(k, q))[1]
    try:
        _flag_off(posegraph, "PG_PROGRAM", _flag_off(
            posegraph, "PG_GRAPHS", lambda: posegraph.optimize_pose_graph(*args, max_iters=1)))()
    finally:
        posegraph._normal_equations = run
    return {"dense jacobian": cuda_ms(lambda: posegraph.dense_jacobian(poses, eu, ev, rel, w,
                                                                       freef), reps=5),
            "J.T @ J": cuda_ms(lambda: J.T @ J, reps=5),
            "edge jacobian": cuda_ms(lambda: posegraph._edge_jacobian(poses, eu, ev, rel, w,
                                                                      freef), reps=5),
            "normal equations": cuda_ms(lambda: run(seen[0], poses), reps=5),
            "cholesky + solve": cuda_ms(lambda: cuda_graphs.cholesky_solve(
                torch.linalg.cholesky_ex(H)[0], g), reps=5),
            "J": tuple(J.shape)}


def _one_call(fn) -> tuple[float, object]:
    """Host ms of one call of ``fn`` (synchronized), and its output."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def _solve_all(run_opt, solves):
    return [run_opt(win, cam, **kw) for win, cam, kw in solves]


def _counts(c) -> str:
    return (f"{c['launches']} kernel and {c['graphs']} graph launches, {c['syncs']} host "
            f"syncs ({c['stream_syncs']} cudaStreamSynchronize)")


def phase_insertion(frames, pg_call) -> tuple[list, srba_mod.SRBAEngine]:
    """Phase 13: where an insertion's and the epilogue's time goes. The
    bench estimator of phase 7 again over the 81 frames, each part of an
    insertion timed alone (synchronized around it); every window solve
    recorded and solved again: whole, and with ``max_iters=0`` (the
    pose-only stage 1 and the cost reads) to split the two LM stages; the
    LM blocks as CUDA graphs (``WBA_GRAPHS``, the default) against eager
    blocks, equal bit for bit, timed in turns on the largest window of each
    bucket; by exit period; the kernel
    launches and host syncs of one window solve. The pose graph of phase
    7's ``finalize``: its first call (phase 7) against later calls on the
    same inputs; its graph replays against eager iterations (equal bit for
    bit) and against the dense-``jacfwd`` loop it replaced (poses within
    1e-3 rad / m, the parity tolerance against JAX), in turns; one
    iteration split in its parts; the launches and syncs of one call.
    Returns the run's window solves (``SRBAEngine._solve``'s entries) and
    its engine, for phase 14."""
    torch.use_deterministic_algorithms(True)
    est, parts, solves, entries, n_ins, run_opt = _split_run(frames)
    fp = bw.load_fingerprint()
    check(bw.decisions(est.step_log) == fp["decisions"],
          "phase 13's run made other decisions than the JAX fingerprint")
    n_solve = len(solves)
    split = "; ".join(f"{name} {_med(v)} ms ({len(v)}x, {sum(v) / max(n_ins, 1):.3f} ms an "
                      f"insertion)" for name, v in parts.items())
    insertion_ms = [r.define_kf_ms for r in est.step_log if r.inserted_kf not in (None, 0)]
    print(f"[insertion] {n_ins} insertions, {n_solve} window solves, define_kf_ms median "
          f"{_med(insertion_ms)} under the timers | per part, median ms a call (calls, ms an "
          f"insertion): {split}")

    full, stage1 = [], []
    for win, cam, kw in solves:
        full.append(_host_ms(lambda: run_opt(win, cam, **kw), SPLIT_REPS)[0])
        stage1.append(_host_ms(lambda: run_opt(win, cam, **dict(kw, max_iters=0)),
                               SPLIT_REPS)[0])
    stage2 = [a - b for a, b in zip(full, stage1)]
    shapes = [_window_shape(w) for w, _c, _k in solves]
    graphs = _solve_all(run_opt, solves)
    eager = _flag_off(window_ba, "WBA_GRAPHS", lambda: _solve_all(run_opt, solves))()
    for i, (a, b) in enumerate(zip(graphs, eager)):
        for name, x, y in zip(a._fields, a, b):
            check(torch.equal(x, y), f"window {i} {shapes[i]}: {name} differs between graph "
                                     f"and eager LM blocks")
    # timed on the largest window of each bucket (eager blocks take ~0.4 s)
    per_bucket = [solves[max((i for i in range(n_solve) if shapes[i] == b),
                             key=lambda i: solves[i][0].obs_valid.sum().item())]
                  for b in sorted(set(shapes))]
    ms_e, ms_g = _in_turns(_flag_off(window_ba, "WBA_GRAPHS",
                                     lambda: _solve_all(run_opt, per_bucket)),
                           lambda: _solve_all(run_opt, per_bucket), SPLIT_REPS)
    keep, periods = window_ba.WBA_EXIT_EVERY, {}
    try:
        for e in (1, 2, 4, 8):
            window_ba.WBA_EXIT_EVERY = e
            periods[e] = round(_host_ms(lambda: _solve_all(run_opt, solves), SPLIT_REPS)[0], 3)
    finally:
        window_ba.WBA_EXIT_EVERY = keep
    big = max(range(n_solve), key=lambda i: np.prod(shapes[i]))
    win, cam, kw = solves[big]
    c_g = _schedule_counts(lambda: run_opt(win, cam, **kw))
    c_e = _schedule_counts(_flag_off(window_ba, "WBA_GRAPHS", lambda: run_opt(win, cam, **kw)))
    print(f"[insertion solves] the {n_solve} windows solved again (median of {SPLIT_REPS}): "
          f"whole median {_med(full)} ms, max {max(full):.3f}; stage 1 with the cost reads "
          f"(max_iters=0) median {_med(stage1)} ms; stage 2 median {_med(stage2)} ms | window "
          f"shapes (C, L, O): {sorted(set(shapes))}; graph and eager LM blocks give equal "
          f"outputs on all {n_solve}, bit for bit | the largest window of each bucket in turns "
          f"(eager, graphs, graphs, eager): eager LM blocks {ms_e:.3f} ms, CUDA-graph blocks "
          f"{ms_g:.3f} ms ({ms_g / ms_e:.3f}x) | all {n_solve} by exit period WBA_EXIT_EVERY "
          f"(now {keep}): {periods} | the largest {shapes[big]}: graphs {_counts(c_g)}; eager "
          f"{_counts(c_e)}")

    groups, launches = _insertion_programs(frames, entries, est.rba, pg_call)

    args, kw = pg_call["args"], pg_call["kw"]

    def pg():
        return posegraph.optimize_pose_graph(*args, **kw)

    later = [_one_call(pg)[0] for _ in range(3)]
    replays = _flag_off(posegraph, "PG_PROGRAM", pg)
    r_ms, r_out = _one_call(replays)
    e_ms, e_out = _one_call(_flag_off(posegraph, "PG_GRAPHS", replays))
    g_out = pg()
    for what, other in (("its parts launched from the host (PG_PROGRAM off)", r_out),
                        ("eager iterations", e_out)):
        for name, x, y in zip(("poses", "cost_init", "cost_final", "iters"), g_out, other):
            check(torch.equal(x, y), f"the pose graph's {name} differs between the program "
                                     f"and {what}")
    (pg_p, pg_r) = _in_turns(pg, replays, 3)
    # in turns, one call each (the dense loop takes seconds): dense, new, new, dense
    (d1, (d_poses, d_cost)), (n1, _), (n2, _), (d2, _) = (
        _one_call(f) for f in (lambda: _dense_pose_graph(args, kw["max_iters"]), pg, pg,
                               lambda: _dense_pose_graph(args, kw["max_iters"])))
    pg_d, pg_n = statistics.median([d1, d2]), statistics.median([n1, n2])
    d = (g_out[0] - d_poses).abs().max(dim=0).values
    check(bool((d <= 1e-3).all()), f"the pose graph differs from the dense loop by {d.tolist()}")
    r_counts = _schedule_counts(replays)
    with SyncCount() as syncs:
        pg()
    sync()
    it = _iteration_split(args)
    torch.use_deterministic_algorithms(False)
    prog = next(p for p in cuda_graphs.programs() if p["key"][0] == "posegraph"
                and p["key"][1:3] == (args[0].shape[0], args[2].shape[0]))
    first = pg_call["ms"]
    print(f"[epilogue] optimize_pose_graph at N {args[0].shape[0]}, E {args[2].shape[0]}, "
          f"max_iters {kw['max_iters']}, host edges {'host_edges' in kw}: one program "
          f"(PG_PROGRAM) | first call {first:.3f} ms (phase 7's finalize): warm-up "
          f"{prog['warmup_s'] * 1e3:.3f} ms, capture {(prog['capture_s'] - prog['warmup_s']) * 1e3:.3f}"
          f" ms, the rest (tables, upload, replay) {first - prog['capture_s'] * 1e3:.3f} ms; pool "
          f"{prog['pool_bytes'] / 2**20:.1f} MB (steps {prog['body_bytes'] / 2**20:.1f} MB) | "
          f"later calls {', '.join(f'{x:.3f}' for x in later)} ms | equal bit for bit to its "
          f"parts launched from the host (PG_PROGRAM off, iterations as graph replays: "
          f"{r_ms:.3f} ms one call) and to eager iterations ({e_ms:.3f} ms) | in turns (replays, "
          f"program, program, replays): replays {pg_r:.3f} ms, program {pg_p:.3f} ms "
          f"({pg_p / pg_r:.3f}x) | preferred_linalg_library "
          f"{torch.backends.cuda.preferred_linalg_library()} | in turns (dense, program, "
          f"program, dense): the dense-jacfwd loop {pg_d:.3f} ms, the program {pg_n:.3f} ms "
          f"({pg_n / pg_d:.3f}x), poses within {d[:3].max():.2e} rad / {d[3:].max():.2e} m, "
          f"cost {float(g_out[2]):.6g} against {float(d_cost):.6g} | one call: program "
          f"{launches['pose graph program']} (kernel launches / graph launches / copies, "
          f"torch.profiler in a process of its own), host syncs {syncs.n}; parts from the host "
          f"{launches['pose graph eager']} there, {_counts(r_counts)} here | one iteration, "
          f"device ms: " + ", ".join(f"{name} {v:.3f}" for name, v in it.items() if name != "J")
          + f" (dense J {it['J']})")
    return entries, est.rba


def _engine_groups(entries) -> list:
    """The windows of ``entries`` as the engine's schedule groups them: by
    bucket in order, at most WINDOW_SLOTS // 2 a group (the half group at
    which the engine launches)."""
    half, by = window_ba.WINDOW_SLOTS // 2, {}
    for e in entries:
        by.setdefault((e["C"], e["L"], e["O"]), []).append(e)
    return [(key, es[i:i + half]) for key, es in sorted(by.items())
            for i in range(0, len(es), half)]


def _window_programs() -> str:
    """The captured window-group programs: bucket, valid slots, host
    seconds of warm-up and capture, MB of the graph's pool and of its LM
    steps' pools."""
    rows = [f"{p['key'][1:4]} x {sum(p['key'][4])} {p['capture_s']:.3f} s (warm-up "
            f"{p['warmup_s']:.3f}), pool {p['pool_bytes'] / 2**20:.1f} MB (steps "
            f"{p['body_bytes'] / 2**20:.1f} MB)"
            for p in cuda_graphs.programs() if p["key"][0] == "window_group"]
    return "; ".join(rows) or "none"


def program_launches_child(path: str) -> None:
    """:func:`_program_launches`' process: a window group and a pose-graph
    call saved at ``path``, each on its eager route (traced first) and as
    its program (traced last). Prints one JSON object: per call, kernel
    launches, graph launches and copies."""
    rec = torch.load(path, weights_only=False)
    cam = StereoCamera(*rec["cam"])
    pg_args = [torch.as_tensor(a, device=DEV) for a in rec["pg_args"]]

    def group():
        return window_ba.solve_window_group(*rec["group"], cam, DEV, **rec["group_kw"])

    def pose_graph():
        return posegraph.optimize_pose_graph(*pg_args, **rec["pg_kw"])

    got = {"group eager": _flag_off(window_ba, "WBA_GROUP_PROGRAMS", lambda: _scan_launch_counts(
        group))(), "pose graph eager": _flag_off(posegraph, "PG_PROGRAM", lambda: (
            _scan_launch_counts(pose_graph)))()}
    got["group program"] = _scan_launch_counts(group)
    got["pose graph program"] = _scan_launch_counts(pose_graph)
    print(json.dumps(dict(got, captures=cuda_graphs.PROGRAM_STATS["captures"])))


def _program_launches(group: tuple, kw: dict, cam, pg_call: dict) -> dict:
    """The launches of one window-group call and one pose-graph call, each
    eager against its program, under torch.profiler in a process of its
    own (:func:`program_launches_child`; this process traces no program:
    ROADMAP Queue 3). A program call must launch no kernel and one graph."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "programs.pt")
        torch.save(dict(group=group, group_kw=kw, cam=tuple(cam),
                        pg_args=[a.cpu() for a in pg_call["args"]], pg_kw=pg_call["kw"]), path)
        code = f"import chip_smoke; chip_smoke.program_launches_child({path!r})"
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    check(proc.returncode == 0, f"the program-launches process exited with {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("group program", "pose graph program"):
        check(got[name][:2] == [0, 1], f"a {name} call launched {got[name][0]} kernels and "
                                       f"{got[name][1]} graphs")
    return {k: tuple(v) if isinstance(v, list) else v for k, v in got.items()}


def _insertion_programs(frames, entries, rba, pg_call) -> tuple[list, dict]:
    """Phase 13's windows through the window-group programs, in the
    engine's groups (:func:`_engine_groups`): each group's program
    (``window_ba.solve_window_group``) equal bit for bit to its eager route
    (``WBA_GROUP_PROGRAMS`` off) and each slot to its one-window solve
    (``SRBAEngine._solve_window``), padded rows zero; then the bench
    estimator again over the frames (strict) with the programs, its
    decisions equal to the fingerprint, ``define_kf_ms`` median and mean
    and the programs it captured; the launches of the largest group's call
    and of a pose-graph call (:func:`_program_launches`). Prints the
    ``[insertion programs]`` line; returns the groups and the launches."""
    groups = _engine_groups(entries)
    caps0 = cuda_graphs.capture_stats("window_group")["captures"]
    first_s = []
    for key, es in groups:
        windows = [window_ba.pack_window(*e["window"]) for e in es]
        t0 = time.perf_counter()
        prog = rba._solve_group(windows, key)
        sync()
        first_s.append(time.perf_counter() - t0)
        eager = _flag_off(window_ba, "WBA_GROUP_PROGRAMS",
                          lambda w=windows, k=key: rba._solve_group(w, k))()
        check(torch.equal(prog, eager), f"group {key} x {len(es)}: the program differs from "
                                        f"its eager route")
        for i, e in enumerate(es):
            check(torch.equal(prog[i], rba._solve_window(e)), f"group {key} x {len(es)}: slot "
                                                              f"{i} differs from its one-window "
                                                              f"solve")
        check(not prog[len(es):].any(), f"group {key} x {len(es)}: a padded row is not 0")
    caps1 = cuda_graphs.capture_stats("window_group")["captures"]
    est = bench_estimator(DEV, solve_sync=True)
    for left, right in frames:
        est.step(left, right)
    check(bw.decisions(est.step_log) == bw.load_fingerprint()["decisions"],
          "phase 13's run with the window programs made other decisions than the fingerprint")
    ins = [r.define_kf_ms for r in est.step_log if r.inserted_kf not in (None, 0)]
    caps2 = cuda_graphs.capture_stats("window_group")["captures"]
    key, big = max(groups, key=lambda g: (np.prod(g[0]), len(g[1])))
    windows = [window_ba.pack_window(*e["window"]) for e in big]
    pad = window_ba.WINDOW_SLOTS - len(windows)
    group = (*(np.stack([w[j] for w in windows] + [windows[0][j]] * pad) for j in (0, 1)),
             [True] * len(windows) + [False] * pad, *key)
    launches = _program_launches(group, rba._solve_kw(), rba.cam, pg_call)
    sizes: dict = {}
    for k, es in groups:
        sizes.setdefault(k, []).append(len(es))
    print(f"[insertion programs] {len(entries)} windows in {len(groups)} groups as the engine "
          f"makes them (by bucket, at most {window_ba.WINDOW_SLOTS // 2}): {sizes} | each group "
          f"one program replay (WBA_GROUP_PROGRAMS), equal bit for bit to its eager route and "
          f"each slot to its one-window solve, padded rows 0 | first calls "
          f"{', '.join(f'{x:.3f}' for x in first_s)} s ({caps1 - caps0} captured) | the bench "
          f"estimator again with the programs: decisions equal the fingerprint, define_kf_ms "
          f"median {_med(ins)} ms, mean {statistics.mean(ins):.3f} ms over {len(ins)} "
          f"insertions, {caps2 - caps1} window programs captured in the run | a call of "
          f"{key} x {len(big)} (kernel launches / graph launches / copies, torch.profiler in a "
          f"process of its own): eager {launches['group eager']}, program "
          f"{launches['group program']} | programs: {_window_programs()}")
    return groups, launches


def _shard_programs() -> str:
    """The captured sharded-window programs (``window_ba.shard_key``) by
    bucket and options: programs a shard and on the lead, host seconds of
    their warm-ups and captures, MB of their pools (and their steps')."""
    by: dict = {}
    for p in cuda_graphs.programs():
        key = p["key"]
        if key[0] != "window_shard":
            continue
        row = by.setdefault((key[1:4], dict(key[5])["max_iters"], dict(key[5])["stage1_iters"]),
                            dict(shard=0, lead=0, s=0.0, mb=0.0))
        row["shard" if key[9] == "shard" else "lead"] += 1
        row["s"] += p["capture_s"]
        row["mb"] += (p["pool_bytes"] + p["body_bytes"]) / 2**20
    return "; ".join(f"{b} iters {it} stage1 {s1}: {r['shard']} shard + {r['lead']} lead, "
                     f"{r['s']:.3f} s, {r['mb']:.0f} MB" for (b, it, s1), r in by.items()) or "none"


def _sharded_rounds(kw: dict) -> int:
    """The rounds of a sharded solve of options ``kw`` whose exit tests no
    block before its last stops: the first state, each stage's iterations
    (in blocks of ``WBA_EXIT_EVERY``), the switch between stages, the end."""
    stages = [n for n in (kw.get("stage1_iters", 0), kw["max_iters"]) if n > 0]
    its = sum(-(-n // max(1, min(window_ba.WBA_EXIT_EVERY, n))) * max(1, min(
        window_ba.WBA_EXIT_EVERY, n)) for n in stages)
    return 2 + its + (len(stages) - 1)


def _sharded_ab(sw, cam, kw: dict) -> dict:
    """A sharded window ``sw`` solved on its programs against its eager LM
    blocks (``WBA_SHARD_PROGRAMS`` off): the first call (its captures),
    every output equal bit for bit, a call under
    ``set_sync_debug_mode("error")``, then dispatch / done ms in turns."""
    def prog():
        return window_ba.optimize_window(sw, cam, **kw)

    eager = _flag_off(window_ba, "WBA_SHARD_PROGRAMS", prog)
    stats0 = cuda_graphs.capture_stats("window_shard")
    sync()
    t0 = time.perf_counter()
    out = prog()
    sync()
    first_s = time.perf_counter() - t0
    stats1 = cuda_graphs.capture_stats("window_shard")
    ref = eager()
    for field, a, b in zip(out._fields, out, ref):
        check(torch.equal(a, b), f"sharded solve at {tuple(sw.shards[0].cam_pose.shape)}: "
                                 f"{field} differs between its programs and its eager blocks")
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blob = window_ba.optimize_window_blob(sw, cam, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(blob, window_ba.result_blob(out)), "a sharded solve replayed differs")
    return dict(out=out, first_s=first_s, captures=stats1["captures"] - stats0["captures"],
                capture_s=stats1["capture_s"] - stats0["capture_s"],
                med=_dispatch_done(prog, eager, reps=SHARD_REPS))


def _engine_sharded(entries, plain_eng, mesh_eng) -> dict:
    """Phase 13's windows through ``mesh_eng`` (``SRBAEngine(mesh=)``):
    a first pass on the programs, each window's pose rows against
    ``plain_eng`` (no mesh) within SHARDED_TOL, each bucket's programs
    captured at its first window only; then, each window in turns
    (programs, eager, eager, programs), the rows of both routes equal bit
    for bit, the host ms until ``_solve_window`` returns (its layout on the
    host, one pinned upload a shard and its rounds queued) and until the
    card is done."""
    buckets = {(e["C"], e["L"], e["O"]) for e in entries}
    s1 = mesh_eng.p.stage1_iters > 0
    per_bucket = MESH_SIZE * (2 if s1 else 1) + (5 if s1 else 3)
    stats0 = cuda_graphs.capture_stats("window_shard")
    err, t_plain = 0.0, []
    for entry in entries:
        c6 = entry["C"] * 6
        ta, blob_a = _one_call(lambda: plain_eng._solve(entry))
        blob_b = mesh_eng._solve(entry)
        t_plain.append(ta)
        err = max(err, float(np.abs(blob_a[:c6] - blob_b[:c6]).max()))
    stats1 = cuda_graphs.capture_stats("window_shard")
    captures = stats1["captures"] - stats0["captures"]
    check(bool(entries) and err < SHARDED_TOL,
          f"SRBAEngine(mesh=) window poses differ by {err} over {len(entries)} windows")
    check(captures == per_bucket * len(buckets), f"SRBAEngine(mesh=) captured {captures} "
          f"sharded programs over {len(buckets)} buckets, not {per_bucket} a bucket")
    times = {k: [] for k in ("prog_dispatch", "prog_done", "eager_dispatch", "eager_done")}
    for entry in entries:
        def prog(entry=entry):
            return mesh_eng._solve_window(entry)

        routes = {"prog": prog, "eager": _flag_off(window_ba, "WBA_SHARD_PROGRAMS", prog)}
        rows = {}
        for name in ("prog", "eager", "eager", "prog"):
            sync()
            t0 = time.perf_counter()
            rows[name] = routes[name]()
            t1 = time.perf_counter()
            sync()
            times[name + "_dispatch"].append((t1 - t0) * 1e3)
            times[name + "_done"].append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(rows["prog"], rows["eager"]), f"SRBAEngine(mesh=) window at "
              f"{(entry['C'], entry['L'], entry['O'])}: programs differ from the eager blocks")
    check(cuda_graphs.capture_stats("window_shard")["captures"] == stats1["captures"],
          "SRBAEngine(mesh=) captured again in the timed turns")
    return dict(times, err=err, plain=t_plain, buckets=len(buckets), per_bucket=per_bucket,
                captures=captures, capture_s=stats1["capture_s"] - stats0["capture_s"])


def sharded_launches_child(path: str) -> None:
    """:func:`_sharded_launches`' process: the loop-closure-bucket window
    and an engine window saved at ``path``, each solved sharded over the
    saved devices on its eager LM blocks (traced first) and on its
    programs (traced last). Prints one JSON object: per call, kernel
    launches, graph launches and copies."""
    rec = torch.load(path, weights_only=False)
    mesh = make_mesh(devices=rec["devices"], axis="obs")
    cam = StereoCamera(*rec["cam"])
    lc = window_ba.shard_window_obs(window_ba.BAWindow(*rec["lc"]), mesh)
    eng = srba_mod.SRBAEngine(StereoCamera(*rec["eng_cam"]), rec["params"], mesh=mesh)
    fns = {"lc": lambda: window_ba.optimize_window_blob(lc, cam, **rec["kw"]),
           "engine": lambda: eng._solve_window(dict(window=rec["window"]))}
    got = {f"{name} eager": _flag_off(window_ba, "WBA_SHARD_PROGRAMS", lambda fn=fn: (
        _scan_launch_counts(fn)))() for name, fn in fns.items()}
    got.update({f"{name} programs": _scan_launch_counts(fn) for name, fn in fns.items()})
    print(json.dumps(got))


def _sharded_launches(big, cam, kw: dict, entries, mesh_eng) -> dict:
    """The launches of one sharded solve of the loop-closure-bucket window
    ``big`` and of the largest of phase 13's windows through ``mesh_eng``,
    each eager against its programs, under torch.profiler in a process of
    its own (:func:`sharded_launches_child`). A call on the programs must
    launch no kernel, and one graph a shard and one on the lead a round."""
    entry = max(entries, key=lambda e: (e["C"] * e["L"] * e["O"]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.pt")
        torch.save(dict(devices=[str(d) for d in mesh_eng.mesh.devices], cam=tuple(cam),
                        lc=[t.cpu().numpy() for t in big], kw=kw, eng_cam=tuple(mesh_eng.cam),
                        params=mesh_eng.p, window=entry["window"]), path)
        code = f"import chip_smoke; chip_smoke.sharded_launches_child({path!r})"
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    check(proc.returncode == 0, f"the sharded-launches process exited with {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    got = {k: tuple(v) for k, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}
    n = len(mesh_eng.mesh.devices) + 1
    for name, rounds in (("lc", _sharded_rounds(kw)), ("engine", _sharded_rounds(
            mesh_eng._solve_kw()))):
        check(got[f"{name} programs"][:2] == (0, rounds * n), f"a sharded {name} call launched "
              f"{got[f'{name} programs'][:2]} kernels and graphs, not 0 and {rounds} x {n}")
    return dict(got, bucket=(entry["C"], entry["L"], entry["O"]))


def _mesh():
    """Phase 14's mesh: 4 distinct cards where the machine has them, else
    the one card 4 times (a virtual mesh), and which it is."""
    if torch.cuda.device_count() >= MESH_SIZE:
        return make_mesh(MESH_SIZE), f"{MESH_SIZE} distinct cards"
    return (make_mesh(devices=[f"{DEV}:0"] * MESH_SIZE),
            f"cuda:0 x {MESH_SIZE}, a REPEATED card: its shards run one after the other, "
            "so no time here is a scaling number")


def _timed_twice(fn) -> tuple[float, object]:
    """Host ms of the second of two synchronized calls of ``fn``, and its
    output."""
    _one_call(fn)
    return _one_call(fn)


def phase_mesh(frames, cam, fleet_ref: dict, entries: list, rba) -> dict:
    """Phase 14: the sharded paths over a mesh of 4 devices. (a)
    batched_vo_step on 4 street pairs, twice, against the one-card mesh;
    (b) phase 11's four sequences on the mesh against their solo runs;
    (c) the loop-closure-bucket window sharded against unsharded, and
    phase 13's windows through SRBAEngine(mesh=) against the engine
    without one, each sharded solve's programs against its eager LM blocks
    (:func:`_sharded_ab`, :func:`_engine_sharded`, :func:`_sharded_launches`);
    (d) dryrun_multichip on the same devices. Returns the launches of the
    mesh runs of (a) and (b)."""
    mesh, kind = _mesh()
    one = make_mesh(devices=[f"{DEV}:0"])
    torch.use_deterministic_algorithms(True)
    launches = {name: 0 for name in _launches()}

    def on_mesh(fn):
        _reset_launches()
        out = fn()
        sync()
        for name, n in _launches().items():
            launches[name] += n
        return out

    # (a) four sequences' street pairs, one a shard, two steps: on one card,
    # on the mesh with its programs, and on the mesh eagerly
    b, k = MESH_SIZE, 512
    steps = [[np.stack([frames[1 + s + i][j] for i in range(b)]) for j in (0, 1)]
             for s in range(2)]
    init = np.zeros((b, 6), np.float32)
    outs = {}
    for name, m in (("one", one), ("mesh", mesh), ("mesh eager", mesh)):
        prev = empty_features(b, k, device=m.lead)
        run = []
        caps = _captures("batched_step")
        for lefts, rights in steps:
            def step(m=m, lefts=lefts, rights=rights, prev=prev):
                return batched_vo_step(m, lefts, rights, prev, init, cam, k=k)
            if name == "mesh eager":
                step = _flag_off(batch_mod, "FLEET_GRAPHS", step)
            out = on_mesh(step) if name == "mesh" else step()
            run.append(out)
            prev = out[0]
        outs[name] = run
        if name == "mesh":
            step_caps = _captures("batched_step") - caps
    d_vo = 0.0
    for i, (x, y, z) in enumerate(zip(outs["one"], outs["mesh"], outs["mesh eager"])):
        for field, a_, b_ in zip(x[0]._fields, x[0], y[0]):
            check(torch.equal(a_, b_), f"batched_vo_step step {i}: {field} differs on the mesh")
        check(torch.equal(x[2], y[2]), f"batched_vo_step step {i}: validity differs")
        d_vo = max(d_vo, float((x[1] - y[1]).abs().max()))
        check(all(torch.equal(p_, q_) for p_, q_ in zip(pytree.tree_leaves(y),
                                                        pytree.tree_leaves(z))),
              f"batched_vo_step step {i}: the shards' programs differ from the eager step")
    check(d_vo <= POSE_TOL_RAD, f"batched_vo_step poses differ on the mesh by {d_vo}")
    check(bool(outs["mesh"][1][2].all()), "batched_vo_step: a sequence lost tracking")
    step_launches = dict(launches)
    n_step = 2 * b + step_caps
    check(step_launches == {"fast_nms": n_step, "orb_descriptors": n_step, "fast_score_map": 0},
          f"batched_vo_step on the mesh: launches {step_launches}, not one a shard a step "
          f"and one a warm-up ({step_caps} captured)")

    # (b) phase 11's sequences, each estimator on its shard's device, with
    # the programs and eagerly
    seqs, solo = fleet_ref["seqs"], fleet_ref["solo"]
    prog = on_mesh(lambda: _fleet_run(seqs, fleet_ref["voc"], mesh, True))
    eager = _fleet_run(seqs, fleet_ref["voc"], mesh, False)
    _same_fleet_runs(prog, eager, "mesh fleet programs against the eager mesh fleet")
    fleet_launches = {name: launches[name] - step_launches[name] for name in launches}
    n_fl = len(prog["sizes"]) + len(seqs) + prog["captured"]["fleet_attempt"]["captures"]
    check(fleet_launches == {"fast_nms": n_fl, "orb_descriptors": n_fl, "fast_score_map": 0},
          f"mesh fleet: launches {fleet_launches} over {len(prog['sizes'])} shard attempts")
    check(set(prog["sizes"]) == {1}, f"mesh fleet attempts of {set(prog['sizes'])} sequences")
    worst_rad = worst_m = 0.0
    for i, (f, p11, s_) in enumerate(zip(prog["ests"], fleet_ref["run"]["ests"], solo)):
        for other, what in ((s_, "its solo run"), (p11, "phase 11's fleet")):
            check(bw.decisions(f.step_log) == bw.decisions(other.step_log),
                  f"mesh fleet sequence {i}: decisions differ from {what}")
            n = other.store.n_kfs
            check(f.store.n_kfs == n, f"mesh fleet sequence {i}: {f.store.n_kfs} vs {n} "
                  f"keyframes in {what}")
            d = np.abs(f.rba.kf_global[:n] - other.rba.kf_global[:n])
            worst_rad, worst_m = max(worst_rad, d[:, :3].max()), max(worst_m, d[:, 3:].max())
    check(worst_rad <= POSE_TOL_RAD and worst_m <= POSE_TOL_M,
          f"mesh fleet keyframe poses differ from the solo runs by {worst_rad} / {worst_m}")
    n_frames = len(seqs) * N_FLEET_FRAMES
    wall = prog["wall"]

    # (c) the loop-closure bucket, sharded against unsharded, and phase 13's
    # windows through the engine with a mesh against the engine without one;
    # each sharded solve on its programs against its eager LM blocks
    kcam = StereoCamera.kitti()
    big, _gt = make_ba_window_problem(kcam, np.random.default_rng(7), **LC_BUCKET)
    big = window_ba.BAWindow(*(t.to(mesh.lead) for t in big))
    kw = dict(kernel_param=1.5, max_iters=8)
    ms_1, r1 = _timed_twice(lambda: window_ba.optimize_window(big, kcam, **kw))
    obs_mesh = make_mesh(devices=mesh.devices, axis="obs")
    sharded = window_ba.shard_window_obs(big, obs_mesh)
    lc = _sharded_ab(sharded, kcam, kw)
    rn = lc["out"]
    lc_err = float((rn.cam_pose - r1.cam_pose).abs().max())
    check(lc_err < SHARDED_TOL, f"the sharded loop-closure-bucket window differs by {lc_err}")
    check(float(r1.cost_final) < float(r1.cost_init), "the LC-bucket solve did not improve")
    plain_eng = srba_mod.SRBAEngine(rba.cam, rba.p, device=mesh.lead)
    mesh_eng = srba_mod.SRBAEngine(rba.cam, rba.p, mesh=obs_mesh)
    eng = _engine_sharded(entries, plain_eng, mesh_eng)
    win_launches = _sharded_launches(big, kcam, kw, entries, mesh_eng)
    # (d) the dry run on the same devices
    dry = dryrun_multichip(MESH_SIZE, devices=list(mesh.devices))
    torch.use_deterministic_algorithms(False)
    print(f"[mesh] {kind}: {[str(d) for d in mesh.devices]} | (a) batched_vo_step on {b} "
          f"street pairs 370x1226, one a shard, twice: features bit-equal to the one-card "
          f"step, poses within {d_vo:.2e}, each shard's step one program replay = the eager "
          f"step bit for bit, launches {step_launches} (one K1 and one K2 a shard a step, "
          f"{step_caps} program warm-up) | (b) phase 11's {len(seqs)} sequences x "
          f"{N_FLEET_FRAMES} frames on the mesh, programs / eager: {wall:.3f} / "
          f"{eager['wall']:.3f} s, {n_frames / wall:.2f} / {n_frames / eager['wall']:.2f} "
          f"frames/s aggregate (captures in the programs' run {prog['capture_s']:.3f} s; phase "
          f"11's programs on one card: {fleet_ref['wall']:.3f} s, {fleet_ref['fps']:.2f} "
          f"frames/s); programs = eager bit for bit; every sequence's decisions equal its solo "
          f"run and phase 11's fleet, KF poses within {worst_rad:.2e} rad / {worst_m:.2e} m; "
          f"{len(prog['sizes'])} shard attempts ({fleet_ref['attempts']} lockstep attempts on "
          f"one card), launches {fleet_launches}; host syncs programs / eager {prog['syncs']} "
          f"/ {eager['syncs']} ({prog['syncs'] / N_FLEET_FRAMES:.2f} / "
          f"{eager['syncs'] / N_FLEET_FRAMES:.2f} a lockstep step) | programs: "
          f"{_fleet_programs()}")
    print(f"[mesh windows] (c) the loop-closure bucket {LC_BUCKET}, {kw['max_iters']} LM "
          f"iterations, second of two calls: unsharded (CUDA-graph "
          f"blocks) {ms_1:.3f} ms, sharded over {MESH_SIZE} (programs) "
          f"{lc['med']['graph'][1]:.3f} ms, max |dpose| {lc_err:.2e} | phase 13's "
          f"{len(entries)} windows through SRBAEngine(mesh=): window poses within "
          f"{eng['err']:.2e} of the engine without a mesh; median {_med(eng['plain'])} ms a "
          f"solve without a mesh")
    n_sh = MESH_SIZE
    print(f"[mesh programs] (c) each sharded solve as rounds of {n_sh} shard programs and one "
          f"lead program (WBA_SHARD_PROGRAMS) against its eager LM blocks, equal bit for bit "
          f"| the loop-closure bucket: first call {lc['first_s']:.3f} s ({lc['captures']} "
          f"captured, {lc['capture_s']:.3f} s of warm-ups and captures), dispatch / done ms, "
          f"medians in turns (eager, programs, programs, eager; {SHARD_REPS} calls each): eager "
          f"{lc['med']['eager'][0]:.3f} / {lc['med']['eager'][1]:.3f}, programs "
          f"{lc['med']['graph'][0]:.3f} / {lc['med']['graph'][1]:.3f}; a call under "
          f"set_sync_debug_mode('error') (no host sync) | phase 13's {len(entries)} windows "
          f"through SRBAEngine(mesh=) ({eng['buckets']} buckets): first pass "
          f"{eng['captures']} captured ({eng['per_bucket']} a bucket, each bucket once), "
          f"{eng['capture_s']:.3f} s; then in turns a window (programs, eager, eager, "
          f"programs), dispatch / done ms medians: eager {_med(eng['eager_dispatch'])} / "
          f"{_med(eng['eager_done'])}, programs {_med(eng['prog_dispatch'])} / "
          f"{_med(eng['prog_done'])} (host layout and one pinned upload a shard included) | "
          f"launches a call (kernel launches / graph launches / copies; torch.profiler in a "
          f"process of its own): the loop-closure bucket eager {win_launches['lc eager']}, "
          f"programs {win_launches['lc programs']}; an engine window of "
          f"{win_launches['bucket']} eager {win_launches['engine eager']}, programs "
          f"{win_launches['engine programs']} | programs: {_shard_programs()}")
    print(f"[mesh dryrun] (d) dryrun_multichip({MESH_SIZE}) on {dry['devices']}: "
          + json.dumps({k_: v for k_, v in dry.items() if k_ != "devices"}))
    return launches


def _pipeline_counters(est):
    """Wrap what phase 15 counts on one estimator: the batched walk's reads
    (``to_host`` in the estimator and the engine), the deferred checks'
    predictions, misses (fast and classic replays) and demotions, the
    synchronous checks of the replays, the window-solve groups and the
    fused check groups with their valid slots. Returns the counters and the
    function that puts the originals back."""
    n = dict(reads=0, predictions=0, fast_replays=0, classic_replays=0, demotions=0,
             sync_checks=0, window_groups=[], check_groups=[], first_group=None)
    run_host_e, run_host_s = estimator_mod.to_host, srba_mod.to_host
    run_group, run_fused = srba_mod.solve_window_group, estimator_mod.fused_checks_batch

    def host(tensors):
        n["reads"] += 1
        return run_host_e(tensors)

    def group(ints, floats, valids, *a, **k):
        if not k.get("capture_only"):
            n["window_groups"].append(sum(bool(v) for v in valids))
        return run_group(ints, floats, valids, *a, **k)

    def fused(feats, arrays, db, leaf_bits, weights, js, rows, valids, cam, seeds, **k):
        n_valid = sum(bool(v) for v in valids)
        n["check_groups"].append(n_valid)
        if n["first_group"] is None and n_valid >= 2:
            # the first group of two checks or more, its inputs copied as
            # they were, for (e)
            n["first_group"] = dict(
                feats=feats, arrays=type(arrays)(*(a.clone() for a in arrays)), db=db.clone(),
                leaf_bits=leaf_bits, weights=weights, js=list(js),
                rows=rows.clone() if torch.is_tensor(rows) else list(rows),
                valids=list(valids), cam=cam,
                seeds=seeds.clone() if torch.is_tensor(seeds) else list(seeds), kw=k)
        return run_fused(feats, arrays, db, leaf_bits, weights, js, rows, valids, cam, seeds,
                         **k)

    estimator_mod.to_host, srba_mod.to_host = host, host
    srba_mod.solve_window_group, estimator_mod.fused_checks_batch = group, fused
    run_defer, run_miss, run_dem = est._defer_check, est._miss_recover, est._demote_shrink_miss
    run_check = est._kf_check

    def defer(*a):
        n["predictions"] += 1
        return run_defer(*a)

    def miss(c, d):
        before = est._replay_flag
        out = run_miss(c, d)
        n["classic_replays" if est._replay_flag and not before else "fast_replays"] += 1
        return out

    def dem(c, d):
        out = run_dem(c, d)
        n["demotions"] += int(out)
        return out

    def sync_check(frame):
        n["sync_checks"] += 1
        return run_check(frame)

    est._defer_check, est._miss_recover, est._demote_shrink_miss = defer, miss, dem
    est._kf_check = sync_check

    def restore():
        estimator_mod.to_host, srba_mod.to_host = run_host_e, run_host_s
        srba_mod.solve_window_group, estimator_mod.fused_checks_batch = run_group, run_fused
        for name in ("_defer_check", "_miss_recover", "_demote_shrink_miss", "_kf_check"):
            del est.__dict__[name]

    return n, restore


def _pipelined_run(frames, name: str) -> dict:
    """A batched schedule ``name`` of ``bw.SCHEDULES`` on the bench
    estimator as the harness runs it: ``bench._warmed`` (``PIPE_WARMUP``
    frames at the schedule's batch, the solves landed), then the rest in a
    second call timed by ``bench._Timed`` (the solves in flight land inside
    it), with ``_pipeline_counters`` and the host syncs over the timed
    part."""
    t0 = time.perf_counter()
    est = bench._warmed(DEV, frames, name)
    warm_s = time.perf_counter() - t0
    n_b0 = len(est.lat["batches"])
    n, restore = _pipeline_counters(est)
    try:
        with SyncCount() as syncs, bench._Timed(est) as t:
            est.perform_stereo_slam_batched(frames[PIPE_WARMUP:], batch=bw.SCHEDULES[name][0])
    finally:
        restore()
    return dict(est=est, n=n, warm_s=warm_s, timed_s=t.s, fps=(len(frames) - PIPE_WARMUP) / t.s,
                batches=len(est.lat["batches"]) - n_b0, syncs=syncs.n, captures=t.captures)


def _device_resident_run(frames, name: str) -> dict:
    """The device-resident loop of schedule ``name`` of ``bw.SCHEDULES`` as
    the harness runs it: ``bench._warmed``, the rest staged on the card in
    chunks of the schedule's size (``bench.stage_chunks``), each chunk one
    scan chained from the one before, timed by ``bench._Timed``, after one
    scan at the chunk's shape on a throwaway estimator (as the harness)."""
    chunk = bw.SCHEDULES[name][2]
    est = bench._warmed(DEV, frames, name)
    chunks, _bytes = bench.stage_chunks(frames[PIPE_WARMUP:], chunk, DEV)
    # one scan at the chunk's shape outside the timed part, on a throwaway
    # estimator, as the harness warms it (on the card: its graph's capture)
    spare = bench_estimator(DEV)
    spare.step(*frames[0])
    vo_mod.to_host([spare._dispatch_scan(spare.device_batch(*chunks[0]))["last_inc"]])
    with SyncCount() as syncs, bench._Timed(est) as t:
        est.perform_stereo_slam_device(chunks)
    return dict(est=est, timed_s=t.s, fps=(len(frames) - PIPE_WARMUP) / t.s, syncs=syncs.n,
                batches=len(chunks), chunk=chunk, captures=t.captures)


def _gate_run(name: str, run: dict, fp: dict, jax_run: dict, gt_poses, strict_kf) -> dict:
    """Phase 15's checks of one run: the fingerprint's decisions, the
    harness's gate (``bench.gate_estimator``: the decisions, the keyframe
    positions within ``PIPE_JAX_GATE_M`` of the JAX package's run of the
    same schedule, ``bw.PIPELINE_FINGERPRINT``, and the ATE gate), and for
    the batched runs the JAX package's scheduling gate, within 0.15 m of
    the strict batched run. The device-resident loops are held to the JAX
    run of their schedule only: a chunk builds each insertion's window
    before the solves before it have landed, which moves the JAX package's
    own run of the 60-frame chunk farther than 0.15 m from strict (the
    committed file; tests/test_torch_bench_fingerprint.py); their distance
    to strict is printed."""
    est = run["est"]
    got = bw.decisions(est.step_log)
    diff = [(a, b) for a, b in zip(fp["decisions"], got) if a != b]
    check(len(got) == len(fp["decisions"]) and not diff,
          f"{name}: decisions differ from the JAX fingerprint at {len(diff)} frames: "
          f"{diff[:5]}")
    g = bench.gate_estimator(name, est, gt_poses, jax_run)
    kf = g["kf_global"]
    check(kf.shape == strict_kf.shape, f"{name}: {kf.shape} keyframes, strict {strict_kf.shape}")
    d_strict = float(np.max(np.linalg.norm(kf[:, 3:] - strict_kf[:, 3:], axis=1)))
    check(bw.SCHEDULES[name][2] or d_strict < PIPE_POSE_GATE_M,
          f"{name}: keyframe positions {d_strict} m from the strict run (gate "
          f"{PIPE_POSE_GATE_M} m)")
    jax_kf = np.asarray(jax_run["kf_global"])
    return dict(d_strict=d_strict, d_jax=g["d_jax_m"], jax_d_strict=float(np.max(np.linalg.norm(
        jax_kf[:, 3:] - strict_kf[:, 3:], axis=1))), ate=g["ate_m"], jax_ate=jax_run["ate_m"],
        n_kfs=g["n_kfs"], checks=g["checks"])


def _window_groups(entries, rba) -> str:
    """(d): phase 13's windows in groups by bucket (the first WINDOW_SLOTS
    of each) through ``solve_window_group``: the program equal bit for bit
    to its eager route (``WBA_GROUP_PROGRAMS`` off), and to that route
    with eager LM blocks (``WBA_GRAPHS`` off too), every slot to its
    one-window solve, padded rows zero; host ms to dispatch and until done
    in turns (eager, program, program, eager) beside the sum of the
    one-window solves."""
    buckets: dict = {}
    for e in entries:
        buckets.setdefault((e["C"], e["L"], e["O"]), []).append(e)
    rows = []
    for key, es in sorted(buckets.items()):
        grp = es[:window_ba.WINDOW_SLOTS]
        windows = [window_ba.pack_window(*e["window"]) for e in grp]

        def call(w=windows, k=key):
            return rba._solve_group(w, k)

        eager_route = _flag_off(window_ba, "WBA_GROUP_PROGRAMS", call)
        caps = _captures("window_group")
        t0 = time.perf_counter()
        out = call()
        sync()
        first_s = time.perf_counter() - t0
        check(torch.equal(out, eager_route()), f"bucket {key}: the program differs from the "
                                               f"eager group")
        check(torch.equal(out, _flag_off(window_ba, "WBA_GRAPHS", eager_route)()),
              f"bucket {key}: the program differs from eager LM blocks")
        for i, e in enumerate(grp):
            check(torch.equal(out[i], rba._solve_window(e)), f"bucket {key}: slot {i} differs "
                                                             f"from its one-window solve")
        check(not out[len(grp):].any(), f"bucket {key}: a padded row is not 0")
        med = _dispatch_done(call, eager_route, reps=3)
        one_ms = sum(_host_ms(lambda e=e: rba._solve_window(e), 3)[0] for e in grp)
        rows.append(f"{key} x {len(grp)}: first program call {first_s:.3f} s "
                    f"({_captures('window_group') - caps} captured); dispatch / done ms, medians "
                    f"in turns: eager group {med['eager'][0]:.3f} / {med['eager'][1]:.3f}, "
                    f"program {med['graph'][0]:.3f} / {med['graph'][1]:.3f}; the one-window "
                    f"solves {one_ms:.3f} ms summed")
    return "; ".join(rows)


def _fused_group_check(g: dict) -> str:
    """(e): one fused check group of the run again, on copies of its
    inputs (:func:`_group_fns`): its slot programs captured first, then the
    group, its copies set back in place, under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises); the
    same group with the eager check
    (``CHECK_GRAPHS`` off) on copies of its own: the blobs, the store and
    the database equal bit for bit; then each slot against the one-check
    path on the same rows."""
    (graph, eager_fn), parts, _snap = _group_fns(g)
    caps = _captures("check")
    graph()                                         # the capture (its key's first call)
    caps = _captures("check") - caps
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        blobs = graph()                             # the copies set back first, on the card
        host_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    graph_held = [t.clone() for t in parts["graph"]]
    eager = eager_fn()
    check(all(torch.equal(x, y) for x, y in zip(blobs, eager))
          and all(torch.equal(x, y) for x, y in zip(graph_held, parts["eager"])),
          "the fused group's slot programs differ from the eager group")
    rows = [int(r) for r in g["rows"]]
    seeds = [int(sd) for sd in g["seeds"]]
    arrays1 = type(g["arrays"])(*(a.clone() for a in g["arrays"]))
    db1 = g["db"].clone()
    kw = dict(g["kw"])
    debug = kw.pop("debug", False)
    n_valid = sum(g["valids"])
    k = g["feats"].m_valid.shape[-1]
    worst = 0.0
    for i in range(n_valid):
        frame = vo_mod.FrameFeatures(*(a[g["js"][i]] for a in g["feats"]))
        row = rows[i]
        for name in da_mod._ROW_FIELDS:
            getattr(arrays1, name)[row] = getattr(frame, name)
        db1[row] = da_mod.bow_vector(frame.desc_l, frame.m_valid, g["leaf_bits"], g["weights"])
        (one,) = da_mod.query_and_associate_packed(frame, arrays1, db1, g["leaf_bits"],
                                                   g["weights"], row, g["cam"], seeds[i],
                                                   debug=debug, **kw)
        a = da_mod.unpack_check_outputs(blobs[i].cpu().numpy(), 5, k, 4, debug)
        b = da_mod.unpack_check_outputs(one.cpu().numpy(), 5, k, 4, debug)
        for name, x, y in zip(("ids", "status", "other_idx", "tracked", "m_valid", "xs_l",
                               "ys_l", "xs_r", "m_r_idx"), a[1:10], b[1:10]):
            check(np.array_equal(x, y), f"fused slot {i}: {name} differs from the one-check path")
        worst = max(worst, float(np.abs(a[0] - b[0]).max()), float(np.abs(a[10] - b[10]).max()))
        check(worst <= 1e-6, f"fused slot {i}: scores or points differ by {worst}")
    return (f"one fused_checks_batch of {n_valid} checks in {len(g['valids'])} slots "
            f"({caps} slot program captured for its copies first) under "
            f"set_sync_debug_mode('error'): no host sync, {host_ms:.3f} ms host | equal bit for "
            f"bit to the eager group (CHECK_GRAPHS off: blobs, store, database) | every slot "
            f"equal to the one-check path on the same rows (integer fields exact, scores and "
            f"points within {worst:.1e})")


def phase_pipeline(frames, gt_poses, strict: dict, entries, rba) -> dict:
    """Phase 15: the JAX package's default schedule on the bench workload
    (pipelined window solves, deferred checks, one read a batch): (a) at
    batch 20 and 8, (b) with solve_flush_before_insert, (c) the device-
    resident loop in chunks of 60 and of 8, (d) phase 13's windows in
    groups, (e) one fused check group under the sync debug mode's
    "error"."""
    fp = bw.load_fingerprint()
    _reset_launches()
    # (a)-(c): each schedule of bw.SCHEDULES, the device-resident loops
    # (chunk > 0) through one function
    runs = {name: (_device_resident_run if chunk else _pipelined_run)(frames, name)
            for name, (_batch, _mid, chunk) in bw.SCHEDULES.items()}
    counts = _launches()
    # the same schedules with the eager scan (vo.SCAN_GRAPHS off): the same
    # bits, for the frames/s of each beside the graph's
    eager = {name: _flag_off(vo_mod, "SCAN_GRAPHS", lambda n=name, c=chunk: (
        _device_resident_run if c else _pipelined_run)(frames, n))()
        for name, (_batch, _mid, chunk) in bw.SCHEDULES.items()}
    # and with the eager check (da_mod.CHECK_GRAPHS off): the same bits, and
    # the JAX run's decisions and keyframe positions (gated below)
    eager_check = {name: _flag_off(da_mod, "CHECK_GRAPHS", lambda n=name, c=chunk: (
        _device_resident_run if c else _pipelined_run)(frames, n))()
        for name, (_batch, _mid, chunk) in bw.SCHEDULES.items()}
    for what, other in (("scan", eager), ("check", eager_check)):
        for name, r in other.items():
            g = runs[name]["est"]
            check(bw.decisions(r["est"].step_log) == bw.decisions(g.step_log)
                  and np.array_equal(r["est"].rba.kf_global[:r["est"].store.n_kfs],
                                     g.rba.kf_global[:g.store.n_kfs]),
                  f"{name}: the eager {what}'s run differs from the graph {what}'s")
    jax_runs = bw.load_fingerprint(bw.PIPELINE_FINGERPRINT)["runs"]
    check(set(jax_runs) == set(runs), f"{bw.PIPELINE_FINGERPRINT}: runs {sorted(jax_runs)}")
    gates = {name: _gate_run(name, r, fp, jax_runs[name], gt_poses, strict["kf_global"])
             for name, r in runs.items()}
    gates_ec = {name: _gate_run(name, r, fp, jax_runs[name], gt_poses, strict["kf_global"])
                for name, r in eager_check.items()}
    check(gates["flush-before-insert b8"]["d_strict"]
          <= gates["pipelined b8"]["d_strict"] + 1e-9,
          f"flush-before-insert lands farther from strict ({gates['flush-before-insert b8']}) "
          f"than pipelined ({gates['pipelined b8']})")
    n_scans = sum(len(r["est"].lat["batches"]) for r in runs.values())
    for name, r in runs.items():
        g = gates[name]
        extra = ""
        if "n" in r:
            c = r["n"]
            extra = (f" | reads {c['reads']} over {r['batches']} batches "
                     f"({c['reads'] / max(r['batches'], 1):.2f} a batch; synchronous checks of "
                     f"the replays {c['sync_checks']}) | host syncs {r['syncs']} "
                     f"({r['syncs'] / max(r['batches'], 1):.2f} a batch) | predictions "
                     f"{c['predictions']}, misses {c['fast_replays'] + c['classic_replays']} "
                     f"(fast replays {c['fast_replays']}, classic {c['classic_replays']}), "
                     f"demotions {c['demotions']} | window groups {len(c['window_groups'])}, "
                     f"windows a group {c['window_groups']} | fused check "
                     f"groups {len(c['check_groups'])}, checks a group {c['check_groups']} | "
                     f"warm-up {r['warm_s']:.3f} s")
        else:
            extra = (f" | host syncs {r['syncs']} ({r['syncs'] / r['batches']:.2f} a chunk of "
                     f"{r['chunk']})")
        ec = eager_check[name]
        extra += (f" | eager scan (SCAN_GRAPHS off, the same bits): {eager[name]['timed_s']:.3f} "
                  f"s, {eager[name]['fps']:.2f} fps; eager check (CHECK_GRAPHS off, the same "
                  f"bits): {ec['timed_s']:.3f} s, {ec['fps']:.2f} fps, decisions equal the JAX "
                  f"run's, KF positions within {gates_ec[name]['d_jax']:.2e} m of it | graphs "
                  f"captured in the timed part: scans {r['captures']['vo_scan']}, check programs "
                  f"{r['captures']['check']}, window programs {r['captures']['window_group']}")
        print(f"[pipeline] {name}: {len(frames) - PIPE_WARMUP} timed frames after "
              f"{PIPE_WARMUP}: {r['timed_s']:.3f} s, {r['fps']:.2f} fps (phase 10 strict b8: "
              f"{strict['wall']:.3f} s for all {len(frames)}, {len(frames) / strict['wall']:.2f} "
              f"fps, {strict['syncs'] / max(strict['batches'], 1):.2f} syncs a batch) | "
              f"decisions equal the JAX fingerprint; {g['n_kfs']} KFs, {g['checks']} checks | "
              f"KF positions within {g['d_jax']:.2e} m of the JAX run of this schedule (gate "
              f"{PIPE_JAX_GATE_M} m), {g['d_strict']:.2e} m of phase 10's strict run ("
              + ("not gated" if bw.SCHEDULES[name][2] else f"gate {PIPE_POSE_GATE_M} m")
              + f"; JAX's run {g['jax_d_strict']:.2e} m) | ATE {g['ate']:.6f} m (gate "
              f"{ATE_GATE_M} m; JAX's run {g['jax_ate']:.6f} m)" + extra)
    print(f"[pipeline kernels] launches over (a)-(c) {counts}: K1 and K2 once per scan replay, "
          f"per bootstrap frame and per capture's warm-up ({n_scans} batch reads)")
    print(f"[pipeline scan graphs] {_graph_programs()} | " + _scan_ab(frames, bw.SCHEDULES[
        bench.HEADLINE][0]))
    print(f"[pipeline check graphs] {_check_programs()}")
    b20 = runs["pipelined b20"]["n"]
    check(b20["first_group"] is not None, "no fused check group of two checks or more")
    print(f"[pipeline windows] (d) phase 13's {len(entries)} windows by bucket, programs "
          f"equal bit for bit to the eager group, to eager LM blocks and to the one-window "
          f"solves: " + _window_groups(entries, rba))
    print(f"[pipeline checks] (e) " + _fused_group_check(b20["first_group"]))
    return counts


def _same_step(a, b, what: str) -> float:
    """The VO step's outputs ``(pose, num_inliers, m_valid)`` on the card
    (``a``) against the CPU path's (``b``): m_valid and num_inliers exact,
    the pose within POSE_TOL_RAD; returns the pose's largest difference."""
    check(torch.equal(a[2].cpu(), b[2]), f"{what}: m_valid differs from the CPU path")
    check(int(a[1]) == int(b[1]), f"{what}: num_inliers {int(a[1])} on the card, "
                                  f"{int(b[1])} on the CPU")
    d = float((a[0].cpu() - b[0]).abs().max())
    check(d <= POSE_TOL_RAD, f"{what}: pose {d} from the CPU path's")
    return d


def phase_bench(frames, gt_poses) -> dict:
    """Phase 16: the port's bench harness (``srba_slam_tpu_torch/bench.py``)
    at one repeat of each part on the frames rendered above, and
    ``entry()`` once; then ``entry``'s outputs and example frontend against
    the CPU path's, and the step on two street frames on both devices."""
    _reset_launches()
    t0 = time.perf_counter()
    line = bench.run(DEV, repeats=1, dev_repeats=1, bounded_repeats=2,
                     frames=(frames, gt_poses))
    run_s = time.perf_counter() - t0
    fn, args = entry(DEV)
    out = fn(*args)
    sync()
    counts = _launches()
    check(line["launches"]["fast_nms"] > 0 and line["launches"]["orb_descriptors"] > 0,
          f"bench: K1/K2 not launched in the timed parts: {line['launches']}")
    check(counts["fast_nms"] > 0 and counts["orb_descriptors"] > 0
          and counts["fast_score_map"] == 0, f"bench path launches {counts}")
    check(line["busy_share"] is not None and line["card"], "bench: no busy share or card line")
    check(line["cpu_fps"] is not None and line["cpu_fps"] > 0,
          f"bench: no CPU anchor ({line['cpu_fps']})")
    print(f"[bench] {json.dumps(line)}")
    print(f"[bench scan graphs] one repeat a part, {line['card']}: K1/K2 launches in the timed "
          f"parts (a replay adds its graph's) {line['launches']['fast_nms']}/"
          f"{line['launches']['orb_descriptors']}, scan graphs {line['scan_graphs']}, check "
          f"programs {line['check_graphs']}, window programs {line['window_graphs']} | captures "
          f"inside the timed parts (expected 0 for the checks and the windows: the harness "
          f"captures them after its warm-up): check programs "
          f"{line['check_graphs']['captures_timed']}, window programs "
          f"{line['window_graphs']['captures_timed']} | " + _scan_ab(frames, bw.DEV_CHUNK))
    # the comparisons below launch kernels outside the counted path
    fn_cpu, args_cpu = entry("cpu")
    diff = _int_fields_differing(args[2], args_cpu[2])
    check(not diff, f"entry: the example frontend differs from the CPU path in {diff}")
    d_example = _same_step(out, fn_cpu(*args_cpu), "entry")
    street = []
    for dev, step in ((DEV, fn), ("cpu", fn_cpu)):
        prev = extract_and_match(*frames[0], StereoCamera.kitti(), 20.0, 60, device=dev)
        street.append(step(*(torch.from_numpy(a).to(dev) for a in frames[1]), prev,
                           torch.zeros(6, device=dev)))
    d_street = _same_step(*street, "entry on street frames 0-1")
    print(f"[entry] entry(): pose {out[0].cpu().numpy().round(6).tolist()}, num_inliers "
          f"{int(out[1])}, {int(out[2].sum())} stereo matches of {out[2].numel()} (independent "
          f"random frames, as the JAX entry's) | the example frontend equal to the CPU path's | "
          f"outputs equal to the CPU path's (pose within {d_example:.1e}) | the step on street "
          f"frames 0-1: {int(street[0][1])} inliers, {int(street[0][2].sum())} stereo matches, "
          f"equal to the CPU path's (pose within {d_street:.1e}) | bench.run {run_s:.3f} s | "
          f"launches on the path (bench timed and untimed parts, entry) {counts}")
    return counts


def _cli(args: list) -> tuple[int, str]:
    """The port's ``main`` in this process; returns (exit code, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args)
    return rc, buf.getvalue()


def _ini_copy(tmp: str, name: str, **subs) -> tuple[str, str]:
    """The EuRoC demo config with ``out_dir`` under ``tmp``, quiet, and
    ``subs`` replacing other keys."""
    with open(EUROC_INI) as f:
        txt = f.read()
    out = os.path.join(tmp, name)
    for key, val in dict(out_dir=out, verbose_level=0, **subs).items():
        txt, n = re.subn(rf"(?m)^{key}\s*=.*$", lambda _m, k=key, v=val: f"{k} = {v}", txt)
        check(n == 1, f"{EUROC_INI}: {n} lines set {key}")
    path = os.path.join(tmp, name + ".ini")
    with open(path, "w") as f:
        f.write(txt)
    return path, out


def phase_cli() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        ini, out = _ini_copy(tmp, "full")
        scans = []
        scan = estimator_mod.vo_scan
        estimator_mod.vo_scan = lambda lefts, *a, **k: (scans.append(len(lefts)),
                                                        scan(lefts, *a, **k))[1]
        _reset_launches()
        caps = _captures()
        try:
            t0 = time.perf_counter()
            rc, said = _cli([ini, "--synthetic", str(N_CLI_FRAMES)])    # default: --batch 8
            sync()
            wall = time.perf_counter() - t0
        finally:
            estimator_mod.vo_scan = scan
        counts = _launches()
        caps = _captures() - caps
        check(rc == 0, f"the CLI exited with {rc}: {said}")
        m = re.search(r"(\d+) frames, (\d+) keyframes, ([0-9.]+) fps", said)
        check(m is not None and int(m.group(1)) == N_CLI_FRAMES, f"the CLI said: {said}")
        n_kfs, fps = int(m.group(2)), float(m.group(3))
        check(f"backend: cuda ({torch.cuda.get_device_name(0)})" in said, f"backend line: {said}")
        sizes = {f: os.path.getsize(os.path.join(out, f)) for f in CLI_FILES
                 if os.path.exists(os.path.join(out, f))}
        check(len(sizes) == len(CLI_FILES) and all(sizes.values()),
              f"the CLI wrote {sizes}, expected non-empty {CLI_FILES}")
        with open(os.path.join(out, "out_kf_poses.txt")) as f:
            rows = f.read().splitlines()
        check(len(rows) == n_kfs >= 3, f"{len(rows)} pose rows for {n_kfs} keyframes")
        check(np.isfinite(np.loadtxt(os.path.join(out, "out_kf_poses.txt"))).all(),
              "out_kf_poses.txt holds a non-finite pose")
        check(len(scans) >= (N_CLI_FRAMES - 1) // BATCH
              and counts["fast_nms"] == counts["orb_descriptors"] == len(scans) + 1 + caps,
              f"the CLI run launched {counts} over {len(scans)} scans, the bootstrap frame "
              f"and {caps} scan graph captures")
        # the default (batch 8 on the card) keeps the keyframes of per-frame stepping
        ini1, out1 = _ini_copy(tmp, "per_frame")
        t0 = time.perf_counter()
        rc1, said1 = _cli([ini1, "--synthetic", str(N_CLI_FRAMES), "--batch", "1"])
        wall1 = time.perf_counter() - t0
        m1 = re.search(r"([0-9.]+) fps", said1)
        kf_default = open(os.path.join(out, "kf_frames.txt")).read()
        kf_per_frame = open(os.path.join(out1, "kf_frames.txt")).read()
        check(rc1 == 0 and m1 is not None and kf_default == kf_per_frame,
              f"--batch 1 exited {rc1}; its kf_frames.txt differs from the default run's")
        # --fleet 2 over rendered sequences: two output directories
        ini2f, outf = _ini_copy(tmp, "fleet")
        t0 = time.perf_counter()
        rcf, saidf = _cli([ini2f, "--synthetic", str(N_FLEET_CLI_FRAMES), "--fleet", "2"])
        wallf = time.perf_counter() - t0
        mf = re.search(r"fleet: 2 sequences x \d+ frames on a (\d+)-device mesh, ([0-9.]+) "
                       r"frames/s", saidf)
        seq_files = {i: sorted(os.listdir(os.path.join(outf, f"seq{i}")))
                     if os.path.isdir(os.path.join(outf, f"seq{i}")) else [] for i in range(2)}
        check(rcf == 0 and mf is not None
              and all(set(CLI_FILES) <= set(f) for f in seq_files.values()),
              f"--fleet 2 exited {rcf}, wrote {seq_files}: {saidf}")

        # checkpoint at frame 30, then the same continuation on the card and on the CPU
        ckpt = os.path.join(tmp, "s.npz")
        ini2, _ = _ini_copy(tmp, "half")
        rc, said2 = _cli([ini2, "--synthetic", str(N_RESUME_AT), "--checkpoint", ckpt])
        check(rc == 0 and os.path.getsize(ckpt) > 0, f"the checkpoint run exited with {rc}: {said2}")
        cont = {}
        for device in (DEV, "cpu"):
            est = SRBAStereoSLAMEstimator.from_config(ini2, device=device)
            est.initialize()
            load_state(est, ckpt)
            check(est.frame_idx == N_RESUME_AT - 1 and est.store.n_kfs >= 2,
                  f"resumed at frame {est.frame_idx} with {est.store.n_kfs} keyframes")
            tail = list(SyntheticSource(est.cam, n_frames=N_CLI_FRAMES, step=0.5))[N_RESUME_AT:]
            for left, right in tail:
                est.step(left, right)
            cont[device] = (bw.decisions(est.step_log), est.store.n_kfs)
        check(cont[DEV] == cont["cpu"], "after the resume the card's keyframe decisions differ "
              "from the CPU path's")
        check(any(d[2] is not None for d in cont[DEV][0]),
              "no keyframe was inserted after the resume")

        png = "image-dir run skipped: no PIL"
        try:
            from PIL import Image
        except ImportError:
            Image = None
        if Image is not None:
            img_dir = os.path.join(tmp, "seq")
            os.makedirs(img_dir)
            cam = load_config(EUROC_INI)[1].camera
            for i, (left, right) in enumerate(SyntheticSource(cam, n_frames=10, step=0.5)):
                Image.fromarray(left).save(os.path.join(img_dir, f"cam0_{i:06d}.png"))
                Image.fromarray(right).save(os.path.join(img_dir, f"cam1_{i:06d}.png"))
            ini3, _out3 = _ini_copy(tmp, "png", image_dir_url=img_dir)
            rc, said3 = _cli([ini3])
            loader = re.search(r"frame loader: (\w+)", said3)
            check(rc == 0 and loader is not None and "10 frames" in said3,
                  f"the image-directory run exited with {rc}: {said3}")
            png = f"10 PNG pairs through {loader.group(1)}"
    print(f"[cli] {png}")
    print(f"[cli] main() on CUDA, {os.path.basename(EUROC_INI)} (752x480, unrectified) over "
          f"--synthetic {N_CLI_FRAMES} at the default --batch ({BATCH} on the card): exit 0, "
          f"{N_CLI_FRAMES} frames, {n_kfs} keyframes, {fps:.2f} fps (its own clock; {wall:.3f} s "
          f"with set-up and the output files) | {len(scans)} scans ({caps} graphs captured, "
          f"each a warm-up launch), launches {counts} | "
          f"--batch 1: the same kf_frames.txt, {m1.group(1)} fps ({wall1:.3f} s) | files "
          f"{sizes} | --synthetic {N_FLEET_CLI_FRAMES} --fleet 2: exit 0, seq0/ and seq1/ "
          f"written, on a {mf.group(1)}-device mesh, {mf.group(2)} frames/s aggregate "
          f"({wallf:.3f} s with the vocabulary "
          f"training and set-up) | checkpoint at frame {N_RESUME_AT} resumed on "
          f"CUDA and on the CPU: frames {N_RESUME_AT}-{N_CLI_FRAMES - 1} to equal decisions, "
          f"{cont[DEV][1]} keyframes")
    return counts


def _memory(after: str) -> None:
    """The live captured programs by kind and the card's reserved memory,
    after ``gc.collect()`` and ``torch.cuda.empty_cache()``: a program whose
    held tensors are gone (an estimator's, a fleet's) has been freed."""
    gc.collect()
    live = cuda_graphs.live_programs()        # frees the dropped programs' graphs first
    torch.cuda.empty_cache()
    pools: dict = {}
    for p in cuda_graphs.programs():
        pools[p["key"][0]] = pools.get(p["key"][0], 0) + (p["pool_bytes"] + p["body_bytes"]) / 2**20
    print(f"[memory] after {after}: {sum(live.values())} live programs {live}, their pools and "
          f"steps' pools MB at capture {{{', '.join(f'{k}: {v:.0f}' for k, v in pools.items())}}}, "
          f"memory_reserved {torch.cuda.memory_reserved(0) / 2**20:.1f} MB, "
          f"memory_allocated {torch.cuda.memory_allocated(0) / 2**20:.1f} MB ({CARD})")


def main():
    profile = "--profile" in sys.argv[1:]
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    cam = StereoCamera.kitti()

    def render():
        src = SyntheticSource(cam, **bw.SOURCE)
        return src, list(src)               # rendered before any timing

    src, frames = timed("render", render)
    k1 = timed("K1", phase_k1, frames)
    k2 = timed("K2", phase_k2, frames)
    slice_ms = timed("slice", phase_slice, cam, frames[:N_SLICE_FRAMES], src.gt_poses)
    k3 = timed("K3", phase_k3, frames, k1["device_ms"])
    est_counts, per_frame_s, picked, pg_call = timed("estimator", phase_estimator, frames,
                                                     src.gt_poses, profile)
    paths = {"estimator": est_counts}
    paths.update(timed("options", phase_options, cam, frames[:N_SLICE_FRAMES], src.gt_poses,
                       slice_ms))
    paths["cli"] = timed("cli", phase_cli)
    paths["batched"], strict = timed("batched", phase_batched, frames, src.gt_poses,
                                     per_frame_s)
    paths["fleet"], fleet_ref = timed("fleet", phase_fleet, cam)
    _memory("phase 11")
    timed("check", phase_check, cam, frames, picked)
    del picked          # its store's tensors hold a check program
    entries, rba = timed("insertion", phase_insertion, frames, pg_call)
    paths["mesh"] = timed("mesh", phase_mesh, frames, cam, fleet_ref, entries, rba)
    del fleet_ref       # phase 11's estimators, and the programs that hold their tensors
    _memory("phase 14")
    paths["pipeline"] = timed("pipeline", phase_pipeline, frames, src.gt_poses, strict, entries,
                              rba)
    del entries, rba    # phase 13's engine, which holds its estimator
    _memory("phase 15")
    timed("scan launches", phase_scan_launches, frames)
    paths["bench"] = timed("bench", phase_bench, frames, src.gt_poses)
    _memory("phase 16")
    print(f"[phases] seconds {seconds}")
    for k in (k1, k2, k3):
        k["launches_by_path"] = {path: c[k["name"]] for path, c in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        k["on_main_path"] = any(k["launches_by_path"][path] > 0 for path in USER_PATHS)
        check(k["launches"] > 0, f"no driven path launched {k['name']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "device_ms", "profiler_us", "bound_ms", "bound_by", "bound_share", "library_ms",
            "launches_by_path", "on_main_path")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (k1, k2, k3)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
