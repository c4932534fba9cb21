#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU, and check it.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py            # add --profile for the device busy share

Phases, each printing one line; any failure raises and the exit code is
not 0 (there is no CPU fallback):

1. device    - the card (``nvidia-smi`` name and power limit), CUDA, nvcc;
2. build     - compiles the kernels of ``srba_slam_tpu_torch/csrc`` from the
               checkout, one nvcc per source, all started together
               (``ops/cuda_build.py``), and times the build;
3. K1        - ``fast_nms`` kernel against its plain torch version on the
               card, bit-exact (``torch.equal``), on a rendered KITTI-size
               street stereo pair (uint8), a quantized plateau image (f32,
               threshold 20) and an unaligned 3x123x300 random batch;
4. K2        - ``orb_descriptors`` kernel (the blur fused in) against its
               plain version ``upright_descriptors(gauss_blur7(frames))``,
               bit-exact, at the K=512 keypoints K1 gives on the street pair;
5. slice     - ``StereoVOEngine`` on the card over the first 30 frames of
               the bench workload (KITTI geometry, street scene, seed 11,
               capacity 512). K1 and K2 launch exactly once per frame. The
               first 5 frames also run on the port's CPU path and must agree:
               identical validity, counts and integer features, pose
               increments within 1e-4 rad / 1e-3 m. Then one
               ``extract_and_match`` of the street pair under torch.profiler:
               the frontend's kernel launches and device µs per frame;
6. K3        - ``fast_score_map`` kernel against its plain version,
               bit-exact, on the street left image (uint8), the plateau pair
               (f32, threshold 20) and an odd-size 123x300 image; then timed
               on the street left image and on the street pair, each beside
               the launch floor (an empty kernel at K3's grid and block), and
               on the pair beside K1's device time from phase 3. The
               estimator's default margin of 16 never reaches K3, and no
               config key or CLI flag sets the margin: ``margin`` is an
               argument of the library's ``extract_and_match`` only, and
               the margin-3 frontend of phase 8 is what launches K3;
7. estimator - ``SRBAStereoSLAMEstimator`` on the card over the 81-frame
               bench workload, under ``torch.use_deterministic_algorithms``,
               then ``finalize``. K1 and K2 launch once per VO pass (the
               adaptive retry re-runs frames); the per-frame keyframe
               decisions equal the JAX package's per-frame run, committed as
               ``srba_slam_tpu_torch/data/jax_bench_steplog.json``; the frames
               up to the second insertion after KF0 also run on the port's
               CPU path with the same decisions and keyframe poses within
               1e-4 rad / 1e-3 m; the aligned ATE of the final keyframe poses
               is under 0.5 m (the JAX package's gate,
               tests/test_kitti_geometry_ate.py); the four output files exist;
               ``gauss_blur7`` never runs on a CUDA tensor (K2 blurs inside);
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
               ``--synthetic 60``: exit code 0, the seven output files, one
               pose row per keyframe, K1 and K2 at least once per frame.
               Then ``--synthetic 30 --checkpoint``, and the checkpoint
               resumed into a fresh estimator on the card and one on the
               CPU: both step frames 30-59 to equal keyframe decisions. With
               PIL present, 10 rendered pairs go to PNG files and the CLI
               reads them through whichever loader builds.

Then one JSON line with, per kernel: its launches over the driven paths
(``launches_by_path``: the estimator run, the margin-3 frontend, the
two-octave engine and the CLI run, each counted from 0;
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
import hashlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srba_slam_tpu_torch import (  # noqa: E402
    SRBAStereoSLAMEstimator, StereoCamera, StereoVOEngine, VOOptions, load_config,
)
from srba_slam_tpu_torch.__main__ import main as cli_main  # noqa: E402
from srba_slam_tpu_torch.models.estimator import bench_estimator  # noqa: E402
from srba_slam_tpu_torch.models.vo import _avgpool2, _octave_budget, extract_and_match  # noqa: E402
from srba_slam_tpu_torch.ops import cuda_build, hopper_fast, orb  # noqa: E402
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain  # noqa: E402
from srba_slam_tpu_torch.ops.hopper_fast import (  # noqa: E402
    fast_nms, fast_nms_plain, fast_score_map, orb_descriptors, orb_descriptors_plain,
)
from srba_slam_tpu_torch.ops.nms import grid_topk, local_max_suppress  # noqa: E402
from srba_slam_tpu_torch.ops.rectify import build_maps, remap_bilinear  # noqa: E402
from srba_slam_tpu_torch.utils import bench_workload as bw  # noqa: E402
from srba_slam_tpu_torch.utils import kernel_timing as kt  # noqa: E402
from srba_slam_tpu_torch.utils import se3_np  # noqa: E402
from srba_slam_tpu_torch.utils.checkpoint import load_state  # noqa: E402
from srba_slam_tpu_torch.utils.evaluation import ate_rmse  # noqa: E402
from srba_slam_tpu_torch.utils.framesource import SyntheticSource  # noqa: E402

DEV = "cuda"
N_SLICE_FRAMES = 30
N_CPU_FRAMES = 5
POSE_TOL_RAD = 1e-4
POSE_TOL_M = 1e-3
ATE_GATE_M = 0.5
TIMING_REPS = 20
OUTPUT_FILES = ("out_kf_poses.txt", "time_new_kf.txt", "profiler.csv", "final_graph.dot")
CLI_FILES = (*OUTPUT_FILES, "kf_frames.txt", "final_global_path.ply", "map_viewer.html")
EUROC_INI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo",
                         "config_euroc_example.ini")
N_CLI_FRAMES = 60
N_RESUME_AT = 30
# the paths a user of the entry points can reach (phase_options' margin-3
# frontend is reached through the library's extract_and_match only)
USER_PATHS = ("estimator", "two_octave_engine", "cli")
ORIENTED_ROWS_TOL = 0.02
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


def _fmt(t: dict) -> str:
    return (f"device-only {t['device_ms'] * 1e3:.2f} us (CUDA graph of 100; torch.profiler "
            f"{t['profiler_us']:.2f} us) | bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
            f"({t['bytes'] / 1e6:.3f} MB, {t['ops'] / 1e6:.1f} M f32 ops), share "
            f"{t['bound_share']:.3f} | per call with the wrapper {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms")


def p95(xs) -> float:
    srt = sorted(xs)
    return srt[min(len(srt) - 1, int(np.ceil(0.95 * len(srt))) - 1)]


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
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
    print(f"[frontend] one extract_and_match of the street pair (frame 0) under "
          f"torch.profiler: {front['launches']} kernel launches, device "
          f"{front['device_us']:.1f} us, of which K1 {front['fast_nms_kernel']:.1f} us and "
          f"K2 {front['orb_describe_kernel']:.1f} us (the blur inside K2)")
    return slice_ms


def _frontend_profile(cam, left, right) -> dict:
    """The frontend's launches and device µs for one stereo pair, as the
    VO engine of phase 5 calls it."""
    opts = VOOptions(fast_th=20, n_feats=500)
    evs = kt.profile_calls(lambda: extract_and_match(
        left, right, cam, 20.0, int(opts.orb_max_distance), k=512, cell=opts.min_distance,
        max_y_diff=opts.max_y_diff, device=DEV))
    dev = kt.device_events(evs)
    out = {"launches": kt.launch_count(evs),
           "device_us": sum(e.self_device_time_total for e in dev)}
    for name in ("fast_nms_kernel", "orb_describe_kernel"):
        out[name] = sum(e.self_device_time_total for e in dev if name in e.key)
        check(out[name] > 0, f"the frontend's trace holds no {name}")
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


def _run_estimator(device, frames, snapshot_at=None):
    """Step the bench estimator over ``frames``; returns it with per-frame
    host ms (synchronized) and the keyframe poses after frame
    ``snapshot_at``."""
    est = bench_estimator(device)
    passes = _count_vo_passes(est)
    ms, snap = [], None
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        est.step(left, right)
        if device != "cpu":
            sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == snapshot_at:
            snap = est.rba.kf_global[: est.store.n_kfs].copy()
    return est, passes[0], ms, snap


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
    _reset_launches()
    est, n_passes, ms, snap = _run_estimator(DEV, frames, snapshot_at=n_cpu - 1)
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
        t0 = time.perf_counter()
        est.finalize(out_dir=out_dir)
        finalize_ms = (time.perf_counter() - t0) * 1e3
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

    cpu, _n_cpu_passes, cpu_ms, cpu_snap = _run_estimator("cpu", frames[:n_cpu],
                                                          snapshot_at=n_cpu - 1)
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
    if profile:
        _profile_estimator(frames)
    return counts


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


def _profile_estimator(frames):
    """The estimator run again under torch.profiler: device kernel time
    against wall time, and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run_estimator(DEV, frames)
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
    print(f"[profile] estimator {len(frames)} frames under torch.profiler: wall {wall_ms:.1f} ms, "
          f"device kernel time {dev_us / 1e3:.1f} ms, busy share {dev_us / 1e3 / wall_ms:.4f} "
          f"(reading the trace took {time.perf_counter() - t0:.1f} s) | "
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
        _reset_launches()
        t0 = time.perf_counter()
        rc, said = _cli([ini, "--synthetic", str(N_CLI_FRAMES)])
        sync()
        wall = time.perf_counter() - t0
        counts = _launches()
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
        check(counts["fast_nms"] >= N_CLI_FRAMES and counts["orb_descriptors"] >= N_CLI_FRAMES,
              f"the CLI run launched {counts} over {N_CLI_FRAMES} frames")

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
          f"--synthetic {N_CLI_FRAMES}: exit 0, {N_CLI_FRAMES} frames, {n_kfs} keyframes, "
          f"{fps:.2f} fps (its own clock; {wall:.3f} s with set-up and the output files) | "
          f"launches {counts} | files {sizes} | checkpoint at frame {N_RESUME_AT} resumed on "
          f"CUDA and on the CPU: frames {N_RESUME_AT}-{N_CLI_FRAMES - 1} to equal decisions, "
          f"{cont[DEV][1]} keyframes")
    return counts


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
    paths = {"estimator": timed("estimator", phase_estimator, frames, src.gt_poses, profile)}
    paths.update(timed("options", phase_options, cam, frames[:N_SLICE_FRAMES], src.gt_poses,
                       slice_ms))
    paths["cli"] = timed("cli", phase_cli)
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
