#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's stereo-VO slice once on one GPU, and check it.

Run from the root of the repository, on a machine with one CUDA card and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and the exit code is
not 0 (there is no CPU fallback):

1. device  - the card (``nvidia-smi`` name and power limit), CUDA, nvcc;
2. build   - compiles the kernels of ``srba_slam_tpu_torch/csrc`` from the
             checkout (``ops/cuda_build.py``) and times the build;
3. K1      - ``fast_nms`` kernel against its plain torch version on the
             card, bit-exact (``torch.equal``), on a rendered KITTI-size
             street stereo pair (uint8), a quantized plateau image (f32,
             threshold 20) and an unaligned 3x123x300 random batch;
4. K2      - ``orb_descriptors`` kernel against its plain version, bit-exact,
             at the K=512 keypoints K1 gives on the street pair;
5. slice   - ``StereoVOEngine`` on the card over the 30-frame bench
             workload (KITTI geometry, street scene, seed 11, capacity 512).
             Both kernels' launch counts must rise by exactly one per frame.
             The first 5 frames also run on the port's CPU path and must
             agree: identical validity, counts and integer features, pose
             increments within 1e-4 rad / 1e-3 m. Prints per-frame ms and
             the accumulated translation error against ground truth.

Then one JSON line with each kernel's launches, error and times (kernel
and plain version, CUDA events, median of 20), and as the last line
``{"ok": true, "device": {...}}``. float32 matrix products and
convolutions run without TF32 (both flags are set off below).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from srba_slam_tpu_torch import StereoCamera, StereoVOEngine, VOOptions
from srba_slam_tpu_torch.ops import cuda_build, hopper_fast
from srba_slam_tpu_torch.ops.hopper_fast import fast_nms, fast_nms_plain, orb_descriptors
from srba_slam_tpu_torch.ops.nms import grid_topk
from srba_slam_tpu_torch.ops.orb import gauss_blur7, upright_descriptors
from srba_slam_tpu_torch.utils import se3_np
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

N_FRAMES = 30
N_CPU_FRAMES = 5
POSE_TOL_RAD = 1e-4
POSE_TOL_M = 1e-3
TIMING_REPS = 20


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median over ``reps`` calls of ``fn`` of its time on the card (CUDA
    events around each call), after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
          f"cudnn {torch.backends.cudnn.allow_tf32}")


def phase_build():
    t0 = time.perf_counter()
    cuda_build.load()
    dt = time.perf_counter() - t0
    with open(cuda_build.library_path() + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {dt:.3f} s -> {cuda_build.library_path()} | ptxas: {' ; '.join(ptxas)}")


def phase_k1(frames) -> dict:
    rng = np.random.default_rng(0)
    street = torch.from_numpy(np.stack(frames[0])).cuda()                  # [2,370,1226] u8
    plateau = torch.from_numpy(
        rng.integers(0, 8, (2, 370, 1226)).astype(np.float32) * 30.0).cuda()
    unaligned = torch.from_numpy(rng.integers(0, 255, (3, 123, 300)).astype(np.uint8)).cuda()
    worst = 0.0
    parts = []
    for name, imgs, th in (("street", street, 20.0), ("plateau", plateau, 20.0),
                           ("unaligned", unaligned, 12.0)):
        got = fast_nms(imgs, th, margin=16, radius=2)
        ref = fast_nms_plain(imgs, th, margin=16, radius=2)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, ref), f"K1 differs from its plain version on {name}: max {err}")
        parts.append(f"{name} {tuple(imgs.shape)} {imgs.dtype} equal, {int((ref > 0).sum())} kept")
    ms = cuda_ms(lambda: fast_nms(street, 20.0))
    plain_ms = cuda_ms(lambda: fast_nms_plain(street, 20.0))
    print(f"[K1 fast_nms] bit-exact: {'; '.join(parts)} | at 2x370x1226 u8: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "fast_nms", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/fast_nms.cu",
            "replaces": "srba_slam_tpu/ops/pallas_fast.py:195",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_k2(frames) -> dict:
    street = torch.from_numpy(np.stack(frames[0])).cuda()
    ys, xs, _sc, valid = grid_topk(fast_nms(street, 20.0), cell=5, k=512)
    blurred = gauss_blur7(street)
    got = orb_descriptors(blurred, ys, xs, valid, margin=16)
    ref = upright_descriptors(blurred, ys, xs, valid)
    torch.cuda.synchronize()
    err = float((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    check(torch.equal(got, ref), f"K2 differs from its plain version: max word diff {err}")
    n_valid = int(valid.sum())
    check(n_valid > 0 and bool((got[valid] != 0).any()), "K2: no valid keypoint has bits set")
    ms = cuda_ms(lambda: orb_descriptors(blurred, ys, xs, valid, margin=16))
    plain_ms = cuda_ms(lambda: upright_descriptors(blurred, ys, xs, valid))
    print(f"[K2 orb_descriptors] bit-exact at {tuple(got.shape)}, {n_valid} valid keypoints | "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "orb_descriptors", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/orb_describe.cu",
            "replaces": "srba_slam_tpu/ops/pallas_fast.py:296",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _int_fields_differing(a, b) -> list[str]:
    names = ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
             "m_r_idx", "m_valid")
    return [n for n in names if not torch.equal(getattr(a, n).cpu(), getattr(b, n).cpu())]


def phase_slice(cam, frames, gt_poses) -> dict:
    def engine(device):
        return StereoVOEngine(cam, VOOptions(fast_th=20, n_feats=500), capacity=512,
                              device=device)

    eng = engine("cuda")
    results, feats, ms = [], [], []
    hopper_fast.fast_nms.launches = 0
    hopper_fast.orb_descriptors.launches = 0
    for i, (left, right) in enumerate(frames):
        t0 = time.perf_counter()
        res = eng.process_stereo_pair(left, right)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches = (hopper_fast.fast_nms.launches, hopper_fast.orb_descriptors.launches)
        check(launches == (i + 1, i + 1),
              f"frame {i}: kernel launch counts {launches}, expected {i + 1} each")
        results.append(res)
        if i < N_CPU_FRAMES:
            feats.append(eng.last_frame())
    counts = {"fast_nms": hopper_fast.fast_nms.launches,
              "orb_descriptors": hopper_fast.orb_descriptors.launches}

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
    t_err = float(np.linalg.norm(est[3:] - gt_poses[-1][3:]))
    path = float(np.sum(np.linalg.norm(np.diff(gt_poses[:, 3:], axis=0), axis=1)))
    check(t_err < 0.05 * path, f"translation error {t_err} m over a {path} m path")
    srt = sorted(ms)
    p95 = srt[min(len(srt) - 1, int(np.ceil(0.95 * len(srt))) - 1)]
    print(f"[slice] {len(frames)} frames 370x1226 on CUDA: per-frame median "
          f"{statistics.median(ms):.3f} ms, p95 {p95:.3f} ms, first {ms[0]:.3f} ms | "
          f"launches {counts} | first {N_CPU_FRAMES} frames match the CPU path | "
          f"stereo matches median {int(np.median([r.num_stereo_matches for r in results]))}, "
          f"tracked median {int(np.median([r.tracked_from_last_frame for r in results[1:]]))} | "
          f"translation error at frame {len(frames)}: {t_err:.4f} m over {path:.2f} m")
    return counts


def main():
    phase_device()
    phase_build()
    cam = StereoCamera.kitti()
    src = SyntheticSource(cam, n_frames=N_FRAMES, seed=11, step=0.8, scene="street")
    frames = list(src)                      # rendered before any timing
    k1 = phase_k1(frames)
    k2 = phase_k2(frames)
    counts = phase_slice(cam, frames, src.gt_poses)
    k1["launches"] = counts["fast_nms"]
    k2["launches"] = counts["orb_descriptors"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in keys} for d in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
