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
4. K2        - ``orb_descriptors`` kernel against its plain version,
               bit-exact, at the K=512 keypoints K1 gives on the street pair;
5. slice     - ``StereoVOEngine`` on the card over the first 30 frames of
               the bench workload (KITTI geometry, street scene, seed 11,
               capacity 512). K1 and K2 launch exactly once per frame. The
               first 5 frames also run on the port's CPU path and must agree:
               identical validity, counts and integer features, pose
               increments within 1e-4 rad / 1e-3 m;
6. K3        - ``fast_score_map`` kernel against its plain version,
               bit-exact, on the street left image (uint8), the plateau pair
               (f32, threshold 20) and an odd-size 123x300 image. No path of
               the estimator calls it (none of the JAX package does either);
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
               tests/test_kitti_geometry_ate.py); the four output files exist.

Then one JSON line with each kernel's launches in the estimator run, error
and times (kernel and plain version, CUDA events, median of 20), and as the
last line ``{"ok": true, "device": {...}}``. float32 matrix products and
convolutions run without TF32 (both flags are set off below).
"""

from __future__ import annotations

import os

# cuBLAS is deterministic only with a fixed workspace; set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import hashlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srba_slam_tpu_torch import StereoCamera, StereoVOEngine, VOOptions  # noqa: E402
from srba_slam_tpu_torch.models.estimator import bench_estimator  # noqa: E402
from srba_slam_tpu_torch.ops import cuda_build, hopper_fast  # noqa: E402
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain  # noqa: E402
from srba_slam_tpu_torch.ops.hopper_fast import (  # noqa: E402
    fast_nms, fast_nms_plain, fast_score_map, orb_descriptors,
)
from srba_slam_tpu_torch.ops.nms import grid_topk  # noqa: E402
from srba_slam_tpu_torch.ops.orb import gauss_blur7, upright_descriptors  # noqa: E402
from srba_slam_tpu_torch.utils import bench_workload as bw  # noqa: E402
from srba_slam_tpu_torch.utils import se3_np  # noqa: E402
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
PALLAS = "srba_slam_tpu/ops/pallas_fast.py"


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
    ms = cuda_ms(lambda: fast_nms(street, 20.0))
    plain_ms = cuda_ms(lambda: fast_nms_plain(street, 20.0))
    print(f"[K1 fast_nms] bit-exact: {'; '.join(parts)} | at 2x370x1226 u8: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "fast_nms", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/fast_nms.cu",
            "replaces": f"{PALLAS}:197", "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_k2(frames) -> dict:
    street = torch.from_numpy(np.stack(frames[0])).to(DEV)
    ys, xs, _sc, valid = grid_topk(fast_nms(street, 20.0), cell=5, k=512)
    blurred = gauss_blur7(street)
    got = orb_descriptors(blurred, ys, xs, valid, margin=16)
    ref = upright_descriptors(blurred, ys, xs, valid)
    sync()
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
            "replaces": f"{PALLAS}:297", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_k3(frames) -> dict:
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
    ms = cuda_ms(lambda: fast_score_map(left, 20.0))
    plain_ms = cuda_ms(lambda: fast_score_map_plain(left, 20.0))
    print(f"[K3 fast_score_map] bit-exact: {'; '.join(parts)} | at 370x1226 u8: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "fast_score_map", "route": "cuda",
            "source": "srba_slam_tpu_torch/csrc/fast_score.cu",
            "replaces": f"{PALLAS}:71", "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


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
    print(f"[slice] {len(frames)} frames 370x1226 on CUDA: per-frame median "
          f"{statistics.median(ms):.3f} ms, p95 {p95(ms):.3f} ms, first {ms[0]:.3f} ms | "
          f"launches {counts} | first {N_CPU_FRAMES} frames match the CPU path | "
          f"stereo matches median {int(np.median([r.num_stereo_matches for r in results]))}, "
          f"tracked median {int(np.median([r.tracked_from_last_frame for r in results[1:]]))} | "
          f"translation error at frame {len(frames)}: {t_err:.4f} m over {path:.2f} m")


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
    _reset_launches()
    est, n_passes, ms, snap = _run_estimator(DEV, frames, snapshot_at=n_cpu - 1)
    counts = _launches()
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
          f"VO passes {n_passes}, launches {counts} | decisions equal the JAX fingerprint "
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
    timed("slice", phase_slice, cam, frames[:N_SLICE_FRAMES], src.gt_poses)
    k3 = timed("K3", phase_k3, frames)
    counts = timed("estimator", phase_estimator, frames, src.gt_poses, profile)
    print(f"[phases] seconds {seconds}")
    for k in (k1, k2, k3):
        k["launches"] = counts[k["name"]]
    k3["on_main_path"] = False
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: d[k] for k in (*keys, "on_main_path") if k in d}
                                  for d in (k1, k2, k3)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
