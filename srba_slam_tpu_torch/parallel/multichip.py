"""The port's counterparts of the JAX package's ``__graft_entry__.py``:
the single-card VO step and the multi-device dry run.

``entry(device)`` returns ``(fn, example_args)``: ``fn(left, right, prev,
init_pose)`` is the stereo-VO step of the flagship pipeline (detect,
describe, stereo match, track, robust pose: ``extract_and_match`` then
``track_and_solve`` at FAST threshold 20 and ORB threshold 60) at KITTI
resolution with k = 512 features, returning ``(pose, num_inliers,
m_valid)``; the example frames are ``default_rng(0)`` uniform f32
370x1226 images on ``device``, ``prev`` their frontend and ``init_pose``
zeros(6). On a card it launches K1 (on its f32 route) and K2, and a
call is two program replays (``models/vo.py`` ``FRAME_PROGRAMS``: the
frame program, then the track program), where the JAX package compiles
the step as one program.
``vo_step(h, w, k, device)`` builds the same at another size.

``dryrun_multichip(n)`` drives every sharded path of the port over a mesh
of n devices, with the JAX dry run's small camera, asserts and bounds:

1. ``batched_vo_step`` over n sequences, twice, with its fleet means;
2. ``FleetSLAM`` of n sequences (8 frames each), one a device, with
   keyframe checks and insertions on every shard;
3. one window's bundle adjustment observation-sharded over the mesh
   against the unsharded solve, at a tiny window and at the loop-closure
   bucket (C=32, L=8192, O=16384): max |dpose| under 1e-3; the sharded
   solves timed on their default route (on a card the sharded programs,
   ``ops/window_ba.py`` ``WBA_SHARD_PROGRAMS``; on the CPU their bodies)
   and equal bit for bit to the eager LM blocks;
4. the fleet's frames/s on the mesh against one device, median of 3.

``devices=`` gives the mesh where the JAX package bootstraps a virtual one
(``["cpu"] * n``; ``["cuda:0"] * n`` on one card): a repeated device runs
its shards one after the other, so its times are no scaling numbers.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


ENTRY_FAST_TH = 20.0
ENTRY_ORB_TH = 60


def vo_step(h: int, w: int, k: int, device="cuda", cam=None):
    """``(fn, example_args)`` of the stereo-VO step on [h, w] frames with
    ``k`` features on ``device``, with ``cam`` (KITTI's by default)."""
    from srba_slam_tpu_torch.models.vo import extract_and_match, track_frame
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    cam = cam or StereoCamera.kitti()

    def fn(left, right, prev, init_pose):
        cur = extract_and_match(left, right, cam, ENTRY_FAST_TH, ENTRY_ORB_TH, k=k,
                                device=device)
        out = track_frame(prev, cur, cam, init_pose, ENTRY_ORB_TH)
        return out.pose.pose, out.pose.num_inliers, cur.m_valid

    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(device)
    right = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(device)
    prev = extract_and_match(left, right, cam, ENTRY_FAST_TH, ENTRY_ORB_TH, k=k, device=device)
    init = torch.zeros(6, dtype=torch.float32, device=device)
    return fn, (left, right, prev, init)


def entry(device="cuda"):
    """``(fn, example_args)``: the VO step at KITTI resolution (370x1226,
    k = 512) on ``device`` (≙ ``__graft_entry__.py`` ``entry``)."""
    return vo_step(370, 1226, 512, device)


def _tiny_window(cam, rng, device):
    """Small consistent BA window (3 cams on a line, 40 landmarks) for the
    sharded-vs-unsharded window solve check."""
    from srba_slam_tpu_torch.ops.window_ba import BAWindow
    from srba_slam_tpu_torch.utils import se3_np

    C, L, O = 8, 64, 512
    n_cams, n_lms = 3, 40
    gt = np.zeros((n_cams, 6))
    gt[:, 5] = 0.4 * np.arange(n_cams)
    lms_w = np.stack([rng.uniform(-4, 4, n_lms), rng.uniform(-1, 1, n_lms),
                      rng.uniform(5, 15, n_lms)], -1)
    lm_base = rng.integers(0, n_cams, n_lms)
    lm_pos = np.stack([se3_np.transform_point(se3_np.inverse(gt[b]), p)
                       for b, p in zip(lm_base, lms_w)])
    oc, ol, op = [], [], []
    for c in range(n_cams):
        for j in range(n_lms):
            pc = se3_np.transform_point(se3_np.inverse(gt[c]), lms_w[j])
            if pc[2] < 1.0:
                continue
            oc.append(c)
            ol.append(j)
            op.append([cam.cx_l + cam.fx_l * pc[0] / pc[2],
                       cam.cy_l + cam.fy_l * pc[1] / pc[2],
                       cam.cx_r + cam.fx_r * (pc[0] - cam.baseline) / pc[2]])
    cam_pose = np.zeros((C, 6), np.float32)
    cam_pose[:n_cams] = gt
    cam_pose[1:n_cams] += rng.normal(0, 0.02, (n_cams - 1, 6))
    lm_arr = np.zeros((L, 3), np.float32)
    lm_arr[:n_lms] = lm_pos + rng.normal(0, 0.05, (n_lms, 3))
    lb = np.zeros(L, np.int32)
    lb[:n_lms] = lm_base
    oca = np.zeros(O, np.int32)
    ola = np.zeros(O, np.int32)
    opa = np.zeros((O, 3), np.float32)
    ova = np.zeros(O, bool)
    n_o = len(oc)
    oca[:n_o], ola[:n_o], opa[:n_o], ova[:n_o] = oc, ol, op, True
    return BAWindow(*(torch.as_tensor(a, device=device) for a in (
        cam_pose, np.arange(C) < n_cams, lm_arr, lb, np.arange(L) < n_lms, oca, ola, opa, ova)))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the port's sharded paths over a mesh of ``n_devices`` devices
    (the machine's first cards, or ``devices``), assert what the JAX dry
    run asserts, print one summary line and return its numbers."""
    from srba_slam_tpu_torch.config import GeneralOptions, SRBAStereoSLAMOptions, VOOptions
    from srba_slam_tpu_torch.models.bow import Vocabulary
    from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
    from srba_slam_tpu_torch.ops import window_ba
    from srba_slam_tpu_torch.ops.window_ba import optimize_window, shard_window_obs
    from srba_slam_tpu_torch.parallel.batch import (
        batched_vo_step, empty_features, make_mesh,
    )
    from srba_slam_tpu_torch.parallel.fleet import FleetSLAM
    from srba_slam_tpu_torch.utils.camera import StereoCamera
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource
    from srba_slam_tpu_torch.utils.synthworld import make_ba_window_problem

    mesh = make_mesh(n_devices, devices=devices)
    lead = mesh.lead
    cam = StereoCamera(fx_l=64.0, fy_l=64.0, cx_l=64.0, cy_l=48.0, fx_r=64.0, fy_r=64.0,
                       cx_r=64.0, cy_r=48.0, baseline=0.5, width=128, height=96)
    b, h, w, k = n_devices, 96, 128, 64
    rng = np.random.default_rng(1)

    # 1) the batch-parallel VO step with its fleet reductions
    lefts = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    rights = np.roll(lefts, -3, axis=-1)  # fake disparity
    init = np.zeros((b, 6), np.float32)
    cur, *_ = batched_vo_step(mesh, lefts, rights, empty_features(b, k, device=lead), init, cam,
                              fast_th=8.0, k=k)
    _cur2, poses2, _valid2, fleet_res2, fleet_frac2 = batched_vo_step(
        mesh, lefts, rights, cur, init, cam, fast_th=8.0, k=k)
    assert tuple(poses2.shape) == (b, 6)
    assert bool(torch.isfinite(poses2).all())
    assert bool(torch.isfinite(fleet_res2)) and bool(torch.isfinite(fleet_frac2))

    # 2) the full pipeline: n sequences, one a device, checks and insertions
    #    on every shard
    desc = rng.integers(0, 2**32, (256, 8), dtype=np.uint64).astype(np.uint32)
    voc = Vocabulary.train(desc, k=8, L=2, seed=0)

    def build_est(device):
        opts = SRBAStereoSLAMOptions(
            orb_adaptive_fast_th=True, camera=cam, n_feats=k, detect_fast_th=8,
            adaptive_th_min_matches=20, max_translation=0.25, max_rotation=10.0,
            updated_matches_th=25, vo_id_tracking_th=20, srba_submap_size=4,
            srba_max_optimize_depth=3, da_filter_by_direction=False, residual_th=10.0)
        est = SRBAStereoSLAMEstimator(GeneralOptions(), opts, VOOptions(fast_th=8, n_feats=k),
                                      capacity=k, max_kfs=16, device=device)
        est.initialize(vocabulary=voc)
        return est

    def sources(n):
        return [SyntheticSource(cam, n_frames=8, seed=100 + i, step=0.12) for i in range(n)]

    def run_fleet(m) -> tuple[list, float]:
        ests = [build_est(d) for d in m.devices]
        t0 = time.perf_counter()
        FleetSLAM(ests, mesh=m).run(sources(len(ests)))
        _sync(lead)
        return ests, time.perf_counter() - t0

    ests, _dt = run_fleet(mesh)
    n_kfs = [e.store.n_kfs for e in ests]
    n_checks = sum(1 for e in ests for r in e.step_log if r.kf_check)
    assert all(nk >= 2 for nk in n_kfs), f"expected inserts on every shard: {n_kfs}"
    assert n_checks >= n_devices, f"expected KF checks (BoW+DA) fleet-wide: {n_checks}"
    for e in ests:
        e.rba.flush()
        assert np.isfinite(e.rba.kf_global[: e.store.n_kfs]).all()

    # 3) one sequence's window bundle adjustment observation-sharded over the
    #    mesh against the one-device solve
    obs_mesh = make_mesh(devices=mesh.devices, axis="obs")
    route = ("programs" if window_ba.WBA_SHARD_PROGRAMS and lead.type == "cuda" else
             "program bodies, eager" if window_ba.WBA_SHARD_PROGRAMS else "eager LM blocks")

    def same_as_eager(sharded_win, r, **kw) -> bool:
        prev, window_ba.WBA_SHARD_PROGRAMS = window_ba.WBA_SHARD_PROGRAMS, False
        try:
            eager = optimize_window(sharded_win, **kw)
        finally:
            window_ba.WBA_SHARD_PROGRAMS = prev
        return all(torch.equal(x, y) for x, y in zip(r, eager))

    win = _tiny_window(cam, np.random.default_rng(0), lead)
    r1 = optimize_window(win, cam, max_iters=8)
    tiny = shard_window_obs(win, obs_mesh)
    rs = optimize_window(tiny, cam, max_iters=8)
    sharded_err = float((rs.cam_pose - r1.cam_pose).abs().max())
    assert sharded_err < 1e-3, f"sharded window BA diverged: {sharded_err}"
    assert same_as_eager(tiny, rs, cam=cam, max_iters=8), "sharded solve != its eager blocks"

    # 3b) the same at the loop-closure window bucket, with the wall time of
    #     the second of two solves each
    kcam = StereoCamera.kitti()
    big, _gt = make_ba_window_problem(kcam, np.random.default_rng(7), C=32, L=8192, O=16384,
                                      n_cams=30, n_lms=5000, pose_noise=0.03, px_noise=0.3)
    big = type(big)(*(t.to(lead) for t in big))

    def timed_solve(w_):
        for _ in range(2):
            _sync(lead)
            t0 = time.perf_counter()
            r = optimize_window(w_, kcam, max_iters=4)
            _sync(lead)
        return r, time.perf_counter() - t0

    rb1, t_big1 = timed_solve(big)
    big_sharded = shard_window_obs(big, obs_mesh)
    rbn, t_bign = timed_solve(big_sharded)
    lc_err = float((rbn.cam_pose - rb1.cam_pose).abs().max())
    assert lc_err < 1e-3, f"LC-bucket sharded window BA diverged: {lc_err}"
    assert same_as_eager(big_sharded, rbn, cam=kcam, max_iters=4), \
        "LC-bucket sharded solve != its eager blocks"
    assert float(rb1.cost_final) < float(rb1.cost_init), "solve did not improve"

    # 4) the fleet's frames/s on the mesh against one device, median of 3
    #    fresh runs each (the runs above warmed every path)
    fleet_dts = [run_fleet(mesh)[1] for _ in range(3)]
    solo_dts = [run_fleet(make_mesh(devices=[lead]))[1] for _ in range(3)]
    fleet_med, solo_med = sorted(fleet_dts)[1], sorted(solo_dts)[1]
    frames_fleet = 8 * n_devices
    scaling = (frames_fleet / fleet_med) / max(8 / solo_med, 1e-9)
    kind = "distinct devices" if mesh.distinct else "a REPEATED device: no scaling number"
    out = dict(n_devices=n_devices, devices=[str(d) for d in mesh.devices],
               distinct=mesh.distinct, fleet_valid_fraction=float(fleet_frac2),
               fleet_mean_residual=float(fleet_res2), kfs_per_shard=n_kfs, checks=n_checks,
               sharded_err=sharded_err, lc_err=lc_err, window_route=route, lc_ms_1=t_big1 * 1e3,
               lc_ms_n=t_bign * 1e3, fleet_fps_1=8 / solo_med,
               fleet_fps_n=frames_fleet / fleet_med, scaling=scaling,
               fleet_s=fleet_dts, solo_s=solo_dts)
    print(f"dryrun_multichip OK: {n_devices} devices {out['devices']} ({kind}) | batch-VO "
          f"fleet_valid={out['fleet_valid_fraction']:.2f} residual="
          f"{out['fleet_mean_residual']:.3f} | full-pipeline kfs/shard={n_kfs}, "
          f"checks={n_checks} | sharded-window-BA max|dpose|={sharded_err:.2e} (LC bucket "
          f"C=32/L=8192/O=16384: {lc_err:.2e}, 1-dev {out['lc_ms_1']:.1f} ms vs "
          f"{n_devices}-dev {out['lc_ms_n']:.1f} ms on its {route}, 4 LM iterations; both "
          f"sharded solves = the eager LM blocks bit for bit) | fleet 1->{n_devices} "
          f"devices, median of 3: {out['fleet_fps_1']:.2f} -> {out['fleet_fps_n']:.2f} "
          f"frames/s ({scaling:.2f}x; per-run fleet {['%.2fs' % d for d in fleet_dts]} solo "
          f"{['%.2fs' % d for d in solo_dts]}; {len(os.sched_getaffinity(0))} host cores)")
    return out
