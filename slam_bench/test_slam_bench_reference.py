"""The plain reference at a tiny size on the CPU: its frontend and its pose
solve against the program's CPU path on rendered frames, its remap
against the pinhole render, and its lower-precision control apart."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from slam_bench import correct, render
from slam_bench.reference import frontend, vo as ref_vo

CAM = dict(fx_l=185.0, fy_l=185.0, cx_l=160.5, cy_l=64.2, fx_r=185.0, fy_r=185.0, cx_r=160.5,
           cy_r=64.2, baseline=0.54, width=320, height=128)


@pytest.fixture(scope="module")
def frames():
    eye = render.Camera(CAM["fx_l"], CAM["fy_l"], CAM["cx_l"], CAM["cy_l"], 320, 128)
    drive = render.Drive((eye, eye), 0.54, n_frames=3, seed=9, step=0.5, device="cpu")
    return drive.render(range(3))


def _port_frame(left, right, fast_th, orb_th, k=256, rect_maps=None):
    from srba_slam_tpu_torch.models.vo import extract_and_match
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    return extract_and_match(left, right, StereoCamera(**CAM), fast_th, orb_th, k=k,
                             rect_maps=rect_maps, device="cpu")


def test_frontend_equals_the_programs_cpu_path(frames):
    lefts, rights = frames
    for f in range(3):
        ref = frontend.frontend(lefts[f], rights[f], CAM, 20.0, 60, 256)
        got = _port_frame(lefts[f], rights[f], 20.0, 60)
        for name in ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r", "desc_r",
                     "m_r_idx", "m_valid"):
            assert torch.equal(getattr(ref, name), getattr(got, name)), name
        assert torch.equal(ref.pts3d, got.pts3d)


def test_remapped_frontend_equals_the_programs_cpu_path(frames):
    from srba_slam_tpu_torch.ops.rectify import build_maps

    dist = (-0.28, 0.07, 2e-4, 2e-5, 0.0)
    lefts, rights = frames
    maps = frontend.build_maps(320, 128, CAM["fx_l"], CAM["fy_l"], CAM["cx_l"], CAM["cy_l"], dist)
    port_maps = build_maps(320, 128, CAM["fx_l"], CAM["fy_l"], CAM["cx_l"], CAM["cy_l"], dist,
                           device="cpu")
    assert torch.equal(maps.map_x, port_maps.map_x) and torch.equal(maps.map_y, port_maps.map_y)
    ref = frontend.frontend(lefts[0], rights[0], CAM, 15.0, 60, 256, maps=(maps, maps))
    got = _port_frame(lefts[0], rights[0], 15.0, 60, rect_maps=(port_maps, port_maps))
    for name in ("ys_l", "xs_l", "valid_l", "desc_l", "m_r_idx", "m_valid"):
        assert torch.equal(getattr(ref, name), getattr(got, name)), name


def test_pose_solve_follows_the_programs_cpu_path(frames):
    from srba_slam_tpu_torch.models.vo import track_and_solve
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    lefts, rights = frames
    prev_p, cur_p = (_port_frame(lefts[f], rights[f], 20.0, 60) for f in (0, 1))
    init = torch.zeros(6)
    opts = dict(kernel_param=3.0, residual_threshold=15.0, min_mod=1e-3, max_iters_initial=30,
                max_iters=30, min_inliers=5, max_incr_cost=3)
    out = track_and_solve(prev_p, cur_p, StereoCamera(**CAM), init, 60, **opts)
    prev_r, cur_r = (frontend.frontend(lefts[f], rights[f], CAM, 20.0, 60, 256) for f in (0, 1))
    R, t, ok = ref_vo.solve(cur_r, prev_r, CAM, torch.eye(3, dtype=torch.float64),
                            torch.zeros(3, dtype=torch.float64), 60, **opts)
    assert ok and bool(out.pose.valid)
    pose = out.pose.pose.double().numpy()
    assert np.linalg.norm(pose[3:] - t.numpy()) < 1e-4
    assert correct._angle(correct.rotvec_to_R(pose[:3]), R.numpy()) < 1e-5
    # the rendered motion: 0.5 m forward
    assert abs(float(t[2]) + 0.5) < 0.05


def test_bfloat16_reference_moves_the_answers(frames):
    lefts, rights = frames
    f32 = [frontend.frontend(lefts[f], rights[f], CAM, 20.0, 60, 256) for f in (0, 1)]
    b16 = [frontend.frontend(lefts[f], rights[f], CAM, 20.0, 60, 256, dtype=torch.bfloat16)
           for f in (0, 1)]
    assert not torch.equal(f32[1].desc_l, b16[1].desc_l)
    eye3, z3 = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    opts = dict(kernel_param=3.0, residual_threshold=15.0, min_mod=1e-3, max_iters_initial=30,
                max_iters=30, min_inliers=5, max_incr_cost=3)
    _R, t32, _ = ref_vo.solve(f32[1], f32[0], CAM, eye3, z3, 60, **opts)
    _R, t16, _ = ref_vo.solve(b16[1], b16[0], CAM, eye3, z3, 60, dtype=torch.bfloat16, **opts)
    assert float(torch.linalg.vector_norm(t32 - t16)) > 1e-3


def _vocabulary(desc: torch.Tensor, n_words: int = 64, seed: int = 3):
    """A vocabulary of ``n_words`` random {0,1} words with random idf weights."""
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (n_words, 256), generator=g, dtype=torch.int8)
    weights = torch.rand(n_words, generator=g) + 0.1
    return bits, weights


def test_bow_query_equals_the_programs_cpu_path(frames):
    from srba_slam_tpu_torch.models.bow import bow_vector, rank_scores

    from slam_bench.reference import bow as ref_bow

    lefts, rights = frames
    feats = [frontend.frontend(lefts[f], rights[f], CAM, 20.0, 60, 256) for f in range(3)]
    bits, weights = _vocabulary(feats[0].desc_l)
    desc = torch.stack([f.desc_l for f in feats])
    valid = torch.stack([f.m_valid for f in feats])
    prog = bow_vector(desc, valid, bits.float(), weights)
    mine = ref_bow.vectors(desc, valid, bits, weights)
    assert torch.allclose(prog.double(), mine, atol=1e-7)
    # the query of frame 2 against frames 0 and 1: the same scores and order
    s_prog = torch.sum(torch.minimum(prog[:2], prog[2][None]), -1)
    s_ref = ref_bow.scores(mine[2], mine[:2])
    assert torch.allclose(s_prog.double(), s_ref, atol=1e-7)
    assert rank_scores(s_prog, 2)[1].tolist() == ref_bow.rank(s_ref, 2)[1].tolist()
    # the lower type moves the scores past the limit of the configuration
    low = ref_bow.scores(*(lambda v: (v[2], v[:2]))(
        ref_bow.vectors(desc, valid, bits, weights, torch.bfloat16))).double()
    assert float((low - s_ref).abs().max()) > 1e-4


def _window(seed: int = 5, C: int = 4, L: int = 60):
    """A small window: C keyframes 0.5 m apart along z, L landmarks seen by
    every keyframe, observations exact but for a pixel of noise, the
    keyframes' initial poses 2 cm and 0.5 degrees off."""
    g = np.random.default_rng(seed)
    truth = np.zeros((C, 6))
    truth[:, 5] = 0.5 * np.arange(C)
    pts = np.c_[g.uniform(-4, 4, L), g.uniform(-1, 1, L), g.uniform(6, 20, L)]
    obs_cam, obs_lm, obs_px = [], [], []
    for c in range(C):
        x = pts - truth[c, 3:]
        for lm in range(L):
            X, Y, Z = x[lm]
            obs_cam.append(c), obs_lm.append(lm)
            obs_px.append([CAM["cx_l"] + CAM["fx_l"] * X / Z, CAM["cy_l"] + CAM["fy_l"] * Y / Z,
                           CAM["cx_r"] + CAM["fx_r"] * (X - CAM["baseline"]) / Z])
    obs_px = np.asarray(obs_px) + g.normal(0, 1.0, (len(obs_px), 3))
    init = truth.copy()
    init[1:, 3:] += g.normal(0, 0.02, (C - 1, 3))
    init[1:, :3] += g.normal(0, 0.01, (C - 1, 3))
    O = len(obs_cam)
    ints = np.concatenate([np.zeros(L), obs_cam, obs_lm, np.ones(C), np.ones(L),
                           np.ones(O)]).astype(np.int32)
    floats = np.concatenate([init.ravel(), (pts + g.normal(0, 0.05, pts.shape)).ravel(),
                             obs_px.ravel()]).astype(np.float32)
    return ints, floats, (C, L, O)


def test_window_solve_follows_the_programs_cpu_path():
    from srba_slam_tpu_torch.ops import window_ba
    from srba_slam_tpu_torch.utils.camera import StereoCamera

    from slam_bench.reference import window as ref_window

    ints, floats, (C, L, O) = _window()
    kw = dict(kernel_param=1.5, max_iters=8, use_kernel=True, init_lambda=1e-4,
              w_prior_rot=1000.0, w_prior_trans=100.0, stage1_iters=2, use_kernel_stage1=True)
    win = ref_window.unpack(ints, floats, C, L, O)
    pose, lm, cost0, cost = ref_window.solve(win, CAM, **kw)
    assert cost < 0.5 * cost0
    bw = window_ba.unpack_window(torch.as_tensor(ints), torch.as_tensor(floats), C, L, O)
    r = window_ba.optimize_window(bw, StereoCamera(**CAM), **kw)
    assert abs(float(r.cost_init) - cost0) < 1e-5 * cost0
    pb = ref_window.Problem(win, CAM, 1.5, 1000.0, 100.0)
    prog = float(pb.cost(r.cam_pose.double(), r.lm_pos.double(), True))
    assert abs(prog - cost) < 1e-4 * cost
    assert float((r.cam_pose.double() - pose).abs().max()) < 1e-4
    # bfloat16 in its place reaches a cost past the configuration's limit
    p16, l16, _, _ = ref_window.solve(win, CAM, dtype=torch.bfloat16, **kw)
    low = float(pb.cost(p16.double(), l16.double(), True))
    assert (low - cost) / max(cost, cost0 - cost) > 1e-3
