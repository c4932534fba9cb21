"""The window solve's fixed shapes and masked LM blocks (``ops/window_ba.py``)
and the SRBA engine's capacity buckets (``models/srba.py``), on the CPU.

* ``optimize_window`` gives the same bits at every period of its exit test
  (``WBA_EXIT_EVERY`` 1, 2, 4 and 12): an LM iteration past the loop's
  exit changes nothing.
* The fixed-shape gather tables (``segment_tables(..., fixed=True)``) sum
  each segment bit for bit as the data-sized ones do, over skewed segment
  sizes and left-out items, and their shapes follow only the item count,
  the segment count and the width.
* One window solve reads the host (``Tensor.item``, ``__bool__``,
  ``__int__``, ``__float__``) at most ceil(iterations / E) times a stage.
* The port's engine pads each window to the (C, L, O) bucket the JAX
  engine picks for the same insertions.
"""

import math

import numpy as np
import pytest
import torch

from srba_slam_tpu.models import srba as jsrba
from srba_slam_tpu.models.srba import SRBAEngine as JEngine, SRBAParams as JParams
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models import srba as tsrba
from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu_torch.ops import window_ba as twb
from srba_slam_tpu_torch.utils.camera import StereoCamera
from srba_slam_tpu_torch.utils.synthworld import make_ba_window_problem

from test_lc_validation import _corridor, _drive_corridor, _true_obs
from test_torch_batched_solve import _count_host_reads

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

SOLVE_KW = dict(kernel_param=1.5, max_iters=8, stage1_iters=2)


def _window(seed=0, C=8, L=128, O=512, n_cams=5, n_lms=100):
    return make_ba_window_problem(StereoCamera.kitti(), np.random.default_rng(seed), C, L, O,
                                  n_cams, n_lms)[0]


@pytest.mark.parametrize("exit_every", [1, 2, 4, 12])
def test_optimize_window_same_bits_at_any_exit_period(monkeypatch, exit_every):
    win = _window(seed=1, C=16, L=256, O=1024, n_cams=9, n_lms=220)
    cam = StereoCamera.kitti()
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", exit_every)
    got = twb.optimize_window(win, cam, **SOLVE_KW)
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", 1)
    ref = twb.optimize_window(win, cam, **SOLVE_KW)
    assert 2 <= int(ref.iters) <= SOLVE_KW["max_iters"]
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name


def _skewed_segments(kind, n, n_seg, rng):
    if kind == "uniform":
        seg = rng.integers(0, n_seg, n)
    elif kind == "one_hot_segment":     # 90% of the items in segment 0
        seg = np.where(rng.random(n) < 0.9, 0, rng.integers(0, n_seg, n))
    elif kind == "geometric":           # sizes fall off like landmark track lengths
        seg = np.minimum(rng.geometric(0.05, n) - 1, n_seg - 1)
    else:                               # "all_in_last"
        seg = np.full(n, n_seg - 1)
    return np.where(rng.random(n) < 0.2, -1, seg)        # a fifth left out


@pytest.mark.parametrize("kind", ["uniform", "one_hot_segment", "geometric", "all_in_last"])
@pytest.mark.parametrize("n,n_seg,width", [(0, 4, 32), (50, 7, 4), (5000, 3, 8),
                                          (3000, 900, 32), (2048, 4096, 4)])
def test_fixed_tables_sum_as_the_data_sized_ones(kind, n, n_seg, width):
    rng = np.random.default_rng(n + n_seg)
    seg = _skewed_segments(kind, n, n_seg, rng)
    data = torch.from_numpy(rng.standard_normal((n, 2, 3)).astype(np.float32))
    tight = twb.segment_tables(seg, n_seg, width)
    fixed = twb.segment_tables(seg, n_seg, width, fixed=True)
    want = twb.segment_sum(data, [torch.from_numpy(t) for t in tight])
    got = twb.segment_sum(data, [torch.from_numpy(t) for t in fixed])
    assert torch.equal(got, want)
    ref = np.zeros((n_seg, 2, 3), np.float64)
    np.add.at(ref, seg[seg >= 0], data.numpy()[seg >= 0].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # the shapes follow (n, n_seg, width) only
    other = twb.segment_tables(np.full(n, -1), n_seg, width, fixed=True)
    assert [t.shape for t in fixed] == [t.shape for t in other]
    assert [t.shape[0] for t in fixed] == twb._fixed_levels(n, n_seg, width)


@pytest.mark.parametrize("exit_every", [1, 4])
def test_window_solve_host_reads_are_bounded(monkeypatch, exit_every):
    win = _window(seed=2)
    cam = StereoCamera.kitti()
    plan = twb.assembly_plan(win.obs_cam.numpy(), win.obs_lm.numpy(), win.lm_base.numpy(),
                             win.obs_valid.numpy(), 8, 128, "cpu")
    monkeypatch.setattr(twb, "WBA_EXIT_EVERY", exit_every)
    reads = _count_host_reads(monkeypatch)
    out = twb.optimize_window(win, cam, plan=plan, **SOLVE_KW)
    blob = torch.cat([out.cam_pose.reshape(-1), out.lm_pos.reshape(-1)]).cpu().numpy()
    monkeypatch.undo()
    bound = sum(math.ceil(n / exit_every) - 1
                for n in (SOLVE_KW["stage1_iters"], SOLVE_KW["max_iters"]))
    assert reads[0] <= bound, (reads[0], bound)
    assert blob.shape == (8 * 6 + 128 * 3,)


def _record_buckets(monkeypatch):
    jax_shapes, port_shapes = [], []
    run_pack, run_opt = jsrba.pack_window, tsrba.optimize_window

    def pack(cam_pose, cam_valid, lm_pos, lm_base, lm_valid, oc, ol, opx, ov):
        jax_shapes.append((len(cam_pose), len(lm_pos), len(opx)))
        return run_pack(cam_pose, cam_valid, lm_pos, lm_base, lm_valid, oc, ol, opx, ov)

    def opt(win, cam, **kw):
        port_shapes.append((len(win.cam_pose), len(win.lm_pos), len(win.obs_px)))
        return run_opt(win, cam, **kw)

    monkeypatch.setattr(jsrba, "pack_window", pack)
    monkeypatch.setattr(tsrba, "optimize_window", opt)
    return jax_shapes, port_shapes


@pytest.mark.parametrize("caps", [dict(win_cams=8), dict(win_cams=16, win_lms=700, win_obs=1400),
                                  dict(win_cams=4, win_lms=600, win_obs=1100)])
def test_engine_picks_the_jax_bucket(monkeypatch, caps):
    p = dict(submap_size=2, max_optimize_depth=3, opt_iters=2, stage1_iters=1, **caps)
    j = JEngine(JCam.kitti(), JParams(**p))
    t = SRBAEngine(StereoCamera.kitti(), SRBAParams(**p), device="cpu")
    assert t.window_buckets()[-1] == (p["win_cams"], t.p.win_lms, t.p.win_obs)
    jax_shapes, port_shapes = _record_buckets(monkeypatch)
    pts = _corridor(np.random.default_rng(7))
    for eng in (j, t):
        known, _first = _drive_corridor(eng, pts, n_kfs=6)
        eng.set_initial_kf_pose(np.array([0, 0, 0, 0, 0, 0.8]))
        eng.define_new_keyframe(_true_obs(pts, np.array([0, 0, 0, 0, 0, 4.8]), set(known)),
                                run_opt=True)
    assert len(port_shapes) == 6
    assert port_shapes == jax_shapes
    assert all(s in t.window_buckets() for s in port_shapes)
