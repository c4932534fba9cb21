"""Port parity: ops/window_ba.py optimize_window against the JAX package's,
on the same synthetic windows (srba_slam_tpu.utils.synthworld
make_ba_window_problem).

Tolerance: f32 block sums run in another order (JAX scatter-adds on the
CPU, the port sums gather tables). While LM steps still improve the cost
materially (the first two here), the accepted-step count is identical.
After that the steps change the cost in its 7th digit, and whether such a
step is accepted is decided by rounding, so at the full iteration cap the
count is not compared (ROADMAP Queue 3 records this). At both caps: camera
poses within 1e-4, landmarks within 2e-3, costs and RMSEs within 1e-4
relative. The segment sums behind the assembly are exact on integers.
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu.ops import window_ba as jwb
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu.utils.synthworld import make_ba_window_problem
from srba_slam_tpu_torch.ops import window_ba as twb
from srba_slam_tpu_torch.utils.camera import StereoCamera

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)


def _port_window(win):
    return twb.BAWindow(*(torch.from_numpy(np.array(a)) for a in win))


@pytest.mark.parametrize("case", [
    dict(C=8, L=128, O=512, n_cams=5, n_lms=100, seed=0, kw=dict(max_iters=8)),
    dict(C=8, L=256, O=1024, n_cams=6, n_lms=200, seed=1,
         kw=dict(max_iters=8, stage1_iters=2)),
    dict(C=16, L=256, O=1024, n_cams=9, n_lms=220, seed=2,
         kw=dict(max_iters=10, use_kernel=False, stage1_iters=2, use_kernel_stage1=False)),
    dict(C=8, L=128, O=512, n_cams=5, n_lms=100, seed=3,
         kw=dict(max_iters=6, w_prior_rot=0.0, w_prior_trans=0.0)),
])
def test_optimize_window_matches_jax(case):
    rng = np.random.default_rng(case["seed"])
    cam = StereoCamera.kitti()
    win, _gt = make_ba_window_problem(JCam.kitti(), rng, case["C"], case["L"], case["O"],
                                      case["n_cams"], case["n_lms"])
    valid = np.asarray(win.lm_valid)
    for cap in (2, case["kw"].pop("max_iters")):
        kw = dict(kernel_param=1.5, max_iters=cap, **case["kw"])
        rj = jwb.optimize_window(win, JCam.kitti(), **kw)
        rt = twb.optimize_window(_port_window(win), cam, **kw)
        if cap == 2:
            assert int(rj.iters) == int(rt.iters) == 2
        np.testing.assert_allclose(rt.cam_pose.numpy(), np.asarray(rj.cam_pose), atol=1e-4)
        np.testing.assert_allclose(rt.lm_pos.numpy()[valid], np.asarray(rj.lm_pos)[valid],
                                   atol=2e-3)
        for f in ("cost_init", "cost_final", "obs_rmse", "obs_rmse_stg1"):
            np.testing.assert_allclose(float(getattr(rt, f)), float(getattr(rj, f)),
                                       rtol=1e-4, err_msg=f)


@pytest.mark.parametrize("n,n_seg,width", [(0, 4, 32), (50, 7, 4), (5000, 3, 8),
                                          (3000, 900, 32)])
def test_segment_sum_exact(n, n_seg, width):
    rng = np.random.default_rng(n)
    seg = rng.integers(0, n_seg, n) if n_seg > 3 else (rng.random(n) < 0.9).astype(int)
    data = rng.integers(-1000, 1000, (n, 2, 3)).astype(np.float32)
    ref = np.zeros((n_seg, 2, 3), np.float32)
    np.add.at(ref, seg, data)
    tabs = twb.segment_tables(seg, n_seg, width=width)
    got = twb.segment_sum(torch.from_numpy(data), [torch.from_numpy(t) for t in tabs])
    np.testing.assert_array_equal(got.numpy(), ref)
    # memory stays O(items + segments)
    assert sum(t.size for t in tabs) <= 2 * (n + n_seg * width) + n_seg
