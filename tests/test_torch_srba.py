"""Port parity of the SRBA backend (``models/srba.py``): the loop-closure
validation scenarios of ``tests/test_lc_validation.py`` driven through the
JAX package's engine and the port's with the same observations.

The scenarios exercise the edge-creation policy, the geometric seed of a
loop-closure edge, layer A (rejection at creation, with the re-basing of
the aliased observations), layer B (rollback after the committed window
solve, then the re-solve) and the blacklist. Both engines commit each
window solve before ``define_new_keyframe`` returns (``lazy=False``).

Tolerance: the graph (edges, their kinds and validity), the landmark and
observation bookkeeping, the rejections and the blacklist are identical;
edge and keyframe poses within 1e-4 (f32 window solves that sum in another
order than XLA's).
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu.models.srba import SRBAEngine as JEngine, SRBAParams as JParams
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models.srba import SRBAEngine, SRBAParams
from srba_slam_tpu_torch.utils.camera import StereoCamera

from test_lc_validation import _aliased_obs, _corridor, _drive_corridor, _fresh_obs, _true_obs

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

POSE_TOL = 1e-4


def _engines(**kw):
    p = dict(submap_size=2, max_optimize_depth=2, opt_iters=4, win_cams=8, **kw)
    return JEngine(JCam.kitti(), JParams(**p)), SRBAEngine(StereoCamera.kitti(), SRBAParams(**p))


def _corrupt_far(obs, first_seen):
    out = []
    for (lm, ul, vl, ur, rel) in obs:
        if first_seen.get(lm) in (0, 1):
            ul, vl, ur = ul + 110.0, vl + 70.0, ur + 110.0
        out.append((lm, ul, vl, ur, rel))
    return out


def _scenario(name, seed):
    """Build the scenario's insertions: a list of (lc_old_id or None,
    observations), after the 6-keyframe corridor drive."""
    rng = np.random.default_rng(seed)
    pts = _corridor(rng)
    probe, _ = _engines()
    known, first_seen = _drive_corridor(probe, pts, n_kfs=6)
    if name == "aliased":
        return pts, [(0, _aliased_obs(pts, first_seen) + _fresh_obs(rng))]
    if name == "true":
        return pts, [(0, _true_obs(pts, np.array([0, 0, 0, 0, 0, 4.8]), set(known)))]
    if name == "corrupt":
        obs = _true_obs(pts, np.array([0, 0, 0, 0, 0, 4.8]), set(known))
        return pts, [(0, _corrupt_far(obs, first_seen))]
    assert name == "blacklist"
    return pts, [(0, _aliased_obs(pts, first_seen) + _fresh_obs(rng)),
                 (0, _aliased_obs(pts, first_seen) + _fresh_obs(rng, base_id=20_000))]


def _assert_same_state(j, t):
    assert t.n_kfs == j.n_kfs and t.n_edges == j.n_edges
    for name in ("edge_u", "edge_v", "edge_valid"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_array_equal(t._edge_kind[: t.n_edges], j._edge_kind[: j.n_edges])
    np.testing.assert_allclose(t.edge_pose, j.edge_pose, atol=POSE_TOL)
    np.testing.assert_allclose(t.kf_global[: t.n_kfs], j.kf_global[: j.n_kfs], atol=POSE_TOL)
    assert (t.n_lms, t.n_obs) == (j.n_lms, j.n_obs)
    np.testing.assert_array_equal(t.lm_base[: t.n_lms], j.lm_base[: j.n_lms])
    np.testing.assert_array_equal(t.lm_match_id[: t.n_lms], j.lm_match_id[: j.n_lms])
    np.testing.assert_array_equal(t.obs_kf[: t.n_obs], j.obs_kf[: j.n_obs])
    np.testing.assert_array_equal(t.obs_lm[: t.n_obs], j.obs_lm[: j.n_obs])
    np.testing.assert_array_equal(t.localmap_center[: t.n_kfs], j.localmap_center[: j.n_kfs])
    assert t.lc_blacklist == j.lc_blacklist
    assert t.lc_rejects_last_insert == j.lc_rejects_last_insert


@pytest.mark.parametrize("name,seed,kw", [
    ("aliased", 7, {}),
    ("true", 7, {}),
    ("corrupt", 11, {"lc_chi2_px": 3.0}),
    ("blacklist", 7, {}),
])
def test_lc_validation_scenarios_match_jax(name, seed, kw):
    pts, inserts = _scenario(name, seed)
    j, t = _engines(**kw)
    _drive_corridor(j, pts, n_kfs=6)
    _drive_corridor(t, pts, n_kfs=6)
    _assert_same_state(j, t)
    for old_id, obs in inserts:
        for eng in (j, t):
            eng.loop_closure_detected(True)
            eng.set_lc_old_id(old_id)
            eng.set_initial_kf_pose(np.array([0, 0, 0, 0, 0, 0.8]))
        ij = j.define_new_keyframe(obs, run_opt=True)
        it = t.define_new_keyframe(obs, run_opt=True)
        assert (it.kf_id, it.created_edges, it.n_window_kfs, it.n_window_obs) \
            == (ij.kf_id, ij.created_edges, ij.n_window_kfs, ij.n_window_obs)
        assert not it.pending
        np.testing.assert_allclose([it.cost_init, it.cost_final, it.obs_rmse],
                                   [ij.cost_init, ij.cost_final, ij.obs_rmse], rtol=1e-3, atol=1e-3)
        _assert_same_state(j, t)
    if name in ("aliased", "corrupt", "blacklist"):
        assert t.lc_blacklist
    else:
        assert not t.lc_blacklist


def test_graph_exports_match_jax(tmp_path):
    pts, inserts = _scenario("corrupt", 11)
    j, t = _engines(lc_chi2_px=3.0)
    for eng in (j, t):
        _drive_corridor(eng, pts, n_kfs=6)
        eng.loop_closure_detected(True)
        eng.set_lc_old_id(0)
        eng.set_initial_kf_pose(np.array([0, 0, 0, 0, 0, 0.8]))
        eng.define_new_keyframe(inserts[0][1], run_opt=True)
    (uj, vj, pj), (ut, vt, pt) = j.get_global_graphslam_problem(), t.get_global_graphslam_problem()
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(pt, pj, atol=POSE_TOL)
    j.save_graph_as_dot(str(tmp_path / "j.dot"))
    t.save_graph_as_dot(str(tmp_path / "t.dot"))
    lj = (tmp_path / "j.dot").read_text().splitlines()
    lt = (tmp_path / "t.dot").read_text().splitlines()
    assert [ln.split("[")[0] for ln in lt] == [ln.split("[")[0] for ln in lj]
    for a, b in (("spanning", 0), ("topo", 6)):
        assert t.topo_distance(b, 0, max_depth=10) == j.topo_distance(b, 0, max_depth=10), a
