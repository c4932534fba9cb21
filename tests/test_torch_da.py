"""Port parity: models/data_association.py against the JAX package's DA
cascade, on keyframe features the JAX frontend extracted from the
small-geometry sequence (both sides get the same features).

Tolerance: status, other_idx, tracked count and pose validity are
identical (the RANSAC draws are JAX's bits, ops/prng.py); poses within
1e-4 (f32 normal sums and the 3x3 SVD run in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srba_slam_tpu.models import data_association as jda
from srba_slam_tpu.models.bow import BoWDatabase as JBoW, Vocabulary as JVoc
from srba_slam_tpu.models.vo import FrameFeatures as JFeat
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models import data_association as tda
from srba_slam_tpu_torch.models.bow import BoWDatabase
from srba_slam_tpu_torch.ops import prng
from srba_slam_tpu_torch.utils.camera import StereoCamera

from torch_parity_inputs import (SMALL_CAM, jax_features, jax_store, port_features,
                                 port_store)

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

POSE_TOL = 1e-4
KF_FRAMES = (0, 3, 6, 9)
CUR_FRAME = 12


def _jf(f):
    return JFeat(*(jnp.asarray(a) for a in f))


def _assert_da_equal(rj, rt, valid):
    np.testing.assert_array_equal(np.asarray(rj.status), rt.status.numpy())
    np.testing.assert_array_equal(np.asarray(rj.other_idx), rt.other_idx.numpy())
    np.testing.assert_array_equal(np.asarray(rj.tracked_count), rt.tracked_count.numpy())
    np.testing.assert_array_equal(np.asarray(rj.pose_valid), rt.pose_valid.numpy())
    np.testing.assert_array_equal(np.asarray(rj.raw_oidx), rt.raw_oidx.numpy())
    ok = np.asarray(rj.pose_valid) & valid
    np.testing.assert_allclose(rt.pose.numpy()[ok], np.asarray(rj.pose)[ok], atol=POSE_TOL)


@pytest.mark.parametrize("direction,seed", [(False, 7), (True, 8)])
def test_da_cascade_matches_jax(direction, seed):
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    js = jax_store(feats[:-1])
    cand = np.array([3, 0, 1, 2, 0], np.int32)
    valid = np.array([True, True, True, True, False])
    kw = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
              filter_by_direction=direction, kernel_param=2.0, ransac_n_hyp=64)
    rj = jda.da_cascade(_jf(feats[-1]), js.arrays, jnp.asarray(cand), jnp.asarray(valid),
                        JCam(**SMALL_CAM), jax.random.PRNGKey(seed), **kw)
    rt = tda.da_cascade(port_features(feats[-1]), port_store(js).arrays,
                        torch.from_numpy(cand), torch.from_numpy(valid),
                        StereoCamera(**SMALL_CAM), prng.PRNGKey(seed), **kw)
    assert int(np.asarray(rj.tracked_count)[0]) >= 15  # filter 3 and 4 really run
    _assert_da_equal(rj, rt, valid)


def test_query_and_associate_matches_jax():
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    js = jax_store(feats[:-1])
    desc = np.concatenate([np.asarray(f.desc_l)[np.asarray(f.m_valid)] for f in feats[:-1]])
    jvoc = JVoc.train(desc, k=8, L=3, seed=0)
    jdb = JBoW(jvoc, max_kfs=js.max_kfs)
    jdb.rebuild_from_store(js.arrays, js.n_kfs)
    kw = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
              filter_by_direction=False, ransac_n_hyp=64)
    top_s, top_i, cand, rj = jda.query_and_associate(
        _jf(feats[-1]), js.arrays, jdb._db, jdb._leaf_bits, jdb._weights,
        jnp.int32(js.n_kfs), JCam(**SMALL_CAM), jax.random.PRNGKey(9), **kw)
    tdb = BoWDatabase.from_jax_numpy(jvoc, jax.device_get(jdb._db), jdb.n_kfs,
                                     device="cpu")
    ts, ti, tc, rt = tda.query_and_associate(
        port_features(feats[-1]), port_store(js).arrays, tdb._db, tdb._leaf_bits,
        tdb._weights, js.n_kfs, StereoCamera(**SMALL_CAM), prng.PRNGKey(9), **kw)
    np.testing.assert_array_equal(np.asarray(top_i), ti.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(top_s), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(cand), tc.numpy())
    valid = np.concatenate([[True], (np.asarray(top_s) > 0)
                            & (np.asarray(top_i) != js.n_kfs - 1)])
    _assert_da_equal(rj, rt, valid)


@pytest.mark.parametrize("budget", [0.0, 0.5])
def test_recheck_candidate_matches_jax(budget):
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    js = jax_store(feats)            # the new keyframe's row is written
    init = np.array([0.002, -0.01, 0.001, -0.02, 0.01, -0.9], np.float32)
    kw = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
              filter_by_direction=False, ransac_n_hyp=64, init_gate_budget_m=budget)
    sj, oj, tj, pj = jda.recheck_candidate(js.arrays, 4, 1, JCam(**SMALL_CAM),
                                           jnp.asarray(init), 11, **kw)
    st, ot, tt, pt = tda.recheck_candidate(port_store(js).arrays, 4, 1,
                                           StereoCamera(**SMALL_CAM),
                                           torch.from_numpy(init), 11, **kw)
    assert int(tj) >= 15
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    assert int(tj) == int(tt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=POSE_TOL)
