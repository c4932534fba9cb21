"""Port parity: models/data_association.py against the JAX package's DA
cascade, on keyframe features the JAX frontend extracted from the
small-geometry sequence (both sides get the same features).

Tolerance: status, other_idx, tracked count and pose validity are
identical (the RANSAC draws are JAX's bits, ops/prng.py); poses within
1e-4 (f32 normal sums and the 3x3 SVD run in another order).

The Horn seed's rotation on a card (``_horn_rotation``, Jacobi sweeps of
Horn's 4x4 matrix) against the SVD Kabsch of the JAX package's
``_horn_seed`` on random, reflection-prone, planar and near-planar
cross-covariances: in float64 within 1e-12 of numpy's SVD Kabsch (4
sweeps miss that), in float32 within 1e-5 of JAX's (3 sweeps miss that);
the seed and the cascade with that route forced on the CPU against JAX's.
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


def test_query_and_associate_packed_with_device_scalars_matches_jax():
    """The one-check path with ``n_kfs`` and the seed as int64 scalar
    tensors (the one-check program's inputs on a card) against the JAX
    package's jitted ``query_and_associate_packed`` (its key built in the
    program from the seed): statuses, indices, tracked counts and the
    frame's fields identical, BoW scores within 1e-6; and equal bit for
    bit to the same call with host ints."""
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    js = jax_store(feats[:-1])
    desc = np.concatenate([np.asarray(f.desc_l)[np.asarray(f.m_valid)] for f in feats[:-1]])
    jvoc = JVoc.train(desc, k=8, L=3, seed=0)
    jdb = JBoW(jvoc, max_kfs=js.max_kfs)
    jdb.rebuild_from_store(js.arrays, js.n_kfs)
    kw = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
              filter_by_direction=False, ransac_n_hyp=64)
    s, k, nq = 5, port_features(feats[-1]).m_valid.shape[0], 4
    (jblob,) = jda.query_and_associate_packed(
        _jf(feats[-1]), js.arrays, jdb._db, jdb._leaf_bits, jdb._weights, jnp.int32(js.n_kfs),
        JCam(**SMALL_CAM), 9, **kw)
    tdb = BoWDatabase.from_jax_numpy(jvoc, jax.device_get(jdb._db), jdb.n_kfs, device="cpu")
    args = (port_features(feats[-1]), port_store(js).arrays, tdb._db, tdb._leaf_bits,
            tdb._weights)
    (got,) = tda.query_and_associate_packed(*args, torch.tensor(js.n_kfs, dtype=torch.int64),
                                            StereoCamera(**SMALL_CAM),
                                            torch.tensor(9, dtype=torch.int64), **kw)
    (ints,) = tda.query_and_associate_packed(*args, js.n_kfs, StereoCamera(**SMALL_CAM), 9,
                                             **kw)
    assert torch.equal(got, ints)
    oj = jda.unpack_check_outputs(np.asarray(jblob), s=s, k=k, nq=nq)
    ot = tda.unpack_check_outputs(got.numpy(), s=s, k=k, nq=nq)
    np.testing.assert_allclose(ot[0], oj[0], atol=1e-6)                # scores
    for a, b in zip(ot[1:11], oj[1:11]):                             # ints and the points
        np.testing.assert_array_equal(a, b)
    assert int(oj[4][0]) >= 15                                       # the cascade ran


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


def _rot(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _point_pairs(case, rng, n=40):
    """(p_oth, p_cur) [n, 3] related by a rotation, a mirror or a plane."""
    if case == "random":
        a = rng.normal(size=(n, 3)) * [3.0, 2.0, 8.0]
        return a, a @ _rot(rng).T + rng.normal(size=(n, 3)) * 0.05 + [0.3, -0.1, 1.0]
    if case == "reflection":       # the best orthogonal map is a mirror
        a = rng.normal(size=(n, 3))
        return a, a @ (_rot(rng) @ np.diag([1.0, 1.0, -1.0])).T + rng.normal(size=(n, 3)) * 0.05
    # a plane (rank-2 cross-covariance) or nearly one
    a = rng.normal(size=(n, 3)) * [5.0, 3.0, 0.0 if case == "planar" else 1e-3]
    return a, a @ _rot(rng).T + rng.normal(size=(n, 3)) * 1e-6


def _cross_covariances(case, lanes=32, seed=3):
    rng = np.random.default_rng(seed)
    if case == "generic":
        return rng.normal(size=(lanes, 3, 3))
    hs = []
    for _ in range(lanes):
        a, b = _point_pairs(case, rng)
        hs.append((a - a.mean(0)).T @ (b - b.mean(0)))
    return np.stack(hs)


def _kabsch_np(H):
    """The SVD Kabsch with its reflection guard, in float64 (numpy)."""
    U, _S, Vt = np.linalg.svd(H)
    V, Ut = np.swapaxes(Vt, 1, 2), np.swapaxes(U, 1, 2)
    D = np.zeros_like(H)
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = np.linalg.det(V @ Ut)
    return V @ D @ Ut


def _kabsch_jax(H):
    """The JAX package's rotation of ``_horn_seed``'s ``fit``
    (srba_slam_tpu/models/data_association.py), lane by lane, in f32."""
    def one(h):
        U, _S, Vt = jnp.linalg.svd(h)
        d = jnp.linalg.det(Vt.T @ U.T)
        return Vt.T @ jnp.diag(jnp.stack([1.0, 1.0, d])) @ U.T
    return np.asarray(jax.vmap(one)(jnp.asarray(H, jnp.float32)))


def _horn_errors(H):
    """Max |R - R_ref| of the port's Horn rotation: f64 against numpy's
    SVD Kabsch, f32 against JAX's."""
    r64 = tda._horn_rotation(torch.from_numpy(H)).numpy()
    r32 = tda._horn_rotation(torch.from_numpy(H.astype(np.float32))).numpy()
    return np.abs(r64 - _kabsch_np(H)).max(), np.abs(r32 - _kabsch_jax(H)).max()


HORN_CASES = ["random", "generic", "reflection", "planar", "near_planar"]


@pytest.mark.parametrize("case", HORN_CASES)
def test_horn_rotation_matches_svd_kabsch(case):
    H = _cross_covariances(case)
    if case == "reflection":
        assert (np.linalg.det(H) < 0).all()       # the guard's branch is the one taken
    e64, e32 = _horn_errors(H)
    assert e64 < 1e-12, e64
    assert e32 < 1e-5, e32
    R = tda._horn_rotation(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)


def test_horn_rotation_tolerances_catch_too_few_sweeps(monkeypatch):
    """The tolerances above fail a Jacobi sweep count short of convergence:
    at 4 sweeps some case misses 1e-12 in float64; at 3 every case misses
    1e-5 against JAX's float32 Kabsch."""
    Hs = [_cross_covariances(case) for case in HORN_CASES]
    monkeypatch.setattr(tda, "_JACOBI_SWEEPS", 4)
    assert max(_horn_errors(H)[0] for H in Hs) > 1e-12
    monkeypatch.setattr(tda, "_JACOBI_SWEEPS", 3)
    assert min(_horn_errors(H)[1] for H in Hs) > 1e-5


@pytest.mark.parametrize("case", ["random", "reflection", "near_planar"])
def test_horn_seed_on_the_card_route_matches_jax(case, monkeypatch):
    """``_horn_seed`` with the card's rotation forced on the CPU (Horn's in
    place of the SVD Kabsch) against the JAX package's, lane by lane: 48
    points with a tenth of them outliers (the trim pass), within
    POSE_TOL."""
    rng = np.random.default_rng(5)
    lanes = []
    for _ in range(8):
        a, b = _point_pairs(case, rng, n=48)
        b[::10] += rng.normal(size=(5, 3)) * 3.0
        lanes.append((a.astype(np.float32), b.astype(np.float32)))
    p_oth = np.stack([a for a, _ in lanes])
    p_cur = np.stack([b for _, b in lanes])
    w0 = np.ones(p_oth.shape[:2], bool)
    fallback = np.full((len(lanes), 6), 0.01, np.float32)
    ref = np.stack([np.asarray(jda._horn_seed(jnp.asarray(p_oth[i]), jnp.asarray(p_cur[i]),
                                              jnp.asarray(w0[i]), jnp.asarray(fallback[i])))
                    for i in range(len(lanes))])
    monkeypatch.setattr(tda, "_kabsch_rotation", tda._horn_rotation)
    got = tda._horn_seed(*(torch.from_numpy(a) for a in (p_oth, p_cur, w0, fallback))).numpy()
    assert not np.any(np.all(ref == fallback, axis=1))   # every lane fits
    np.testing.assert_allclose(got, ref, atol=POSE_TOL)


@pytest.mark.parametrize("direction,seed", [(False, 7), (True, 8)])
def test_da_cascade_on_the_card_route_matches_jax(direction, seed, monkeypatch):
    """test_da_cascade_matches_jax with the card's rotation forced on the
    CPU: the same identities and tolerance."""
    monkeypatch.setattr(tda, "_kabsch_rotation", tda._horn_rotation)
    test_da_cascade_matches_jax(direction, seed)
