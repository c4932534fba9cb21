"""Checkpoints cross between the port and the JAX package (CPU).

The small-geometry sequence of tests/test_estimator.py: 20 frames, a
checkpoint, 10 more frames.

Held exactly: the resumed port's per-frame decisions, keyframe match ids and
BoW query ids equal the JAX package's own resumed continuation from the
same JAX-written file; a port-written file loads in the JAX package with
``compare.py`` reporting no difference; every array of a file the port
writes has the dtype and shape of the JAX package's, descriptor words as
uint32. Keyframe poses of the continuations within 1e-4 (the f32 solves sum
in another order).
"""

import numpy as np
import pytest
import torch

from srba_slam_tpu.utils import checkpoint as jcheckpoint
from srba_slam_tpu.utils import compare as jcompare
from srba_slam_tpu_torch.utils import checkpoint, compare
from srba_slam_tpu_torch.utils.bench_workload import decisions
from test_torch_estimator import SMALL, _run
from torch_parity_inputs import small_frames

torch.set_num_threads(1)

N_BEFORE, N_AFTER = 20, 10


def _fresh(port: bool):
    return _run(SMALL, [], port)[0]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """JAX and port estimators after N_BEFORE frames, and their checkpoints."""
    d = tmp_path_factory.mktemp("ckpt")
    frames, _gt = small_frames()
    jest, _ = _run(SMALL, frames[:N_BEFORE], port=False)
    test, _ = _run(SMALL, frames[:N_BEFORE], port=True)
    jpath, tpath = str(d / "jax.npz"), str(d / "port.npz")
    jcheckpoint.save_state(jest, jpath)
    checkpoint.save_state(test, tpath)
    assert jest.store.n_kfs >= 3
    return jest, test, jpath, tpath


def _continue(est, frames):
    for left, right in frames:
        est.step(left, right)
    return est


def test_jax_checkpoint_resumes_in_port_like_jax(files):
    _jest, _test, jpath, _ = files
    frames, _gt = small_frames()
    tail = frames[N_BEFORE:N_BEFORE + N_AFTER]
    j, t = _fresh(port=False), _fresh(port=True)
    jcheckpoint.load_state(j, jpath)
    checkpoint.load_state(t, jpath)
    assert t.store.arrays.desc_l.dtype == torch.int32 and t.frame_idx == N_BEFORE - 1
    _continue(j, tail), _continue(t, tail)
    assert decisions(t.step_log) == decisions(j.step_log)
    assert [r.frame_idx for r in t.step_log] == list(range(N_BEFORE, N_BEFORE + N_AFTER))
    n = j.store.n_kfs
    assert t.store.n_kfs == n > files[0].store.n_kfs           # keyframes were added
    np.testing.assert_array_equal(t.store.match_ids[:n], j.store.match_ids[:n])
    assert [(f, list(i)) for f, _s, i in t.query_log] \
        == [(f, [int(x) for x in i]) for f, _s, i in j.query_log]
    np.testing.assert_allclose(t.rba.kf_global[:n], j.rba.kf_global[:n], atol=1e-4)
    assert t.next_match_id == j.next_match_id


def test_port_checkpoint_loads_in_jax_without_difference(files):
    jest, test, jpath, tpath = files
    # (a) the file round trip is exact: what JAX loads from the port's file
    # is the port's own state, field by field, bit for bit
    j = _fresh(port=False)
    jcheckpoint.load_state(j, tpath)
    assert j.store.n_kfs == test.store.n_kfs and j.frame_idx == test.frame_idx
    for name, arr_j, arr_t in zip(j.store.arrays._fields, j.store.arrays, test.store.arrays):
        arr_j, arr_t = np.asarray(arr_j), arr_t.numpy()
        if arr_j.dtype == np.uint32:
            arr_j = arr_j.view(np.int32)
        assert arr_j.dtype == arr_t.dtype, name
        np.testing.assert_array_equal(arr_j, arr_t, err_msg=name)
    np.testing.assert_array_equal(j.store.match_ids, test.store.match_ids)
    np.testing.assert_array_equal(j.rba.kf_global, test.rba.kf_global)
    n_e = int(test.rba.edge_valid.sum())
    assert int(np.asarray(j.rba.edge_valid).sum()) == n_e
    np.testing.assert_array_equal(np.asarray(j.rba.edge_pose)[np.asarray(j.rba.edge_valid)],
                                  test.rba.edge_pose[test.rba.edge_valid])
    assert (j.rba.n_obs, j.rba.n_lms, j.next_match_id, j.vo.fast_th) \
        == (test.rba.n_obs, test.rba.n_lms, test.next_match_id, test.vo.fast_th)
    np.testing.assert_array_equal(np.asarray(j.bow._db), test.bow._db.numpy())
    # run against run (the port's own 20 frames against JAX's own): every
    # stored feature, id and count equal; the poses of two f32 solves that
    # sum in another order may pass compare.py's np.allclose default and
    # are held to 1e-4 here
    assert jcompare.compare_estimator_state(jest, j) in ([], ["kf_global differs"])
    np.testing.assert_allclose(j.rba.kf_global, jest.rba.kf_global, atol=1e-4)
    # (b) a JAX file through the port and back
    t = _fresh(port=True)
    checkpoint.load_state(t, jpath)
    back = tpath.replace("port.npz", "back.npz")
    checkpoint.save_state(t, back)
    j2 = _fresh(port=False)
    jcheckpoint.load_state(j2, back)
    assert jcompare.compare_estimator_state(jest, j2) == []
    assert j2.frame_idx == jest.frame_idx and j2.vo.fast_th == jest.vo.fast_th
    np.testing.assert_array_equal(np.asarray(j2.bow._db), np.asarray(jest.bow._db))


def test_file_layout_equals_jax(files):
    _jest, _test, jpath, tpath = files
    a, b = np.load(jpath), np.load(tpath)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
    assert b["kf_desc_l"].dtype == np.uint32 and b["rba_edge_pose"].dtype == np.float64
    import json

    sa, sb = json.loads(str(a["__scalars__"])), json.loads(str(b["__scalars__"]))
    assert sa == sb and sb["format_version"] == checkpoint.FORMAT_VERSION == 3


def test_round_trip_in_port_preserves_state_and_queries(files):
    _jest, test, _jpath, tpath = files
    t = _fresh(port=True)
    checkpoint.load_state(t, tpath)
    assert compare.compare_estimator_state(test, t) == []
    for name in ("edge_u", "edge_v", "edge_pose", "edge_valid"):
        np.testing.assert_array_equal(getattr(t.rba, name), getattr(test.rba, name))
    assert t.rba.adj == test.rba.adj and t.rba.n_lms == test.rba.n_lms
    np.testing.assert_array_equal(t.rba._lm_lookup[:8192], test.rba._lm_lookup[:8192])
    for k in range(test.store.n_kfs):
        desc, valid = test.store.arrays.desc_l[k], test.store.arrays.m_valid[k]
        s0, i0 = test.bow.query(desc, valid)
        s1, i1 = t.bow.query(desc, valid)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(s1, s0)
        assert i0[0] == k
    # an in-place restore clears the engine's in-flight state
    assert test.vo._prev is not None
    checkpoint.load_state(test, tpath)
    assert test.vo._prev is None and test.step_log == [] and not test.vo._last_pose_inc.any()
    assert test.vo._kf_id_set == {int(i) for i in test.store.match_ids[test.store.n_kfs - 1]
                                  if i >= 0}


def test_checkpoint_before_first_check_trains_the_vocabulary(tmp_path):
    frames, _gt = small_frames()
    t, _ = _run(SMALL, frames[:1], port=True)
    assert t.bow is None
    path = str(tmp_path / "early.npz")
    t.save_checkpoint(path)
    assert t.bow is not None and t.bow.n_kfs == 1
    u = _fresh(port=True)
    checkpoint.load_state(u, path)
    assert u.store.n_kfs == 1 and u.bow.n_kfs == 1 and compare.compare_estimator_state(t, u) == []
