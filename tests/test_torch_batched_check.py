"""The keyframe check as one batch, in the port against the JAX package,
on keyframe features the JAX frontend extracted from the small-geometry
sequence (both sides get the same features).

* ``da_cascade`` with two of its five candidates invalid: the five
  candidates are lanes of one batch in the port, ``jax.vmap`` in JAX.
* ``query_and_associate`` over two sequences at once (each its own store,
  BoW database, keyframe count and key; lanes = (sequence, candidate)),
  against JAX's ``query_and_associate`` vmapped over the sequences as the
  JAX fleet runs it; the sequence with three keyframes has two invalid
  candidates. Each sequence's slice equals its one-sequence call exactly.
* The host reads of one cascade (``Tensor.item``, ``__bool__``,
  ``__int__``, ``__float__``) stay at those of the two GN stages' exit
  tests, 2 x (ceil(12 / E) + 1), at one candidate and at five: no serial
  loop over candidates, no read per GN iteration.

Contract (tests/test_torch_da.py): status, other_idx, tracked count, pose
validity and the raw matches identical (the RANSAC draws are JAX's bits,
ops/prng.py); poses within 1e-4 (f32 sums and the 3x3 SVD run in another
order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.models import data_association as jda
from srba_slam_tpu.models.bow import BoWDatabase as JBoW, Vocabulary as JVoc
from srba_slam_tpu.models.vo import FrameFeatures as JFeat
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models import data_association as tda
from srba_slam_tpu_torch.models.bow import BoWDatabase
from srba_slam_tpu_torch.models.vo import stack_features
from srba_slam_tpu_torch.ops import prng, robust_lm
from srba_slam_tpu_torch.utils.camera import StereoCamera

from torch_parity_inputs import (SMALL_CAM, jax_features, jax_store, port_features,
                                 port_store)

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

POSE_TOL = 1e-4
KW = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
          kernel_param=2.0, ransac_n_hyp=64)
# (keyframe frames, current frame) of the two sequences
SEQS = (((0, 3, 6, 9), 12), ((2, 5, 8), 11))


def _jf(f):
    return JFeat(*(jnp.asarray(a) for a in f))


def _assert_da_equal(rj, rt, valid):
    for name in ("status", "other_idx", "tracked_count", "pose_valid", "raw_oidx"):
        np.testing.assert_array_equal(np.asarray(getattr(rj, name)),
                                      getattr(rt, name).numpy(), err_msg=name)
    ok = np.asarray(rj.pose_valid) & valid
    np.testing.assert_allclose(rt.pose.numpy()[ok], np.asarray(rj.pose)[ok], atol=POSE_TOL)


@pytest.mark.parametrize("direction,seed", [(False, 3), (True, 4)])
def test_da_cascade_two_invalid_candidates_matches_jax(direction, seed):
    kfs, cur = SEQS[0]
    feats = jax_features(kfs + (cur,))
    js = jax_store(feats[:-1])
    cand = np.array([3, 1, 0, 2, 1], np.int32)
    valid = np.array([True, False, True, False, True])
    rj = jda.da_cascade(_jf(feats[-1]), js.arrays, jnp.asarray(cand), jnp.asarray(valid),
                        JCam(**SMALL_CAM), jax.random.PRNGKey(seed),
                        filter_by_direction=direction, **KW)
    rt = tda.da_cascade(port_features(feats[-1]), port_store(js).arrays,
                        torch.from_numpy(cand), torch.from_numpy(valid),
                        StereoCamera(**SMALL_CAM), prng.PRNGKey(seed),
                        filter_by_direction=direction, **KW)
    tracked = np.asarray(rj.tracked_count)
    assert tracked[0] >= 15 and (tracked[~valid] == 0).all()
    _assert_da_equal(rj, rt, valid)


@pytest.fixture(scope="module")
def two_sequences():
    """Both sequences' JAX stores and BoW databases, one vocabulary."""
    stores, currents = [], []
    for kfs, cur in SEQS:
        feats = jax_features(kfs + (cur,))
        stores.append(jax_store(feats[:-1]))
        currents.append(feats[-1])
    desc = np.concatenate([np.asarray(f.desc_l)[np.asarray(f.m_valid)]
                           for kfs, cur in SEQS for f in jax_features(kfs + (cur,))[:-1]])
    jvoc = JVoc.train(desc, k=8, L=3, seed=0)
    dbs = []
    for js in stores:
        jdb = JBoW(jvoc, max_kfs=js.max_kfs)
        jdb.rebuild_from_store(js.arrays, js.n_kfs)
        dbs.append(jdb)
    return jvoc, stores, dbs, currents


def test_query_and_associate_over_sequences_matches_vmapped_jax(two_sequences):
    jvoc, stores, dbs, currents = two_sequences
    seeds = (9, 10)
    n_kfs = [js.n_kfs for js in stores]
    leaf, weights = dbs[0]._leaf_bits, dbs[0]._weights

    def one(frame, arrays, db, n, key):
        return jda.query_and_associate(frame, arrays, db, leaf, weights, n, JCam(**SMALL_CAM),
                                       key, filter_by_direction=False, **KW)

    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *[js.arrays for js in stores])
    top_s, top_i, cand, rj = jax.vmap(one)(
        jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *currents), jstack,
        jnp.stack([d._db for d in dbs]), jnp.asarray(n_kfs, jnp.int32),
        jnp.stack([jax.random.PRNGKey(s) for s in seeds]))

    tdbs = [BoWDatabase.from_jax_numpy(jvoc, jax.device_get(d._db), d.n_kfs, device="cpu")
            for d in dbs]
    tstores = [port_store(js).arrays for js in stores]
    tcur = [port_features(f) for f in currents]
    tkeys = torch.stack([prng.PRNGKey(s) for s in seeds])
    ts, ti, tc, rt = tda.query_and_associate(
        stack_features(tcur), type(tstores[0])(*(torch.stack(p) for p in zip(*tstores))),
        torch.stack([d._db for d in tdbs]), tdbs[0]._leaf_bits, tdbs[0]._weights, n_kfs,
        StereoCamera(**SMALL_CAM), tkeys, filter_by_direction=False, **KW)
    np.testing.assert_array_equal(np.asarray(top_i), ti.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(top_s), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(cand), tc.numpy())
    valid = np.concatenate([np.ones((2, 1), bool), (np.asarray(top_s) > 0)
                            & (np.asarray(top_i) != np.asarray(n_kfs)[:, None] - 1)], axis=1)
    assert (~valid[1]).sum() >= 2 and valid[0, 0] and np.asarray(rj.tracked_count)[0, 0] >= 15
    _assert_da_equal(rj, rt, valid)
    for q in range(2):                        # each sequence = its one-sequence call
        one_t = tda.query_and_associate(tcur[q], tstores[q], tdbs[q]._db, tdbs[q]._leaf_bits,
                                        tdbs[q]._weights, n_kfs[q], StereoCamera(**SMALL_CAM),
                                        tkeys[q], filter_by_direction=False, **KW)
        for a, b in zip((ts, ti, tc), one_t[:3]):
            assert torch.equal(a[q], b)
        for name, a, b in zip(rt._fields, rt, one_t[3]):
            assert torch.equal(a[q], b), name


def _count_host_reads(monkeypatch) -> list:
    reads = [0]
    for name in ("item", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads[0] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


@pytest.mark.parametrize("n_cand", [1, 5])
def test_da_cascade_host_reads_are_bounded(monkeypatch, n_cand):
    kfs, cur = SEQS[0]
    feats = jax_features(kfs + (cur,))
    store = port_store(jax_store(feats[:-1])).arrays
    frame = port_features(feats[-1])
    cand = torch.tensor([3, 0, 1, 2, 0][:n_cand])
    valid = torch.ones(n_cand, dtype=torch.bool)
    reads = _count_host_reads(monkeypatch)
    out = tda.da_cascade(frame, store, cand, valid, StereoCamera(**SMALL_CAM), prng.PRNGKey(5),
                         filter_by_direction=False, **KW)
    monkeypatch.undo()
    iters = max(tda.DA_SOLVE_ITERS_STAGE1, tda.DA_SOLVE_ITERS_STAGE2)
    bound = 2 * (math.ceil(iters / robust_lm.GN_EXIT_EVERY) + 1)
    assert reads[0] <= bound, (reads[0], bound)
    assert out.status.shape[0] == n_cand and int(out.tracked_count[0]) >= 15
