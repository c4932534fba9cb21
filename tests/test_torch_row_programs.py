"""The keyframe store's and the BoW database's programs, and the
loop-closure re-check's, against the JAX package, on the CPU.

On a card the store's row write (``models/keyframe.py`` ``write_row``), the
database's row write and rebuild (``models/bow.py``) and the re-check
(``models/data_association.py`` ``recheck_candidate``) are each one
CUDA-graph program replay, their rows, counts, seeds, prior and drift
budget device inputs, the store and the database held in place. Here the
same bodies run eagerly (tests/test_torch_cuda.py holds the programs to
the eager routes on the card). Inputs: the JAX frontend's features of the
small-geometry sequence (tests/torch_parity_inputs.py), stores built by
the JAX package and copied with ``from_jax_numpy``.

* ``write_row_body`` of the store against JAX's ``_append_row`` at a
  device row, on a store of 4 keyframes (a committed row rewritten and the
  next row): every array identical.
* The database's ``write_row_body`` and ``rebuild_body`` against JAX's
  ``_insert`` and ``_rebuild``: the quantized words identical, the rows
  within 1e-6 (tests/test_torch_bow.py's contract: f32 sums in another
  order), the rows past the count zero; ``rebuild_body`` equal bit for bit
  to the eager route's host loop (``ROW_PROGRAMS`` off on a card), and
  each of its rows to a one-row ``bow_vector``.
* The re-check's body with device rows, seed, prior and budget against
  JAX's ``recheck_candidate`` at budgets 0 and 0.5 m (tests/test_torch_da.py's
  case): status, other_idx and the tracked count identical, the pose within
  1e-4 (tests/test_torch_da.py's tolerance).
* Every body with ``Tensor.item``, ``tolist``, ``cpu``, ``numpy``,
  ``__bool__``, ``__int__`` and ``__float__`` made to raise (the re-check
  under ``no_exit_reads``, as in a capture): the same outputs.
* The programs' keys: the row, the count, the seed, the prior and the
  budget are inputs (the same program key at other values); another store
  or database held gives another key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from srba_slam_tpu.models import bow as jbow
from srba_slam_tpu.models import data_association as jda
from srba_slam_tpu.models import keyframe as jkeyframe
from srba_slam_tpu.utils.camera import StereoCamera as JCam
from srba_slam_tpu_torch.models import bow as tbow
from srba_slam_tpu_torch.models import data_association as tda
from srba_slam_tpu_torch.models import keyframe as tkeyframe
from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.utils.camera import StereoCamera

from torch_parity_inputs import (SMALL_CAM, jax_features, jax_store, port_features,
                                 port_store)

torch.set_num_threads(1)

KF_FRAMES = (0, 3, 6, 9)
CUR_FRAME = 12
FRAMES = (0, 2, 4, 6, 8, 10, 12, 14)
_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__")
INIT = np.array([0.002, -0.01, 0.001, -0.02, 0.01, -0.9], np.float32)
RECHECK = dict(max_orb_distance_da=60.0, residual_th=10.0, max_y_diff_epipolar=1.5,
               filter_by_direction=False, filter_by_orb_distance=True, use_fund_matrix=True,
               kernel_param=2.0, ransac_n_hyp=64)


def _np(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _refusing(monkeypatch):
    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"a body read a tensor on the host: Tensor.{name}")
        return read

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


def _row(row: int) -> torch.Tensor:
    return cuda_graphs.upload([row], "cpu", torch.int64)


def _frame_fields(f) -> dict:
    t = port_features(f)
    return {name: getattr(t, name) for name in tkeyframe._ROW_FIELDS}


@pytest.mark.parametrize("row", [2, 4], ids=["committed", "next"])
def test_store_row_body_matches_jax_append_row(monkeypatch, row):
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    js = jax_store(feats[:4])
    ts = port_store(js)
    new = feats[4]
    jarrays = jkeyframe._append_row(js.arrays, jnp.int32(row),
                                    tuple(jnp.asarray(getattr(new, name))
                                          for name in tkeyframe._ROW_FIELDS))
    x = dict(frame=_frame_fields(new), row=_row(row), store=ts.arrays)
    _refusing(monkeypatch)
    assert tkeyframe.write_row_body(x) == ()
    monkeypatch.undo()
    for name in ts.arrays._fields:
        np.testing.assert_array_equal(getattr(ts.arrays, name).numpy(),
                                      _np(getattr(jax.device_get(jarrays), name)), err_msg=name)


def test_store_write_row_is_the_body():
    """``KeyframeStore.write_row`` on the CPU (its eager route) writes what
    the body writes, and commits nothing."""
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    a, b = port_store(jax_store(feats[:4])), port_store(jax_store(feats[:4]))
    a.write_row(port_features(feats[4]), 4)
    tkeyframe.write_row_body(dict(frame=_frame_fields(feats[4]), row=_row(4), store=b.arrays))
    assert a.n_kfs == 4
    assert all(torch.equal(x, y) for x, y in zip(a.arrays, b.arrays))


def _databases(n_rows: int = 6):
    feats = jax_features(FRAMES)
    corpus = np.concatenate([np.asarray(f.desc_l)[np.asarray(f.m_valid)] for f in feats])
    voc = jbow.Vocabulary.train(corpus, k=8, L=3, seed=0)
    js = jax_store(feats[:n_rows])
    jdb = jbow.BoWDatabase(voc, max_kfs=js.max_kfs)
    tdb = tbow.BoWDatabase(tbow.Vocabulary.from_jax_numpy(voc), max_kfs=js.max_kfs,
                           device="cpu")
    return feats, js, jdb, tdb


def _same_rows(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert np.array_equal(got.numpy() > 0, ref > 0)          # the same words
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_bow_row_body_matches_jax_insert(monkeypatch):
    feats, js, jdb, tdb = _databases()
    for i, f in enumerate(feats[:3]):
        jdb.insert(jnp.asarray(f.desc_l), jnp.asarray(f.m_valid))
        tdb.insert(torch.from_numpy(_np(f.desc_l)), torch.from_numpy(np.asarray(f.m_valid)))
    _same_rows(tdb._db, jdb._db)
    f = feats[5]
    ref = jbow._insert(jdb._db, jnp.int32(3), jnp.asarray(f.desc_l), jnp.asarray(f.m_valid),
                       jdb._leaf_bits, jdb._weights)
    x = dict(desc=torch.from_numpy(_np(f.desc_l)), valid=torch.from_numpy(np.asarray(f.m_valid)),
             row=_row(3), db=tdb._db, leaf_bits=tdb._leaf_bits, weights=tdb._weights)
    _refusing(monkeypatch)
    assert tbow.write_row_body(x) == ()
    monkeypatch.undo()
    _same_rows(tdb._db, ref)
    assert float(tdb._db[3].sum()) == pytest.approx(1.0, abs=1e-5)
    assert not bool(tdb._db[4:].any())


@pytest.mark.parametrize("n_kfs", [6, 3, 0])
def test_bow_rebuild_body_matches_jax_rebuild(monkeypatch, n_kfs):
    feats, js, jdb, tdb = _databases()
    ts = port_store(js)
    ref = jbow._rebuild(js.arrays.desc_l, js.arrays.m_valid, jnp.int32(n_kfs), jdb._leaf_bits,
                        jdb._weights)
    tdb._db.fill_(7.0)                      # the body sets every row, masked or not
    x = dict(n_kfs=cuda_graphs.upload(n_kfs, "cpu", torch.int64), db=tdb._db,
             leaf_bits=tdb._leaf_bits, weights=tdb._weights, desc=ts.arrays.desc_l,
             valid=ts.arrays.m_valid)
    _refusing(monkeypatch)
    assert tbow.rebuild_body(x) == ()
    monkeypatch.undo()
    _same_rows(tdb._db, ref)
    assert not bool(tdb._db[n_kfs:].any())
    # the eager route (the host's loop over the rows under the count) and a
    # one-row bow_vector a row: the same bits
    eager = tbow.BoWDatabase(tdb.voc, max_kfs=tdb.max_kfs, device="cpu")
    eager.rebuild_from_store(ts.arrays, n_kfs)
    assert torch.equal(eager._db, tdb._db) and eager.n_kfs == n_kfs
    for i in range(n_kfs):
        assert torch.equal(tdb._db[i], tbow.bow_vector(ts.arrays.desc_l[i], ts.arrays.m_valid[i],
                                                       tdb._leaf_bits, tdb._weights))


@pytest.mark.parametrize("budget", [0.0, 0.5])
def test_recheck_body_matches_jax(monkeypatch, budget):
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    js = jax_store(feats)            # the new keyframe's row is written
    sj, oj, tj, pj = jda.recheck_candidate(js.arrays, 4, 1, JCam(**SMALL_CAM), jnp.asarray(INIT),
                                           11, init_gate_budget_m=budget, **RECHECK)
    store = port_store(js).arrays
    x = tda._recheck_inputs(4, 1, 11, INIT, budget, "cpu")
    assert x["rows"].dtype == torch.int64 and x["budget"].dtype == torch.float32
    cam = StereoCamera(**SMALL_CAM)
    with cuda_graphs.no_exit_reads():
        ref = tda._recheck_body({**x, "store": store}, cam, RECHECK)
    _refusing(monkeypatch)
    with cuda_graphs.no_exit_reads():
        got = tda._recheck_body({**x, "store": store}, cam, RECHECK)
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    st, ot, tt, pt = got
    assert int(tj) >= 15
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(oj), ot.numpy())
    assert int(tj) == int(tt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
    # the entry point on the CPU (its eager route) is the body
    out = tda.recheck_candidate(store, 4, 1, cam, INIT, 11, init_gate_budget_m=budget,
                                **RECHECK)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_row_programs_keep_rows_seeds_and_budgets_out_of_their_keys():
    feats = jax_features(KF_FRAMES + (CUR_FRAME,))
    s1, s2 = port_store(jax_store(feats)), port_store(jax_store(feats))
    frame = _frame_fields(feats[4])
    key = ("kf_row",)
    k1 = cuda_graphs.program_key(dict(frame=frame, row=_row(3)), key, dict(store=s1.arrays))
    assert k1 == cuda_graphs.program_key(dict(frame=frame, row=_row(5)), key,
                                         dict(store=s1.arrays))
    assert k1 != cuda_graphs.program_key(dict(frame=frame, row=_row(3)), key,
                                         dict(store=s2.arrays))
    rkey = tda.recheck_key(s1.arrays, StereoCamera(**SMALL_CAM), **RECHECK)
    a = tda._recheck_inputs(4, 1, 11, INIT, 0.0, "cpu")
    b = tda._recheck_inputs(3, 0, 2**32 - 1, np.zeros(6, np.float32), 1.5, "cpu")
    assert cuda_graphs.program_key(a, rkey, dict(store=s1.arrays)) == \
        cuda_graphs.program_key(b, rkey, dict(store=s1.arrays))
    assert rkey != tda.recheck_key(s1.arrays, StereoCamera(**SMALL_CAM),
                                   **{**RECHECK, "ransac_n_hyp": 128})
    assert not any(isinstance(p, torch.Tensor) for p in pytree.tree_leaves(rkey))
    with pytest.raises(ValueError, match="seed"):
        tda._recheck_inputs(4, 1, 2**32, INIT, 0.0, "cpu")
