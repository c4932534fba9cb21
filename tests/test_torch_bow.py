"""Port parity: models/bow.py and models/keyframe.py against the JAX
package, on descriptors the JAX frontend extracted from the small-geometry
sequence.

Tolerance: the trained vocabulary (leaf bits, idf weights, word count) is
bit-identical; the quantized words are identical; BoW vectors and query
scores within 1e-6 (f32 sums in another order); the ranked query ids are
identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from srba_slam_tpu.models import bow as jbow
from srba_slam_tpu_torch.models import bow as tbow

from torch_parity_inputs import jax_features, jax_store, port_store

# one CPU thread per test process: the ops here are small, and the parallel
# test workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

FRAMES = (0, 2, 4, 6, 8, 10, 12, 14)


def _corpus(frame_ids):
    feats = jax_features(frame_ids)
    return np.concatenate([np.asarray(f.desc_l)[np.asarray(f.m_valid)] for f in feats])


@pytest.mark.parametrize("L", [3, 4])
def test_vocabulary_train_bit_identical(L):
    desc = _corpus(FRAMES)
    vj = jbow.Vocabulary.train(desc, k=8, L=L, seed=0)
    vt = tbow.Vocabulary.train(desc.view(np.int32), k=8, L=L, seed=0)
    assert vj.n_words == vt.n_words
    np.testing.assert_array_equal(vj.leaf_bits, vt.leaf_bits)
    np.testing.assert_array_equal(vj.weights.view(np.uint32), vt.weights.view(np.uint32))


def test_vocabulary_save_load_roundtrip(tmp_path):
    v = tbow.Vocabulary.train(_corpus(FRAMES[:3]), k=8, L=3, seed=0)
    v.save(str(tmp_path / "voc"))
    w = tbow.Vocabulary.load(str(tmp_path / "voc"))
    np.testing.assert_array_equal(v.leaf_bits, w.leaf_bits)
    np.testing.assert_array_equal(v.weights, w.weights)
    assert (v.n_words, v.k, v.L) == (w.n_words, w.k, w.L)


def test_bow_vector_and_query_match_jax():
    feats = jax_features(FRAMES)
    voc = jbow.Vocabulary.train(_corpus(FRAMES), k=8, L=4, seed=0)
    js = jax_store(feats[:6])
    jdb = jbow.BoWDatabase(voc, max_kfs=js.max_kfs)
    jdb.rebuild_from_store(js.arrays, js.n_kfs)
    ts = port_store(js)
    tdb = tbow.BoWDatabase(tbow.Vocabulary.from_jax_numpy(voc), max_kfs=ts.max_kfs)
    tdb.rebuild_from_store(ts.arrays, ts.n_kfs)
    np.testing.assert_allclose(tdb._db.numpy(), np.asarray(jdb._db), atol=1e-6)
    for f in feats[6:]:
        d, v = f.desc_l, f.m_valid
        vj = np.asarray(jdb.compute_bow(jnp.asarray(d), jnp.asarray(v)))
        vt = tdb.compute_bow(torch.from_numpy(np.asarray(d).view(np.int32)),
                             torch.from_numpy(np.asarray(v))).numpy()
        assert np.array_equal(vj > 0, vt > 0)        # the same words
        np.testing.assert_allclose(vt, vj, atol=1e-6)
        sj, ij = jdb.query(jnp.asarray(d), jnp.asarray(v), max_results=4)
        st, it = tdb.query(torch.from_numpy(np.asarray(d).view(np.int32)),
                           torch.from_numpy(np.asarray(v)), max_results=4)
        np.testing.assert_array_equal(np.asarray(ij), it)
        np.testing.assert_allclose(st, np.asarray(sj), atol=1e-6)
    # insert keeps entry id == KF id
    assert tdb.insert(torch.from_numpy(np.asarray(feats[6].desc_l).view(np.int32)),
                      torch.from_numpy(np.asarray(feats[6].m_valid))) == 6


def test_rank_scores_tie_order_is_top_k():
    s = np.array([0.5, 0.7, 0.5, -1.0, 0.7, 0.5, 0.0], np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(s), 5)
    vt, it = tbow.rank_scores(torch.from_numpy(s), 5)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_keyframe_store_append_drop_set_pose():
    feats = jax_features(FRAMES[:3])
    js = jax_store(feats)
    ts = port_store(js)
    for name in ts.arrays._fields:
        a = np.asarray(getattr(js.arrays, name))
        b = getattr(ts.arrays, name).numpy()
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.uint32 else a, b)
    ts.drop_last()
    js.drop_last()
    assert ts.n_kfs == js.n_kfs == 2
    np.testing.assert_array_equal(ts.match_ids, js.match_ids)
    ts.set_pose(1, np.arange(6.0))
    np.testing.assert_array_equal(ts.poses[1], np.arange(6.0, dtype=np.float32))
