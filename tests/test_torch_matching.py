"""Hamming distances and matching in the port against the JAX package.

Tolerance: none. Distances are exact integers in f32 on both sides, argmin
takes the first index in both, and the column scatter-min of exact
(distance, row) keys does not depend on order, so idx, dist and valid are
compared bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.ops.hamming import hamming_matrix as jhamming
from srba_slam_tpu.ops.matching import interframe_match as jinterframe
from srba_slam_tpu.ops.matching import masked_best_match as jmbm
from srba_slam_tpu.ops.matching import stereo_match as jstereo
from srba_slam_tpu_torch.ops.hamming import hamming_matrix
from srba_slam_tpu_torch.ops.matching import (interframe_match, masked_best_match,
                                              stereo_match)


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _noisy_copies(rng, base, n_flip):
    """Copies of descriptors with n_flip random bits flipped each."""
    out = base.copy()
    for row in out:
        for b in rng.choice(256, n_flip, replace=False):
            row[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))


def test_hamming_matrix_matches_jax(rng):
    a, b = _words(rng, 40), _words(rng, 50)
    b[:5] = a[:5]
    got = hamming_matrix(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jhamming(jnp.asarray(a), jnp.asarray(b))))
    assert got.dtype == np.float32 and (np.diag(got[:5, :5]) == 0).all()


@pytest.mark.parametrize("unique,mutual", [(True, False), (False, False), (True, True)])
def test_masked_best_match_ties(rng, unique, mutual):
    # distances in a small integer range: rows tie on columns and columns
    # are claimed by several rows
    dist = rng.integers(0, 6, (60, 40)).astype(np.float32)
    gate = rng.random((60, 40)) < 0.5
    ref = jmbm(jnp.asarray(dist), jnp.asarray(gate), 3, unique=unique, mutual=mutual)
    got = masked_best_match(torch.from_numpy(dist), torch.from_numpy(gate), 3,
                            unique=unique, mutual=mutual)
    _assert_same(got, ref)
    assert int(got.valid.sum()) > 0
    if unique:  # 40 columns: at most 40 rows keep a match
        assert int(got.valid.sum()) <= 40


def test_stereo_match_matches_jax(rng):
    n = 64
    d_l = _words(rng, n)
    d_r = _noisy_copies(rng, d_l[rng.permutation(n)], 20)
    ys_l = rng.integers(20, 180, n).astype(np.int32)
    xs_l = rng.integers(40, 300, n).astype(np.int32)
    ys_r = (ys_l + rng.integers(-3, 4, n)).astype(np.int32)
    xs_r = (xs_l - rng.integers(-5, 30, n)).astype(np.int32)
    v_l, v_r = rng.random(n) < 0.9, rng.random(n) < 0.9
    args = (d_l, d_r, ys_l, xs_l, ys_r, xs_r, v_l, v_r)
    kw = dict(max_y_diff=2.0, orb_max_distance=60, min_disparity=0.1)
    ref = jstereo(*map(jnp.asarray, args), **kw)
    got = stereo_match(*map(_t, args), **kw)
    _assert_same(got, ref)
    assert int(got.valid.sum()) > 0


def test_interframe_match_matches_jax(rng):
    n = 80
    prev = _words(rng, n)
    cur = _noisy_copies(rng, prev[rng.permutation(n)], 25)
    cur[10:20] = cur[0]  # duplicates: uniqueness must pick one row per column
    v_a, v_b = rng.random(n) < 0.85, rng.random(n) < 0.85
    oct_ = np.zeros(n, np.int32)
    args = (cur, prev, v_a, v_b)
    ref = jinterframe(*map(jnp.asarray, args), orb_max_distance=60,
                      oct_a=jnp.asarray(oct_), oct_b=jnp.asarray(oct_))
    got = interframe_match(*map(_t, args), orb_max_distance=60,
                           oct_a=_t(oct_), oct_b=_t(oct_))
    _assert_same(got, ref)
    assert int(got.valid.sum()) > 0
