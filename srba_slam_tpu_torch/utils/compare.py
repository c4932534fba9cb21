"""State round-trip comparison helpers (numpy only; the port's own copy of
``srba_slam_tpu/utils/compare.py``; ≙ reference
compareKeypointLists / compareMatchesLists / compareOptions,
src/srba-stereo-slam_utils.cpp:33-96) — validate that a checkpoint
save/restore reproduced the exact SLAM state."""

from __future__ import annotations

import dataclasses

import numpy as np

from srba_slam_tpu_torch.utils import host_numpy



def compare_keypoint_lists(ys_a, xs_a, valid_a, ys_b, xs_b, valid_b) -> bool:
    return (
        np.array_equal(host_numpy(valid_a), host_numpy(valid_b))
        and np.array_equal(host_numpy(ys_a), host_numpy(ys_b))
        and np.array_equal(host_numpy(xs_a), host_numpy(xs_b))
    )


def compare_match_lists(idx_a, valid_a, ids_a, idx_b, valid_b, ids_b) -> bool:
    return (
        np.array_equal(host_numpy(valid_a), host_numpy(valid_b))
        and np.array_equal(host_numpy(idx_a), host_numpy(idx_b))
        and np.array_equal(host_numpy(ids_a), host_numpy(ids_b))
    )


def compare_options(a, b) -> list[str]:
    """Field-by-field diff of two option dataclasses; [] means identical."""
    diffs = []
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, (list, tuple, np.ndarray)):
            same = np.array_equal(np.asarray(va), np.asarray(vb))
        else:
            same = va == vb
        if not same:
            diffs.append(f"{f.name}: {va!r} != {vb!r}")
    return diffs


def compare_estimator_state(a, b) -> list[str]:
    """Deep state comparison of two estimators (checkpoint validation)."""
    diffs = []
    if a.store.n_kfs != b.store.n_kfs:
        diffs.append(f"n_kfs: {a.store.n_kfs} != {b.store.n_kfs}")
    for name, arr_a, arr_b in zip(
        a.store.arrays._fields, a.store.arrays, b.store.arrays
    ):
        if not np.array_equal(host_numpy(arr_a), host_numpy(arr_b)):
            diffs.append(f"store.{name} differs")
    if not np.array_equal(a.store.match_ids, b.store.match_ids):
        diffs.append("match_ids differ")
    if a.rba.kf_global.shape != b.rba.kf_global.shape:
        diffs.append(
            f"kf_global shape: {a.rba.kf_global.shape} != {b.rba.kf_global.shape}"
        )
    elif not np.allclose(a.rba.kf_global, b.rba.kf_global):
        diffs.append("kf_global differs")
    if a.rba.n_obs != b.rba.n_obs:
        diffs.append(f"n_obs: {a.rba.n_obs} != {b.rba.n_obs}")
    if a.next_match_id != b.next_match_id:
        diffs.append("next_match_id differs")
    return diffs
