"""Checkpoint / resume of the full SLAM state.

Counterpart of ``srba_slam_tpu/utils/checkpoint.py``, in its ``.npz``
layout key for key (``FORMAT_VERSION`` 3), so a file written by either
package loads in the other. The reference *designed* binary save/load-state
(src/CSRBAStereoSLAMEstimator.cpp:2411-2616) but compiled the orchestrating
``m_save_state``/``m_load_state`` out (:2264-2407, :2618-2727); here the
whole estimator state (keyframe store, SRBA graph with its edges, landmarks
and observations, BoW database and vocabulary, VO thresholds and ID
counters, pose bookkeeping) is one set of numpy arrays plus a scalar dict.
Restore is direct: arrays in, no replay of ``define_new_keyframe``.

Descriptor words are stored as uint32, as the JAX package holds them; the
port holds the same bits as int32 on its device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from srba_slam_tpu_torch.models.bow import BoWDatabase, Vocabulary
from srba_slam_tpu_torch.models.keyframe import KFArrays
from srba_slam_tpu_torch.utils import host_numpy

FORMAT_VERSION = 3  # v3: array-based SRBA state (lookup table, edge arrays)


def _stored(a) -> np.ndarray:
    """A store tensor as the file holds it (int32 words -> uint32)."""
    a = host_numpy(a)
    return a.view(np.uint32) if a.ndim == 3 and a.dtype == np.int32 else a


def save_state(est, path: str):
    """Serialize a SRBAStereoSLAMEstimator to ``path`` (.npz)."""
    store = est.store
    rba = est.rba
    rba.flush()  # land any queued window solve before snapshotting
    if est.bow is None:
        # the fallback vocabulary has not been trained yet (no keyframe
        # check happened): train it now from whatever is buffered, so that
        # the checkpoint is self-contained
        est.ensure_vocabulary()
    arrays = {f"kf_{name}": _stored(arr)
              for name, arr in zip(store.arrays._fields, store.arrays)}
    scalars = {
        "format_version": FORMAT_VERSION,
        "n_kfs": store.n_kfs,
        "next_match_id": est.next_match_id,
        "frame_idx": est.frame_idx,
        "fast_th": est.vo.fast_th,
        "orb_th": est.vo.orb_th,
        "vo_next_id": est.vo._next_id,
        "updated_translation_th": est.updated_translation_th,
        "updated_rotation_th": est.updated_rotation_th,
        "bow_n_kfs": est.bow.n_kfs,
        "voc_n_words": est.bow.voc.n_words,
        "voc_k": est.bow.voc.k,
        "voc_L": est.bow.voc.L,
        "rba_n_kfs": rba.n_kfs,
    }
    lm_id_keys = np.nonzero(rba._lm_lookup >= 0)[0]
    # edges removed by a loop-closure rollback are compacted away (edge ids
    # are not persisted; the adjacency is rebuilt on load)
    ev_mask = rba.edge_valid
    np.savez_compressed(
        path,
        __scalars__=json.dumps(scalars),
        **arrays,
        kf_match_ids=store.match_ids,
        kf_poses=store.poses,
        rba_edge_u=rba.edge_u[ev_mask].astype(np.int32),
        rba_edge_v=rba.edge_v[ev_mask].astype(np.int32),
        rba_edge_pose=rba.edge_pose[ev_mask].reshape(-1, 6),
        rba_edge_kind=rba._edge_kind[: rba.n_edges][ev_mask].astype(np.int8),
        rba_lc_blacklist=np.asarray(sorted(rba.lc_blacklist), np.int32).reshape(-1, 2),
        rba_kf_global=rba.kf_global,
        rba_lm_base=rba.lm_base[: rba.n_lms].astype(np.int32),
        rba_lm_pos=rba.lm_pos[: rba.n_lms].reshape(-1, 3),
        rba_lm_match_id=rba.lm_match_id[: rba.n_lms].astype(np.int64),
        rba_lm_id_keys=lm_id_keys.astype(np.int64),
        rba_lm_id_vals=rba._lm_lookup[lm_id_keys].astype(np.int32),
        rba_localmap_center=rba.localmap_center.astype(np.int32),
        rba_obs_kf=rba.obs_kf[: rba.n_obs].astype(np.int32),
        rba_obs_lm=rba.obs_lm[: rba.n_obs].astype(np.int32),
        rba_obs_px=rba.obs_px[: rba.n_obs].reshape(-1, 3),
        bow_db=host_numpy(est.bow._db).astype(np.float32),
        voc_leaf_bits=est.bow.voc.leaf_bits,
        voc_weights=est.bow.voc.weights,
        current_pose=est.current_pose,
        last_kf_pose=est.last_kf_pose,
        incr_from_last_kf=est.incr_from_last_kf,
        incr_from_last_check=est.incr_from_last_check,
    )


def load_state(est, path: str):
    """Restore state saved by :func:`save_state` (of this package or of the
    JAX package) into an initialize()'d estimator with the same capacities,
    on the estimator's device."""
    data = np.load(path, allow_pickle=False)
    scalars = json.loads(str(data["__scalars__"]))
    assert scalars["format_version"] == FORMAT_VERSION
    dev = est.device

    def on_device(a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a)).to(dev)

    store = est.store
    store.arrays = KFArrays(*(on_device(data[f"kf_{name}"]) for name in KFArrays._fields))
    store.match_ids = data["kf_match_ids"].copy()
    store.poses = data["kf_poses"].copy()
    store.n_kfs = scalars["n_kfs"]

    rba = est.rba
    rba._queued = []
    rba.n_kfs = scalars["rba_n_kfs"]
    n_edges = len(data["rba_edge_u"])
    rba._edge_cap = max(64, 1 << max(n_edges - 1, 1).bit_length())
    rba._edge_u = np.zeros(rba._edge_cap, np.int32)
    rba._edge_v = np.zeros(rba._edge_cap, np.int32)
    rba._edge_pose = np.zeros((rba._edge_cap, 6), np.float64)
    rba._edge_kind = np.zeros(rba._edge_cap, np.int8)
    rba._edge_valid = np.ones(rba._edge_cap, bool)
    rba._edge_u[:n_edges] = data["rba_edge_u"]
    rba._edge_v[:n_edges] = data["rba_edge_v"]
    rba._edge_pose[:n_edges] = data["rba_edge_pose"]
    if "rba_edge_kind" in data:  # absent in older checkpoints
        rba._edge_kind[:n_edges] = data["rba_edge_kind"]
    rba.n_edges = n_edges
    rba.lc_blacklist = (
        {(int(a), int(b)) for a, b in data["rba_lc_blacklist"]}
        if "rba_lc_blacklist" in data else set())
    rba.lc_rejects_last_insert = []
    rba.adj = {}
    for e in range(n_edges):
        u, v = int(rba.edge_u[e]), int(rba.edge_v[e])
        rba.adj.setdefault(u, []).append((v, e))
        rba.adj.setdefault(v, []).append((u, e))
    rba.kf_global = data["rba_kf_global"].copy()
    n_lms = len(data["rba_lm_base"])
    rba._lm_cap = max(4096, 1 << max(n_lms - 1, 1).bit_length())
    rba.lm_base = np.zeros(rba._lm_cap, np.int32)
    rba.lm_pos = np.zeros((rba._lm_cap, 3), np.float64)
    rba.lm_match_id = np.full(rba._lm_cap, -1, np.int64)
    rba.lm_base[:n_lms] = data["rba_lm_base"]
    rba.lm_pos[:n_lms] = data["rba_lm_pos"]
    if "rba_lm_match_id" in data:
        rba.lm_match_id[:n_lms] = data["rba_lm_match_id"]
    rba.n_lms = n_lms
    n_obs = len(data["rba_obs_kf"])
    rba._obs_cap = max(4096, 1 << max(n_obs - 1, 1).bit_length())
    rba.obs_kf = np.zeros(rba._obs_cap, np.int32)
    rba.obs_lm = np.zeros(rba._obs_cap, np.int32)
    rba.obs_px = np.zeros((rba._obs_cap, 3), np.float64)
    rba.obs_kf[:n_obs] = data["rba_obs_kf"]
    rba.obs_lm[:n_obs] = data["rba_obs_lm"]
    rba.obs_px[:n_obs] = data["rba_obs_px"]
    rba.n_obs = n_obs
    keys = data["rba_lm_id_keys"]
    rba._lookup_cap = max(8192,
                          1 << max(int(keys.max()) if len(keys) else 1, 1).bit_length())
    rba._lm_lookup = np.full(rba._lookup_cap, -1, np.int32)
    rba._lm_lookup[keys] = data["rba_lm_id_vals"]
    if "rba_lm_match_id" not in data and len(keys):
        # older checkpoints: reconstruct the inverse map from the lookup
        rba.lm_match_id[data["rba_lm_id_vals"]] = keys
    rba.localmap_center = data["rba_localmap_center"].astype(np.int32)

    # rebuild the BoW database (the estimator may not have a vocabulary yet:
    # the train-on-first-frames path has not run in this process)
    voc = Vocabulary(
        leaf_bits=data["voc_leaf_bits"].copy(),
        weights=data["voc_weights"].copy(),
        n_words=scalars["voc_n_words"],
        k=scalars["voc_k"], L=scalars["voc_L"],
    )
    est.bow = BoWDatabase(voc, max_kfs=est.max_kfs, device=dev)
    est._pending_voc_training = False
    est.bow._db = on_device(data["bow_db"])
    est.bow.n_kfs = scalars["bow_n_kfs"]

    est.next_match_id = scalars["next_match_id"]
    est.frame_idx = scalars["frame_idx"]
    est.vo.fast_th = scalars["fast_th"]
    est.vo.orb_th = scalars["orb_th"]
    est.vo._next_id = scalars["vo_next_id"]
    est.updated_translation_th = scalars["updated_translation_th"]
    est.updated_rotation_th = scalars["updated_rotation_th"]
    est.current_pose = data["current_pose"].copy()
    est.last_kf_pose = data["last_kf_pose"].copy()
    est.incr_from_last_kf = data["incr_from_last_kf"].copy()
    est.incr_from_last_check = data["incr_from_last_check"].copy()
    # VO inter-frame tracking restarts cleanly on the next frame; the KF ID
    # set is rebuilt from the last stored keyframe
    last_ids = store.match_ids[store.n_kfs - 1] if store.n_kfs else []
    est.vo._kf_id_set = set(int(i) for i in last_ids if i >= 0)
    # a checkpoint carries no in-flight frame features: clear the pre-load
    # run's remnants, so that an in-place restore (same estimator object)
    # behaves exactly like restoring into a fresh one
    est.vo._prev = None
    est.vo._cur = None
    est.vo._prev_ids = np.full(est.capacity, -1, np.int64)
    est.vo._cur_ids = None
    est.vo._last_pose_inc = np.zeros(6, np.float32)
    est._da_dead = False
    est._pose_dirty = False
    est.step_log = []
    est.query_log = []
    est.kf_stats = []
