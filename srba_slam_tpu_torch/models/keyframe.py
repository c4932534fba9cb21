"""Fixed-capacity keyframe store (≙ CStereoSLAMKF + the vector of KFs).

Counterpart of ``srba_slam_tpu/models/keyframe.py``. The reference keeps a
``std::vector<CStereoSLAMKF>`` (left/right keypoints, 256-bit descriptors,
L-R matches, match IDs and a pose per keyframe, reference
src/CStereoSLAMKF.h:99-104). Here the per-feature data are padded device
tensors ``[max_kfs, K, ...]``, so any subset of keyframes gathers into one
tensor program; the match IDs, poses and the count live on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.models.vo import FrameFeatures

_ROW_FIELDS = ("ys_l", "xs_l", "valid_l", "desc_l", "ys_r", "xs_r", "valid_r",
               "desc_r", "m_r_idx", "m_valid", "pts3d", "octave")


class KFArrays(NamedTuple):
    """Device-side stacked keyframe data."""

    ys_l: torch.Tensor     # int32 [M, K]
    xs_l: torch.Tensor
    valid_l: torch.Tensor  # bool [M, K]
    desc_l: torch.Tensor   # int32 [M, K, 8]: the JAX package's uint32 words
    ys_r: torch.Tensor
    xs_r: torch.Tensor
    valid_r: torch.Tensor
    desc_r: torch.Tensor
    m_r_idx: torch.Tensor  # int32 [M, K]
    m_valid: torch.Tensor  # bool [M, K]
    pts3d: torch.Tensor    # f32 [M, K, 3] (left-camera frame)
    octave: torch.Tensor   # int32 [M, K]


def kf_arrays_from_numpy(arrays, device) -> KFArrays:
    """The port's KFArrays from the JAX package's, taken to numpy with
    ``jax.device_get(store.arrays)`` (uint32 words keep their bits as int32)."""
    out = {}
    for name in KFArrays._fields:
        a = np.asarray(getattr(arrays, name))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return KFArrays(**out)


class KeyframeStore:
    """Host wrapper around KFArrays + per-KF match IDs and poses."""

    def __init__(self, max_kfs: int = 512, capacity: int = 512, device="cuda"):
        self.max_kfs = max_kfs
        self.capacity = capacity
        self.device = torch.device(device)
        m, k, dev = max_kfs, capacity, self.device
        i32 = torch.int32

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.arrays = KFArrays(
            ys_l=z((m, k), i32), xs_l=z((m, k), i32), valid_l=z((m, k), torch.bool),
            desc_l=z((m, k, 8), i32),
            ys_r=z((m, k), i32), xs_r=z((m, k), i32), valid_r=z((m, k), torch.bool),
            desc_r=z((m, k, 8), i32),
            m_r_idx=z((m, k), i32), m_valid=z((m, k), torch.bool),
            pts3d=z((m, k, 3), torch.float32), octave=z((m, k), i32),
        )
        self.match_ids = np.full((max_kfs, k), -1, np.int64)  # host
        self.poses = np.zeros((max_kfs, 6), np.float32)       # world poses, host
        self.n_kfs = 0

    @staticmethod
    def from_jax_numpy(arrays, n_kfs: int, match_ids: np.ndarray, poses: np.ndarray,
                       device="cuda") -> "KeyframeStore":
        """A store holding the JAX package's store state: ``arrays`` from
        ``jax.device_get(store.arrays)``, with its ``n_kfs``, ``match_ids``
        and ``poses``."""
        a = kf_arrays_from_numpy(arrays, device)
        max_kfs, k = a.ys_l.shape
        store = KeyframeStore(max_kfs, k, device)
        store.arrays = a
        store.n_kfs = int(n_kfs)
        store.match_ids = np.array(match_ids, np.int64)
        store.poses = np.array(poses, np.float32)
        return store

    def _write_row(self, frame: FrameFeatures, row: int):
        """Write ``frame`` into device row ``row`` without committing the
        count. Rows at or past ``n_kfs`` are inert (every reader masks by
        the count); the loop-closure re-check reads the new keyframe's row
        before it is committed."""
        assert row < self.max_kfs, "keyframe capacity exhausted"
        for name in _ROW_FIELDS:
            getattr(self.arrays, name)[row] = getattr(frame, name)

    def append(self, frame: FrameFeatures, ids: np.ndarray, pose: np.ndarray) -> int:
        """Store a frame as keyframe; returns its KF id."""
        i = self.n_kfs
        self._write_row(frame, i)
        self.match_ids[i] = ids
        self.poses[i] = pose
        self.n_kfs += 1
        return i

    def drop_last(self):
        """Un-insert the most recent KF (≙ the candidate-KF rollback at
        reference src/CSRBAStereoSLAMEstimator.cpp:558-562)."""
        assert self.n_kfs > 0
        self.n_kfs -= 1
        self.match_ids[self.n_kfs] = -1

    def set_pose(self, kf_id: int, pose: np.ndarray):
        self.poses[kf_id] = np.asarray(pose, np.float32)
