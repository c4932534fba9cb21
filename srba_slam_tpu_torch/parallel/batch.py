"""Many stereo sequences through one VO step on one card.

Counterpart of ``srba_slam_tpu/parallel/batch.py``. The JAX package places
a leading batch of sequences across a device mesh (``make_mesh``,
``shard_batch``) and lets XLA partition the step. One H100 has no mesh: the
batch is a leading dimension on the card, so those two functions have no
counterpart here. The frontend of the B sequences' 2B images is one batch
(one K1 and one K2 launch), and their frame-to-frame tracking and pose
solve one ``track_and_solve`` of B lanes (≙ JAX's ``_batched_step``).
"""

from __future__ import annotations

import numpy as np
import torch

from srba_slam_tpu_torch.models.vo import (
    FrameFeatures, extract_and_match_batch, stack_features, track_and_solve,
)
from srba_slam_tpu_torch.utils.camera import StereoCamera


def batched_vo_step(lefts, rights, prev: FrameFeatures, init_pose, cam: StereoCamera,
                    fast_th: float = 20.0, orb_th: int = 60, k: int = 256, cell: int = 5,
                    device="cuda"):
    """One VO step for B sequences at once: extract and stereo-match each
    sequence's pair (``lefts``/``rights`` [B, H, W]), track it against its
    previous frame (``prev``, FrameFeatures stacked along B) from
    ``init_pose`` [B, 6], and solve its pose. Returns ``(cur, poses, valid,
    fleet_mean_residual, fleet_valid_fraction)``: the stacked features, the
    per-sequence increments [B, 6] and validity [B], and the two fleet-wide
    means."""
    th = float(np.float32(fast_th))
    curs = extract_and_match_batch(lefts, rights, cam, th, int(orb_th), k=k, cell=cell,
                                   device=device)
    init_pose = torch.as_tensor(init_pose, dtype=torch.float32, device=device)
    cur = stack_features(curs)
    out = track_and_solve(prev, cur, cam, init_pose, int(orb_th)).pose
    return (cur, out.pose, out.valid, torch.mean(out.mean_residual),
            torch.mean(out.valid.to(torch.float32)))


def empty_features(batch: int, k: int, device="cuda") -> FrameFeatures:
    """A valid all-empty FrameFeatures batch (for the first frame)."""
    z_i = torch.zeros((batch, k), dtype=torch.int32, device=device)
    z_b = torch.zeros((batch, k), dtype=torch.bool, device=device)
    return FrameFeatures(
        ys_l=z_i, xs_l=z_i, score_l=torch.zeros((batch, k), dtype=torch.float32, device=device),
        valid_l=z_b, desc_l=torch.zeros((batch, k, 8), dtype=torch.int32, device=device),
        ys_r=z_i, xs_r=z_i, valid_r=z_b,
        desc_r=torch.zeros((batch, k, 8), dtype=torch.int32, device=device),
        m_r_idx=z_i, m_valid=z_b,
        pts3d=torch.zeros((batch, k, 3), dtype=torch.float32, device=device),
        octave=z_i,
    )
