"""Batched descriptor matching (stereo and inter-frame) as masked tensor ops.

Counterpart of ``srba_slam_tpu/ops/matching.py`` (the reference's
row-by-row stereo matching ``smDescRbR`` and brute-force inter-frame
matching ``ifmDescBF``, src/CSRBAStereoSLAMEstimator.cpp:1135-1137): one N×M
Hamming matrix, gates as masks, a per-row argmin (first index on ties), then
1-to-1 uniqueness by a column-wise scatter-min of (distance, row) keys.
A min does not depend on the order the scatter runs in, so the result is
the same on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srba_slam_tpu_torch.ops.hamming import hamming_matrix

_BIG = 1e9  # exact in f32


class MatchResult(NamedTuple):
    """Per-left-feature match info; all tensors have length N."""

    idx: torch.Tensor    # int32 [N] index into the right/other set
    dist: torch.Tensor   # f32 [N] Hamming distance (BIG where invalid)
    valid: torch.Tensor  # bool [N]


def masked_best_match(
    dist: torch.Tensor,
    gate: torch.Tensor,
    max_dist: float,
    unique: bool = True,
    mutual: bool = False,
) -> MatchResult:
    """Row-wise best match under a mask, with optional 1-to-1 uniqueness.

    Args:
      dist: [..., N, M] f32 distance matrix (leading dimensions are lanes).
      gate: [..., N, M] bool; False entries are excluded.
      max_dist: distance threshold (inclusive); a number, or a tensor of
        one threshold per lane.
      unique: each column is claimed by at most one row (the row with the
        smallest distance wins; ties break to the lowest row).
      mutual: additionally require STRICT mutual best (≙ the stereo-vo
        ``enable_robust_1to1_match`` MATCH option).
    """
    n, m = dist.shape[-2:]
    d = torch.where(gate, dist.to(torch.float32), _BIG)
    best_j = torch.argmin(d, dim=-1)
    best_d = torch.amin(d, dim=-1)
    if isinstance(max_dist, torch.Tensor):
        max_dist = max_dist[..., None]
    valid = best_d <= max_dist
    if unique:
        # (distance, row) keys stay exact in f32: dist*n + row < 2^24
        rows = torch.arange(n, dtype=torch.float32, device=dist.device)
        key = torch.where(valid, best_d * n + rows, _BIG)
        col_best = torch.full((*d.shape[:-2], m), _BIG, dtype=torch.float32,
                              device=dist.device)
        col_best = col_best.scatter_reduce(-1, best_j, key, reduce="amin",
                                           include_self=True)
        valid = valid & (key == torch.gather(col_best, -1, best_j))
    if mutual:
        col_min_all = torch.amin(d, dim=-2)
        valid = valid & (best_d <= torch.gather(col_min_all, -1, best_j))
    best_j = torch.where(valid, best_j, 0).to(torch.int32)
    best_d = torch.where(valid, best_d, _BIG)
    return MatchResult(best_j, best_d, valid)


def stereo_match(
    desc_l: torch.Tensor,
    desc_r: torch.Tensor,
    ys_l: torch.Tensor,
    xs_l: torch.Tensor,
    ys_r: torch.Tensor,
    xs_r: torch.Tensor,
    valid_l: torch.Tensor,
    valid_r: torch.Tensor,
    max_y_diff: float = 2.0,
    orb_max_distance: int = 60,
    min_disparity: float = 0.0,
    max_disparity: float = 1e9,
    oct_l: torch.Tensor | None = None,
    oct_r: torch.Tensor | None = None,
    robust_1to1: bool = False,
) -> MatchResult:
    """Epipolar-gated left-right matching (≙ smDescRbR; gates per
    demo/config_imgdir_kitti_srba.ini MATCH). Features only match within
    the same pyramid octave when octave tensors are given."""
    dist = hamming_matrix(desc_l, desc_r)
    f32 = torch.float32
    dy = torch.abs(ys_l[:, None].to(f32) - ys_r[None, :].to(f32))
    disp = xs_l[:, None].to(f32) - xs_r[None, :].to(f32)
    gate = (
        valid_l[:, None]
        & valid_r[None, :]
        & (dy <= max_y_diff)
        & (disp > min_disparity)
        & (disp < max_disparity)
    )
    if oct_l is not None:
        gate = gate & (oct_l[:, None] == oct_r[None, :])
    return masked_best_match(dist, gate, orb_max_distance, mutual=robust_1to1)


def interframe_match(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    orb_max_distance: int = 60,
    unique: bool = True,
    oct_a: torch.Tensor | None = None,
    oct_b: torch.Tensor | None = None,
) -> MatchResult:
    """Brute-force matching of feature set A against B (≙ ifmDescBF);
    restricted to same-octave pairs when octave tensors are given. Every
    tensor may lead with a lane dimension (``orb_max_distance`` then a
    number or one threshold per lane)."""
    dist = hamming_matrix(desc_a, desc_b)
    gate = valid_a[..., :, None] & valid_b[..., None, :]
    if oct_a is not None:
        gate = gate & (oct_a[..., :, None] == oct_b[..., None, :])
    return masked_best_match(dist, gate, orb_max_distance, unique=unique)
