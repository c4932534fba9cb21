"""Stereo visual-odometry engine on torch (≙ rso::CStereoOdometryEstimator).

Counterpart of ``srba_slam_tpu/models/vo.py``, with the same behavioural
contract (reference src/CSRBAStereoSLAMEstimator.cpp:112, 267, 2139-2147;
forced modes dmORB / smDescRbR / ifmDescBF at :1135-1137):

* per frame: FAST detection + NMS on both rectified images (kernel K1),
  grid top-K, upright ORB descriptors with the Gaussian pre-blur fused in
  (kernel K2),
  epipolar-gated stereo matching and triangulation, brute-force tracking
  against the previous frame, the robust two-stage pose solve, and the
  track-ID bookkeeping;
* the adaptive FAST/ORB threshold protocol (reference :275-311) as plain
  host attributes, and the KF hand-off (``set_frame_ids``/``reset_ids``).

Eager code on an explicit device: frames go up as uint8, and per frame the
host reads back only what the frame decision needs. The frontend's options
run as in the JAX package: rectification maps (the remap in front of the
detector), image pyramids (``n_octaves > 1``: every octave through K1 and
K2, on float32 images from octave 1 on), oriented ORB (plain torch: the JAX
package has no kernel for it either), detector margins below 16 (K3 and a
separate suppression where K1's fused window does not fit) and the
fundamental-matrix filter of the tracked matches. Not ported yet: the
batched ``vo_scan`` (ROADMAP M12).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.config import VOOptions
from srba_slam_tpu_torch.ops import prng
from srba_slam_tpu_torch.ops.hopper_fast import fast_nms, fast_score_map, orb_descriptors
from srba_slam_tpu_torch.ops.matching import interframe_match, stereo_match
from srba_slam_tpu_torch.ops.nms import grid_topk, local_max_suppress
from srba_slam_tpu_torch.ops.orb import describe
from srba_slam_tpu_torch.ops.ransac import ransac_fundamental
from srba_slam_tpu_torch.ops.rectify import remap_bilinear
from srba_slam_tpu_torch.ops.robust_lm import PoseSolveResult, solve_pose
from srba_slam_tpu_torch.utils.camera import StereoCamera, project_match_to_3d


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame feature set (capacity K)."""

    ys_l: torch.Tensor      # int32 [K]
    xs_l: torch.Tensor
    score_l: torch.Tensor   # f32 [K]
    valid_l: torch.Tensor   # bool [K]
    desc_l: torch.Tensor    # int32 [K, 8]: the JAX package's uint32 words
    ys_r: torch.Tensor
    xs_r: torch.Tensor
    valid_r: torch.Tensor
    desc_r: torch.Tensor
    m_r_idx: torch.Tensor   # int32 [K] stereo match: left i -> right m_r_idx[i]
    m_valid: torch.Tensor   # bool [K]
    pts3d: torch.Tensor     # f32 [K, 3] triangulated in the left camera frame
    octave: torch.Tensor    # int32 [K] pyramid level of the detection


def frame_features_from_numpy(d, device) -> FrameFeatures:
    """The port's FrameFeatures from the JAX package's, taken to numpy with
    ``jax.device_get``.

    uint32 descriptor words keep their bits as int32. With the JAX engine's
    ``get_state()`` tuple ``(prev, prev_ids, last_pose_inc, next_id)``,
    ``(frame_features_from_numpy(prev, dev), prev_ids, last_pose_inc,
    next_id)`` is a state for :meth:`StereoVOEngine.set_state`.
    """
    out = {}
    for name in FrameFeatures._fields:
        a = np.asarray(getattr(d, name))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    return FrameFeatures(**out)


def _avgpool2(img: torch.Tensor) -> torch.Tensor:
    """2x decimation of ``img`` [..., H, W] f32 for the next pyramid octave
    (an odd last row or column is dropped). Exact for uint8-valued input
    down to three octaves: sums of integers times 0.25."""
    h, w = img.shape[-2] // 2 * 2, img.shape[-1] // 2 * 2
    x = img[..., :h, :w]
    s = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + (x[..., 1::2, 0::2] + x[..., 1::2, 1::2])
    return s * 0.25


def _octave_budget(h0: int, w0: int, cell: int, k: int, n_levels: int):
    """Feature-budget split across pyramid octaves, capped by each octave's
    grid-cell count; any deficit from capped deep octaves flows back to
    octave 0."""
    cells = [((h0 >> lv) // cell) * ((w0 >> lv) // cell)
             for lv in range(n_levels)]
    k_levels = [min(k // n_levels, cells[lv]) for lv in range(n_levels)]
    k_levels[0] = k - sum(k_levels[1:])
    if k_levels[0] > cells[0]:
        raise ValueError(
            f"feature capacity k={k} exceeds octave-0 grid cells {cells[0]} "
            f"(image {h0}x{w0}, cell {cell})"
        )
    return k_levels


def _suppressed_scores(imgs, fast_th, margin, nms_radius):
    """Suppressed FAST score maps of ``imgs`` [N, H, W]: K1 where its fused
    5x5 window fits inside the margin; below that the score map (K3) and
    the suppression as separate stages, as the JAX package leaves its fused
    kernel there."""
    if margin >= 3 + nms_radius:
        return fast_nms(imgs, fast_th, margin=margin, radius=nms_radius)
    s = fast_score_map(imgs, fast_th, margin=margin)
    return local_max_suppress(s, radius=nms_radius)


def _detect_describe_batch(imgs, fast_th, k, cell, nms_radius, margin,
                           oriented=False, n_levels=1):
    """Detect + describe for a batch of images [N, H, W] (uint8 or f32) at
    once, over ``n_levels`` octaves of a 2x pyramid: per octave the
    suppressed score maps (:func:`_suppressed_scores`), grid top-K with the
    octave's share of ``k``, and the descriptors (K2 with the blur inside
    for upright ones, plain torch for oriented ones). Coordinates are
    reported at full resolution. Returns (ys, xs, sc, valid, desc, octv),
    each with leading dim N."""
    n, h0, w0 = imgs.shape
    k_levels = _octave_budget(h0, w0, cell, k, n_levels)
    per = []
    cur = imgs
    for lvl in range(n_levels):
        kl = k_levels[lvl]
        s = _suppressed_scores(cur, fast_th, margin, nms_radius)
        ys, xs, sc, valid = grid_topk(s, cell=cell, k=kl)
        if oriented:
            desc = describe(cur, ys, xs, valid, oriented=True)[0]
        else:
            desc = orb_descriptors(cur, ys, xs, valid)
        octv = torch.full((n, kl), lvl, dtype=torch.int32, device=imgs.device)
        if lvl:
            ys, xs = ys << lvl, xs << lvl
        per.append((ys, xs, sc, valid, desc, octv))
        if lvl + 1 < n_levels:
            cur = _avgpool2(cur.to(torch.float32))
    if n_levels == 1:
        return per[0]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*per))


def _build_frame(det_l, det_r, cam, orb_th, max_y_diff, min_disparity,
                 max_disparity, robust_1to1) -> FrameFeatures:
    """Stereo-match one detected pair and triangulate (single frame)."""
    (ys_l, xs_l, sc_l, v_l, d_l, o_l) = det_l
    (ys_r, xs_r, _sc_r, v_r, d_r, o_r) = det_r
    m = stereo_match(
        d_l, d_r, ys_l, xs_l, ys_r, xs_r, v_l, v_r,
        max_y_diff=max_y_diff, orb_max_distance=orb_th,
        min_disparity=min_disparity, max_disparity=max_disparity,
        oct_l=o_l, oct_r=o_r, robust_1to1=robust_1to1,
    )
    f32 = torch.float32
    xr = xs_r[m.idx.long()].to(f32)
    pts = project_match_to_3d(xs_l.to(f32), ys_l.to(f32), xr, cam)
    pts = torch.where(m.valid[:, None], pts, 0.0)
    return FrameFeatures(
        ys_l=ys_l, xs_l=xs_l, score_l=sc_l, valid_l=v_l, desc_l=d_l,
        ys_r=ys_r, xs_r=xs_r, valid_r=v_r, desc_r=d_r,
        m_r_idx=m.idx, m_valid=m.valid, pts3d=pts, octave=o_l,
    )


def extract_and_match(
    left,
    right,
    cam: StereoCamera,
    fast_th: float,
    orb_th: int,
    k: int = 512,
    cell: int = 5,
    nms_radius: int = 2,
    margin: int = 16,
    max_y_diff: float = 2.0,
    min_disparity: float = 0.1,
    max_disparity: float = 1e9,
    oriented: bool = False,
    n_levels: int = 1,
    robust_1to1: bool = False,
    rect_maps=None,
    device="cuda",
) -> FrameFeatures:
    """The full frontend for one stereo pair ``left``/``right`` [H, W]
    (numpy or tensors, uint8 or float32) on ``device`` (the card unless the
    caller asks for the CPU), both images batched through the detector and
    the descriptor kernels together.

    ``n_levels`` > 1 detects and describes on a 2x image pyramid (≙ the
    stereo-vo nOctaves option): coordinates are reported at full resolution,
    descriptors are sampled at the detecting octave's scale, and the feature
    budget splits evenly across octaves (the remainder to octave 0).
    ``rect_maps``, a (RectifyMaps_left, RectifyMaps_right) pair on
    ``device``, runs the RECTIFY stage first (≙ stereo-vo's rectification
    for ``rectified_images=false`` rigs)."""
    left = torch.as_tensor(left, device=device)
    right = torch.as_tensor(right, device=device)
    if rect_maps is not None:
        left = remap_bilinear(left, rect_maps[0])
        right = remap_bilinear(right, rect_maps[1])
    imgs = torch.stack([left, right])
    out = _detect_describe_batch(imgs, fast_th, k=k, cell=cell,
                                 nms_radius=nms_radius, margin=margin,
                                 oriented=oriented, n_levels=n_levels)
    det_l = tuple(a[0] for a in out)
    det_r = tuple(a[1] for a in out)
    return _build_frame(det_l, det_r, cam, orb_th, max_y_diff,
                        min_disparity, max_disparity, robust_1to1)


class TrackSolveOut(NamedTuple):
    track_idx: torch.Tensor    # int32 [K]: cur i -> prev track_idx[i]
    track_valid: torch.Tensor  # bool [K]
    pose: PoseSolveResult


def track_and_solve(
    prev: FrameFeatures,
    cur: FrameFeatures,
    cam: StereoCamera,
    initial_pose: torch.Tensor,
    orb_th: int,
    kernel_param: float = 2.0,
    residual_threshold: float = 15.0,
    min_mod: float = 1e-3,
    max_iters_initial: int = 30,
    max_iters: int = 30,
    min_inliers: int = 5,
    max_incr_cost: int = 3,
    filter_fund_matrix: bool = False,
) -> TrackSolveOut:
    """Track stereo-matched features into the current frame and solve the
    frame-to-frame pose increment (x_cur = T x_prev)."""
    m = interframe_match(cur.desc_l, prev.desc_l, cur.m_valid, prev.m_valid,
                         orb_max_distance=orb_th,
                         oct_a=cur.octave, oct_b=prev.octave)
    f32 = torch.float32
    pts_prev = prev.pts3d[m.idx.long()]
    ur = cur.xs_r[cur.m_r_idx.long()].to(f32)
    obs = torch.stack([cur.xs_l.to(f32), cur.ys_l.to(f32), ur], dim=-1)
    valid = m.valid & cur.m_valid
    if filter_fund_matrix:
        # ≙ the stereo-vo IF-MATCH filter_fund_matrix option: gate the
        # tracked matches by fundamental-matrix RANSAC over the left pixels
        # before the pose solve (applied only when enough matches survive)
        prev_idx = m.idx.long()
        inl, _cnt, _F = ransac_fundamental(
            cur.xs_l.to(f32), cur.ys_l.to(f32),
            prev.xs_l[prev_idx].to(f32), prev.ys_l[prev_idx].to(f32),
            valid, prng.PRNGKey(0, device=valid.device), threshold=2.0, n_hyp=64)
        n_alive = torch.sum(valid.to(torch.int32))
        valid = torch.where(n_alive >= 15, valid & inl, valid)
    res = solve_pose(
        pts_prev, obs, valid, cam,
        initial_pose=initial_pose,
        kernel_param=kernel_param,
        residual_threshold=residual_threshold,
        min_mod=min_mod,
        max_iters_initial=max_iters_initial,
        max_iters=max_iters,
        min_inliers=min_inliers,
        max_incr_cost=max_incr_cost,
    )
    return TrackSolveOut(track_idx=m.idx, track_valid=valid, pose=res)


class VOResult(NamedTuple):
    """≙ TStereoOdometryResult (reference .cpp:268-269, 318-360)."""

    valid: bool
    pose_increment: np.ndarray          # [6] prev-frame -> cur-frame
    num_stereo_matches: int
    tracked_from_last_frame: int
    tracked_from_last_kf: int
    mean_residual: float
    num_iters: int


@dataclass
class StereoVOEngine:
    """Host orchestrator over the frontend and the pose solve on ``device``."""

    cam: StereoCamera
    opts: VOOptions = field(default_factory=VOOptions)
    capacity: int = 512
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.fast_th: float = float(self.opts.fast_th)
        self.fast_th_min: float = 5.0
        self.fast_th_max: float = float(self.opts.fast_th)
        self.orb_th: float = float(self.opts.orb_max_distance)
        self.orb_th_max: float = 90.0
        self._prev: FrameFeatures | None = None
        self._prev_ids: np.ndarray = np.full(self.capacity, -1, np.int64)
        self._kf_id_set: set[int] = set()
        self._cur: FrameFeatures | None = None
        self._cur_ids: np.ndarray | None = None
        self._last_pose_inc = np.zeros(6, np.float32)
        self._next_id: int = 0
        # optional (RectifyMaps_l, RectifyMaps_r) undistortion grids on the
        # engine's device, applied in front of the detector (set by the
        # estimator when the config declares unrectified input)
        self.rect_maps = None
        if not self.opts.vo_use_matches_ids:
            # ≙ the stereo-vo GENERAL vo_use_matches_ids option: the SLAM
            # layer REQUIRES match-id bookkeeping, so the key is refused
            # rather than silently honoured
            import sys

            print("[srba_slam_tpu_torch] warning: vo_use_matches_ids=false "
                  "requested, but SLAM requires match-ID bookkeeping — "
                  "keeping it enabled", file=sys.stderr)

    def _mint_ids(self, ids: np.ndarray, m_valid: np.ndarray) -> np.ndarray:
        fresh = m_valid & (ids < 0)
        n = int(fresh.sum())
        ids[fresh] = np.arange(self._next_id, self._next_id + n)
        self._next_id += n
        return ids

    # --- adaptive threshold protocol (reference .cpp:275-311) -------------
    def is_fast_th_min(self) -> bool:
        return self.fast_th <= self.fast_th_min

    def is_orb_th_max(self) -> bool:
        return self.orb_th >= self.orb_th_max

    def set_fast_threshold(self, th: float):
        self.fast_th = float(np.clip(th, self.fast_th_min, 255.0))

    def set_orb_threshold(self, th: float):
        self.orb_th = float(np.clip(th, 1.0, self.orb_th_max))

    def reset_fast_threshold(self):
        self.fast_th = self.fast_th_max

    def reset_orb_threshold(self):
        self.orb_th = float(self.opts.orb_max_distance)

    def retry_step(self) -> bool:
        """One adaptive-retry threshold move (≙ the do-while body of
        reference .cpp:271-315): drop FAST by 10 while it can still drop,
        then raise the ORB matching threshold by 10. Returns True when a
        threshold moved (the caller re-processes the same frame); False
        when both are exhausted."""
        if not self.is_fast_th_min():
            self.set_fast_threshold(self.fast_th - 10)
            return True
        if not self.is_orb_th_max():
            self.set_orb_threshold(self.orb_th + 10)
            return True
        return False

    def drift_thresholds(self, n_matches: float, th_min: float):
        """Post-retry healthy drift (≙ the tail adjustments of reference
        .cpp:298-314): below 1.2x the minimum pull FAST down by 5, or, with
        FAST on its floor, raise the ORB matching threshold by 5; a healthy
        frame drifts FAST back toward ``min(detect_fast_th, fast+5)`` and
        resets the ORB threshold."""
        if n_matches < 1.2 * th_min:
            if not self.is_fast_th_min():
                self.set_fast_threshold(self.fast_th - 5)
            elif not self.is_orb_th_max():
                self.set_orb_threshold(self.orb_th + 5)
        else:
            self.set_fast_threshold(min(self.fast_th_max, self.fast_th + 5))
            self.reset_orb_threshold()

    # --- main per-frame entry (≙ processNewImagePair) ---------------------
    def process_stereo_pair(self, left, right) -> VOResult:
        cur = extract_and_match(
            left, right, self.cam, float(np.float32(self.fast_th)), int(self.orb_th),
            k=self.capacity, cell=self.opts.min_distance,
            max_y_diff=self.opts.max_y_diff,
            oriented=self.opts.orb_oriented,
            n_levels=self.opts.n_octaves,
            robust_1to1=self.opts.enable_robust_1to1_match,
            rect_maps=self.rect_maps,
            device=self.device,
        )
        if self._prev is None:
            m_valid_h = cur.m_valid.cpu().numpy()
            n_matches = int(m_valid_h.sum())
            self._cur = cur
            self._cur_ids = self._mint_ids(
                np.full(self.capacity, -1, np.int64), m_valid_h
            )
            self._advance()
            return VOResult(True, np.zeros(6, np.float32), n_matches, 0, 0, 0.0, 0)

        init = (
            torch.as_tensor(self._last_pose_inc, device=self.device)
            if self.opts.use_previous_pose_as_initial
            else torch.zeros(6, dtype=torch.float32, device=self.device)
        )
        out = track_and_solve(
            self._prev, cur, self.cam, init, int(self.orb_th),
            kernel_param=self.opts.kernel_param,
            residual_threshold=self.opts.residual_threshold,
            min_mod=self.opts.min_mod_out_vector,
            max_iters_initial=self.opts.initial_max_iters,
            max_iters=self.opts.max_iters,
            min_inliers=self.opts.bad_tracking_th,
            max_incr_cost=self.opts.max_incr_cost,
            filter_fund_matrix=self.opts.filter_fund_matrix,
        )
        track_idx = out.track_idx.cpu().numpy()
        track_valid = out.track_valid.cpu().numpy()
        m_valid_h = cur.m_valid.cpu().numpy()
        pose_inc = out.pose.pose.cpu().numpy()
        pose_ok = bool(out.pose.valid)
        mean_res = float(out.pose.mean_residual)
        iters = int(out.pose.iters)
        n_matches = int(m_valid_h.sum())
        # ID propagation: tracked features inherit the previous frame's IDs;
        # fresh stereo matches get fresh IDs from the engine counter (the
        # estimator may overwrite them at KF insertion via set_frame_ids)
        cur_ids = np.full(self.capacity, -1, np.int64)
        cur_ids[track_valid] = self._prev_ids[track_idx[track_valid]]
        cur_ids[~m_valid_h] = -1
        cur_ids = self._mint_ids(cur_ids, m_valid_h)
        tracked_last = int(track_valid.sum())
        if self._kf_id_set:
            kf_ids = np.fromiter(self._kf_id_set, np.int64)
            tracked_kf = int(np.isin(cur_ids[cur_ids >= 0], kf_ids).sum())
        else:
            tracked_kf = 0

        self._cur = cur
        self._cur_ids = cur_ids
        if pose_ok:
            self._last_pose_inc = pose_inc
        self._advance()
        return VOResult(
            valid=pose_ok,
            pose_increment=pose_inc if pose_ok else np.zeros(6, np.float32),
            num_stereo_matches=n_matches,
            tracked_from_last_frame=tracked_last,
            tracked_from_last_kf=tracked_kf,
            mean_residual=mean_res,
            num_iters=iters,
        )

    def _advance(self):
        self._prev = self._cur
        self._prev_ids = self._cur_ids.copy()

    # --- KF hand-off (≙ setThisFrameAsKF / getValues / resetIds) ----------
    def last_frame(self) -> FrameFeatures:
        """The features of the most recent processed frame."""
        return self._prev

    def last_frame_ids(self) -> np.ndarray:
        return self._prev_ids

    def set_frame_ids(self, ids: np.ndarray, kf_id_set: set[int]):
        """Estimator writes back the (possibly freshly minted) match IDs when
        the last frame is promoted to a keyframe."""
        self._prev_ids = ids.copy()
        self._kf_id_set = set(kf_id_set)
        # keep the engine's fresh-id sequence ABOVE every assigned id, so an
        # engine-minted track id never collides with a keyframe id
        if len(ids) and (ids >= 0).any():
            self._next_id = max(self._next_id, int(ids.max()) + 1)

    def reset_ids(self):
        self._kf_id_set = set()

    # --- state snapshot (for the estimator's re-process-same-frame retry,
    #     ≙ the `repeat` request flag of TStereoOdometryRequest) -----------
    def get_state(self):
        return (self._prev, None if self._prev_ids is None else self._prev_ids.copy(),
                self._last_pose_inc.copy(), self._next_id)

    def set_state(self, state):
        self._prev, ids, self._last_pose_inc, self._next_id = state
        self._prev_ids = None if ids is None else ids.copy()
