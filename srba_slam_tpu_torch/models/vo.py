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
fundamental-matrix filter of the tracked matches.

``vo_scan`` is the batched form behind the estimator's batched loop (the
CLI's ``--batch N``): the frontend of B frames as one batch over their 2B
images (K1 and K2 launch once), then the B frame-to-frame solves in order.
On a card it is one replay of a CUDA graph per shape and options
(``scan_key``), its GN loops conditional nodes inside it and its FAST and
ORB thresholds device inputs, as the JAX package's ``vo_scan`` is one
jitted dispatch per shape.
The host half of a frame, ID propagation and the tracked-from-keyframe
count, is :meth:`StereoVOEngine.commit_frame`, the one copy that per-frame
stepping, the scan's walk and the fleet's lockstep step all call.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.config import VOOptions
from srba_slam_tpu_torch.ops import cuda_graphs, prng, robust_lm
from srba_slam_tpu_torch.ops.hopper_fast import (
    fast_nms, fast_score_map, orb_descriptors,
)
from srba_slam_tpu_torch.ops.matching import interframe_match, stereo_match
from srba_slam_tpu_torch.ops.nms import grid_topk, local_max_suppress
from srba_slam_tpu_torch.ops.orb import describe
from srba_slam_tpu_torch.ops.ransac import ransac_fundamental
from srba_slam_tpu_torch.ops.rectify import remap_bilinear
from srba_slam_tpu_torch.ops.robust_lm import PoseSolveResult, solve_pose
from srba_slam_tpu_torch.utils.camera import StereoCamera, project_match_to_3d

# On a CUDA device, vo_scan is one replay of a CUDA graph per scan_key; eager
# launches otherwise (the CPU path, and the card's reference in the tests)
SCAN_GRAPHS = True
# the fundamental-matrix filter's PRNG key 0 on each device, copied there
# once (a capture cannot copy it from the host)
_FUND_KEYS: dict = {}


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
    """Suppressed FAST score maps of ``imgs`` [N, H, W] at ``fast_th`` (a
    float, or f32 [N]: one per image): K1 where its fused window fits inside
    the margin (K1 refuses a radius outside 0-5, as the JAX package's
    kernel takes no other); below that the score map (K3) and the
    suppression as separate stages, as the JAX package leaves its fused
    kernel there."""
    if margin >= 3 + nms_radius:
        return fast_nms(imgs, fast_th, margin=margin, radius=nms_radius)
    s = fast_score_map(imgs, fast_th, margin=margin)
    return local_max_suppress(s, radius=nms_radius)


def _detect_describe_batch(imgs, fast_th, k, cell, nms_radius, margin,
                           oriented=False, n_levels=1):
    """Detect + describe for a batch of images [N, H, W] (uint8 or f32) at
    once, at ``fast_th`` (a float, or f32 [N]: one per image), over
    ``n_levels`` octaves of a 2x pyramid: per octave the
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


def _frames_on(x, device) -> torch.Tensor:
    """Frames (numpy or tensors) on ``device``: uint8 stays uint8 (K1's DPX
    route), every other type becomes float32, as the JAX package casts."""
    x = torch.as_tensor(x, device=device)
    return x if x.dtype == torch.uint8 else x.to(torch.float32)


def extract_and_match_batch(
    lefts, rights, cam: StereoCamera, fast_th, orb_th, k: int = 512, cell: int = 5,
    nms_radius: int = 2, margin: int = 16, max_y_diff: float = 2.0,
    min_disparity: float = 0.1, max_disparity: float = 1e9, oriented: bool = False,
    n_levels: int = 1, robust_1to1: bool = False, rect_maps=None, device="cuda",
) -> list[FrameFeatures]:
    """The frontend of B stereo pairs ``lefts``/``rights`` [B, H, W] (numpy
    or tensors, uint8 or float32) on ``device`` as one batch over their 2B
    images: the remap with the rig's maps, then detect and describe (K1 and
    K2 launch once), then the stereo match of each pair. ``fast_th`` is a
    float, or an f32 tensor on ``device`` (one value, or [B]: one per pair);
    ``orb_th`` an int or B ints, or a tensor on ``device`` (one value, or
    [B]), which the matcher compares on the device without a host read.
    Returns the B frames' FrameFeatures (see :func:`extract_and_match` for
    the options)."""
    lefts, rights = _frames_on(lefts, device), _frames_on(rights, device)
    b = lefts.shape[0]
    if rect_maps is not None:
        lefts = remap_bilinear(lefts, rect_maps[0])
        rights = remap_bilinear(rights, rect_maps[1])
    if isinstance(fast_th, torch.Tensor):
        fast_th = fast_th.reshape(-1).expand(b)
        fast_th = torch.cat([fast_th, fast_th])
    det = _detect_describe_batch(torch.cat([lefts, rights]), fast_th, k=k, cell=cell,
                                 nms_radius=nms_radius, margin=margin,
                                 oriented=oriented, n_levels=n_levels)
    if isinstance(orb_th, torch.Tensor):
        orb_ths = [orb_th[j] if orb_th.dim() else orb_th for j in range(b)]
    else:
        orb_ths = [int(orb_th)] * b if np.ndim(orb_th) == 0 else [int(t) for t in orb_th]
    return [_build_frame(tuple(a[j] for a in det), tuple(a[b + j] for a in det), cam,
                         orb_ths[j], max_y_diff, min_disparity, max_disparity, robust_1to1)
            for j in range(b)]


def stack_features(frames) -> FrameFeatures:
    """FrameFeatures with a leading frame dimension from a list of them."""
    return FrameFeatures(*(torch.stack(parts) for parts in zip(*frames)))


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
    left, right = _frames_on(left, device), _frames_on(right, device)
    return extract_and_match_batch(
        left[None], right[None], cam, fast_th, orb_th, k=k, cell=cell, nms_radius=nms_radius,
        margin=margin, max_y_diff=max_y_diff, min_disparity=min_disparity,
        max_disparity=max_disparity, oriented=oriented, n_levels=n_levels,
        robust_1to1=robust_1to1, rect_maps=rect_maps, device=device)[0]


class TrackSolveOut(NamedTuple):
    track_idx: torch.Tensor    # int32 [K]: cur i -> prev track_idx[i]
    track_valid: torch.Tensor  # bool [K]
    pose: PoseSolveResult


def track_and_solve(
    prev: FrameFeatures,
    cur: FrameFeatures,
    cam: StereoCamera,
    initial_pose: torch.Tensor,
    orb_th,
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
    frame-to-frame pose increment (x_cur = T x_prev).

    With a leading sequence dimension B on ``prev``, ``cur`` and
    ``initial_pose`` [B, 6] (``orb_th`` one number, or one per sequence as a
    tensor [B]), the B sequences track together and their poses are one
    ``solve_pose`` of B lanes (≙ the JAX package's vmapped
    ``track_and_solve``); every output leads with B."""
    lanes = cur.desc_l.dim() == 3
    if not lanes:
        prev, cur = (FrameFeatures(*(a[None] for a in f)) for f in (prev, cur))
        initial_pose = initial_pose[None]
    m = interframe_match(cur.desc_l, prev.desc_l, cur.m_valid, prev.m_valid,
                         orb_max_distance=orb_th,
                         oct_a=cur.octave, oct_b=prev.octave)
    f32 = torch.float32
    seq = torch.arange(cur.desc_l.shape[0], device=cur.desc_l.device)[:, None]
    prev_idx = m.idx.long()
    pts_prev = prev.pts3d[seq, prev_idx]
    ur = cur.xs_r[seq, cur.m_r_idx.long()].to(f32)
    obs = torch.stack([cur.xs_l.to(f32), cur.ys_l.to(f32), ur], dim=-1)
    valid = m.valid & cur.m_valid
    if filter_fund_matrix:
        # ≙ the stereo-vo IF-MATCH filter_fund_matrix option: gate the
        # tracked matches by fundamental-matrix RANSAC over the left pixels
        # before the pose solve (applied only when enough matches survive)
        if valid.device not in _FUND_KEYS:
            _FUND_KEYS[valid.device] = prng.PRNGKey(0, device=valid.device)
        key = _FUND_KEYS[valid.device].expand(valid.shape[0], 2)
        inl, _cnt, _F = ransac_fundamental(
            cur.xs_l.to(f32), cur.ys_l.to(f32),
            prev.xs_l[seq, prev_idx].to(f32), prev.ys_l[seq, prev_idx].to(f32),
            valid, key, threshold=2.0, n_hyp=64)
        n_alive = torch.sum(valid.to(torch.int32), dim=-1, keepdim=True)
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
    out = TrackSolveOut(track_idx=m.idx, track_valid=valid, pose=res)
    if lanes:
        return out
    return TrackSolveOut(out.track_idx[0], out.track_valid[0],
                         PoseSolveResult(*(a[0] for a in out.pose)))


def to_host(tensors) -> list[np.ndarray]:
    """Copy several device tensors (int8/int32/int64-small/bool/f32) to the
    host in ONE transfer: all as 32-bit words in one buffer."""
    flat = [t.reshape(-1) for t in tensors]
    with cuda_graphs.span("eager", flat[0].device):
        words = torch.cat([f.view(torch.int32) if f.dtype == torch.float32
                           else f.to(torch.int32) for f in flat]).cpu().numpy()
    out, o = [], 0
    for t, f in zip(tensors, flat):
        w = words[o:o + f.numel()]
        o += f.numel()
        if t.dtype == torch.float32:
            a = w.view(np.float32)
        elif t.dtype == torch.bool:
            a = w.astype(bool)
        else:
            a = w.astype(np.int8 if t.dtype == torch.int8 else np.int32)
        out.append(a.reshape(tuple(t.shape)))
    return out


def track_batch(engines, curs) -> list:
    """Track each engine's frame ``curs[i]`` (its features at the engine's
    thresholds) against the engine's previous frame with ONE pose solve of
    ``len(engines)`` lanes, copy the outputs to the host once, and commit
    each frame through its engine's ``commit_frame``. The engines share
    camera, device and solve options (per-frame stepping passes one; a
    fleet's lockstep attempt solves its lanes in its own program and
    commits through :func:`commit_tracks`). Returns the VOResults."""
    return commit_tracks(engines, curs, to_host(solve_tracks(engines, curs)))


def solve_tracks(engines, curs) -> list[torch.Tensor]:
    """The device half of :func:`track_batch`: the one pose solve of
    ``len(engines)`` lanes, and the tensors that :func:`commit_tracks`
    reads (``to_host`` copies them out in one transfer)."""
    e0 = engines[0]
    init = np.stack([e.initial_increment() for e in engines]).astype(np.float32)
    orb = np.array([int(e.orb_th) for e in engines], np.float32)
    out = track_and_solve(
        stack_features([e._prev for e in engines]), stack_features(curs), e0.cam,
        *(torch.from_numpy(a).to(e0.device, non_blocking=True) for a in (init, orb)),
        **e0.solve_options())
    return [out.track_idx, out.track_valid, torch.stack([c.m_valid for c in curs]),
            out.pose.pose, out.pose.valid, out.pose.mean_residual, out.pose.iters]


def commit_tracks(engines, curs, host: list) -> list:
    """The host half of :func:`track_batch`: commit each frame from the
    host copies ``host`` of :func:`solve_tracks`' outputs (or of a fleet
    attempt's, ``parallel/fleet.py``, the same list)."""
    ti, tv, mv, pose, ok, res, iters = host
    return [e.commit_frame(cur, ti[i], tv[i], mv[i], pose[i].copy(), bool(ok[i]),
                           float(res[i]), int(iters[i]))
            for i, (e, cur) in enumerate(zip(engines, curs))]


def vo_scan(
    lefts,
    rights,
    prev: FrameFeatures,
    init_pose: torch.Tensor,
    cam: StereoCamera,
    fast_th,
    orb_th,
    k: int = 512,
    cell: int = 5,
    nms_radius: int = 2,
    margin: int = 16,
    max_y_diff: float = 2.0,
    min_disparity: float = 0.1,
    max_disparity: float = 1e9,
    oriented: bool = False,
    n_levels: int = 1,
    kernel_param: float = 2.0,
    residual_threshold: float = 15.0,
    min_mod: float = 1e-3,
    max_iters_initial: int = 30,
    max_iters: int = 30,
    min_inliers: int = 5,
    max_incr_cost: int = 3,
    robust_1to1: bool = False,
    filter_fund_matrix: bool = False,
    rect_maps=None,
    device="cuda",
):
    """VO of B frames ``lefts``/``rights`` [B, H, W] (numpy or tensors,
    uint8 or float32) on ``device``, chained from ``prev`` (the features of
    the frame before them) and ``init_pose`` [6] (the initial increment
    guess), at the FAST threshold ``fast_th`` (a float, or an f32 tensor on
    ``device``: one value or one per frame) and the ORB matching threshold
    ``orb_th`` (an int, or a one-value tensor on ``device``).

    Two phases, as the JAX package's ``vo_scan``: (1) the frontend of all
    2B images as one batch (remap, detect and describe with one K1 and one
    K2 launch, then each pair's stereo match and triangulation); (2)
    ``track_and_solve`` over the B frames in order, each against its
    predecessor's features and warm-started from the last valid increment.
    Each frame's math is that of per-frame stepping.

    On a CUDA device (``SCAN_GRAPHS``) the whole scan is one replay of a
    CUDA graph (``ops/cuda_graphs.py`` ``program``), captured at the first
    call of its :func:`scan_key` and of the inputs' shapes: the frames,
    ``prev``, ``init_pose``, ``rect_maps`` and the thresholds, as tensors,
    are its inputs, copied in at each call; its GN loops run to their caps
    as conditional nodes, with no host read; the outputs are fresh tensors.
    The same kernels as the eager scan, so the same bits.

    Returns ``(last_feat, last_inc, outs)`` in the JAX layout: the last
    frame's features, the last valid increment, and ``outs = (curs,
    track_idx [B, K], track_valid [B, K], poses [B, 6], pose_valid [B],
    num_inliers [B], mean_residual [B])``, ``curs`` the frames'
    FrameFeatures stacked along a leading B."""
    opts = dict(k=k, cell=cell, nms_radius=nms_radius, margin=margin, max_y_diff=max_y_diff,
                min_disparity=min_disparity, max_disparity=max_disparity, oriented=oriented,
                n_levels=n_levels, kernel_param=kernel_param,
                residual_threshold=residual_threshold, min_mod=min_mod,
                max_iters_initial=max_iters_initial, max_iters=max_iters,
                min_inliers=min_inliers, max_incr_cost=max_incr_cost, robust_1to1=robust_1to1,
                filter_fund_matrix=filter_fund_matrix)
    dev = torch.device(device)
    if not (SCAN_GRAPHS and dev.type == "cuda"):
        return _scan(lefts, rights, prev, init_pose, cam, fast_th, orb_th, rect_maps, dev, **opts)
    lefts, rights = _frames_on(lefts, dev), _frames_on(rights, dev)
    inputs = dict(lefts=lefts, rights=rights, prev=prev, rect_maps=rect_maps,
                  init_pose=torch.as_tensor(init_pose, dtype=torch.float32, device=dev),
                  fast_th=_threshold_on(fast_th, (lefts.shape[0],), dev),
                  orb_th=_threshold_on(orb_th, (), dev))
    return cuda_graphs.program(
        lambda x: _scan(cam=cam, device=dev, **x, **opts), inputs,
        scan_key(lefts, cam, rect_maps, **opts), counted=(fast_nms, orb_descriptors, fast_score_map))


def scan_key(lefts: torch.Tensor, cam: StereoCamera, rect_maps, **opts) -> tuple:
    """The key of :func:`vo_scan`'s CUDA graph: everything the scan bakes
    into its kernels. The frames' batch, height, width and dtype, whether
    ``rect_maps`` is given, the camera, every frontend and solve option of
    ``vo_scan`` (``opts``), and the GN solve's block length and route
    (``robust_lm.GN_EXIT_EVERY``, ``GN_GRAPHS``). A key's first call
    captures a graph, as a new shape compiles a new program in JAX."""
    b, h, w = lefts.shape
    return ("vo_scan", b, h, w, lefts.dtype, rect_maps is not None, cam,
            tuple(sorted(opts.items())), robust_lm.GN_EXIT_EVERY, robust_lm.GN_GRAPHS)


def attempt_key(lefts: torch.Tensor, n: int, cam: StereoCamera, rect_maps, **opts) -> tuple:
    """The key of a fleet shard's lockstep-attempt program
    (``parallel/fleet.py``): the number ``n`` of the shard's sequences that
    the attempt runs, then what :func:`scan_key` holds for the shard's
    frames ``lefts`` [S', H, W] (their count, size and dtype, whether
    ``rect_maps`` is given, the camera, the frontend and solve options
    ``opts``, the GN solve's block length and route). The maps themselves
    are held by the program, so their address joins the key there."""
    return ("fleet_attempt", n) + scan_key(lefts, cam, rect_maps, **opts)[1:]


def _threshold_on(th, shape: tuple, device) -> torch.Tensor:
    """A threshold as an f32 tensor of ``shape`` on ``device``: a graph's
    input, where a Python number would be baked into the graph."""
    if not isinstance(th, torch.Tensor):
        return torch.full(shape, float(th), dtype=torch.float32, device=device)
    th = th.to(device=device, dtype=torch.float32)
    return th.reshape(()).expand(shape) if th.numel() == 1 else th


def _scan(lefts, rights, prev, init_pose, cam, fast_th, orb_th, rect_maps, device, k, cell,
          nms_radius, margin, max_y_diff, min_disparity, max_disparity, oriented, n_levels,
          robust_1to1, **solve):
    """The eager scan of :func:`vo_scan`: the frontend of the batch, then
    the B solves in order, with no host read."""
    curs = extract_and_match_batch(
        lefts, rights, cam, fast_th, orb_th, k=k, cell=cell, nms_radius=nms_radius,
        margin=margin, max_y_diff=max_y_diff, min_disparity=min_disparity,
        max_disparity=max_disparity, oriented=oriented, n_levels=n_levels,
        robust_1to1=robust_1to1, rect_maps=rect_maps, device=device)
    prev_feat, last_inc = prev, init_pose
    outs = []
    for cur in curs:
        out = track_and_solve(prev_feat, cur, cam, last_inc, orb_th, **solve)
        last_inc = torch.where(out.pose.valid, out.pose.pose, last_inc)
        outs.append(out)
        prev_feat = cur
    souts = tuple(torch.stack(parts) for parts in zip(*(
        (o.track_idx, o.track_valid, o.pose.pose, o.pose.valid, o.pose.num_inliers,
         o.pose.mean_residual) for o in outs)))
    return prev_feat, last_inc, (stack_features(curs),) + souts


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
    def frontend_options(self) -> dict:
        """The engine's frontend options, as keyword arguments of
        :func:`extract_and_match`, :func:`extract_and_match_batch` and
        :func:`vo_scan`."""
        o = self.opts
        return dict(k=self.capacity, cell=o.min_distance, max_y_diff=o.max_y_diff,
                    oriented=o.orb_oriented, n_levels=o.n_octaves,
                    robust_1to1=o.enable_robust_1to1_match, rect_maps=self.rect_maps,
                    device=self.device)

    def solve_options(self) -> dict:
        """The engine's tracking and pose-solve options, as keyword
        arguments of :func:`track_and_solve` and :func:`vo_scan`."""
        o = self.opts
        return dict(kernel_param=o.kernel_param, residual_threshold=o.residual_threshold,
                    min_mod=o.min_mod_out_vector, max_iters_initial=o.initial_max_iters,
                    max_iters=o.max_iters, min_inliers=o.bad_tracking_th,
                    max_incr_cost=o.max_incr_cost, filter_fund_matrix=o.filter_fund_matrix)

    def thresholds(self) -> tuple[float, int]:
        """The frontend's FAST and ORB thresholds now: FAST rounded to f32,
        as the JAX package passes it."""
        return float(np.float32(self.fast_th)), int(self.orb_th)

    def process_stereo_pair(self, left, right) -> VOResult:
        fast_th, orb_th = self.thresholds()
        return self.track(extract_and_match(left, right, self.cam, fast_th, orb_th,
                                            **self.frontend_options()))

    def initial_increment(self) -> np.ndarray:
        """The pose solve's starting increment for the next frame: the last
        valid one under ``use_previous_pose_as_initial``, else zero."""
        if self.opts.use_previous_pose_as_initial:
            return self._last_pose_inc
        return np.zeros(6, np.float32)

    def track(self, cur: FrameFeatures) -> VOResult:
        """The rest of a VO pass after the frontend: track ``cur`` (the
        frame's features at the engine's thresholds) against the previous
        frame, solve the increment, and commit the frame
        (:func:`track_batch` of this engine alone). The first frame only
        mints its IDs."""
        if self._prev is None:
            m_valid_h = cur.m_valid.cpu().numpy()
            n_matches = int(m_valid_h.sum())
            self._cur = cur
            self._cur_ids = self._mint_ids(
                np.full(self.capacity, -1, np.int64), m_valid_h
            )
            self._advance()
            return VOResult(True, np.zeros(6, np.float32), n_matches, 0, 0, 0.0, 0)
        return track_batch([self], [cur])[0]

    def commit_frame(self, cur: FrameFeatures, track_idx: np.ndarray, track_valid: np.ndarray,
                     m_valid_h: np.ndarray, pose_inc: np.ndarray, pose_ok: bool,
                     mean_res: float, iters: int) -> VOResult:
        """The host half of one tracked frame, on the host copies of its
        tracking outputs: ID propagation, fresh IDs, the tracked counts, and
        the hand-over of ``cur`` as the previous frame. The one copy of this
        walk: per-frame stepping, the batched scan's walk and the fleet's
        lockstep step all come here."""
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
