"""Inter-keyframe data association: the 4-filter cascade (plain torch).

Counterpart of ``srba_slam_tpu/models/data_association.py`` (≙
``m_data_association`` / ``m_internal_data_association``, reference
src/CSRBAStereoSLAMEstimator.cpp:1341-1411, 1413-1727). Against each
candidate keyframe:

1. brute-force Hamming matching of left descriptors (≙ cv::BFMatcher);
2. filter 1 (optional): direction histogram, 36 x 10° bins of the
   stacked-image match slope, mode bin ±1 kept (.cpp:1883-1946);
3. filter 2: ORB distance <= max_orb_distance_da with 1-to-1 uniqueness,
   best distance wins (.cpp:1951-2010);
4. filter 3: fundamental-matrix RANSAC over the left pixels, applied only
   when >= 15 matches remain (.cpp:2015-2055);
5. filter 4: change in pose, a robust GN solve of the candidate-KF ->
   current pose from the candidate's 3D points, then a depth-consistency
   gate (.cpp:2113-2177).

The S = 5 candidates run as one batch, lanes of every stage (the JAX
package vmaps them), and a fleet's checks add a sequence dimension in front
(lanes = (sequence, candidate)); every reduction stays inside its lane.
Each candidate draws its RANSAC hypotheses from its own ``ops/prng.py``
key, split from the check's key as JAX splits it, so the draws are JAX's.
On a card the Horn seed's rotation comes from Jacobi sweeps, not the
library SVD (which reads the host there), and the GN solves test their
exits on the device (``ops/cuda_graphs.py``), so a check reads nothing on
the host there; on the CPU it reads the GN exit tests, except inside
``cuda_graphs.no_exit_reads``. Statuses use the reference's enum values.

A check's outputs travel as one int32 blob (``pack_check_outputs``; the
floats bitcast), unpacked on the host (``unpack_check_outputs``). The
batched loop's deferred checks run as ``fused_checks_batch``: up to
``CHECK_SLOTS`` checks of one scanned batch, each writing its frame's
keyframe-store and BoW rows at its speculative row (inert until the
estimator commits it) and checking against the rows before it, so a slot
sees the rows of the slots before it (≙ the JAX package's ``lax.scan``
over slots); nothing is read on the host. On a card (``CHECK_GRAPHS``) a
check is one CUDA-graph replay (``ops/cuda_graphs.py`` ``program``, one
per ``check_key``): a fused group's slot program, one launch a valid slot,
and the synchronous check's one-check program, their rows, counts and
seeds device inputs (one pinned upload a group, ``slot_table``), the
keyframe store and the BoW database held and written in place, their
Horn and GN loops conditional nodes inside the graph.
"""

from __future__ import annotations

import inspect
from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.models.bow import bow_vector, rank_scores
from srba_slam_tpu_torch.models.keyframe import _ROW_FIELDS, KFArrays
from srba_slam_tpu_torch.models.vo import FrameFeatures
from srba_slam_tpu_torch.ops import cuda_graphs, prng, robust_lm
from srba_slam_tpu_torch.ops.hamming import hamming_matrix
from srba_slam_tpu_torch.ops.ransac import ransac_fundamental
from srba_slam_tpu_torch.ops.robust_lm import lanewise, solve_pose
from srba_slam_tpu_torch.utils import se3
from srba_slam_tpu_torch.utils.camera import StereoCamera

# ≙ the status enum at reference src/CSRBAStereoSLAMEstimator.h:102
S_TRACKED = 0
S_NON_TRACKED = 1
S_REJ_SLOPE = 2
S_REJ_ORB = 3
S_REJ_FUND_MATRIX = 4
S_REJ_CHANGE_POSE = 5
S_REJ_CONSISTENCY = 6

_BIG = 1e9  # exact in f32

# Iteration caps of the filter-4 change-in-pose GN solve, as in the JAX
# package: the Horn seed starts it near the basin, so 12/12 reaches the
# same inlier classification as the VO engine's 30/30.
DA_SOLVE_ITERS_STAGE1 = 12
DA_SOLVE_ITERS_STAGE2 = 12


class DAResult(NamedTuple):
    """Per-candidate-KF association results (S candidates, K features)."""

    status: torch.Tensor         # int8 [S, K] per current-KF feature
    other_idx: torch.Tensor      # int32 [S, K] matched feature in candidate KF
    tracked_count: torch.Tensor  # int32 [S]
    pose: torch.Tensor           # f32 [S, 6] candidate-KF -> current-KF transform
    pose_valid: torch.Tensor     # bool [S]
    mean_residual: torch.Tensor  # f32 [S]
    raw_oidx: torch.Tensor       # int32 [S, K] pre-filter Hamming argmin
    distance: torch.Tensor       # f32 [S, K] raw match distance (_BIG if none)
    residuals: torch.Tensor      # f32 [S, K] filter-4 residuals


_JACOBI_SWEEPS = 8   # cyclic Jacobi sweeps of Horn's 4x4 matrix (f64: converged by 5)
_JACOBI_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _jacobi_sweep(c: dict, k: dict) -> dict:
    """One cyclic Jacobi sweep on the symmetric 4x4 matrices ``c["A"]``
    [L, 4, 4], the rotations accumulated in ``c["V"]``
    (``A = V diag V^T`` at convergence)."""
    A, V = c["A"], c["V"]
    for p, q in _JACOBI_PAIRS:
        apq, app, aqq = A[:, p, q], A[:, p, p], A[:, q, q]
        zero = apq == 0
        tau = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
        t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(zero, 0.0, t)
        cs = 1.0 / torch.sqrt(1.0 + t * t)
        sn = t * cs
        G = (k["eye"] + (cs - 1.0)[:, None, None] * k["e_pp_qq"][(p, q)]
             + sn[:, None, None] * k["e_pq"][(p, q)])
        A = G.transpose(1, 2) @ A @ G
        V = V @ G
    return dict(A=A, V=V)


def _horn_rotation(H: torch.Tensor) -> torch.Tensor:
    """The rotation R [L, 3, 3] maximizing sum b^T R a for the cross-
    covariances ``H`` [L, 3, 3] = sum a b^T (Horn's unit quaternion: the
    eigenvector of the largest eigenvalue of his symmetric 4x4 matrix), in
    float64. The same rotation as the SVD Kabsch with its reflection guard
    (the JAX package's), with no library call that reads the host: the
    eigenvectors come from a fixed number of Jacobi sweeps, one CUDA graph
    a sweep on a card."""
    f64 = torch.float64
    S = H.to(f64)
    sxx, sxy, sxz = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    syx, syy, syz = S[:, 1, 0], S[:, 1, 1], S[:, 1, 2]
    szx, szy, szz = S[:, 2, 0], S[:, 2, 1], S[:, 2, 2]
    N = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)
    dev = H.device
    eye = torch.eye(4, dtype=f64, device=dev)
    e_pp_qq, e_pq = {}, {}
    for p, q in _JACOBI_PAIRS:
        e_pp_qq[(p, q)] = eye[p][:, None] * eye[p][None, :] + eye[q][:, None] * eye[q][None, :]
        e_pq[(p, q)] = eye[p][:, None] * eye[q][None, :] - eye[q][:, None] * eye[p][None, :]
    k = dict(eye=eye, e_pp_qq=[e_pp_qq[pq] for pq in _JACOBI_PAIRS],
             e_pq=[e_pq[pq] for pq in _JACOBI_PAIRS])

    def sweep(c_, k_):
        return _jacobi_sweep(c_, dict(eye=k_["eye"],
                                      e_pp_qq=dict(zip(_JACOBI_PAIRS, k_["e_pp_qq"])),
                                      e_pq=dict(zip(_JACOBI_PAIRS, k_["e_pq"]))))

    c = cuda_graphs.loop(sweep, dict(A=N, V=eye.expand_as(N).clone()), k, _JACOBI_SWEEPS,
                         ("jacobi4",), True)
    top = torch.argmax(torch.diagonal(c["A"], dim1=-2, dim2=-1), dim=-1)
    qv = torch.gather(c["V"], 2, top[:, None, None].expand(-1, 4, 1))[..., 0]
    w, x, y, z = qv.unbind(-1)
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return R.to(H.dtype)


def _kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """The rotation of :func:`_horn_rotation` by the JAX package's SVD
    Kabsch with its reflection guard (one batched SVD)."""
    U, _S, Vt = torch.linalg.svd(H)
    d = torch.linalg.det(lanewise(lambda u, vt: vt.T @ u.T, U, Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1))
    return lanewise(lambda u, dd, vt: vt.T @ dd @ u.T, U, D, Vt)


def _horn_seed(p_oth: torch.Tensor, p_cur: torch.Tensor, w0: torch.Tensor,
               fallback: torch.Tensor, min_pts: int = 8) -> torch.Tensor:
    """Robust 3D-3D alignment seed for the change-in-pose solve, per lane
    of ``[L, K, 3]``: the best rotation R p_oth + t ≈ p_cur over the masked
    correspondences, one median-residual trim pass; ``fallback`` [L, 6]
    where the geometry is too thin. The matrix products run per lane
    (``lanewise``). The rotation: on the CPU the JAX package's SVD Kabsch
    (:func:`_kabsch_rotation`); on a card, where the library SVD reads the
    host, Horn's quaternion (:func:`_horn_rotation`), the same rotation to
    float rounding, so nothing is read there."""
    finite = torch.isfinite(p_oth).all(-1) & torch.isfinite(p_cur).all(-1)
    no = torch.linalg.vector_norm(p_oth, dim=-1)
    nc = torch.linalg.vector_norm(p_cur, dim=-1)
    near = (no > 1e-6) & (nc > 1e-6) & (no < 1e4) & (nc < 1e4)
    base = w0 & finite & near
    eye = torch.eye(3, dtype=torch.float32, device=p_oth.device)

    def fit(w):
        wf = w.to(torch.float32)[..., None]
        n = torch.sum(wf, dim=-2)                              # [L, 1]
        nz = torch.clamp(n, min=1.0)
        co = torch.sum(p_oth * wf, dim=-2) / nz
        cp = torch.sum(p_cur * wf, dim=-2) / nz
        H = lanewise(lambda a, b: a.T @ b, (p_oth - co[:, None]) * wf, p_cur - cp[:, None])
        # JAX's SVD returns NaNs on non-finite input, which end in the
        # fallback below. Keep that outcome.
        bad = ~torch.isfinite(H).all(-1).all(-1)[:, None, None]
        rot = _kabsch_rotation if H.device.type == "cpu" else _horn_rotation
        R = torch.where(bad, float("nan"), rot(torch.where(bad, eye, H)))
        t = cp - lanewise(torch.mv, R, co)
        return R, t, n[:, 0]

    R, t, n = fit(base)
    res = torch.linalg.vector_norm(lanewise(lambda p, r: p @ r.T, p_oth, R) + t[:, None] - p_cur,
                                   dim=-1)
    res_sorted = torch.sort(torch.where(base, res, float("inf")), dim=-1).values
    mid = torch.clamp(torch.div(n.to(torch.int64) - 1, 2, rounding_mode="floor"),
                      0, res.shape[-1] - 1)
    med = torch.gather(res_sorted, -1, mid[:, None])
    keep2 = base & (res <= torch.clamp(3.0 * med, min=0.5))
    R, t, n2 = fit(keep2)
    pose = se3.log(R, t)
    ok = (n2 >= min_pts) & torch.isfinite(pose).all(-1)
    return torch.where(ok[:, None], pose, fallback)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [L, K] of each lane of ``a`` [L, M, ...]."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def _direction_filter(keep, cur_y, cur_x, oth_y, oth_x, oidx, img_h: float):
    """Mode-bin direction histogram (36 bins of 10 degrees), mode ±1 kept,
    with the reference's binning of the slope across vertically stacked
    images (reference .cpp:1883-1946, offset = image height at :1486), per
    lane of ``[L, K]``. The histogram is a one-hot count, never a
    scatter-add."""
    f32 = torch.float32
    dy = _take(oth_y, oidx).to(f32) + img_h - cur_y.to(f32)
    dx = _take(oth_x, oidx).to(f32) - cur_x.to(f32)
    ang = torch.rad2deg(torch.atan(dy / torch.where(dx == 0, 1e-9, dx))) + 180.0
    bins = torch.clamp((ang / 10.0).to(torch.int32), 0, 35)
    onehot = bins[..., None] == torch.arange(36, dtype=torch.int32, device=bins.device)
    hist = torch.sum(onehot & keep[..., None], dim=-2)
    # first mode on ties, as jnp.argmax
    mode = torch.argmax(hist, dim=-1, keepdim=True).to(torch.int32)
    diff = torch.abs(bins - mode)
    diff = torch.minimum(diff, 36 - diff)
    return diff <= 1


def _da_single(cur: FrameFeatures, oth_row, oth_valid_kf, init_pose, cam: StereoCamera,
               key, max_orb_distance_da: float, residual_th: float,
               max_y_diff_epipolar: float, filter_by_direction: bool,
               use_fund_matrix: bool, use_change_pose: bool, kernel_param: float,
               filter_by_orb_distance: bool = True, ransac_n_hyp: int = 128,
               min_alive: int = 15, seed_from_init: bool = False,
               init_gate_budget_m: float = 0.0):
    """The cascade of ``cur`` against one candidate keyframe row, per lane:
    every argument leads with the lane dimension L (``cur``'s fields and
    ``oth_row``'s arrays [L, K, ...], ``oth_valid_kf`` [L], ``init_pose``
    [L, 6], ``key`` [L, 2]); lane j is JAX's ``_da_single`` on lane j's
    inputs."""
    (oy_l, ox_l, _oval_l, odesc_l, _oy_r, _oxr, _ovr, _odesc_r, _om_ridx,
     om_valid, opts3d, ooct) = oth_row
    f32, i8 = torch.float32, torch.int8
    n_lanes, k = cur.desc_l.shape[:2]
    dev = cur.desc_l.device

    dist = hamming_matrix(cur.desc_l, odesc_l)
    gate = (cur.m_valid[:, :, None] & om_valid[:, None, :] & oth_valid_kf[:, None, None]
            & (cur.octave[:, :, None] == ooct[:, None, :]))
    d = torch.where(gate, dist, _BIG)
    oidx = torch.argmin(d, dim=-1)  # first index on ties, as jnp.argmin
    bd = torch.amin(d, dim=-1)
    raw = bd < _BIG
    status = torch.where(raw, S_TRACKED, S_NON_TRACKED).to(i8)
    keep = raw

    # filter 1: direction histogram
    if filter_by_direction:
        ok = _direction_filter(keep, cur.ys_l, cur.xs_l, oy_l, ox_l, oidx, float(cam.height))
        status = torch.where(keep & ~ok, S_REJ_SLOPE, status).to(i8)
        keep = keep & ok

    # filter 2: ORB distance + 1-to-1 uniqueness (best wins), both under
    # da_filter_by_orb_distance as in the reference (.cpp:1500)
    if filter_by_orb_distance:
        ok = bd <= max_orb_distance_da
        status = torch.where(keep & ~ok, S_REJ_ORB, status).to(i8)
        keep = keep & ok
        rows = torch.arange(k, dtype=f32, device=dev)
        lex = torch.where(keep, bd * k + rows, _BIG)
        claimed = torch.arange(k, device=dev) == oidx[..., None]
        col_best = torch.amin(torch.where(claimed, lex[..., None], _BIG), dim=-2)
        ok = lex == torch.gather(col_best, -1, oidx)
        status = torch.where(keep & ~ok, S_REJ_CONSISTENCY, status).to(i8)
        keep = keep & ok

    # filter 3: fundamental-matrix RANSAC on left pixel pairs
    if use_fund_matrix:
        n_alive = torch.sum(keep.to(torch.int32), dim=-1, keepdim=True)
        inl, _cnt, _F = ransac_fundamental(
            cur.xs_l.to(f32), cur.ys_l.to(f32), _take(ox_l, oidx).to(f32),
            _take(oy_l, oidx).to(f32), keep, key, threshold=max_y_diff_epipolar,
            n_hyp=ransac_n_hyp)
        ok = torch.where(n_alive >= min_alive, inl, keep)
        status = torch.where(keep & ~ok, S_REJ_FUND_MATRIX, status).to(i8)
        keep = keep & ok

    # filter 4: change-in-pose residual gating (≙ getChangeInPose)
    pose = torch.zeros((n_lanes, 6), dtype=f32, device=dev)
    pose_ok = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    mean_res = torch.zeros(n_lanes, dtype=f32, device=dev)
    residuals = torch.zeros((n_lanes, k), dtype=f32, device=dev)
    if use_change_pose:
        ur = _take(cur.xs_r, cur.m_r_idx.long()).to(f32)
        obs = torch.stack([cur.xs_l.to(f32), cur.ys_l.to(f32), ur], dim=-1)
        p_oth = _take(opts3d, oidx)
        if seed_from_init:
            # loop-closure recovery: the odometry prior seeds the solve, and
            # matches whose residual AT the prior exceeds what the drift
            # budget allows are dropped first (depth-adaptive: a budget_m
            # offset at depth z subtends ~budget*fx/z pixels)
            seed = init_pose
            p_pred = se3.transform_points(init_pose, p_oth)
            zq = torch.clamp(p_pred[..., 2], min=1.0)
            ulp = cam.cx_l + cam.fx_l * p_pred[..., 0] / zq
            vlp = cam.cy_l + cam.fy_l * p_pred[..., 1] / zq
            urp = cam.cx_r + cam.fx_r * (p_pred[..., 0] - cam.baseline) / zq
            e_px = torch.maximum(torch.abs(ulp - cur.xs_l.to(f32)),
                                 torch.maximum(torch.abs(vlp - cur.ys_l.to(f32)),
                                               torch.abs(urp - ur)))
            budget = torch.full((), init_gate_budget_m, dtype=f32, device=dev)
            allow = budget * cam.fx_l / zq + residual_th
            okg = (budget <= 0.0) | (e_px <= allow)
            status = torch.where(keep & ~okg, S_REJ_CHANGE_POSE, status).to(i8)
            keep = keep & okg
        else:
            seed = _horn_seed(p_oth, cur.pts3d, keep, init_pose)
        sol = solve_pose(p_oth, obs, keep, cam, initial_pose=seed,
                         kernel_param=kernel_param, residual_threshold=residual_th,
                         min_inliers=min_alive, max_iters_initial=DA_SOLVE_ITERS_STAGE1,
                         max_iters=DA_SOLVE_ITERS_STAGE2)
        pose, pose_ok, mean_res = sol.pose, sol.valid, sol.mean_residual
        residuals = sol.residuals
        ok = sol.inliers & pose_ok[:, None]
        # depth-consistency gate: predicted vs triangulated depth within a
        # stereo-noise-proportional tolerance (sigma_z ~ z^2 * 2 px / (fx b),
        # 4 sigma + 0.5 m floor)
        p_pred = se3.transform_points(pose, p_oth)
        z = torch.clamp(cur.pts3d[..., 2], min=0.5)
        depth_sig = z * z * 2.0 / (cam.fx_l * cam.baseline)
        ok3d = torch.abs(p_pred[..., 2] - cur.pts3d[..., 2]) <= 4.0 * depth_sig + 0.5
        ok = ok & ok3d
        status = torch.where(keep & ~ok, S_REJ_CHANGE_POSE, status).to(i8)
        keep = keep & ok

    tracked = torch.sum(keep.to(torch.int32), dim=-1)
    status = torch.where(keep, S_TRACKED, status).to(i8)
    oidx32 = oidx.to(torch.int32)
    return (status, torch.where(keep, oidx32, 0), tracked, pose, pose_ok, mean_res,
            oidx32, bd, residuals)


def _tree(fn, x):
    """``fn`` on a tensor, or on each tensor of (nested, named) tuples."""
    if isinstance(x, tuple):
        parts = [_tree(fn, a) for a in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return fn(x)


def _leading(x, seqs: bool):
    """``x`` (a tensor, or a tuple of them) with a sequence dimension of 1
    in front where the call has none."""
    return x if seqs else _tree(lambda a: a[None], x)


def _drop_leading(x, seqs: bool):
    return x if seqs else _tree(lambda a: a[0], x)


def da_cascade(cur: FrameFeatures, store_arrays: KFArrays, similar_idx: torch.Tensor,
               others_valid: torch.Tensor, cam: StereoCamera, key: torch.Tensor,
               init_poses: torch.Tensor | None = None, max_orb_distance_da: float = 60.0,
               residual_th: float = 30.0, max_y_diff_epipolar: float = 2.0,
               filter_by_direction: bool = True, filter_by_orb_distance: bool = True,
               use_fund_matrix: bool = True, use_change_pose: bool = True,
               kernel_param: float = 2.0, ransac_n_hyp: int = 128) -> DAResult:
    """The full cascade of the current KF against S candidate KFs
    (``similar_idx`` int [S] rows of the store, ``others_valid`` bool [S]),
    the S candidates as lanes of one batch.

    With a leading sequence dimension Q on every argument (``cur``'s fields
    [Q, K, ...], ``store_arrays`` [Q, M, K, ...], ``similar_idx`` and
    ``others_valid`` [Q, S], ``key`` [Q, 2], ``init_poses`` [Q, S, 6]) the
    Q cascades run as one batch of Q × S lanes, and every field of the
    result leads with Q."""
    seqs = similar_idx.dim() == 2
    cur, store_arrays, similar_idx, others_valid, key = (
        _leading(x, seqs) for x in (cur, tuple(store_arrays), similar_idx, others_valid, key))
    q, s = similar_idx.shape
    dev = similar_idx.device
    if init_poses is None:
        init_poses = torch.zeros((q, s, 6), dtype=torch.float32, device=dev)
    else:
        init_poses = _leading(init_poses, seqs)
    seq = torch.arange(q, device=dev)[:, None]
    idx = similar_idx.long()
    others = tuple(a[seq, idx].flatten(0, 1) for a in store_arrays)
    cur_lanes = FrameFeatures(*(a[:, None].expand(q, s, *a.shape[1:]).flatten(0, 1)
                                for a in cur))
    keys = prng.split(key, s).flatten(0, 1)
    lanes = _da_single(cur_lanes, others, others_valid.flatten(), init_poses.flatten(0, 1),
                       cam, keys, max_orb_distance_da, residual_th, max_y_diff_epipolar,
                       filter_by_direction, use_fund_matrix, use_change_pose, kernel_param,
                       filter_by_orb_distance=filter_by_orb_distance,
                       ransac_n_hyp=ransac_n_hyp)
    (status, oidx, tracked, pose, pose_ok, mean_res, raw_oidx, bd,
     residuals) = (a.unflatten(0, (q, s)) for a in lanes)
    tracked = torch.where(others_valid, tracked, 0)
    return _drop_leading(DAResult(status, oidx, tracked, pose, pose_ok & others_valid,
                                  mean_res, raw_oidx, bd, residuals), seqs)


def _counts(n_kfs, q: int, device) -> torch.Tensor:
    """Stored-keyframe counts as an int32 [Q] tensor on ``device`` without
    a blocking copy: from an int, a list of Q ints (the fleet's), or an
    integer tensor on ``device``, one count or Q (a captured check's input:
    an int would be baked into the graph)."""
    if isinstance(n_kfs, torch.Tensor):
        n = n_kfs.to(device=device, dtype=torch.int32)
        return n.reshape(()).expand(q) if n.numel() == 1 else n
    if isinstance(n_kfs, int):
        return torch.full((q,), n_kfs, dtype=torch.int32, device=device)
    return torch.tensor(list(n_kfs), dtype=torch.int32).to(device, non_blocking=True)


def bow_candidates(cur: FrameFeatures, db: torch.Tensor, leaf_bits: torch.Tensor,
                   weights: torch.Tensor, n_kfs, n_query: int = 4):
    """The BoW query of a check, Q sequences at once (``cur``'s fields [Q,
    K, ...], ``db`` [Q, M, W], ``n_kfs`` Q counts): quantize, score the
    ``n_kfs`` stored rows, rank. Returns (scores [Q, n_query], ids [Q,
    n_query], candidates [Q, 1 + n_query] = the previous KF and the ids,
    their validity [Q, 1 + n_query])."""
    q, m = db.shape[:2]
    dev = db.device
    v = bow_vector(cur.desc_l, cur.m_valid, leaf_bits, weights)
    scores_all = torch.sum(torch.minimum(db, v[:, None, :]), dim=-1)
    n = _counts(n_kfs, q, dev)
    rows = torch.arange(m, device=dev)
    scores_all = torch.where(rows < n[:, None], scores_all, -1.0)
    top_s, top_i = rank_scores(scores_all, n_query)

    prev_kf = (n - 1)[:, None]
    cand = torch.cat([prev_kf, top_i], dim=-1)
    cand_valid = torch.cat([torch.ones((q, 1), dtype=torch.bool, device=dev),
                            (top_s > 0) & (top_i != prev_kf)], dim=-1)
    return top_s, top_i, torch.clamp(cand, 0, m - 1), cand_valid


def query_and_associate(cur: FrameFeatures, store_arrays: KFArrays, db: torch.Tensor,
                        leaf_bits: torch.Tensor, weights: torch.Tensor, n_kfs,
                        cam: StereoCamera, key: torch.Tensor,
                        init_poses: torch.Tensor | None = None, n_query: int = 4,
                        max_orb_distance_da: float = 60.0, residual_th: float = 30.0,
                        max_y_diff_epipolar: float = 2.0, filter_by_direction: bool = True,
                        filter_by_orb_distance: bool = True, use_fund_matrix: bool = True,
                        use_change_pose: bool = True, kernel_param: float = 2.0,
                        ransac_n_hyp: int = 128):
    """The whole keyframe check: BoW query (quantize, score, rank), then
    the DA cascade against {previous KF} ∪ the top ``n_query`` BoW results
    (``n_kfs`` stored KFs, an int or a device scalar; the new one is not in
    yet). ``init_poses[i]`` seeds the change-in-pose solve against KF i
    (zeros when omitted).

    Several sequences' checks run as one batch (≙ the JAX fleet's vmapped
    ``query_and_associate``) when every argument leads with a sequence
    dimension Q: ``cur``'s fields [Q, K, ...], ``store_arrays`` [Q, M, K,
    ...], ``db`` [Q, M, W], ``n_kfs`` a list of Q counts,
    ``key`` [Q, 2], ``init_poses`` [Q, M, 6]; the vocabulary is shared.

    Returns (scores [n_query], ids [n_query], cand [1+n_query], DAResult),
    each leading with Q in the batched form."""
    seqs = db.dim() == 3
    cur, store_arrays, db, key = (_leading(x, seqs)
                                  for x in (cur, tuple(store_arrays), db, key))
    top_s, top_i, cand, cand_valid = bow_candidates(cur, db, leaf_bits, weights, n_kfs,
                                                    n_query)
    init_cand = None
    if init_poses is not None:
        init_poses = _leading(init_poses, seqs)
        init_cand = init_poses[torch.arange(db.shape[0], device=db.device)[:, None],
                               cand.long()]
    da = da_cascade(cur, store_arrays, cand, cand_valid, cam, key, init_poses=init_cand,
                    max_orb_distance_da=max_orb_distance_da, residual_th=residual_th,
                    max_y_diff_epipolar=max_y_diff_epipolar,
                    filter_by_direction=filter_by_direction,
                    filter_by_orb_distance=filter_by_orb_distance,
                    use_fund_matrix=use_fund_matrix, use_change_pose=use_change_pose,
                    kernel_param=kernel_param, ransac_n_hyp=ransac_n_hyp)
    return _drop_leading((top_s, top_i, cand, da), seqs)


def pack_check_outputs(top_s, top_i, da: DAResult, frame: FrameFeatures,
                       debug: bool = False) -> tuple:
    """A check's outputs as ONE int32 blob on the device (≙ the JAX
    package's): the BoW ids, the cascade's statuses, matched indices and
    tracked counts, the frame's stereo matches, then the floats (scores,
    the frame's points) bitcast to int32. ``debug=True`` adds the cascade's
    raw match indices, distances (integral) and filter-4 residuals, the
    inputs of the reference's debug match files. Host side:
    :func:`unpack_check_outputs`."""
    i32 = torch.int32
    ints = [top_i.to(i32), da.status.to(i32).reshape(-1), da.other_idx.to(i32).reshape(-1),
            da.tracked_count.to(i32), frame.m_valid.to(i32), frame.xs_l.to(i32),
            frame.ys_l.to(i32), frame.xs_r.to(i32), frame.m_r_idx.to(i32)]
    floats = [top_s.to(torch.float32), frame.pts3d.reshape(-1)]
    if debug:
        ints += [da.raw_oidx.to(i32).reshape(-1), da.distance.to(i32).reshape(-1)]
        floats += [da.residuals.reshape(-1)]
    return (torch.cat(ints + [torch.cat(floats).view(i32)]),)


def _blob_len(s: int, k: int, nq: int, debug: bool) -> int:
    """The length of a :func:`pack_check_outputs` blob."""
    return 2 * nq + 2 * s * k + s + 8 * k + (3 * s * k if debug else 0)


def unpack_check_outputs(blob: np.ndarray, s: int, k: int, nq: int,
                         debug: bool = False) -> tuple:
    """Inverse of :func:`pack_check_outputs` on the host copy: (scores,
    ids, status, other_idx, tracked, m_valid, xs_l, ys_l, xs_r, m_r_idx,
    pts3d), with ``debug=True`` a 12th element, the dict {raw_oidx,
    distance, residuals}."""
    o = 0
    top_i = blob[o:o + nq]; o += nq
    status = blob[o:o + s * k].reshape(s, k).astype(np.int8); o += s * k
    other_idx = blob[o:o + s * k].reshape(s, k); o += s * k
    tracked = blob[o:o + s]; o += s
    m_valid = blob[o:o + k].astype(bool); o += k
    xs_l = blob[o:o + k]; o += k
    ys_l = blob[o:o + k]; o += k
    xs_r = blob[o:o + k]; o += k
    m_r_idx = blob[o:o + k]; o += k
    if debug:
        raw_oidx = blob[o:o + s * k].reshape(s, k); o += s * k
        distance = blob[o:o + s * k].reshape(s, k).astype(np.float32); o += s * k
    floats = np.ascontiguousarray(blob[o:]).view(np.float32)
    top_s = floats[:nq]
    pts3d = floats[nq:nq + 3 * k].reshape(k, 3)
    out = (top_s, top_i, status, other_idx, tracked, m_valid, xs_l, ys_l, xs_r, m_r_idx,
           pts3d)
    if debug:
        residuals = floats[nq + 3 * k:nq + 3 * k + s * k].reshape(s, k)
        out = out + (dict(raw_oidx=raw_oidx, distance=distance, residuals=residuals),)
    return out


# On a CUDA device, a keyframe check is one replay of a CUDA graph per
# check_key (the slot program of fused_checks_batch, the one-check program
# of query_and_associate_packed); eager launches otherwise (the CPU path,
# and the card's reference in the tests)
CHECK_GRAPHS = True
# the check's options, by name, as query_and_associate takes them
_CHECK_OPTS = ("max_orb_distance_da", "residual_th", "max_y_diff_epipolar",
               "filter_by_direction", "filter_by_orb_distance", "use_fund_matrix",
               "use_change_pose", "kernel_param", "ransac_n_hyp")
_CHECK_DEFAULTS = {name: p.default for name, p in
                   inspect.signature(query_and_associate).parameters.items()
                   if name in _CHECK_OPTS}


def _graphs(db: torch.Tensor) -> bool:
    """Whether a check on ``db``'s device runs as a program: on a card,
    with CHECK_GRAPHS, and not inside another program's capture."""
    return CHECK_GRAPHS and db.device.type == "cuda" and not cuda_graphs.in_program()


def check_key(cur: FrameFeatures, store_arrays: KFArrays, db: torch.Tensor,
              cam: StereoCamera, n_query: int, debug: bool, slot: bool, **opts) -> tuple:
    """The key of a check's CUDA graph: everything the check bakes into its
    kernels. The program (a fused group's slot, which writes its row first,
    or the one-check program), the frame's capacity K, the store's rows M,
    the database's shape, the camera, ``n_query``, ``debug``, every option
    of the cascade (``opts``, the defaults of :func:`query_and_associate`
    filled in), the change-in-pose solve's caps, the GN solve's block length
    and route (``robust_lm.GN_EXIT_EVERY``, ``GN_GRAPHS``) and the Horn
    seed's sweeps. The row and the seed are inputs, never in the key; the
    program adds the held tensors' addresses (:func:`cuda_graphs.program`)."""
    full = {name: _CHECK_DEFAULTS[name] for name in _CHECK_OPTS}
    full.update(opts)
    return ("check", "slot" if slot else "one", tuple(cur.desc_l.shape),
            tuple(store_arrays.desc_l.shape), tuple(db.shape), cam, n_query, debug,
            tuple(sorted(full.items())), DA_SOLVE_ITERS_STAGE1, DA_SOLVE_ITERS_STAGE2,
            robust_lm.GN_EXIT_EVERY, robust_lm.GN_GRAPHS, _JACOBI_SWEEPS)


def fleet_check_key(curs: list, stores: list, dbs: list, cam: StereoCamera, n_query: int,
                    debug: bool, **opts) -> tuple:
    """The key of a fleet shard's check-group program (``parallel/fleet.py``):
    the group's size Q (``len(curs)``), the number of the shard's stores
    and databases it holds (``len(stores)``), then what :func:`check_key`
    holds for one of its checks (the shapes, the camera, ``n_query``,
    ``debug``, every cascade option and the loops' caps and routes). The
    program adds the held stores', databases' and vocabulary's addresses,
    so the vocabulary's identity is in its key."""
    return (("fleet_check", len(curs), len(stores))
            + check_key(curs[0], stores[0], dbs[0], cam, n_query, debug, False, **opts)[2:])


def check_output_list(top_s, top_i, da: DAResult, frame: FrameFeatures, debug: bool) -> list:
    """A check's outputs as the estimator's host walk reads them (its
    ``_kf_check_host``): the BoW scores and ids, the cascade's statuses,
    matched indices and tracked counts, the frame's stereo matches and
    points, and with ``debug`` the cascade's raw matches, distances and
    residuals (the debug dumps' inputs); each leading with Q where the check
    ran over Q sequences."""
    return ([top_s, top_i, da.status, da.other_idx, da.tracked_count, frame.m_valid,
             frame.xs_l, frame.ys_l, frame.xs_r, frame.m_r_idx, frame.pts3d]
            + ([da.raw_oidx, da.distance, da.residuals] if debug else []))


def slot_table(rows, seeds, device) -> torch.Tensor:
    """The rows (or stored-keyframe counts) and seeds of a group's checks,
    host ints (each seed checked to lie in [0, 2^32), ``prng.check_seed``),
    as one int64 [n, 2] tensor on ``device``: one upload, pinned and
    ``non_blocking`` on a card (a pageable copy would synchronize the
    host)."""
    return cuda_graphs.upload([[int(r), prng.check_seed(sd)] for r, sd in zip(rows, seeds)],
                              device, torch.int64)


def _on_device(rows, seeds, device) -> tuple:
    """Rows (or counts) and seeds as integer tensors on ``device``: as given
    where they are tensors (no launch), else the columns of one
    :func:`slot_table` upload (a list each, or one int each)."""
    if isinstance(rows, torch.Tensor):
        return rows, seeds
    one = not isinstance(rows, list)
    table = slot_table([rows] if one else rows, [seeds] if one else seeds, device)
    return (table[0, 0], table[0, 1]) if one else (table[:, 0], table[:, 1])


_ZERO_BLOBS: dict = {}


def _zero_blob(n: int, device) -> torch.Tensor:
    """A padded slot's blob: zeros, made once per length and device (a
    padded slot launches nothing; callers only read blobs)."""
    key = (n, torch.device(device))
    if key not in _ZERO_BLOBS:
        _ZERO_BLOBS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return _ZERO_BLOBS[key]


def _held(store_arrays: KFArrays, db, leaf_bits, weights) -> dict:
    return dict(store=store_arrays, db=db, leaf_bits=leaf_bits, weights=weights)


def _packed(cur, store_arrays, db, leaf_bits, weights, n_kfs, cam, seed, n_query, debug,
            **opts) -> tuple:
    """The eager one-check: the key from ``seed``, the check, its blob."""
    key = prng.PRNGKey(seed, device=db.device)
    top_s, top_i, _cand, da = query_and_associate(cur, store_arrays, db, leaf_bits, weights,
                                                  n_kfs, cam, key, n_query=n_query, **opts)
    return pack_check_outputs(top_s, top_i, da, cur, debug=debug)


def query_and_associate_packed(cur: FrameFeatures, store_arrays: KFArrays, db, leaf_bits,
                               weights, n_kfs, cam: StereoCamera, seed, n_query: int = 4,
                               debug: bool = False, **opts) -> tuple:
    """:func:`query_and_associate` of one frame with the check's key built
    from ``seed`` (the host's DA stream), its outputs packed
    (:func:`pack_check_outputs`): the synchronous check. ``n_kfs`` and
    ``seed`` are host ints or integer scalar tensors on ``db``'s device.

    On a card (``CHECK_GRAPHS``) the check is one replay of the one-check
    program per :func:`check_key` (``cuda_graphs.program``), its key built
    in the program, as the JAX package's jitted check builds it: the frame,
    ``n_kfs`` and the seed are its inputs (host ints in one pinned upload,
    :func:`slot_table`), the store, the database and the vocabulary are
    held where they are; its loops run unread as conditional nodes. The
    same kernels as the eager check, so the same bits."""
    if not _graphs(db):
        return _packed(cur, store_arrays, db, leaf_bits, weights, n_kfs, cam, seed, n_query,
                       debug, **opts)
    n_kfs, seed = _on_device(n_kfs, seed, db.device)
    return cuda_graphs.program(
        lambda x: _packed(x["cur"], x["store"], x["db"], x["leaf_bits"], x["weights"],
                          x["n_kfs"], cam, x["seed"], n_query, debug, **opts),
        dict(cur=cur, n_kfs=n_kfs, seed=seed),
        check_key(cur, store_arrays, db, cam, n_query, debug, False, **opts),
        held=_held(store_arrays, db, leaf_bits, weights))


def _write_and_check(frame, store_arrays, db, leaf_bits, weights, row, cam, seed, n_query,
                     debug, **opts) -> torch.Tensor:
    """A slot's work: ``frame`` written into the store and the database at
    ``row`` (a device scalar, ``index_copy_``, in place), then the check
    against rows [0, row) with ``seed``'s key; its blob."""
    idx = row.reshape(1).to(torch.int64)
    for name in _ROW_FIELDS:
        dst = getattr(store_arrays, name)
        dst.index_copy_(0, idx, getattr(frame, name).to(dst.dtype)[None])
    db.index_copy_(0, idx, bow_vector(frame.desc_l, frame.m_valid, leaf_bits, weights)[None])
    (blob,) = _packed(frame, store_arrays, db, leaf_bits, weights, row, cam, seed, n_query,
                      debug, **opts)
    return blob


def _check_one_slot(feats: FrameFeatures, store_arrays: KFArrays, db, leaf_bits, weights,
                    j: int, row: torch.Tensor, cam: StereoCamera, seed: torch.Tensor,
                    n_query: int = 4, debug: bool = False, **opts) -> torch.Tensor:
    """One deferred check: frame ``j`` of the scanned batch ``feats`` (a
    view: ``j`` stays a host int) written into the keyframe store and the
    BoW database at the speculative row ``row``, in place, then the check
    against rows [0, row) with ``seed``'s key (``row`` and ``seed`` integer
    scalar tensors on ``db``'s device); its blob. On a card
    (``CHECK_GRAPHS``) one replay of the slot program per
    :func:`check_key`: the frame, ``row`` and ``seed`` copied in, the store,
    the database and the vocabulary held."""
    frame = FrameFeatures(*(a[j] for a in feats))
    if not _graphs(db):
        return _write_and_check(frame, store_arrays, db, leaf_bits, weights, row, cam, seed,
                                n_query, debug, **opts)
    return cuda_graphs.program(
        lambda x: _write_and_check(x["frame"], x["store"], x["db"], x["leaf_bits"],
                                   x["weights"], x["row"], cam, x["seed"], n_query, debug,
                                   **opts),
        dict(frame=frame, row=row, seed=seed),
        check_key(frame, store_arrays, db, cam, n_query, debug, True, **opts),
        held=_held(store_arrays, db, leaf_bits, weights))


def fused_check_write(feats: FrameFeatures, store_arrays: KFArrays, db, leaf_bits, weights,
                      j: int, n_kfs: int, cam: StereoCamera, seed: int, n_query: int = 4,
                      debug: bool = False, **opts):
    """One deferred check (:func:`_check_one_slot` at row ``n_kfs``);
    returns ``((blob,), store_arrays, db)``, the store and the database
    written in place (≙ the JAX package's donated arrays)."""
    row, seed = _on_device(n_kfs, seed, db.device)
    blob = _check_one_slot(feats, store_arrays, db, leaf_bits, weights, j, row, cam, seed,
                           n_query=n_query, debug=debug, **opts)
    return (blob,), store_arrays, db


# Slots of a fused check group (≙ the JAX package's): the batched walk
# launches its planned checks once this many are planned, the rest at the
# batch's end.
CHECK_SLOTS = 8


def fused_checks_batch(feats: FrameFeatures, store_arrays: KFArrays, db, leaf_bits, weights,
                       js, rows, valids, cam: StereoCamera, seeds, n_query: int = 4,
                       debug: bool = False, **opts):
    """A batch's deferred checks as one group of ``len(js)`` slots
    (CHECK_SLOTS): slot i checks frame ``js[i]`` of ``feats`` at row
    ``rows[i]`` with seed ``seeds[i]``, in slot order, each seeing the rows
    the slots before it wrote (≙ the JAX package's ``lax.scan`` threading
    the store). ``js`` and ``valids`` are host ints and bools; ``rows`` and
    ``seeds`` host ints or integer tensors [len(js)] on ``db``'s device (the
    estimator's slot table, one upload a group). A padded slot
    (``valids[i]`` False) launches nothing and gives a zero blob (one
    tensor a length and device, made once: read it, never write it).
    Nothing is read on the host: the
    GN solves run to their caps (``cuda_graphs.no_exit_reads``; the bits
    are the read path's). On a card (``CHECK_GRAPHS``) a valid slot is one
    replay of the slot program (:func:`_check_one_slot`), and slot i + 1
    reads the rows slot i wrote, the store being held in place: one graph
    launch a check, where the JAX package fuses the group into one jitted
    dispatch (to save its runtime's ~5 ms a call). Returns (the
    CHECK_SLOTS blobs, store_arrays, db), the store and database written in
    place."""
    s, k = 1 + n_query, feats.m_valid.shape[-1]
    if not isinstance(rows, torch.Tensor):
        rows, seeds = list(rows), list(seeds)
    rows, seeds = _on_device(rows, seeds, db.device)
    blobs = []
    with cuda_graphs.no_exit_reads():
        for i, (j, valid) in enumerate(zip(js, valids)):
            if not valid:
                blobs.append(_zero_blob(_blob_len(s, k, n_query, debug), db.device))
                continue
            blobs.append(_check_one_slot(feats, store_arrays, db, leaf_bits, weights, int(j),
                                         rows[i], cam, seeds[i], n_query=n_query, debug=debug,
                                         **opts))
    return tuple(blobs), store_arrays, db


def recheck_candidate(store_arrays: KFArrays, row_new: int, row_old: int,
                      cam: StereoCamera, init_pose: torch.Tensor, seed: int,
                      max_orb_distance_da: float = 60.0, residual_th: float = 30.0,
                      max_y_diff_epipolar: float = 2.0, filter_by_direction: bool = True,
                      filter_by_orb_distance: bool = True, use_fund_matrix: bool = True,
                      kernel_param: float = 2.0, ransac_n_hyp: int = 128,
                      init_gate_budget_m: float = 0.0):
    """Loop-closure RECOVERY re-check (framework extension; no reference
    counterpart): the cascade for ONE candidate (one lane) with the
    change-in-pose solve started from the odometry-implied relative pose
    ``init_pose`` instead of the Horn appearance alignment, behind a hard
    residual pre-gate at that prior (``init_gate_budget_m`` meters of drift;
    0 disables). On an aliased world this keeps the odometry-consistent
    subset of the raw matches. Both keyframes are read from the store (the
    new KF's row must be written). Returns (status [K], other_idx [K],
    tracked, pose [6])."""
    oth_row = tuple(a[row_old][None] for a in store_arrays)
    r = KFArrays(*(a[row_new][None] for a in store_arrays))
    cur = FrameFeatures(
        ys_l=r.ys_l, xs_l=r.xs_l, score_l=torch.zeros_like(r.xs_l, dtype=torch.float32),
        valid_l=r.valid_l, desc_l=r.desc_l, ys_r=r.ys_r, xs_r=r.xs_r, valid_r=r.valid_r,
        desc_r=r.desc_r, m_r_idx=r.m_r_idx, m_valid=r.m_valid, pts3d=r.pts3d,
        octave=r.octave)
    dev = r.ys_l.device
    key = prng.PRNGKey(seed, device=dev)
    init = torch.as_tensor(init_pose, dtype=torch.float32).to(dev, non_blocking=True)
    (status, oidx, tracked, pose, *_rest) = _da_single(
        cur, oth_row, torch.ones(1, dtype=torch.bool, device=dev), init[None], cam, key[None],
        max_orb_distance_da, residual_th, max_y_diff_epipolar, filter_by_direction,
        use_fund_matrix, True, kernel_param, filter_by_orb_distance=filter_by_orb_distance,
        ransac_n_hyp=ransac_n_hyp, seed_from_init=True,
        init_gate_budget_m=float(init_gate_budget_m))
    return status[0], oidx[0], tracked[0], pose[0]
