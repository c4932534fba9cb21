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

The S = 5 candidates run one after another (the JAX package vmaps them);
each draws its RANSAC hypotheses from its own ``ops/prng.py`` key, split
from the check's key as JAX splits it, so the draws are JAX's. Statuses use
the reference's enum values. The tunnel machinery of the JAX module (the
packed check blobs, ``fused_check_write``, ``fused_checks_batch``) is not
ported: a check here is one call whose outputs the caller copies to the
host once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srba_slam_tpu_torch.models.bow import bow_vector, rank_scores
from srba_slam_tpu_torch.models.keyframe import KFArrays
from srba_slam_tpu_torch.models.vo import FrameFeatures
from srba_slam_tpu_torch.ops import prng
from srba_slam_tpu_torch.ops.hamming import hamming_matrix
from srba_slam_tpu_torch.ops.ransac import ransac_fundamental
from srba_slam_tpu_torch.ops.robust_lm import solve_pose
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


def _horn_seed(p_oth: torch.Tensor, p_cur: torch.Tensor, w0: torch.Tensor,
               fallback: torch.Tensor, min_pts: int = 8) -> torch.Tensor:
    """Robust 3D-3D alignment seed for the change-in-pose solve: Kabsch of
    R p_oth + t ≈ p_cur over the masked correspondences, one median-
    residual trim pass; ``fallback`` when the geometry is too thin."""
    finite = torch.isfinite(p_oth).all(-1) & torch.isfinite(p_cur).all(-1)
    no = torch.linalg.vector_norm(p_oth, dim=-1)
    nc = torch.linalg.vector_norm(p_cur, dim=-1)
    near = (no > 1e-6) & (nc > 1e-6) & (no < 1e4) & (nc < 1e4)
    base = w0 & finite & near
    eye = torch.eye(3, dtype=torch.float32, device=p_oth.device)

    def fit(w):
        wf = w.to(torch.float32)
        n = torch.sum(wf)
        nz = torch.clamp(n, min=1.0)
        co = torch.sum(p_oth * wf[:, None], dim=0) / nz
        cp = torch.sum(p_cur * wf[:, None], dim=0) / nz
        H = ((p_oth - co) * wf[:, None]).T @ (p_cur - cp)
        # LAPACK refuses non-finite input; JAX's SVD returns NaNs there,
        # which end in the fallback below. Keep that outcome.
        bad = ~torch.isfinite(H).all()
        U, _S, Vt = torch.linalg.svd(torch.where(bad, eye, H))
        d = torch.linalg.det(Vt.T @ U.T)
        D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
        R = Vt.T @ D @ U.T
        R = torch.where(bad, float("nan"), R)
        t = cp - R @ co
        return R, t, n

    R, t, n = fit(base)
    res = torch.linalg.vector_norm(p_oth @ R.T + t - p_cur, dim=-1)
    res_sorted = torch.sort(torch.where(base, res, float("inf"))).values
    mid = torch.clamp(torch.div(n.to(torch.int64) - 1, 2, rounding_mode="floor"),
                      0, res.shape[0] - 1)
    med = res_sorted[mid]
    keep2 = base & (res <= torch.clamp(3.0 * med, min=0.5))
    R, t, n2 = fit(keep2)
    pose = se3.log(R, t)
    ok = (n2 >= min_pts) & torch.isfinite(pose).all()
    return torch.where(ok, pose, fallback)


def _direction_filter(keep, cur_y, cur_x, oth_y, oth_x, oidx, img_h: float):
    """Mode-bin direction histogram (36 bins of 10 degrees), mode ±1 kept,
    with the reference's binning of the slope across vertically stacked
    images (reference .cpp:1883-1946, offset = image height at :1486).
    The histogram is a one-hot count, never a scatter-add."""
    f32 = torch.float32
    dy = oth_y[oidx].to(f32) + img_h - cur_y.to(f32)
    dx = oth_x[oidx].to(f32) - cur_x.to(f32)
    ang = torch.rad2deg(torch.atan(dy / torch.where(dx == 0, 1e-9, dx))) + 180.0
    bins = torch.clamp((ang / 10.0).to(torch.int32), 0, 35)
    onehot = bins[:, None] == torch.arange(36, dtype=torch.int32, device=bins.device)
    hist = torch.sum(onehot & keep[:, None], dim=0)
    mode = torch.argmax(hist).to(torch.int32)  # first mode on ties, as jnp.argmax
    diff = torch.abs(bins - mode)
    diff = torch.minimum(diff, 36 - diff)
    return diff <= 1


def _transform_points(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    R, t = se3.exp(pose)
    return torch.einsum("ij,nj->ni", R, pts) + t


def _da_single(cur: FrameFeatures, oth_row, oth_valid_kf, init_pose, cam: StereoCamera,
               key, max_orb_distance_da: float, residual_th: float,
               max_y_diff_epipolar: float, filter_by_direction: bool,
               use_fund_matrix: bool, use_change_pose: bool, kernel_param: float,
               filter_by_orb_distance: bool = True, ransac_n_hyp: int = 128,
               min_alive: int = 15, seed_from_init: bool = False,
               init_gate_budget_m: float = 0.0):
    """The cascade of ``cur`` against one candidate keyframe row."""
    (oy_l, ox_l, _oval_l, odesc_l, _oy_r, _oxr, _ovr, _odesc_r, _om_ridx,
     om_valid, opts3d, ooct) = oth_row
    f32, i8 = torch.float32, torch.int8
    k = cur.desc_l.shape[0]
    dev = cur.desc_l.device

    dist = hamming_matrix(cur.desc_l, odesc_l)
    gate = (cur.m_valid[:, None] & om_valid[None, :] & oth_valid_kf
            & (cur.octave[:, None] == ooct[None, :]))
    d = torch.where(gate, dist, _BIG)
    oidx = torch.argmin(d, dim=1)  # first index on ties, as jnp.argmin
    bd = torch.amin(d, dim=1)
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
        claimed = torch.arange(k, device=dev)[None, :] == oidx[:, None]
        col_best = torch.amin(torch.where(claimed, lex[:, None], _BIG), dim=0)
        ok = lex == col_best[oidx]
        status = torch.where(keep & ~ok, S_REJ_CONSISTENCY, status).to(i8)
        keep = keep & ok

    # filter 3: fundamental-matrix RANSAC on left pixel pairs
    if use_fund_matrix:
        n_alive = torch.sum(keep.to(torch.int32))
        inl, _cnt, _F = ransac_fundamental(
            cur.xs_l.to(f32), cur.ys_l.to(f32), ox_l[oidx].to(f32), oy_l[oidx].to(f32),
            keep, key, threshold=max_y_diff_epipolar, n_hyp=ransac_n_hyp)
        ok = torch.where(n_alive >= min_alive, inl, keep)
        status = torch.where(keep & ~ok, S_REJ_FUND_MATRIX, status).to(i8)
        keep = keep & ok

    # filter 4: change-in-pose residual gating (≙ getChangeInPose)
    pose = torch.zeros(6, dtype=f32, device=dev)
    pose_ok = torch.tensor(False, device=dev)
    mean_res = torch.tensor(0.0, dtype=f32, device=dev)
    residuals = torch.zeros(k, dtype=f32, device=dev)
    if use_change_pose:
        ur = cur.xs_r[cur.m_r_idx.long()].to(f32)
        obs = torch.stack([cur.xs_l.to(f32), cur.ys_l.to(f32), ur], dim=-1)
        p_oth = opts3d[oidx]
        if seed_from_init:
            # loop-closure recovery: the odometry prior seeds the solve, and
            # matches whose residual AT the prior exceeds what the drift
            # budget allows are dropped first (depth-adaptive: a budget_m
            # offset at depth z subtends ~budget*fx/z pixels)
            seed = init_pose
            p_pred = _transform_points(init_pose, p_oth)
            zq = torch.clamp(p_pred[:, 2], min=1.0)
            ulp = cam.cx_l + cam.fx_l * p_pred[:, 0] / zq
            vlp = cam.cy_l + cam.fy_l * p_pred[:, 1] / zq
            urp = cam.cx_r + cam.fx_r * (p_pred[:, 0] - cam.baseline) / zq
            e_px = torch.maximum(torch.abs(ulp - cur.xs_l.to(f32)),
                                 torch.maximum(torch.abs(vlp - cur.ys_l.to(f32)),
                                               torch.abs(urp - ur)))
            budget = torch.tensor(init_gate_budget_m, dtype=f32, device=dev)
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
        ok = torch.where(pose_ok, sol.inliers, torch.zeros_like(keep))
        # depth-consistency gate: predicted vs triangulated depth within a
        # stereo-noise-proportional tolerance (sigma_z ~ z^2 * 2 px / (fx b),
        # 4 sigma + 0.5 m floor)
        p_pred = _transform_points(pose, p_oth)
        z = torch.clamp(cur.pts3d[:, 2], min=0.5)
        depth_sig = z * z * 2.0 / (cam.fx_l * cam.baseline)
        ok3d = torch.abs(p_pred[:, 2] - cur.pts3d[:, 2]) <= 4.0 * depth_sig + 0.5
        ok = ok & ok3d
        status = torch.where(keep & ~ok, S_REJ_CHANGE_POSE, status).to(i8)
        keep = keep & ok

    tracked = torch.sum(keep.to(torch.int32))
    status = torch.where(keep, S_TRACKED, status).to(i8)
    oidx32 = oidx.to(torch.int32)
    return (status, torch.where(keep, oidx32, 0), tracked, pose, pose_ok, mean_res,
            oidx32, bd, residuals)


def da_cascade(cur: FrameFeatures, store_arrays: KFArrays, similar_idx: torch.Tensor,
               others_valid: torch.Tensor, cam: StereoCamera, key: torch.Tensor,
               init_poses: torch.Tensor | None = None, max_orb_distance_da: float = 60.0,
               residual_th: float = 30.0, max_y_diff_epipolar: float = 2.0,
               filter_by_direction: bool = True, filter_by_orb_distance: bool = True,
               use_fund_matrix: bool = True, use_change_pose: bool = True,
               kernel_param: float = 2.0, ransac_n_hyp: int = 128) -> DAResult:
    """The full cascade of the current KF against S candidate KFs
    (``similar_idx`` int [S] rows of the store, ``others_valid`` bool [S])."""
    s = others_valid.shape[0]
    idx = similar_idx.long()
    others = [a[idx] for a in store_arrays]
    keys = prng.split(key, s)
    if init_poses is None:
        init_poses = torch.zeros((s, 6), dtype=torch.float32, device=key.device)
    lanes = [
        _da_single(cur, tuple(a[j] for a in others), others_valid[j], init_poses[j], cam,
                   keys[j], max_orb_distance_da, residual_th, max_y_diff_epipolar,
                   filter_by_direction, use_fund_matrix, use_change_pose, kernel_param,
                   filter_by_orb_distance=filter_by_orb_distance,
                   ransac_n_hyp=ransac_n_hyp)
        for j in range(s)
    ]
    (status, oidx, tracked, pose, pose_ok, mean_res, raw_oidx, bd,
     residuals) = (torch.stack(x) for x in zip(*lanes))
    tracked = torch.where(others_valid, tracked, 0)
    return DAResult(status, oidx, tracked, pose, pose_ok & others_valid, mean_res,
                    raw_oidx, bd, residuals)


def query_and_associate(cur: FrameFeatures, store_arrays: KFArrays, db: torch.Tensor,
                        leaf_bits: torch.Tensor, weights: torch.Tensor, n_kfs: int,
                        cam: StereoCamera, key: torch.Tensor,
                        init_poses: torch.Tensor | None = None, n_query: int = 4,
                        max_orb_distance_da: float = 60.0, residual_th: float = 30.0,
                        max_y_diff_epipolar: float = 2.0, filter_by_direction: bool = True,
                        filter_by_orb_distance: bool = True, use_fund_matrix: bool = True,
                        use_change_pose: bool = True, kernel_param: float = 2.0,
                        ransac_n_hyp: int = 128):
    """The whole keyframe check: BoW query (quantize, score, rank), then
    the DA cascade against {previous KF} ∪ the top ``n_query`` BoW results
    (``n_kfs`` stored KFs; the new one is not in yet). ``init_poses[i]``
    seeds the change-in-pose solve against KF i (zeros when omitted).

    Returns (scores [n_query], ids [n_query], cand [1+n_query], DAResult)."""
    q = bow_vector(cur.desc_l, cur.m_valid, leaf_bits, weights)
    scores_all = torch.sum(torch.minimum(db, q[None, :]), dim=-1)
    rows = torch.arange(db.shape[0], device=db.device)
    scores_all = torch.where(rows < n_kfs, scores_all, -1.0)
    top_s, top_i = rank_scores(scores_all, n_query)

    prev_kf = n_kfs - 1
    dev = db.device
    cand = torch.cat([torch.tensor([prev_kf], dtype=torch.int32, device=dev), top_i])
    cand_valid = torch.cat([torch.tensor([True], device=dev),
                            (top_s > 0) & (top_i != prev_kf)])
    cand = torch.clamp(cand, 0, db.shape[0] - 1)
    init_cand = (init_poses[cand.long()] if init_poses is not None
                 else torch.zeros((cand.shape[0], 6), dtype=torch.float32, device=dev))
    da = da_cascade(cur, store_arrays, cand, cand_valid, cam, key, init_poses=init_cand,
                    max_orb_distance_da=max_orb_distance_da, residual_th=residual_th,
                    max_y_diff_epipolar=max_y_diff_epipolar,
                    filter_by_direction=filter_by_direction,
                    filter_by_orb_distance=filter_by_orb_distance,
                    use_fund_matrix=use_fund_matrix, use_change_pose=use_change_pose,
                    kernel_param=kernel_param, ransac_n_hyp=ransac_n_hyp)
    return top_s, top_i, cand, da


def recheck_candidate(store_arrays: KFArrays, row_new: int, row_old: int,
                      cam: StereoCamera, init_pose: torch.Tensor, seed: int,
                      max_orb_distance_da: float = 60.0, residual_th: float = 30.0,
                      max_y_diff_epipolar: float = 2.0, filter_by_direction: bool = True,
                      filter_by_orb_distance: bool = True, use_fund_matrix: bool = True,
                      kernel_param: float = 2.0, ransac_n_hyp: int = 128,
                      init_gate_budget_m: float = 0.0):
    """Loop-closure RECOVERY re-check (framework extension; no reference
    counterpart): the cascade for ONE candidate with the change-in-pose
    solve started from the odometry-implied relative pose ``init_pose``
    instead of the Horn appearance alignment, behind a hard residual
    pre-gate at that prior (``init_gate_budget_m`` meters of drift; 0
    disables). On an aliased world this keeps the odometry-consistent
    subset of the raw matches. Both keyframes are read from the store (the
    new KF's row must be written). Returns (status [K], other_idx [K],
    tracked, pose [6])."""
    oth_row = tuple(a[row_old] for a in store_arrays)
    r = KFArrays(*(a[row_new] for a in store_arrays))
    cur = FrameFeatures(
        ys_l=r.ys_l, xs_l=r.xs_l, score_l=torch.zeros_like(r.xs_l, dtype=torch.float32),
        valid_l=r.valid_l, desc_l=r.desc_l, ys_r=r.ys_r, xs_r=r.xs_r, valid_r=r.valid_r,
        desc_r=r.desc_r, m_r_idx=r.m_r_idx, m_valid=r.m_valid, pts3d=r.pts3d,
        octave=r.octave)
    dev = r.ys_l.device
    key = prng.PRNGKey(seed, device=dev)
    (status, oidx, tracked, pose, *_rest) = _da_single(
        cur, oth_row, torch.tensor(True, device=dev),
        torch.as_tensor(init_pose, dtype=torch.float32, device=dev), cam, key,
        max_orb_distance_da, residual_th, max_y_diff_epipolar, filter_by_direction,
        use_fund_matrix, True, kernel_param, filter_by_orb_distance=filter_by_orb_distance,
        ransac_n_hyp=ransac_n_hyp, seed_from_init=True,
        init_gate_budget_m=float(init_gate_budget_m))
    return status, oidx, tracked, pose
