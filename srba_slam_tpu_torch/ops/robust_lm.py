"""Robust two-stage Gauss-Newton SE(3) pose estimation (plain torch).

Counterpart of ``srba_slam_tpu/ops/robust_lm.py`` (the stereo-vo engine's
least-squares pose solver, reference src/CSRBAStereoSLAMEstimator.cpp:2139-2177
and the LEAST_SQUARES config section): find the rigid transform taking 3D
points of the previous camera frame onto their stereo pixels (ul, vl, ur)
in the current frame, with a pseudo-Huber kernel. Stage 1 runs on all
correspondences; outliers (residual norm > threshold) are masked; stage 2
refines on the inliers.

The JAX package's ``while_loop`` is a Python loop here. Reading its exit
flag syncs the host once per iteration (ROADMAP M4 owns removing that).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srba_slam_tpu_torch.utils import se3
from srba_slam_tpu_torch.utils.camera import StereoCamera


class PoseSolveResult(NamedTuple):
    pose: torch.Tensor          # [6] rotvec+trans: x_cur = R x_prev + t
    residuals: torch.Tensor     # [N] final residual norms (0 where not inlier)
    inliers: torch.Tensor       # [N] bool mask of surviving correspondences
    num_inliers: torch.Tensor   # int32
    mean_residual: torch.Tensor # mean over inliers (pixels)
    iters: torch.Tensor         # int32 GN iterations applied in stage 2
    valid: torch.Tensor         # bool: enough inliers and a finite pose


def stereo_residuals(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor,
                     obs: torch.Tensor, cam: StereoCamera, eps: float = 1e-6):
    """Residuals r = project(R p + t) - obs, and the camera-frame points.

    pts: [N,3] in the previous frame; obs: [N,3] = (ul, vl, ur).
    Returns (r [N,3], x [N,3]).
    """
    x = torch.einsum("ij,nj->ni", R, pts) + t[None, :]
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / torch.clamp(Z, min=eps)
    ul = cam.cx_l + cam.fx_l * X * zi
    vl = cam.cy_l + cam.fy_l * Y * zi
    ur = cam.cx_r + cam.fx_r * (X - cam.baseline) * zi
    r = torch.stack([ul, vl, ur], dim=-1) - obs
    return r, x


def _jacobian(x: torch.Tensor, cam: StereoCamera, eps: float = 1e-6) -> torch.Tensor:
    """d residual / d twist (left perturbation), [N, 3, 6]."""
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / torch.clamp(Z, min=eps)
    zi2 = zi * zi
    zeros = torch.zeros_like(X)
    dr_dx = torch.stack(
        [
            torch.stack([cam.fx_l * zi, zeros, -cam.fx_l * X * zi2], dim=-1),
            torch.stack([zeros, cam.fy_l * zi, -cam.fy_l * Y * zi2], dim=-1),
            torch.stack([cam.fx_r * zi, zeros, -cam.fx_r * (X - cam.baseline) * zi2], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(*x.shape[:-1], 3, 3)
    dx_dxi = torch.cat([-se3.hat(x), eye], dim=-1)
    return torch.einsum("nij,njk->nik", dr_dx, dx_dxi)


def _pseudo_huber_weight(rnorm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IRLS weight rho'(r)/r for the pseudo-Huber kernel with parameter b."""
    return 1.0 / torch.sqrt(1.0 + (rnorm / b) ** 2)


def _gn_stage(R0, t0, pts, obs, w_valid, cam, kernel_param, use_kernel,
              max_iters: int, min_mod: float, damping: float,
              max_incr_cost=1 << 30):
    """Up to ``max_iters`` damped GN steps, stopping once the step modulus
    drops below ``min_mod`` (the reference's ending condition), or after
    ``max_incr_cost`` consecutive cost increases (≙ the stereo-vo
    LEAST_SQUARES option): the solver is diverging, and the best pose seen
    is kept."""
    dev = pts.device
    b2 = kernel_param * kernel_param

    def cost_at(r):
        rsq = torch.sum(r * r, dim=-1)
        rho = 2.0 * b2 * (torch.sqrt(1.0 + rsq / b2) - 1.0) if use_kernel else rsq
        return torch.sum(rho * w_valid)

    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    R, t = R0, t0
    done = torch.tensor(False, device=dev)
    iters = torch.tensor(0, dtype=torch.int32, device=dev)
    incr = torch.tensor(0, dtype=torch.int32, device=dev)
    prev_cost = inf
    best_R, best_t, best_cost = R0, t0, inf
    while bool(((~done) & (iters < max_iters) & (incr < max_incr_cost)).item()):
        r, x = stereo_residuals(R, t, pts, obs, cam)
        cost = cost_at(r)
        incr = torch.where(cost > prev_cost, incr + 1, 0).to(torch.int32)
        better = cost < best_cost
        best_R = torch.where(better, R, best_R)
        best_t = torch.where(better, t, best_t)
        best_cost = torch.minimum(cost, best_cost)
        prev_cost = cost
        J = _jacobian(x, cam)
        rnorm = torch.linalg.vector_norm(r, dim=-1)
        w = _pseudo_huber_weight(rnorm, kernel_param) if use_kernel else torch.ones_like(rnorm)
        w = w * w_valid
        H = torch.einsum("nij,n,nik->jk", J, w, J) + damping * eye6
        g = torch.einsum("nij,n,ni->j", J, w, r)
        # JAX's cholesky returns NaNs where H is not positive definite;
        # cholesky_ex reports it in `info` instead of raising
        L, info = torch.linalg.cholesky_ex(H)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = torch.all(torch.isfinite(delta)) & (info == 0)
        delta = torch.where(ok, delta, 0.0)
        step_mod = torch.linalg.vector_norm(delta)
        apply = (~done) & ok
        dR = se3.so3_exp(delta[:3])
        R = torch.where(apply, dR @ R, R)
        t = torch.where(apply, dR @ t + delta[3:], t)
        done = done | (step_mod < min_mod) | (~ok)
        iters = iters + apply.to(torch.int32)
    r_fin, _ = stereo_residuals(R, t, pts, obs, cam)
    diverged = (incr >= max_incr_cost) & (cost_at(r_fin) > best_cost)
    R = torch.where(diverged, best_R, R)
    t = torch.where(diverged, best_t, t)
    return R, t, iters


def solve_pose(
    pts_prev: torch.Tensor,
    obs_cur: torch.Tensor,
    valid: torch.Tensor,
    cam: StereoCamera,
    initial_pose: torch.Tensor | None = None,
    kernel_param: float = 2.0,
    residual_threshold: float = 15.0,
    min_mod: float = 1e-3,
    max_iters_initial: int = 30,
    max_iters: int = 30,
    min_inliers: int = 5,
    use_kernel: bool = True,
    damping: float = 1e-4,
    max_incr_cost: int = 3,
) -> PoseSolveResult:
    """Two-stage robust pose solve (≙ LEAST_SQUARES config defaults).

    Args:
      pts_prev: [N, 3] 3D points in the previous camera frame (padded).
      obs_cur: [N, 3] observed (ul, vl, ur) in the current frame.
      valid: [N] bool correspondence mask.
      initial_pose: optional [6] rotvec+trans initial guess.
      min_inliers: ≙ bad_tracking_th.
      max_incr_cost: abort a stage after this many consecutive
        cost-increasing steps (best-seen pose kept).
    """
    dev = pts_prev.device
    pts_prev = pts_prev.to(torch.float32)
    obs_cur = obs_cur.to(torch.float32)
    w_valid = valid.to(torch.float32)
    if initial_pose is None:
        initial_pose = torch.zeros(6, dtype=torch.float32, device=dev)
    R0, t0 = se3.exp(initial_pose)
    kp = torch.tensor(kernel_param, dtype=torch.float32, device=dev)

    R1, t1, _ = _gn_stage(R0, t0, pts_prev, obs_cur, w_valid, cam, kp,
                          use_kernel, max_iters_initial, min_mod, damping,
                          max_incr_cost)
    r1, _ = stereo_residuals(R1, t1, pts_prev, obs_cur, cam)
    inliers = valid & (torch.linalg.vector_norm(r1, dim=-1) <= residual_threshold)

    w2 = inliers.to(torch.float32)
    R2, t2, iters2 = _gn_stage(R1, t1, pts_prev, obs_cur, w2, cam, kp,
                               use_kernel, max_iters, min_mod, damping,
                               max_incr_cost)
    r2, _ = stereo_residuals(R2, t2, pts_prev, obs_cur, cam)
    rnorm2 = torch.linalg.vector_norm(r2, dim=-1) * w2
    n_in = torch.sum(inliers.to(torch.int32)).to(torch.int32)
    mean_res = torch.sum(rnorm2) / torch.clamp(n_in.to(torch.float32), min=1.0)
    pose = se3.log(R2, t2)
    ok = (n_in >= min_inliers) & torch.all(torch.isfinite(pose))
    pose = torch.where(ok, pose, initial_pose)
    return PoseSolveResult(
        pose=pose,
        residuals=rnorm2,
        inliers=inliers,
        num_inliers=n_in,
        mean_residual=mean_res,
        iters=iters2,
        valid=ok,
    )
