"""Robust two-stage Gauss-Newton SE(3) pose estimation (plain torch).

Counterpart of ``srba_slam_tpu/ops/robust_lm.py`` (the stereo-vo engine's
least-squares pose solver, reference src/CSRBAStereoSLAMEstimator.cpp:2139-2177
and the LEAST_SQUARES config section): find the rigid transform taking 3D
points of the previous camera frame onto their stereo pixels (ul, vl, ur)
in the current frame, with a pseudo-Huber kernel. Stage 1 runs on all
correspondences; outliers (residual norm > threshold) are masked; stage 2
refines on the inliers.

Every tensor may carry a leading lane dimension ``[L]``: the DA cascade's
candidates and the sequences of a batched VO step are lanes of one solve,
as the JAX package vmaps ``solve_pose``. The JAX ``while_loop`` becomes a
loop whose lanes freeze, each on its own exit test (JAX's ``cond`` under
``vmap``): a frozen lane keeps its whole carry, so iterations past its
exit change nothing. "Any lane still active" is tested once every
``GN_EXIT_EVERY`` iterations: by a host read in the eager loop, on the
device in a card's graph launch (``ops/cuda_graphs.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.utils import se3
from srba_slam_tpu_torch.utils.camera import StereoCamera

# Iterations between two tests of a stage's exit. The result does not
# depend on it (frozen lanes); it trades tests against iterations run past
# the last lane's exit.
GN_EXIT_EVERY = 4
# On a CUDA device, each block of GN_EXIT_EVERY iterations replays as one
# CUDA graph (one launch in place of ~150 an iteration); eager otherwise.
GN_GRAPHS = True


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

    R [L,3,3], t [L,3]; pts [L,N,3] in the previous frame; obs [L,N,3] =
    (ul, vl, ur). Returns (r [L,N,3], x [L,N,3]).
    """
    x = torch.einsum("lij,lnj->lni", R, pts) + t[:, None, :]
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / torch.clamp(Z, min=eps)
    ul = cam.cx_l + cam.fx_l * X * zi
    vl = cam.cy_l + cam.fy_l * Y * zi
    ur = cam.cx_r + cam.fx_r * (X - cam.baseline) * zi
    r = torch.stack([ul, vl, ur], dim=-1) - obs
    return r, x


def _jacobian(x: torch.Tensor, cam: StereoCamera, eps: float = 1e-6) -> torch.Tensor:
    """d residual / d twist (left perturbation), [..., N, 3, 6]."""
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
    return torch.einsum("...ij,...jk->...ik", dr_dx, dx_dxi)


def _pseudo_huber_weight(rnorm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IRLS weight rho'(r)/r for the pseudo-Huber kernel with parameter b."""
    return 1.0 / torch.sqrt(1.0 + (rnorm / b) ** 2)


def lanewise(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` on each lane of ``xs``, stacked. For the products a BLAS call
    computes: a batched product may sum in another order than the one-lane
    call, and a lane must give the one-lane solve's bits (the per-frame VO
    and the cascade's candidates keep their decisions). A tuple result is
    stacked field by field."""
    outs = [fn(*(x[i] for x in xs)) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def _lanes(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A [L] mask shaped against a [L, ...] tensor."""
    return m.view(-1, *([1] * (x.dim() - 1)))


def _cost(r, w_valid, kp, use_kernel: bool):
    rsq = torch.sum(r * r, dim=-1)
    b2 = kp * kp
    rho = 2.0 * b2 * (torch.sqrt(1.0 + rsq / b2) - 1.0) if use_kernel else rsq
    return torch.sum(rho * w_valid, dim=-1)


def _gn_block(c: dict, k: dict, n: int, cam: StereoCamera, use_kernel: bool,
              max_iters: int, min_mod: float, damping: float, max_incr_cost: int) -> dict:
    """``n`` GN iterations on the carry ``c`` (R, t, done, iters, incr,
    prev_cost, best_R, best_t, best_cost; lanes leading) over the stage's
    inputs ``k`` (pts, obs, w_valid, kp, eye6); returns the new carry with
    ``more``, "a lane is still active". A lane that is not active keeps its
    whole carry (JAX's ``cond`` under ``vmap``). No host read."""
    R, t, done, iters, incr = c["R"], c["t"], c["done"], c["iters"], c["incr"]
    prev_cost, best_R, best_t, best_cost = c["prev_cost"], c["best_R"], c["best_t"], c["best_cost"]
    for _ in range(n):
        active = (~done) & (iters < max_iters) & (incr < max_incr_cost)
        r, x = stereo_residuals(R, t, k["pts"], k["obs"], cam)
        cost = _cost(r, k["w_valid"], k["kp"], use_kernel)
        better = active & (cost < best_cost)
        best_R = torch.where(_lanes(R, better), R, best_R)
        best_t = torch.where(_lanes(t, better), t, best_t)
        best_cost = torch.where(active, torch.minimum(cost, best_cost), best_cost)
        incr = torch.where(active, torch.where(cost > prev_cost, incr + 1, 0), incr)
        prev_cost = torch.where(active, cost, prev_cost)
        J = _jacobian(x, cam)
        rnorm = torch.linalg.vector_norm(r, dim=-1)
        w = _pseudo_huber_weight(rnorm, k["kp"]) if use_kernel else torch.ones_like(rnorm)
        w = w * k["w_valid"]
        H = lanewise(lambda a, b: torch.einsum("nij,n,nik->jk", a, b, a), J, w) \
            + damping * k["eye6"]
        g = lanewise(lambda a, b, c_: torch.einsum("nij,n,ni->j", a, b, c_), J, w, r)
        # JAX's cholesky returns NaNs where H is not positive definite;
        # cholesky_ex reports it in `info` instead of raising. One matrix a
        # call: the batched factorization synchronizes the host on the card
        L, info = lanewise(torch.linalg.cholesky_ex, H)
        delta = -lanewise(cuda_graphs.cholesky_solve, L, g)
        ok = torch.all(torch.isfinite(delta), dim=-1) & (info == 0)
        delta = torch.where(ok[:, None], delta, 0.0)
        step_mod = torch.linalg.vector_norm(delta, dim=-1)
        apply = active & ok
        dR = se3.so3_exp(delta[:, :3])
        R = torch.where(_lanes(R, apply), lanewise(torch.mm, dR, R), R)
        t = torch.where(_lanes(t, apply), lanewise(torch.mv, dR, t) + delta[:, 3:], t)
        done = done | (active & ((step_mod < min_mod) | ~ok))
        iters = iters + apply.to(torch.int32)
    more = torch.any((~done) & (iters < max_iters) & (incr < max_incr_cost))
    return dict(R=R, t=t, done=done, iters=iters, incr=incr, prev_cost=prev_cost,
                best_R=best_R, best_t=best_t, best_cost=best_cost, more=more)


def _gn_stage(R0, t0, pts, obs, w_valid, cam, kernel_param, use_kernel,
              max_iters: int, min_mod: float, damping: float,
              max_incr_cost=1 << 30):
    """Up to ``max_iters`` damped GN steps per lane, a lane stopping once
    its step modulus drops below ``min_mod`` (the reference's ending
    condition), or after ``max_incr_cost`` consecutive cost increases (≙
    the stereo-vo LEAST_SQUARES option): that lane is diverging, and the
    best pose it saw is kept. Lanes run together ([L] leading every
    tensor), in blocks of ``GN_EXIT_EVERY`` iterations, each block a CUDA
    graph on a card (``GN_GRAPHS``); the host reads "a lane is still
    active" between blocks. Every active iteration applies a step or ends
    its lane, so after ``max_iters`` iterations no lane is active, and the
    iterations of a block past that are no-ops."""
    dev = pts.device
    n_lanes = pts.shape[0]
    inf = torch.full((n_lanes,), float("inf"), dtype=torch.float32, device=dev)
    zeros = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
    c = dict(R=R0, t=t0, done=torch.zeros(n_lanes, dtype=torch.bool, device=dev),
             iters=zeros, incr=zeros, prev_cost=inf, best_R=R0, best_t=t0, best_cost=inf,
             more=torch.ones((), dtype=torch.bool, device=dev))
    k = dict(pts=pts, obs=obs, w_valid=w_valid, kp=kernel_param,
             eye6=torch.eye(6, dtype=torch.float32, device=dev))

    def block(c_, k_):
        return _gn_block(c_, k_, GN_EXIT_EVERY, cam, use_kernel, max_iters, min_mod, damping,
                         max_incr_cost)

    c = cuda_graphs.loop(block, c, k, -(-max_iters // GN_EXIT_EVERY),
                         ("gn", GN_EXIT_EVERY, max_iters, cam, use_kernel, min_mod, damping,
                          max_incr_cost), GN_GRAPHS)
    R, t = c["R"], c["t"]
    r_fin, _ = stereo_residuals(R, t, pts, obs, cam)
    diverged = (c["incr"] >= max_incr_cost) & (_cost(r_fin, w_valid, kernel_param, use_kernel)
                                               > c["best_cost"])
    R = torch.where(_lanes(R, diverged), c["best_R"], R)
    t = torch.where(_lanes(t, diverged), c["best_t"], t)
    return R, t, c["iters"]


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

    With a leading lane dimension on every tensor (``[L, N, 3]``,
    ``[L, N]``, ``[L, 6]``) the L solves run as one, each lane the solve of
    its own inputs, and every field of the result has the lane dimension.
    """
    dev = pts_prev.device
    lanes = pts_prev.dim() == 3
    if not lanes:
        pts_prev, obs_cur, valid = pts_prev[None], obs_cur[None], valid[None]
        if initial_pose is not None:
            initial_pose = initial_pose[None]
    pts_prev = pts_prev.to(torch.float32)
    obs_cur = obs_cur.to(torch.float32)
    w_valid = valid.to(torch.float32)
    if initial_pose is None:
        initial_pose = torch.zeros((pts_prev.shape[0], 6), dtype=torch.float32, device=dev)
    R0, t0 = se3.exp(initial_pose)
    kp = torch.full((), kernel_param, dtype=torch.float32, device=dev)

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
    n_in = torch.sum(inliers.to(torch.int32), dim=-1).to(torch.int32)
    mean_res = torch.sum(rnorm2, dim=-1) / torch.clamp(n_in.to(torch.float32), min=1.0)
    pose = se3.log(R2, t2)
    ok = (n_in >= min_inliers) & torch.all(torch.isfinite(pose), dim=-1)
    pose = torch.where(ok[:, None], pose, initial_pose)
    out = PoseSolveResult(
        pose=pose,
        residuals=rnorm2,
        inliers=inliers,
        num_inliers=n_in,
        mean_residual=mean_res,
        iters=iters2,
        valid=ok,
    )
    return out if lanes else PoseSolveResult(*(a[0] for a in out))
