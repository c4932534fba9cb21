"""Windowed stereo bundle adjustment: LM + Schur over landmarks + Cholesky.

Counterpart of ``srba_slam_tpu/ops/window_ba.py`` ``optimize_window``
(≙ the solver the reference configures, LM with a Schur complement over
landmarks and dense Cholesky, ``srba::options::solver_LM_schur_dense_cholesky``,
reference src/srba-stereo-slam.h:34, run over the <= max_optimize_depth
window on each keyframe insertion, src/CSRBAStereoSLAMEstimator.cpp:782-784).

Window keyframes carry poses Q_c relative to the window root (frozen:
the gauge); landmarks live in their base keyframe's frame. Per LM
iteration: analytic Jacobians of all observations at once, block-Hessian
assembly, closed-form 3x3 landmark-block inverses, the Schur reduction, one
dense Cholesky solve of the 6C camera system, masked accept/reject with
adaptive damping; an optional pose-only stage 1 first, and the init-anchor
pose prior of the JAX package.

Assembly is deterministic on every device: each block sum is a fixed
gather plus fixed-width sums over a table of the observations that feed
it (``assembly_plan``, built on the host once per solve), never a float
scatter-add, whose order on a GPU changes from run to run. The JAX
package's static window buckets are an XLA compile device; windows here
run at their own size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.utils import se3
from srba_slam_tpu_torch.utils.camera import StereoCamera

_SEG_WIDTH = 32  # items summed per gather row of a segment-sum level


class BAWindow(NamedTuple):
    """A window problem; all tensors on one device."""

    cam_pose: torch.Tensor   # f32 [C, 6] pose of each window KF in ROOT frame (Q_c)
    cam_valid: torch.Tensor  # bool [C]; entry 0 is the root (always frozen)
    lm_pos: torch.Tensor     # f32 [L, 3] landmark in its base KF frame
    lm_base: torch.Tensor    # int [L] window-local index of the base KF
    lm_valid: torch.Tensor   # bool [L]
    obs_cam: torch.Tensor    # int [O] window-local observing KF
    obs_lm: torch.Tensor     # int [O] window-local landmark index
    obs_px: torch.Tensor     # f32 [O, 3] (ul, vl, ur)
    obs_valid: torch.Tensor  # bool [O]


class BAResult(NamedTuple):
    cam_pose: torch.Tensor   # optimized [C, 6]
    lm_pos: torch.Tensor     # optimized [L, 3]
    cost_init: torch.Tensor  # robust total cost before
    cost_final: torch.Tensor
    obs_rmse: torch.Tensor   # raw pixel RMSE over valid obs after
    iters: torch.Tensor
    obs_rmse_stg1: torch.Tensor  # raw pixel RMSE after the pose-only stage 1


def segment_tables(seg: np.ndarray, n_seg: int, width: int = _SEG_WIDTH) -> list[np.ndarray]:
    """Gather tables that sum items into segments: item i belongs to
    segment ``seg[i]``. Each level groups the rows of one segment, in item
    order, into rows of at most ``width`` (a pad index points at an
    appended zero row); the last level has exactly one row per segment.
    Memory stays O(items + segments) however skewed the segments are."""
    seg = np.asarray(seg, np.int64)
    tables = []
    while True:
        n = len(seg)
        order = np.argsort(seg, kind="stable")
        counts = np.bincount(seg, minlength=n_seg)
        starts = np.cumsum(counts) - counts
        s_sorted = seg[order]
        pos = np.arange(n) - starts[s_sorted]
        top = int(counts.max(initial=0))
        if top <= width:
            tab = np.full((n_seg, max(top, 1)), n, np.int64)
            tab[s_sorted, pos] = order
            tables.append(tab)
            return tables
        n_chunks = -(-counts // width)
        chunk_base = np.cumsum(n_chunks) - n_chunks
        rows = int(n_chunks.sum())
        tab = np.full((rows, width), n, np.int64)
        tab[chunk_base[s_sorted] + pos // width, pos % width] = order
        tables.append(tab)
        seg = np.repeat(np.arange(n_seg), n_chunks)


def segment_sum(data: torch.Tensor, tables) -> torch.Tensor:
    """Apply :func:`segment_tables`: [N, ...] -> [n_seg, ...]."""
    x = data
    for tab in tables:
        x = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])[tab].sum(dim=1)
    return x


class AssemblyPlan(NamedTuple):
    """The gather tables of one window's block sums (loop-invariant)."""

    g_c: list     # [rA; rB] -> C
    h_cc: list    # [aa; bb; ab; ab^T] -> C*C
    lm: list      # rC, cc -> L
    h_cl: list    # [ac; bc] -> C*L
    obs: torch.Tensor  # int64 indices of the valid observations


def assembly_plan(obs_cam, obs_lm, lm_base, obs_valid, C: int, L: int,
                  device) -> AssemblyPlan:
    """Host-side gather tables for the block sums of a window (numpy
    index arrays in); padded observations (``obs_valid`` False) are left
    out, since their weight is zero."""
    sel = np.nonzero(np.asarray(obs_valid))[0]
    a = np.asarray(obs_cam, np.int64)[sel]
    li = np.asarray(obs_lm, np.int64)[sel]
    b = np.asarray(lm_base, np.int64)[li]

    def up(tabs):
        return [torch.as_tensor(t, device=device) for t in tabs]

    return AssemblyPlan(
        g_c=up(segment_tables(np.concatenate([a, b]), C)),
        h_cc=up(segment_tables(np.concatenate([a * C + a, b * C + b, a * C + b, b * C + a]),
                               C * C)),
        lm=up(segment_tables(li, L)),
        h_cl=up(segment_tables(np.concatenate([a * L + li, b * L + li]), C * L)),
        obs=torch.as_tensor(sel, device=device),
    )


def _project_residuals(cam_pose, lm_pos, lm_base, obs_cam, obs_lm, obs_px,
                       cam: StereoCamera, eps=1e-6):
    """Residuals and the intermediates of the Jacobians, batched over O."""
    Q_R, Q_t = se3.exp(cam_pose)                              # [C,3,3], [C,3]
    Xw = torch.einsum("lij,lj->li", Q_R[lm_base], lm_pos) + Q_t[lm_base]
    Rc = Q_R[obs_cam]
    tc = Q_t[obs_cam]
    X = Xw[obs_lm]
    x = torch.einsum("oji,oj->oi", Rc, X - tc)                 # R^T (X - t)
    Xc, Yc, Zc = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / torch.clamp(Zc, min=eps)
    ul = cam.cx_l + cam.fx_l * Xc * zi
    vl = cam.cy_l + cam.fy_l * Yc * zi
    ur = cam.cx_r + cam.fx_r * (Xc - cam.baseline) * zi
    r = torch.stack([ul, vl, ur], dim=-1) - obs_px
    return r, x, X, Rc, Q_R


def _dproj(x, cam: StereoCamera, eps=1e-6):
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    zi = 1.0 / torch.clamp(Z, min=eps)
    zi2 = zi * zi
    zeros = torch.zeros_like(X)
    return torch.stack([
        torch.stack([cam.fx_l * zi, zeros, -cam.fx_l * X * zi2], dim=-1),
        torch.stack([zeros, cam.fy_l * zi, -cam.fy_l * Y * zi2], dim=-1),
        torch.stack([cam.fx_r * zi, zeros, -cam.fx_r * (X - cam.baseline) * zi2], dim=-1),
    ], dim=-2)


def _inv3x3(A: torch.Tensor, damp: float = 1e-8) -> torch.Tensor:
    """Batched closed-form 3x3 inverse with a tiny Tikhonov guard."""
    A = A + damp * torch.eye(3, dtype=A.dtype, device=A.device)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _robust_cost(r, w_valid, kernel_param, use_kernel: bool):
    rsq = torch.sum(r * r, dim=-1)
    if use_kernel:
        b2 = kernel_param * kernel_param
        rsq = 2.0 * b2 * (torch.sqrt(1.0 + rsq / b2) - 1.0)
    return torch.sum(rsq * w_valid)


def optimize_window(
    win: BAWindow,
    cam: StereoCamera,
    kernel_param: float = 1.5,
    max_iters: int = 12,
    use_kernel: bool = True,
    init_lambda: float = 1e-4,
    w_prior_rot: float = 1000.0,
    w_prior_trans: float = 100.0,
    stage1_iters: int = 0,
    use_kernel_stage1: bool = True,
    plan: AssemblyPlan | None = None,
) -> BAResult:
    """Optimize one window. ``plan`` (``assembly_plan`` of the window's
    index arrays) saves a device-to-host copy when the caller has them."""
    f32 = torch.float32
    dev = win.cam_pose.device
    C = win.cam_pose.shape[0]
    L_n = win.lm_pos.shape[0]
    if plan is None:
        plan = assembly_plan(win.obs_cam.cpu().numpy(), win.obs_lm.cpu().numpy(),
                             win.lm_base.cpu().numpy(), win.obs_valid.cpu().numpy(),
                             C, L_n, dev)
    lm_base = win.lm_base.long()
    obs_cam = win.obs_cam.long()
    obs_lm = win.obs_lm.long()
    kp = torch.tensor(kernel_param, dtype=f32, device=dev)
    obs_w = win.obs_valid.to(f32)
    lm_w = win.lm_valid.to(f32)
    free_cam = win.cam_valid & (torch.arange(C, device=dev) != 0)
    free6 = torch.repeat_interleave(free_cam, 6)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    # init-anchor pose prior (a deliberate deviation from the reference
    # SRBA objective, as in the JAX package): every free camera is tied to
    # its spanning-tree init pose with weights w_prior_rot (twist, rad) and
    # w_prior_trans (m), so a small aliased consensus cannot fold the map
    init_R, init_t = se3.exp(win.cam_pose)
    prior_w6 = torch.tensor([w_prior_rot] * 3 + [w_prior_trans] * 3, dtype=f32, device=dev)

    def prior_residual(cam_pose):
        Rq, tq = se3.exp(cam_pose)
        dR = torch.einsum("cij,ckj->cik", Rq, init_R)
        w = se3.so3_log(dR)
        dt = tq - torch.einsum("cij,cj->ci", dR, init_t)
        return w, dt

    def prior_cost(cam_pose):
        w, dt = prior_residual(cam_pose)
        m = free_cam.to(f32)
        return torch.sum(m * (prior_w6[0] * torch.sum(w * w, -1)
                              + prior_w6[3] * torch.sum(dt * dt, -1)))

    def residuals(cam_pose, lm_pos):
        return _project_residuals(cam_pose, lm_pos, lm_base, obs_cam, obs_lm,
                                  win.obs_px, cam)

    def cost_of(cam_pose, lm_pos, kern):
        r = residuals(cam_pose, lm_pos)[0]
        return _robust_cost(r, obs_w, kp, kern) + prior_cost(cam_pose)

    def rmse_of(cam_pose, lm_pos):
        r = residuals(cam_pose, lm_pos)[0]
        n_obs = torch.clamp(torch.sum(obs_w), min=1.0)
        return torch.sqrt(torch.sum(torch.sum(r * r, -1) * obs_w) / n_obs)

    def assemble(r, wJA, wJB, wJC, JA, JB, JC, skip_lms):
        o = plan.obs
        r, wJA, wJB, wJC, JA, JB, JC = (t[o] for t in (r, wJA, wJB, wJC, JA, JB, JC))
        rA = torch.einsum("oij,oi->oj", wJA, r)
        rB = torch.einsum("oij,oi->oj", wJB, r)
        aa = torch.einsum("oij,oik->ojk", wJA, JA)
        bb = torch.einsum("oij,oik->ojk", wJB, JB)
        ab = torch.einsum("oij,oik->ojk", wJA, JB)
        g_c = segment_sum(torch.cat([rA, rB]), plan.g_c)
        Hcc = segment_sum(torch.cat([aa, bb, ab, ab.transpose(-1, -2)]), plan.h_cc)
        if skip_lms:
            return g_c, None, Hcc, None, None
        rC = torch.einsum("oij,oi->oj", wJC, r)
        ac = torch.einsum("oij,oik->ojk", wJA, JC)
        bc = torch.einsum("oij,oik->ojk", wJB, JC)
        cc = torch.einsum("oij,oik->ojk", wJC, JC)
        g_l = segment_sum(rC, plan.lm)
        Hll = segment_sum(cc, plan.lm)
        Hcl = segment_sum(torch.cat([ac, bc]), plan.h_cl).reshape(C, L_n, 6, 3)
        return g_c, g_l, Hcc, Hcl, Hll

    def lm_step(cam_pose, lm_pos, lam, kern, freeze_lms):
        r, x, X, Rc, Q_R = residuals(cam_pose, lm_pos)
        P = _dproj(x, cam)
        rnorm = torch.linalg.vector_norm(r, dim=-1)
        w_rob = 1.0 / torch.sqrt(1.0 + (rnorm / kp) ** 2) if kern else torch.ones_like(rnorm)
        w = w_rob * obs_w
        RcT = Rc.transpose(-1, -2)
        # dx/d(base twist) = R_c^T [ -[X]x | I ];  dx/d(cam twist) = -that
        dB_rot = torch.einsum("oij,ojk->oik", RcT, -se3.hat(X))
        dB = torch.cat([dB_rot, RcT], dim=-1)
        JB = torch.einsum("oij,ojk->oik", P, dB)
        JA = -JB
        Rb = Q_R[lm_base][obs_lm]
        dP = torch.einsum("oij,ojk->oik", RcT, Rb)              # dx/dp = R_c^T R_base
        JC = torch.einsum("oij,ojk->oik", P, dP)
        wJA, wJB, wJC = (J * w[:, None, None] for J in (JA, JB, JC))

        g_c, g_l, Hcc, Hcl, Hll = assemble(r, wJA, wJB, wJC, JA, JB, JC, freeze_lms)
        pw, pdt = prior_residual(cam_pose)
        g_c = g_c + torch.cat([pw, pdt], -1) * prior_w6[None, :]
        diag = torch.arange(C, device=dev) * (C + 1)
        Hcc = Hcc.clone()
        Hcc[diag] = Hcc[diag] + prior_w6[None, :, None] * eye6[None]
        if freeze_lms:
            # pose-only stage 1: landmarks held, plain Hcc, no Schur step
            S = Hcc.reshape(C, C, 6, 6)
            rhs = g_c
        else:
            Hll = Hll + (lam + 1e-6) * eye3[None]
            Hll = torch.where(lm_w[:, None, None] > 0, Hll, eye3[None])
            g_l = g_l * lm_w[:, None]
            Hll_inv = _inv3x3(Hll)
            W = torch.einsum("clij,ljk->clik", Hcl, Hll_inv)
            S = Hcc.reshape(C, C, 6, 6) - torch.einsum("clij,dlkj->cdik", W, Hcl)
            rhs = g_c - torch.einsum("clij,lj->ci", W, g_l)

        S = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        S = S + lam * torch.diag(torch.diagonal(S)) + 1e-8 * torch.eye(C * 6, dtype=f32,
                                                                       device=dev)
        rhs_f = rhs.reshape(C * 6)
        S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + torch.diag(torch.where(free6, 0.0, 1.0))
        rhs_f = torch.where(free6, rhs_f, 0.0)
        Lchol, info = torch.linalg.cholesky_ex(S)
        dc = -torch.cholesky_solve(rhs_f[:, None], Lchol)[:, 0]
        ok = torch.all(torch.isfinite(dc)) & (info == 0)
        dc = torch.where(ok, dc, 0.0).reshape(C, 6)
        # predicted decrease of the local quadratic model (~0 at convergence)
        pred = -torch.sum(dc.reshape(-1) * rhs_f)
        if freeze_lms:
            dl = torch.zeros_like(lm_pos)
        else:
            corr = torch.einsum("clij,ci->lj", Hcl, dc)
            dl = -torch.einsum("lij,lj->li", Hll_inv, g_l + corr)
            dl = dl * lm_w[:, None]
            pred = pred - torch.sum(dl * g_l)
        dR = se3.so3_exp(dc[:, :3])
        Rq, tq = se3.exp(cam_pose)
        R_new = torch.einsum("cij,cjk->cik", dR, Rq)
        t_new = torch.einsum("cij,cj->ci", dR, tq) + dc[:, 3:]
        cam_new = torch.where(free_cam[:, None], se3.log(R_new, t_new), cam_pose)
        return cam_new, lm_pos + dl, ok, pred

    def run_loop(cam_pose, lm_pos, n_iters, kern, freeze_lms):
        """The LM loop. Its exit test is read on the host each iteration.
        Stops once accepted steps stop improving (3 sub-1e-6 relative
        decreases, or a vanishing predicted decrease), or after 6 rejected
        steps in a row."""
        cost = cost_of(cam_pose, lm_pos, kern)
        lam = torch.tensor(init_lambda, dtype=f32, device=dev)
        zero = torch.tensor(0, dtype=torch.int32, device=dev)
        iters, stall, rejects = zero, zero, zero
        for _ in range(n_iters):
            cam_new, lm_new, ok, pred = lm_step(cam_pose, lm_pos, lam, kern, freeze_lms)
            new_cost = cost_of(cam_new, lm_new, kern)
            accept = ok & (new_cost < cost)
            improving = accept & (cost - new_cost > 1e-6 * cost)
            converged = ok & (torch.abs(pred) < 1e-8 * (cost + 1.0))
            stall = torch.where(improving, 0, torch.where(accept, stall + 1, stall))
            stall = torch.where(converged, 3, stall)
            rejects = torch.where(accept, 0, rejects + 1)
            cam_pose = torch.where(accept, cam_new, cam_pose)
            lm_pos = torch.where(accept, lm_new, lm_pos)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.where(accept, torch.clamp(lam * 0.4, min=1e-7),
                              torch.clamp(lam * 6.0, max=1e3))
            iters = iters + accept.to(torch.int32)
            if not bool(((stall < 3) & (rejects < 6)).item()):
                break
        return cam_pose, lm_pos, iters

    cost0 = cost_of(win.cam_pose, win.lm_pos, use_kernel)
    cam_pose, lm_pos = win.cam_pose, win.lm_pos
    if stage1_iters > 0:
        # stage 1 (≙ SRBA's first pass over the new kf2kf edges, kernel flag
        # use_robust_kernel_stage1, reference .cpp:1159): pose-only
        cam_pose, lm_pos, _ = run_loop(cam_pose, lm_pos, stage1_iters, use_kernel_stage1,
                                       True)
    rmse_stg1 = rmse_of(cam_pose, lm_pos)
    cam_pose, lm_pos, iters = run_loop(cam_pose, lm_pos, max_iters, use_kernel, False)
    cost = cost_of(cam_pose, lm_pos, use_kernel)
    rmse = rmse_of(cam_pose, lm_pos)
    return BAResult(cam_pose, lm_pos, cost0, cost, rmse, iters, rmse_stg1)
