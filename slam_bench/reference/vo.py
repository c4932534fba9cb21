"""The plain reference of a frame's pose: tracking and the robust solve.

The reference system's visual odometry (stereo-vo's brute-force tracking,
``ifmDescBF``, and its two-stage least-squares pose estimate with the
pseudo-Huber kernel, LEAST_SQUARES section): each stereo-matched feature of
the current frame takes its Hamming-nearest stereo-matched feature of the
previous frame within the ORB threshold, unique per previous feature; then
damped Gauss-Newton over (R, t) taking the previous frame's 3-D points onto
the current (ul, vl, ur) pixels, stopping a stage when a step is shorter
than ``min_mod``, after ``max_iters`` steps, or after ``max_incr_cost``
rising costs in a row (the best pose of that stage kept); stage 2 runs on
the correspondences stage 1 leaves within ``residual_threshold`` pixels.
Plain torch in ``dtype``; nothing of the program.
"""

from __future__ import annotations

import torch

from slam_bench.reference.frontend import Features, best_unique, hamming


def track(cur: Features, prev: Features, orb_th: float):
    """For each feature of ``cur``, its match in ``prev`` (index, valid)."""
    gate = cur.m_valid[:, None] & prev.m_valid[None, :]
    return best_unique(hamming(cur.desc_l, prev.desc_l), gate, float(orb_th))


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w)
    W = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(theta2) < 1e-12:
        return eye + (1.0 - theta2 / 6.0) * W + (0.5 - theta2 / 24.0) * (W @ W)
    theta = torch.sqrt(theta2)
    return eye + torch.sin(theta) / theta * W + (1.0 - torch.cos(theta)) / theta2 * (W @ W)


def _residuals(R, t, pts, obs, cam):
    x = pts @ R.T + t
    zi = 1.0 / torch.clamp(x[:, 2], min=1e-6)
    ul = cam["cx_l"] + cam["fx_l"] * x[:, 0] * zi
    vl = cam["cy_l"] + cam["fy_l"] * x[:, 1] * zi
    ur = cam["cx_r"] + cam["fx_r"] * (x[:, 0] - cam["baseline"]) * zi
    return torch.stack([ul, vl, ur], -1) - obs, x


def _jacobian(x, cam):
    X, Y = x[:, 0], x[:, 1]
    zi = 1.0 / torch.clamp(x[:, 2], min=1e-6)
    zi2, z0 = zi * zi, torch.zeros_like(X)
    dr = torch.stack([torch.stack([cam["fx_l"] * zi, z0, -cam["fx_l"] * X * zi2], -1),
                      torch.stack([z0, cam["fy_l"] * zi, -cam["fy_l"] * Y * zi2], -1),
                      torch.stack([cam["fx_r"] * zi, z0,
                                   -cam["fx_r"] * (X - cam["baseline"]) * zi2], -1)], -2)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[0], 3, 3)
    return dr @ torch.cat([-_hat(x), eye], -1)                    # [N, 3, 6]


def _cost(r, w, kp):
    b2 = kp * kp
    return torch.sum(2.0 * b2 * (torch.sqrt(1.0 + torch.sum(r * r, -1) / b2) - 1.0) * w)


def _stage(R, t, pts, obs, w_valid, cam, kp, max_iters, min_mod, max_incr_cost, damping=1e-4):
    best = (R, t, float("inf"))
    prev_cost, incr = float("inf"), 0
    eye6 = torch.eye(6, dtype=pts.dtype, device=pts.device)
    for _ in range(max_iters):
        if incr >= max_incr_cost:
            break
        r, x = _residuals(R, t, pts, obs, cam)
        cost = float(_cost(r, w_valid, kp))
        if cost < best[2]:
            best = (R, t, cost)
        incr = incr + 1 if cost > prev_cost else 0
        prev_cost = cost
        J = _jacobian(x, cam)
        w = w_valid / torch.sqrt(1.0 + (torch.linalg.vector_norm(r, dim=-1) / kp) ** 2)
        H = torch.einsum("nij,n,nik->jk", J, w, J) + damping * eye6
        g = torch.einsum("nij,n,ni->j", J, w, r)
        L, info = torch.linalg.cholesky_ex(H.float() if H.dtype == torch.bfloat16 else H)
        if int(info):
            break
        delta = -torch.cholesky_solve(g.to(L.dtype)[:, None], L)[:, 0].to(pts.dtype)
        if not bool(torch.isfinite(delta).all()):
            break
        dR = so3_exp(delta[:3])
        R, t = dR @ R, dR @ t + delta[3:]
        if float(torch.linalg.vector_norm(delta)) < min_mod:
            break
    r, _ = _residuals(R, t, pts, obs, cam)
    if incr >= max_incr_cost and float(_cost(r, w_valid, kp)) > best[2]:
        R, t = best[0], best[1]
    return R, t


def solve(cur: Features, prev: Features, cam: dict, init_R, init_t, orb_th: float,
          kernel_param: float, residual_threshold: float, min_mod: float, max_iters_initial: int,
          max_iters: int, min_inliers: int, max_incr_cost: int, dtype=torch.float32):
    """The pose (R, t) taking ``prev``'s points into ``cur``'s frame,
    started at (``init_R``, ``init_t``), and whether it is valid (enough
    inliers, finite)."""
    idx, ok = track(cur, prev, orb_th)
    valid = ok & cur.m_valid
    pts = prev.pts3d[idx.long()].to(dtype)
    obs = torch.stack([cur.xs_l, cur.ys_l, cur.xs_r[cur.m_r_idx.long()]], -1).to(dtype)
    kp = torch.tensor(kernel_param, dtype=dtype, device=pts.device)
    R, t = init_R.to(dtype), init_t.to(dtype)
    w1 = valid.to(dtype)
    R, t = _stage(R, t, pts, obs, w1, cam, kp, max_iters_initial, min_mod, max_incr_cost)
    r1, _ = _residuals(R, t, pts, obs, cam)
    inl = valid & (torch.linalg.vector_norm(r1.float(), dim=-1) <= residual_threshold)
    R, t = _stage(R, t, pts, obs, inl.to(dtype), cam, kp, max_iters, min_mod, max_incr_cost)
    good = int(inl.sum()) >= min_inliers and bool(torch.isfinite(R).all() & torch.isfinite(t).all())
    return R.double(), t.double(), good
