"""The plain reference of a window solve: SRBA's windowed stereo bundle
adjustment, Levenberg-Marquardt with a Schur complement over landmarks.

The problem (the reference system's ``solver_LM_schur_dense_cholesky`` over
the optimized window, with the port's documented init-anchor prior): C
keyframes with poses Q_c = (R_c, t_c) relative to the window's root
(camera 0, frozen, and every invalid camera frozen), landmarks p_l in the
frame of their base keyframe, and stereo observations (ul, vl, ur) of a
landmark in a keyframe. The cost is

    sum_o rho(|r_o|^2) + sum_c free_c (w_rot |log(R_c R0_c^T)|^2
                                       + w_trans |t_c - R_c R0_c^T t0_c|^2)

with rho the pseudo-Huber kernel 2 b^2 (sqrt(1 + s / b^2) - 1) (or s) and
(R0_c, t0_c) the window's initial poses. A pose is [rotation vector,
translation]; a step perturbs it on the left. Each iteration builds the
full Jacobian of every observation with respect to its observing and its
base keyframe and its landmark, weights it by the kernel's IRLS weight,
damps the landmark blocks by (lambda + 1e-6) I, reduces to the camera
system, damps that by lambda times its diagonal, and solves it by
Cholesky; a step is kept if it lowers the cost (lambda * 0.4), else
dropped (lambda * 6). A stage stops after its iterations, after 3 kept
steps that lower the cost by under a millionth or one whose predicted
decrease vanishes, or after 6 dropped steps in a row. An optional first
stage moves the poses alone.

Plain torch in ``dtype``, dense per-landmark blocks; nothing of the
program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Window(NamedTuple):
    cam_pose: torch.Tensor   # [C, 6]
    cam_valid: torch.Tensor  # bool [C]
    lm_pos: torch.Tensor     # [L, 3]
    lm_base: torch.Tensor    # int64 [L]
    lm_valid: torch.Tensor   # bool [L]
    obs_cam: torch.Tensor    # int64 [O]
    obs_lm: torch.Tensor     # int64 [O]
    obs_px: torch.Tensor     # [O, 3]
    obs_valid: torch.Tensor  # bool [O]


def unpack(ints, floats, C: int, L: int, O: int, dtype=torch.float64, device="cpu") -> Window:
    """A window from its two packed rows: int32 [lm_base L | obs_cam O |
    obs_lm O | cam_valid C | lm_valid L | obs_valid O] and float32
    [cam_pose C*6 | lm_pos L*3 | obs_px O*3]."""
    i = torch.as_tensor(ints).to(device=device, dtype=torch.int64)
    f = torch.as_tensor(floats).to(device=device, dtype=dtype)
    cuts = [L, O, O, C, L, O]
    lm_base, obs_cam, obs_lm, cam_valid, lm_valid, obs_valid = torch.split(i, cuts)
    cam_pose, lm_pos, obs_px = torch.split(f, [C * 6, L * 3, O * 3])
    return Window(cam_pose.reshape(C, 6), cam_valid != 0, lm_pos.reshape(L, 3), lm_base,
                  lm_valid != 0, obs_cam, obs_lm, obs_px.reshape(O, 3), obs_valid != 0)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rot(w):
    """Rotation matrices of rotation vectors [..., 3] (Rodrigues)."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    W = hat(w)
    small = th2 < 1e-12
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * (W @ W)


def rotvec(R):
    """Rotation vectors of rotation matrices [..., 3, 3], from the skew
    part and the trace (exact near 0; the windows' rotations are small)."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2.0
    s = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)[..., None] / 2.0
    th = torch.atan2(s, c)
    return v * torch.where(s < 1e-12, torch.ones_like(s), th / torch.clamp(s, min=1e-30))


class Problem:
    """A window's fixed data in ``dtype`` and the cost and step on it."""

    def __init__(self, win: Window, cam: dict, kernel_param: float, w_prior_rot: float,
                 w_prior_trans: float, dtype=torch.float64):
        self.dtype = dtype
        self.w = Window(*(x.to(dtype) if x.is_floating_point() else x for x in win))
        self.cam = {k: float(v) for k, v in cam.items()}
        C = win.cam_pose.shape[0]
        self.free = win.cam_valid & (torch.arange(C, device=win.cam_pose.device) != 0)
        self.b = float(kernel_param)
        self.wr, self.wt = float(w_prior_rot), float(w_prior_trans)
        self.R0 = rot(self.w.cam_pose[:, :3])
        self.t0 = self.w.cam_pose[:, 3:]
        self.ov = win.obs_valid.to(dtype)
        self.lv = win.lm_valid

    def residuals(self, pose, lm):
        w, c = self.w, self.cam
        R, t = rot(pose[:, :3]), pose[:, 3:]
        Xw = torch.einsum("lij,lj->li", R[w.lm_base], lm) + t[w.lm_base]
        X = Xw[w.obs_lm]
        Rc = R[w.obs_cam]
        x = torch.einsum("oji,oj->oi", Rc, X - t[w.obs_cam])
        zi = 1.0 / torch.clamp(x[:, 2], min=1e-6)
        px = torch.stack([c["cx_l"] + c["fx_l"] * x[:, 0] * zi, c["cy_l"] + c["fy_l"] * x[:, 1] * zi,
                          c["cx_r"] + c["fx_r"] * (x[:, 0] - c["baseline"]) * zi], -1)
        return px - w.obs_px, x, X, Rc, R

    def prior(self, pose):
        R, t = rot(pose[:, :3]), pose[:, 3:]
        dR = R @ self.R0.transpose(-1, -2)
        return rotvec(dR), t - torch.einsum("cij,cj->ci", dR, self.t0)

    def cost(self, pose, lm, kern: bool):
        r = self.residuals(pose, lm)[0]
        s = torch.sum(r * r, -1)
        if kern:
            s = 2.0 * self.b**2 * (torch.sqrt(1.0 + s / self.b**2) - 1.0)
        pw, pt = self.prior(pose)
        f = self.free.to(self.dtype)
        return torch.sum(s * self.ov) + torch.sum(f * (self.wr * torch.sum(pw * pw, -1)
                                                       + self.wt * torch.sum(pt * pt, -1)))

    def step(self, pose, lm, lam, kern: bool, poses_only: bool):
        """The damped step from (``pose``, ``lm``): the proposal, whether
        the solve was finite, the predicted decrease."""
        w, c, dt = self.w, self.cam, self.dtype
        C, L = pose.shape[0], lm.shape[0]
        r, x, X, Rc, R = self.residuals(pose, lm)
        zi = 1.0 / torch.clamp(x[:, 2], min=1e-6)
        z0 = torch.zeros_like(zi)
        P = torch.stack([
            torch.stack([c["fx_l"] * zi, z0, -c["fx_l"] * x[:, 0] * zi * zi], -1),
            torch.stack([z0, c["fy_l"] * zi, -c["fy_l"] * x[:, 1] * zi * zi], -1),
            torch.stack([c["fx_r"] * zi, z0, -c["fx_r"] * (x[:, 0] - c["baseline"]) * zi * zi], -1),
        ], -2)
        RcT = Rc.transpose(-1, -2)
        # x = R_c^T (R_b p + t_b - t_c): a left step (dw, dt) of the base
        # keyframe moves it by R_c^T (-[X]x dw + dt), of the observing one
        # by the negative of that
        Jb = P @ torch.cat([RcT @ -hat(X), RcT], -1)                    # [O, 3, 6]
        Jl = P @ (RcT @ R[w.lm_base][w.obs_lm])                         # [O, 3, 3]
        rn = torch.linalg.vector_norm(r, dim=-1)
        wo = self.ov / torch.sqrt(1.0 + (rn / self.b) ** 2) if kern else self.ov
        # the camera Jacobian of each observation, dense over the window
        Jc = torch.zeros(r.shape[0], 3, C, 6, dtype=dt, device=r.device)
        o = torch.arange(r.shape[0], device=r.device)
        Jc[o, :, w.lm_base[w.obs_lm]] += Jb
        Jc[o, :, w.obs_cam] -= Jb
        Jc = Jc.reshape(-1, 3, C * 6)
        wJc = Jc * wo[:, None, None]
        Hcc = torch.einsum("oia,oib->ab", wJc, Jc)
        gc = torch.einsum("oia,oi->a", wJc, r)
        pw, pt = self.prior(pose)
        w6 = torch.tensor([self.wr] * 3 + [self.wt] * 3, dtype=dt, device=r.device)
        gc = gc + (torch.cat([pw, pt], -1) * w6).reshape(-1)
        Hcc = Hcc + torch.diag(w6.repeat(C))
        free6 = self.free[:, None].expand(C, 6).reshape(-1)
        eye3 = torch.eye(3, dtype=dt, device=r.device)
        # the small inverses and the Cholesky factor of a lower type in
        # float32 (torch has them in no lower type)
        work = torch.float32 if dt in (torch.bfloat16, torch.float16) else dt
        if poses_only:
            S, rhs = Hcc, gc
        else:
            lmw = self.lv.to(dt)
            Hll = torch.zeros(L, 3, 3, dtype=dt, device=r.device).index_add_(
                0, w.obs_lm, torch.einsum("oij,oik->ojk", Jl * wo[:, None, None], Jl))
            gl = torch.zeros(L, 3, dtype=dt, device=r.device).index_add_(
                0, w.obs_lm, torch.einsum("oij,oi->oj", Jl * wo[:, None, None], r))
            Hcl = torch.zeros(L, C * 6, 3, dtype=dt, device=r.device).index_add_(
                0, w.obs_lm, torch.einsum("oia,oib->oab", wJc, Jl))
            Hll = Hll + (lam + 1e-6) * eye3
            Hll = torch.where(self.lv[:, None, None], Hll, eye3)
            gl = gl * lmw[:, None]
            Hll_inv, bad = torch.linalg.inv_ex((Hll + 1e-8 * eye3).to(work))
            # a block the type cannot invert holds its landmark
            Hll_inv = torch.where((bad != 0)[:, None, None], 0.0, Hll_inv).to(dt)
            Wm = torch.einsum("lab,lbc->lac", Hcl, Hll_inv)             # [L, 6C, 3]
            S = Hcc - torch.einsum("lac,ldc->ad", Wm, Hcl)
            rhs = gc - torch.einsum("lac,lc->a", Wm, gl)
        S = S + lam * torch.diag(torch.diagonal(S)) + 1e-8 * torch.eye(C * 6, dtype=dt, device=r.device)
        S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + torch.diag((~free6).to(dt))
        rhs = torch.where(free6, rhs, 0.0)
        Lc, info = torch.linalg.cholesky_ex(S.to(work))
        dc = -torch.cholesky_solve(rhs.to(work)[:, None], Lc)[:, 0].to(dt)
        ok = bool(torch.isfinite(dc).all()) and int(info) == 0
        if not ok:
            dc = torch.zeros_like(dc)
        pred = -torch.sum(dc * rhs)
        if poses_only:
            dl = torch.zeros_like(lm)
        else:
            dl = -torch.einsum("lij,lj->li", Hll_inv, gl + torch.einsum("lac,a->lc", Hcl, dc))
            dl = dl * lmw[:, None]
            pred = pred - torch.sum(dl * gl)
        dc = dc.reshape(C, 6)
        dR = rot(dc[:, :3])
        Rn = dR @ R
        tn = torch.einsum("cij,cj->ci", dR, pose[:, 3:]) + dc[:, 3:]
        new = torch.where(self.free[:, None], torch.cat([rotvec(Rn), tn], -1), pose)
        return new, lm + dl, ok, float(pred)

    def stage(self, pose, lm, iters: int, kern: bool, poses_only: bool, init_lambda: float):
        cost = float(self.cost(pose, lm, kern))
        lam, stall, rejects = float(init_lambda), 0, 0
        for _ in range(iters):
            if stall >= 3 or rejects >= 6:
                break
            new_p, new_l, ok, pred = self.step(pose, lm, lam, kern, poses_only)
            new_cost = float(self.cost(new_p, new_l, kern))
            accept = ok and new_cost < cost
            if accept:
                stall = 0 if cost - new_cost > 1e-6 * cost else stall + 1
            if ok and abs(pred) < 1e-8 * (cost + 1.0):
                stall = 3
            rejects = 0 if accept else rejects + 1
            if accept:
                pose, lm, cost = new_p, new_l, new_cost
                lam = max(lam * 0.4, 1e-7)
            else:
                lam = min(lam * 6.0, 1e3)
        return pose, lm


def solve(win: Window, cam: dict, kernel_param: float = 1.5, max_iters: int = 12,
          use_kernel: bool = True, init_lambda: float = 1e-4, w_prior_rot: float = 1000.0,
          w_prior_trans: float = 100.0, stage1_iters: int = 0, use_kernel_stage1: bool = True,
          dtype=torch.float64):
    """The window solved in ``dtype``: (poses [C, 6], landmarks [L, 3],
    the cost before, the cost after), the costs in ``dtype``'s own
    arithmetic."""
    pb = Problem(win, cam, kernel_param, w_prior_rot, w_prior_trans, dtype)
    pose, lm = pb.w.cam_pose, pb.w.lm_pos
    cost0 = float(pb.cost(pose, lm, use_kernel))
    if stage1_iters > 0:
        pose, lm = pb.stage(pose, lm, stage1_iters, use_kernel_stage1, True, init_lambda)
    pose, lm = pb.stage(pose, lm, max_iters, use_kernel, False, init_lambda)
    return pose, lm, cost0, float(pb.cost(pose, lm, use_kernel))
