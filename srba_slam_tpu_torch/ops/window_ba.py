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

Windows come padded to the capacities of one of the engine's buckets
(``models/srba.py``), as in the JAX package: invalid cameras are frozen,
invalid landmarks get an identity block, invalid observations weight 0.
Assembly is deterministic on every device: each block sum is a fixed
gather plus fixed-width sums over a table of the observations that feed
it (``assembly_plan``, built on the host once per solve, of shapes fixed
by the window's capacities), never a float scatter-add, whose order on a
GPU changes from run to run.

JAX's LM ``while_loop`` becomes blocks of ``WBA_EXIT_EVERY`` iterations
whose updates are masked by the loop's ``cond``, so an iteration past the
exit changes nothing and the result does not depend on the period; the
eager loop reads the exit test on the host between blocks only. On a card
each block is one CUDA graph, captured at a shape's first solve, and a
stage's blocks are one launch that tests the exit on the device
(``ops/cuda_graphs.py``).

``shard_window_obs`` lays one window out over a device mesh (≙ the JAX
package's SPMD solve over sharded observations): each device holds a
replica of the camera and landmark state and a contiguous slice of the
observations with its own gather tables, built on the host and sent in
one copy a shard. A CUDA graph belongs to one device, so the solve is
split by device (``_solve_sharded``, ≙ JAX's one SPMD program): in each
round every shard, at the state the lead sent it, computes its cost
terms and its partial gradient and Hessian blocks, one program replay a
shard on its own device (:func:`_shard_terms`); then one replay on the
lead device sums them in shard order, accepts or rejects the step
proposed last round, and proposes the next (the Schur/Cholesky solve),
whose poses and landmarks go back to every shard. The state and the
terms cross devices as copies into the programs' buffers, ordered by
events; the host reads nothing inside a block. Programs are keyed on the
bucket's shapes and the options (:func:`shard_key`), so every window of a
bucket replays them. One round an iteration: a shard's terms at the
proposal give both its cost and, if the lead accepts it, the partials of
the next step (the same state, the same bits as partials taken anew).
``WBA_SHARD_PROGRAMS = False`` runs the LM blocks eagerly, shard by shard
each step, the same bits.
"""

from __future__ import annotations

import functools
import inspect
from typing import NamedTuple

import numpy as np
import torch

from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.utils import se3
from srba_slam_tpu_torch.utils.camera import StereoCamera

_SEG_WIDTH = 32  # items summed per gather row of a segment-sum level
# LM iterations between two tests of a stage's exit (host reads in the
# eager loop, device tests on a card). The result does not depend on it
# (an iteration past the exit changes nothing); it trades tests against
# iterations run past the exit. 8 = the engine's
# opt_iters: a stage is one block, with no read (chip_smoke.py phase 13
# times 1, 2, 4 and 8).
WBA_EXIT_EVERY = 8
# On a CUDA device, each block of WBA_EXIT_EVERY iterations of a stage
# replays as one CUDA graph; eager otherwise.
WBA_GRAPHS = True
# A sharded window solves in rounds of a program a shard and one on the
# lead (_solve_sharded; on the CPU their bodies); False (tests and
# chip_smoke.py only) runs its LM blocks eagerly, the same bits.
WBA_SHARD_PROGRAMS = True


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


class ShardedWindow(NamedTuple):
    """A window laid out over a mesh by :func:`shard_window_obs`."""

    shards: tuple   # BAWindow per mesh device: the state replicated, a slice of the obs;
    #                 the first device's (the mesh's lead) solves and holds the result
    plans: tuple    # AssemblyPlan of each shard's observations, on its device
    bufs: tuple     # each shard's one upload (uint8, on its device), which the two read
    layout: tuple   # the buffers' layout (cuda_graphs.pack), the same for every shard


class BAResult(NamedTuple):
    cam_pose: torch.Tensor   # optimized [C, 6]
    lm_pos: torch.Tensor     # optimized [L, 3]
    cost_init: torch.Tensor  # robust total cost before
    cost_final: torch.Tensor
    obs_rmse: torch.Tensor   # raw pixel RMSE over valid obs after
    iters: torch.Tensor
    obs_rmse_stg1: torch.Tensor  # raw pixel RMSE after the pose-only stage 1


def _fixed_levels(n: int, n_seg: int, width: int) -> list[int]:
    """Row counts of the levels of :func:`segment_tables` with ``fixed``:
    the most that ``n`` items into ``n_seg`` segments can need, whatever
    the segments are. The last level has one row per segment."""
    k = min(n_seg, n)          # segments that can hold an item
    rows, top = [], n          # top: the most items one segment can hold
    while top > width:
        rows.append((rows[-1] if rows else n) // width + k)
        top = -(-top // width)
    return rows + [n_seg]


def segment_tables(seg: np.ndarray, n_seg: int, width: int = _SEG_WIDTH,
                   fixed: bool = False) -> list[np.ndarray]:
    """Gather tables that sum items into segments: item i belongs to
    segment ``seg[i]``, and an item with ``seg[i] < 0`` is left out. Each
    level groups the rows of one segment, in item order, into rows of
    ``width`` (a pad index points at an appended zero row); the last level
    has one row per segment. Memory stays O(items + segments x width)
    however skewed the segments are.

    ``fixed`` gives tables whose shapes depend only on ``len(seg)``,
    ``n_seg`` and ``width`` (:func:`_fixed_levels`): pad rows, and the
    worst case's number of levels (a level past the data's last one has one
    row per segment). Each segment sums the same items at the same places
    of its rows, and the later levels add +0.0 only, so the sums keep
    their bits."""
    seg = np.asarray(seg, np.int64)
    n_in = len(seg)
    bounds = _fixed_levels(n_in, n_seg, width) if fixed else None
    tables = []
    while True:
        idx = np.nonzero(seg >= 0)[0]
        order = idx[np.argsort(seg[idx], kind="stable")]
        s_sorted = seg[order]
        counts = np.bincount(s_sorted, minlength=n_seg)
        starts = np.cumsum(counts) - counts
        pos = np.arange(len(order)) - starts[s_sorted]
        top = int(counts.max(initial=0))
        last = len(tables) == len(bounds) - 1 if fixed else top <= width
        if last:
            tab = np.full((n_seg, width), n_in, np.int64)
            tab[s_sorted, pos] = order
            tables.append(tab)
            return tables
        n_chunks = -(-counts // width)
        chunk_base = np.cumsum(n_chunks) - n_chunks
        rows = int(n_chunks.sum())
        n_rows = bounds[len(tables)] if fixed else rows
        tab = np.full((n_rows, width), n_in, np.int64)
        tab[chunk_base[s_sorted] + pos // width, pos % width] = order
        tables.append(tab)
        seg = np.full(n_rows, -1, np.int64)
        seg[:rows] = np.repeat(np.arange(n_seg), n_chunks)
        n_in = n_rows


def segment_sum(data: torch.Tensor, tables) -> torch.Tensor:
    """Apply :func:`segment_tables`: [N, ...] -> [n_seg, ...]."""
    x = data
    for tab in tables:
        x = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])[tab].sum(dim=1)
    return x


class AssemblyPlan(NamedTuple):
    """The gather tables of one window's block sums (loop-invariant), of
    fixed shapes for the window's (C, L, O)."""

    g_c: list     # [rA; rB] -> C
    h_cc: list    # [aa; bb; ab; ab^T] -> C*C
    lm: list      # rC, cc -> L
    h_cl: list    # [ac; bc] -> C*L


def plan_arrays(obs_cam, obs_lm, lm_base, obs_valid, C: int, L: int) -> AssemblyPlan:
    """The gather tables for the block sums of a window, built on the host
    (numpy index arrays in, numpy int64 tables out). Padded observations
    (``obs_valid`` False) are left out, since their weight is zero; the
    tables' shapes follow (C, L, O) only (:func:`plan_levels`), so every
    window of a bucket solves on the same shapes."""
    valid = np.asarray(obs_valid, bool)
    a = np.where(valid, np.asarray(obs_cam, np.int64), -1)
    li = np.where(valid, np.asarray(obs_lm, np.int64), -1)
    b = np.where(valid, np.asarray(lm_base, np.int64)[np.where(valid, li, 0)], -1)

    def pair(x, y, n):  # segment x * n + y, left out where x is
        return np.where(x >= 0, x * n + y, -1)

    def tables(seg, n_seg):
        return segment_tables(seg, n_seg, fixed=True)

    return AssemblyPlan(
        g_c=tables(np.concatenate([a, b]), C),
        h_cc=tables(np.concatenate([pair(a, a, C), pair(b, b, C), pair(a, b, C),
                                    pair(b, a, C)]), C * C),
        lm=tables(li, L),
        h_cl=tables(np.concatenate([pair(a, li, L), pair(b, li, L)]), C * L),
    )


def plan_levels(C: int, L: int, O: int) -> AssemblyPlan:
    """The number of tables of each field of a (C, L, O) window's plan."""
    return AssemblyPlan(g_c=len(_fixed_levels(2 * O, C, _SEG_WIDTH)),
                        h_cc=len(_fixed_levels(4 * O, C * C, _SEG_WIDTH)),
                        lm=len(_fixed_levels(O, L, _SEG_WIDTH)),
                        h_cl=len(_fixed_levels(2 * O, C * L, _SEG_WIDTH)))


def _plan_to(plan: AssemblyPlan, device) -> AssemblyPlan:
    """A host plan's tables on ``device``, a copy a table."""
    # staged copies: a blocking copy to a card synchronizes the host
    return AssemblyPlan(*([torch.from_numpy(t).to(device, non_blocking=True) for t in field]
                          for field in plan))


def assembly_plan(obs_cam, obs_lm, lm_base, obs_valid, C: int, L: int,
                  device) -> AssemblyPlan:
    """:func:`plan_arrays` on ``device``."""
    return _plan_to(plan_arrays(obs_cam, obs_lm, lm_base, obs_valid, C, L), device)


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


def _prior_residual(k: dict, cam_pose):
    """The init-anchor prior's residual: the left twist from each camera's
    init pose to ``cam_pose``."""
    Rq, tq = se3.exp(cam_pose)
    dR = torch.einsum("cij,ckj->cik", Rq, k["init_R"])
    w = se3.so3_log(dR)
    dt = tq - torch.einsum("cij,cj->ci", dR, k["init_t"])
    return w, dt


def _residuals(k: dict, cam_pose, lm_pos, cam: StereoCamera):
    return _project_residuals(cam_pose, lm_pos, k["lm_base"], k["obs_cam"], k["obs_lm"],
                              k["obs_px"], cam)


def _shards(k: dict) -> list[dict]:
    """The observation tensors of ``k``: one dict a shard of a sharded
    window, else ``k`` itself."""
    return k["shards"] if "shards" in k else [k]


def _summed(parts, dev):
    """The shards' partial sums ``parts`` added on ``dev``, in shard order
    (one part: itself)."""
    total = None
    for p in parts:
        p = p.to(dev)
        total = p if total is None else total + p
    return total


def _shard_residuals(s: dict, cam_pose, lm_pos, cam: StereoCamera):
    """The residuals of shard ``s``'s observations, the state sent to its
    device."""
    dev = s["obs_px"].device
    return _residuals(s, cam_pose.to(dev), lm_pos.to(dev), cam)[0]


def _prior_cost(k: dict, cam_pose):
    """The init-anchor prior's cost at ``cam_pose``."""
    w, dt = _prior_residual(k, cam_pose)
    return torch.sum(k["free_w"] * (k["prior_w6"][0] * torch.sum(w * w, -1)
                                    + k["prior_w6"][3] * torch.sum(dt * dt, -1)))


def _cost(k: dict, cam_pose, lm_pos, cam: StereoCamera, kern: bool):
    robust = _summed([_robust_cost(_shard_residuals(s, cam_pose, lm_pos, cam), s["obs_w"],
                                   s["kp"], kern) for s in _shards(k)], cam_pose.device)
    return robust + _prior_cost(k, cam_pose)


def _rmse(k: dict, cam_pose, lm_pos, cam: StereoCamera):
    sq, n_obs = [], []
    for s in _shards(k):
        r = _shard_residuals(s, cam_pose, lm_pos, cam)
        sq.append(torch.sum(torch.sum(r * r, -1) * s["obs_w"]))
        n_obs.append(torch.sum(s["obs_w"]))
    dev = cam_pose.device
    return _rmse_of(_summed(sq, dev), _summed(n_obs, dev))


def _rmse_of(sq, n_obs):
    """The raw pixel RMSE from the summed squared residuals and the count
    of valid observations."""
    return torch.sqrt(sq / torch.clamp(n_obs, min=1.0))


def _assemble(k: dict, r, wJA, wJB, wJC, JA, JB, JC, skip_lms: bool):
    rA = torch.einsum("oij,oi->oj", wJA, r)
    rB = torch.einsum("oij,oi->oj", wJB, r)
    aa = torch.einsum("oij,oik->ojk", wJA, JA)
    bb = torch.einsum("oij,oik->ojk", wJB, JB)
    ab = torch.einsum("oij,oik->ojk", wJA, JB)
    g_c = segment_sum(torch.cat([rA, rB]), k["g_c"])
    Hcc = segment_sum(torch.cat([aa, bb, ab, ab.transpose(-1, -2)]), k["h_cc"])
    if skip_lms:
        return g_c, None, Hcc, None, None
    rC = torch.einsum("oij,oi->oj", wJC, r)
    ac = torch.einsum("oij,oik->ojk", wJA, JC)
    bc = torch.einsum("oij,oik->ojk", wJB, JC)
    cc = torch.einsum("oij,oik->ojk", wJC, JC)
    g_l = segment_sum(rC, k["lm"])
    Hll = segment_sum(cc, k["lm"])
    Hcl = segment_sum(torch.cat([ac, bc]), k["h_cl"]).reshape(g_c.shape[0],
                                                              k["lm_base"].shape[0], 6, 3)
    return g_c, g_l, Hcc, Hcl, Hll


def _partials(s: dict, cam_pose, lm_pos, cam: StereoCamera, kern: bool, freeze_lms: bool):
    """The gradient and Hessian blocks ``(g_c, g_l, Hcc, Hcl, Hll)`` of the
    observations of ``s`` (a window's, or one shard's on its device)."""
    dev = s["obs_px"].device
    return _partials_at(s, _residuals(s, cam_pose.to(dev), lm_pos.to(dev), cam), cam, kern,
                        freeze_lms)


def _partials_at(s: dict, res: tuple, cam: StereoCamera, kern: bool, freeze_lms: bool):
    """:func:`_partials` from the residuals and intermediates ``res`` of
    :func:`_residuals` at the state."""
    r, x, X, Rc, Q_R = res
    P = _dproj(x, cam)
    rnorm = torch.linalg.vector_norm(r, dim=-1)
    w_rob = 1.0 / torch.sqrt(1.0 + (rnorm / s["kp"]) ** 2) if kern else torch.ones_like(rnorm)
    w = w_rob * s["obs_w"]
    RcT = Rc.transpose(-1, -2)
    # dx/d(base twist) = R_c^T [ -[X]x | I ];  dx/d(cam twist) = -that
    dB_rot = torch.einsum("oij,ojk->oik", RcT, -se3.hat(X))
    dB = torch.cat([dB_rot, RcT], dim=-1)
    JB = torch.einsum("oij,ojk->oik", P, dB)
    JA = -JB
    Rb = Q_R[s["lm_base"]][s["obs_lm"]]
    dP = torch.einsum("oij,ojk->oik", RcT, Rb)              # dx/dp = R_c^T R_base
    JC = torch.einsum("oij,ojk->oik", P, dP)
    wJA, wJB, wJC = (J * w[:, None, None] for J in (JA, JB, JC))
    return _assemble(s, r, wJA, wJB, wJC, JA, JB, JC, freeze_lms)


def _sum_parts(parts, dev) -> tuple:
    """The shards' partials ``parts`` (a tuple of five a shard, None where
    a stage leaves a block out) summed block by block on ``dev``, in shard
    order."""
    return tuple(None if p[0] is None else _summed(p, dev) for p in zip(*parts))


def _lm_step(k: dict, cam_pose, lm_pos, lam, cam: StereoCamera, kern: bool, freeze_lms: bool):
    """One LM step: the proposed poses and landmarks, whether the solve
    was finite, and the predicted decrease of the local quadratic model."""
    parts = [_partials(s, cam_pose, lm_pos, cam, kern, freeze_lms) for s in _shards(k)]
    return _solve_step(k, _sum_parts(parts, cam_pose.device), cam_pose, lm_pos, lam, freeze_lms)


def _solve_step(k: dict, parts: tuple, cam_pose, lm_pos, lam, freeze_lms: bool):
    """:func:`_lm_step` from the window's summed partials ``parts`` at the
    state: the prior, the Schur reduction, the Cholesky solve and the
    update."""
    C = cam_pose.shape[0]
    g_c, g_l, Hcc, Hcl, Hll = parts
    pw, pdt = _prior_residual(k, cam_pose)
    g_c = g_c + torch.cat([pw, pdt], -1) * k["prior_w6"][None, :]
    Hcc = Hcc + k["prior_blocks"]
    if freeze_lms:
        # pose-only stage 1: landmarks held, plain Hcc, no Schur step
        S = Hcc.reshape(C, C, 6, 6)
        rhs = g_c
    else:
        eye3 = k["eye6C"][:3, :3]
        Hll = Hll + (lam + 1e-6) * eye3[None]
        Hll = torch.where(k["lm_w"][:, None, None] > 0, Hll, eye3[None])
        g_l = g_l * k["lm_w"][:, None]
        Hll_inv = _inv3x3(Hll)
        W = torch.einsum("clij,ljk->clik", Hcl, Hll_inv)
        S = Hcc.reshape(C, C, 6, 6) - torch.einsum("clij,dlkj->cdik", W, Hcl)
        rhs = g_c - torch.einsum("clij,lj->ci", W, g_l)

    free6 = k["free6"]
    S = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    S = S + lam * torch.diag(torch.diagonal(S)) + 1e-8 * k["eye6C"]
    rhs_f = rhs.reshape(C * 6)
    S = torch.where(free6[:, None] & free6[None, :], S, 0.0)
    S = S + torch.diag(torch.where(free6, 0.0, 1.0))
    rhs_f = torch.where(free6, rhs_f, 0.0)
    Lchol, info = torch.linalg.cholesky_ex(S)
    dc = -cuda_graphs.cholesky_solve(Lchol, rhs_f)
    ok = torch.all(torch.isfinite(dc)) & (info == 0)
    dc = torch.where(ok, dc, 0.0).reshape(C, 6)
    # predicted decrease of the local quadratic model (~0 at convergence)
    pred = -torch.sum(dc.reshape(-1) * rhs_f)
    if freeze_lms:
        dl = torch.zeros_like(lm_pos)
    else:
        corr = torch.einsum("clij,ci->lj", Hcl, dc)
        dl = -torch.einsum("lij,lj->li", Hll_inv, g_l + corr)
        dl = dl * k["lm_w"][:, None]
        pred = pred - torch.sum(dl * g_l)
    dR = se3.so3_exp(dc[:, :3])
    Rq, tq = se3.exp(cam_pose)
    R_new = torch.einsum("cij,cjk->cik", dR, Rq)
    t_new = torch.einsum("cij,cj->ci", dR, tq) + dc[:, 3:]
    cam_new = torch.where(k["free_cam"][:, None], se3.log(R_new, t_new), cam_pose)
    return cam_new, lm_pos + dl, ok, pred


def _active(c: dict, n_iters: int):
    """JAX's ``cond`` of the LM ``while_loop``."""
    return (c["it"] < n_iters) & (c["stall"] < 3) & (c["rejects"] < 6)


def _update(c: dict, cam_new, lm_new, ok, pred, new_cost, n_iters: int) -> tuple:
    """One LM iteration's masked accept or reject of the proposal
    ``cam_new``, ``lm_new`` (cost ``new_cost``) on the carry ``c``: the new
    carry and whether it accepted."""
    c = dict(c)
    active = _active(c, n_iters)
    cost, stall = c["cost"], c["stall"]
    accept = active & ok & (new_cost < cost)
    improving = accept & (cost - new_cost > 1e-6 * cost)
    converged = ok & (torch.abs(pred) < 1e-8 * (cost + 1.0))
    stall = torch.where(improving, 0, torch.where(accept, stall + 1, stall))
    stall = torch.where(converged, 3, stall)
    c["stall"] = torch.where(active, stall, c["stall"])
    c["rejects"] = torch.where(active, torch.where(accept, 0, c["rejects"] + 1), c["rejects"])
    c["cam_pose"] = torch.where(accept, cam_new, c["cam_pose"])
    c["lm_pos"] = torch.where(accept, lm_new, c["lm_pos"])
    c["cost"] = torch.where(accept, new_cost, cost)
    c["lam"] = torch.where(active, torch.where(accept, torch.clamp(c["lam"] * 0.4, min=1e-7),
                                               torch.clamp(c["lam"] * 6.0, max=1e3)),
                           c["lam"])
    c["iters"] = c["iters"] + accept.to(torch.int32)
    c["it"] = c["it"] + active.to(torch.int32)
    return c, accept


def _lm_block(c: dict, k: dict, n: int, n_iters: int, cam: StereoCamera, kern: bool,
              freeze_lms: bool) -> dict:
    """``n`` LM iterations on the carry ``c`` (cam_pose, lm_pos, cost, lam,
    iters, it, stall, rejects) over the window's tensors ``k``; returns the
    new carry with ``more``, "the loop is still active". Every update is
    masked by the loop's ``cond``, so an iteration past the exit changes
    nothing. No host read."""
    for _ in range(n):
        cam_new, lm_new, ok, pred = _lm_step(k, c["cam_pose"], c["lm_pos"], c["lam"], cam,
                                             kern, freeze_lms)
        new_cost = _cost(k, cam_new, lm_new, cam, kern)
        c, _accept = _update(c, cam_new, lm_new, ok, pred, new_cost, n_iters)
    c = dict(c)
    c["more"] = _active(c, n_iters)
    return c


def _run_stage(k: dict, cam_pose, lm_pos, n_iters: int, cam: StereoCamera, kern: bool,
               freeze_lms: bool, init_lambda: float):
    """JAX's LM ``while_loop``: up to ``n_iters`` iterations, stopping once
    accepted steps stop improving (3 sub-1e-6 relative decreases, or a
    vanishing predicted decrease), or after 6 rejected steps in a row. In
    blocks of ``WBA_EXIT_EVERY`` iterations, each a CUDA graph on a card
    (``WBA_GRAPHS``; eager for a sharded window, whose blocks this runs only
    with ``WBA_SHARD_PROGRAMS`` off: its programs' route is
    :func:`_solve_sharded`); the host reads the exit test between blocks
    only."""
    dev = cam_pose.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    c = dict(cam_pose=cam_pose, lm_pos=lm_pos, cost=_cost(k, cam_pose, lm_pos, cam, kern),
             lam=torch.full((), init_lambda, dtype=torch.float32, device=dev), iters=zero,
             it=zero, stall=zero, rejects=zero, more=torch.ones((), dtype=torch.bool, device=dev))
    n = max(1, min(WBA_EXIT_EVERY, n_iters))

    def block(c_, k_):
        return _lm_block(c_, k_, n, n_iters, cam, kern, freeze_lms)

    c = cuda_graphs.loop(block, c, k, -(-n_iters // n), ("lm", n, n_iters, cam, kern, freeze_lms),
                         WBA_GRAPHS and "shards" not in k)
    return c["cam_pose"], c["lm_pos"], c["iters"]


def shard_window_obs(win: BAWindow, mesh) -> ShardedWindow:
    """Lay ``win`` out over ``mesh`` (``parallel/batch.py``; ≙ the JAX
    package's ``shard_window_obs``): shard i, on ``mesh.devices[i]``, holds
    a replica of the camera and landmark state and the i-th of
    ``len(mesh.devices)`` contiguous slices of the observations, with its
    slice's gather tables (:func:`plan_arrays`). ``win``'s fields are host
    arrays (the engine's), or tensors, read to the host once. Each shard's
    arrays and tables are built on the host and go to its device in one
    copy (pinned on a card: ``cuda_graphs.pack`` and ``upload``); the
    shard's :class:`BAWindow` and :class:`AssemblyPlan` are views of it. O
    must divide over the mesh: every bucket's O is a power of two.
    :func:`optimize_window` solves the result."""
    arrays = [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in win]
    n = len(mesh.devices)
    n_obs = arrays[5].shape[0]
    if n_obs % n:
        raise ValueError(f"{n_obs} observations do not split over a mesh of {n} devices")
    C, L = arrays[0].shape[0], arrays[2].shape[0]
    m = n_obs // n
    bufs, layout = [], ()
    for i, dev in enumerate(mesh.devices):
        part = arrays[:5] + [a[i * m:(i + 1) * m] for a in arrays[5:]]
        plan = plan_arrays(part[5], part[6], part[3], part[8], C, L)
        buf, layout = cuda_graphs.pack([*part, *(t for field in plan for t in field)])
        bufs.append(cuda_graphs.upload(buf, dev))
    views = [_shard_views(buf, layout) for buf in bufs]
    return ShardedWindow(tuple(v[0] for v in views), tuple(v[1] for v in views), tuple(bufs),
                         layout)


def _shard_views(buf: torch.Tensor, layout: tuple) -> tuple:
    """A shard's :class:`BAWindow` and :class:`AssemblyPlan`, views of its
    buffer ``buf`` (:func:`shard_window_obs`)."""
    arrays = cuda_graphs.unpack(buf, layout)
    win = BAWindow(*arrays[:9])
    tabs = iter(arrays[9:])
    levels = plan_levels(win.cam_pose.shape[0], win.lm_pos.shape[0], win.obs_px.shape[0])
    return win, AssemblyPlan(*([next(tabs) for _ in range(n)] for n in levels))


def _obs_keys(win: BAWindow, plan: AssemblyPlan, kernel_param: float) -> dict:
    """The observation tensors of a window (or of a shard) and its gather
    tables, as the LM step reads them."""
    return dict(lm_base=win.lm_base.long(), obs_cam=win.obs_cam.long(),
                obs_lm=win.obs_lm.long(), obs_px=win.obs_px,
                obs_w=win.obs_valid.to(torch.float32),
                kp=torch.full((), kernel_param, dtype=torch.float32, device=win.obs_px.device),
                **plan._asdict())


def _lead_keys(cam_pose, cam_valid, lm_valid, w_prior_rot: float, w_prior_trans: float) -> dict:
    """The fixed inputs of a window's LM steps that are not its
    observations': masks and the init-anchor prior, from the window's
    initial poses."""
    f32 = torch.float32
    dev = cam_pose.device
    C = cam_pose.shape[0]
    free_cam = cam_valid & (torch.arange(C, device=dev) != 0)
    # init-anchor pose prior (a deliberate deviation from the reference
    # SRBA objective, as in the JAX package): every free camera is tied to
    # its spanning-tree init pose with weights w_prior_rot (twist, rad) and
    # w_prior_trans (m), so a small aliased consensus cannot fold the map
    init_R, init_t = se3.exp(cam_pose)
    # scalars made on the device (torch.full), not copied there: a copy
    # from the host synchronizes it
    prior_w6 = torch.cat([torch.full((3,), w_prior_rot, dtype=f32, device=dev),
                          torch.full((3,), w_prior_trans, dtype=f32, device=dev)])
    on_diag = torch.arange(C * C, device=dev) % (C + 1) == 0
    prior_blocks = torch.where(on_diag[:, None, None], torch.diag(prior_w6), 0.0)
    return dict(lm_w=lm_valid.to(f32), free_cam=free_cam, free_w=free_cam.to(f32),
                free6=free_cam[:, None].expand(C, 6).reshape(-1), prior_w6=prior_w6,
                prior_blocks=prior_blocks, init_R=init_R, init_t=init_t,
                eye6C=torch.eye(C * 6, dtype=f32, device=dev))


def _window_keys(win: BAWindow | ShardedWindow, cam: StereoCamera, kernel_param: float,
                 w_prior_rot: float, w_prior_trans: float, plan: AssemblyPlan | None):
    """The fixed inputs ``k`` of a window's LM steps and the window (the
    lead device's replica of a sharded one's state)."""
    if isinstance(win, ShardedWindow):
        obs = dict(shards=[_obs_keys(w, p, kernel_param) for w, p in zip(win.shards, win.plans)])
        win = win.shards[0]  # the lead device's replica of the state
    else:
        if plan is None:
            plan = assembly_plan(win.obs_cam.cpu().numpy(), win.obs_lm.cpu().numpy(),
                                 win.lm_base.cpu().numpy(), win.obs_valid.cpu().numpy(),
                                 win.cam_pose.shape[0], win.lm_pos.shape[0], win.cam_pose.device)
        obs = _obs_keys(win, plan, kernel_param)
    k = _lead_keys(win.cam_pose, win.cam_valid, win.lm_valid, w_prior_rot, w_prior_trans)
    return dict(k, **obs), win


# ------------------------------------------------- sharded window programs
# The carry of a stage's LM loop (_lm_block's, but ``more``)
_CARRY = ("cam_pose", "lm_pos", "cost", "lam", "iters", "it", "stall", "rejects")


def _shard_terms(a: dict, layout: tuple, cam: StereoCamera, kernel_param: float, kern: bool,
                 freeze_lms: bool) -> dict:
    """A shard's part of one round of a sharded solve (the shard program's
    body), at the state ``a["cam_pose"]``, ``a["lm_pos"]`` that the lead
    sent, over the observations and tables of its buffer ``a["buf"]``:
    ``costs`` [3], its robust cost with the kernel, without it (its sum of
    squared residuals, the RMSE's numerator) and its count of valid
    observations; and ``parts``, its partials (:func:`_partials`) for a
    stage with ``kern`` and ``freeze_lms``."""
    win, plan = _shard_views(a["buf"], layout)
    s = _obs_keys(win, plan, kernel_param)
    res = _residuals(s, a["cam_pose"], a["lm_pos"], cam)
    w = s["obs_w"]
    costs = torch.stack([_robust_cost(res[0], w, s["kp"], True),
                         _robust_cost(res[0], w, s["kp"], False), torch.sum(w)])
    return dict(costs=costs, parts=_partials_at(s, res, cam, kern, freeze_lms))


def _terms(outs: list, j: int, dev):
    """The shards' cost terms ``j`` (:func:`_shard_terms`) summed on ``dev``
    in shard order."""
    return _summed([o["costs"][j] for o in outs], dev)


def _robust_of(outs: list, kern: bool, dev):
    return _terms(outs, 0 if kern else 1, dev)


def _propose(k: dict, c: dict, P: tuple, freeze_lms: bool) -> dict:
    """The carry ``c`` with the summed partials ``P`` at its state and the
    LM step from there (:func:`_solve_step`): the lead's state between two
    rounds."""
    cam_new, lm_new, ok, pred = _solve_step(k, P, c["cam_pose"], c["lm_pos"], c["lam"],
                                            freeze_lms)
    return dict(c, P=P, cam_new=cam_new, lm_new=lm_new, ok=ok, pred=pred)


def _stage_start(k: dict, cam_pose, lm_pos, outs: list, stage: tuple, init_lambda: float
                 ) -> dict:
    """A stage's first carry (``_run_stage``'s) at the state the shards'
    terms ``outs`` were taken at, and its first step."""
    _n_iters, kern, freeze_lms = stage
    dev = cam_pose.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    c = dict(cam_pose=cam_pose, lm_pos=lm_pos,
             cost=_robust_of(outs, kern, dev) + _prior_cost(k, cam_pose),
             lam=torch.full((), init_lambda, dtype=torch.float32, device=dev), iters=zero,
             it=zero, stall=zero, rejects=zero, more=torch.ones((), dtype=torch.bool, device=dev))
    return _propose(k, c, _sum_parts([o["parts"] for o in outs], dev), freeze_lms)


def _lead_begin(a: dict, kw: dict, stage: tuple) -> dict:
    """The lead's first program: the window's fixed inputs ``k``, the
    initial cost ``cost0``, the first stage's carry and step, and, with no
    pose-only stage, the RMSE that stage would leave (``rmse1``)."""
    dev = a["cam_pose"].device
    k = _lead_keys(a["cam_pose"], a["cam_valid"], a["lm_valid"], kw["w_prior_rot"],
                   kw["w_prior_trans"])
    out = dict(k=k, cost0=_robust_of(a["outs"], kw["use_kernel"], dev)
               + _prior_cost(k, a["cam_pose"]),
               t=_stage_start(k, a["cam_pose"], a["lm_pos"], a["outs"], stage,
                              kw["init_lambda"]))
    if kw["stage1_iters"] <= 0:
        out["rmse1"] = _rmse_of(_terms(a["outs"], 1, dev), _terms(a["outs"], 2, dev))
    return out


def _lead_iter(a: dict, stage: tuple) -> dict:
    """One LM iteration on the lead (the lead's iteration program): the
    masked accept of the step proposed last round, at the cost the shards
    took there, then the next step, from the partials they took there
    where it accepted and the kept ones where it did not (the same state,
    so the same bits as partials taken anew)."""
    k, t, outs = a["k"], a["t"], a["outs"]
    n_iters, kern, freeze_lms = stage
    dev = t["cam_pose"].device
    new_cost = _robust_of(outs, kern, dev) + _prior_cost(k, t["cam_new"])
    c, accept = _update({name: t[name] for name in _CARRY}, t["cam_new"], t["lm_new"], t["ok"],
                        t["pred"], new_cost, n_iters)
    c["more"] = _active(c, n_iters)
    new = _sum_parts([o["parts"] for o in outs], dev)
    P = tuple(None if x is None else torch.where(accept, x, p) for x, p in zip(new, t["P"]))
    return _propose(k, c, P, freeze_lms)


def _lead_switch(a: dict, stage: tuple, init_lambda: float) -> dict:
    """From the pose-only stage to the full one, at the state it left: its
    RMSE (``rmse1``) and the full stage's first carry and step."""
    dev = a["cam_pose"].device
    return dict(rmse1=_rmse_of(_terms(a["outs"], 1, dev), _terms(a["outs"], 2, dev)),
                t=_stage_start(a["k"], a["cam_pose"], a["lm_pos"], a["outs"], stage,
                               init_lambda))


def _lead_end(a: dict, kern: bool) -> torch.Tensor:
    """The solve's result row (:func:`result_blob`) at its final state."""
    dev = a["cam_pose"].device
    cost = _robust_of(a["outs"], kern, dev) + _prior_cost(a["k"], a["cam_pose"])
    rmse = _rmse_of(_terms(a["outs"], 1, dev), _terms(a["outs"], 2, dev))
    return result_blob(BAResult(a["cam_pose"], a["lm_pos"], a["cost0"], cost, rmse, None,
                                a["rmse1"]))


def _options(kw: dict) -> dict:
    """Every solve option of :func:`optimize_window`, its defaults filled
    in where ``kw`` leaves one out."""
    bound = inspect.signature(optimize_window).bind(None, None, **kw)
    bound.apply_defaults()
    return {n: v for n, v in bound.arguments.items() if n not in ("win", "cam", "plan")}


def shard_key(win: ShardedWindow, cam: StereoCamera, kw: dict) -> tuple:
    """The key of a sharded window's programs: the bucket, the shards'
    devices, every solve option of :func:`optimize_window` (``kw``, its
    defaults filled in), the camera, and the module settings that shape
    the LM loop (its block length; programs or eager steps). Shapes, not
    addresses: every window of a bucket replays the same programs."""
    w = win.shards[0]
    n_obs = sum(s.obs_px.shape[0] for s in win.shards)
    return ("window_shard", w.cam_pose.shape[0], w.lm_pos.shape[0], n_obs,
            tuple(b.device for b in win.bufs), tuple(sorted(_options(kw).items())), cam,
            WBA_EXIT_EVERY, WBA_SHARD_PROGRAMS)


def _solve_sharded(win: ShardedWindow, cam: StereoCamera, kw: dict) -> tuple:
    """A sharded window's solve (``WBA_SHARD_PROGRAMS``): rounds of one
    program a shard on its device (:func:`_shard_terms`) and one on the
    lead (begin, an iteration, the switch between stages, the end), each a
    program replay on a card and its body on the CPU. Every shard's round
    is queued before the lead's; the state goes to the shards and their
    terms come back as copies into the programs' buffers, ordered by
    events, not by the host. Each stage's iterations run in blocks of
    ``WBA_EXIT_EVERY``, the host reading the exit test between blocks only
    (``cuda_graphs.stop``; none at the engine's 8 iterations). ``kw``:
    :func:`_options`. Returns the result row and the accepted iterations
    of the last stage."""
    stages = ([(kw["stage1_iters"], kw["use_kernel_stage1"], True)]
              if kw["stage1_iters"] > 0 else []) + [(kw["max_iters"], kw["use_kernel"], False)]
    key = shard_key(win, cam, kw)
    lead = win.bufs[0].device

    def run(body, inputs: dict, fixed: dict, role: tuple, dev):
        if dev.type == "cuda":
            return cuda_graphs.program(body, inputs, (*key, *role), fixed=fixed, device=dev)
        return body({**inputs, **fixed})

    def shard_round(cam_pose, lm_pos, stage: tuple) -> list:
        _n, kern, freeze = stage
        body = functools.partial(_shard_terms, layout=win.layout, cam=cam,
                                 kernel_param=kw["kernel_param"], kern=kern, freeze_lms=freeze)
        return [run(body, dict(cam_pose=cam_pose, lm_pos=lm_pos), dict(buf=buf),
                    ("shard", i, kern, freeze), buf.device) for i, buf in enumerate(win.bufs)]

    w0 = win.shards[0]           # the lead's replica of the state
    outs = shard_round(w0.cam_pose, w0.lm_pos, stages[0])
    first = run(functools.partial(_lead_begin, kw=kw, stage=stages[0]),
                dict(cam_pose=w0.cam_pose, cam_valid=w0.cam_valid, lm_pos=w0.lm_pos,
                     lm_valid=w0.lm_valid, outs=outs), {}, ("begin",), lead)
    k, t, cost0, rmse1 = first["k"], first["t"], first["cost0"], first.get("rmse1")
    for si, stage in enumerate(stages):
        if si:
            outs = shard_round(t["cam_pose"], t["lm_pos"], stage)
            nxt = run(functools.partial(_lead_switch, stage=stage, init_lambda=kw["init_lambda"]),
                      dict(cam_pose=t["cam_pose"], lm_pos=t["lm_pos"], outs=outs), dict(k=k),
                      ("switch",), lead)
            t, rmse1 = nxt["t"], nxt["rmse1"]
        n_iters = stage[0]
        n = max(1, min(WBA_EXIT_EVERY, n_iters))
        for b in range(-(-n_iters // n)):
            if cuda_graphs.stop(b, t):
                break
            for _ in range(n):
                outs = shard_round(t["cam_new"], t["lm_new"], stage)
                t = run(functools.partial(_lead_iter, stage=stage), dict(t=t, outs=outs),
                        dict(k=k), ("iter", *stage), lead)
    outs = shard_round(t["cam_pose"], t["lm_pos"], stages[-1])
    blob = run(functools.partial(_lead_end, kern=kw["use_kernel"]),
               dict(cam_pose=t["cam_pose"], lm_pos=t["lm_pos"], cost0=cost0, rmse1=rmse1,
                    outs=outs), dict(k=k), ("end",), lead)
    return blob, t["iters"]


def optimize_window(
    win: BAWindow | ShardedWindow,
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
    index arrays) saves a device-to-host copy when the caller has them. A
    :class:`ShardedWindow` solves over its mesh, the result on the lead
    device (``plan`` unused: each shard has its own): with
    ``WBA_SHARD_PROGRAMS`` as :func:`_solve_sharded`'s programs (the
    result's fields views of its result row), else its LM blocks eagerly,
    the same bits."""
    if isinstance(win, ShardedWindow) and WBA_SHARD_PROGRAMS:
        kw = dict(kernel_param=kernel_param, max_iters=max_iters, use_kernel=use_kernel,
                  init_lambda=init_lambda, w_prior_rot=w_prior_rot, w_prior_trans=w_prior_trans,
                  stage1_iters=stage1_iters, use_kernel_stage1=use_kernel_stage1)
        blob, iters = _solve_sharded(win, cam, kw)
        C, L = win.shards[0].cam_pose.shape[0], win.shards[0].lm_pos.shape[0]
        return BAResult(blob[:C * 6].view(C, 6), blob[C * 6:C * 6 + L * 3].view(L, 3), blob[-4],
                        blob[-3], blob[-2], iters, blob[-1])
    k, win = _window_keys(win, cam, kernel_param, w_prior_rot, w_prior_trans, plan)
    cost0 = _cost(k, win.cam_pose, win.lm_pos, cam, use_kernel)
    cam_pose, lm_pos = win.cam_pose, win.lm_pos
    if stage1_iters > 0:
        # stage 1 (≙ SRBA's first pass over the new kf2kf edges, kernel flag
        # use_robust_kernel_stage1, reference .cpp:1159): pose-only
        cam_pose, lm_pos, _ = _run_stage(k, cam_pose, lm_pos, stage1_iters, cam,
                                         use_kernel_stage1, True, init_lambda)
    rmse_stg1 = _rmse(k, cam_pose, lm_pos, cam)
    cam_pose, lm_pos, iters = _run_stage(k, cam_pose, lm_pos, max_iters, cam, use_kernel,
                                         False, init_lambda)
    cost = _cost(k, cam_pose, lm_pos, cam, use_kernel)
    rmse = _rmse(k, cam_pose, lm_pos, cam)
    return BAResult(cam_pose, lm_pos, cost0, cost, rmse, iters, rmse_stg1)


def optimize_window_blob(win: BAWindow | ShardedWindow, cam: StereoCamera,
                         plan: AssemblyPlan | None = None, **kw) -> torch.Tensor:
    """:func:`optimize_window` as one f32 row (:func:`result_blob`); a
    sharded window's on the program route is its last program's output, so
    no kernel runs after its programs."""
    if isinstance(win, ShardedWindow) and WBA_SHARD_PROGRAMS:
        return _solve_sharded(win, cam, _options(kw))[0]
    return result_blob(optimize_window(win, cam, plan=plan, **kw))


# ---------------------------------------------------------------- groups
def pack_window(cam_pose, cam_valid, lm_pos, lm_base, lm_valid, obs_cam, obs_lm, obs_px,
                obs_valid):
    """Host packing of a window's nine arrays into two, one int32 and one
    float32 (≙ the JAX package's ``pack_window``): a group of windows goes
    to the device as two stacked uploads."""
    ints = np.concatenate([
        np.asarray(lm_base, np.int32), np.asarray(obs_cam, np.int32),
        np.asarray(obs_lm, np.int32), np.asarray(cam_valid, np.int32),
        np.asarray(lm_valid, np.int32), np.asarray(obs_valid, np.int32)])
    floats = np.concatenate([
        np.asarray(cam_pose, np.float32).ravel(), np.asarray(lm_pos, np.float32).ravel(),
        np.asarray(obs_px, np.float32).ravel()])
    return ints, floats


def unpack_window(ints: torch.Tensor, floats: torch.Tensor, C: int, L: int, O: int
                  ) -> BAWindow:
    """The inverse of :func:`pack_window` on the device: views of the two
    tensors (the validity masks as bool)."""
    o = 0
    lm_base = ints[o:o + L]; o += L
    obs_cam = ints[o:o + O]; o += O
    obs_lm = ints[o:o + O]; o += O
    cam_valid = ints[o:o + C] != 0; o += C
    lm_valid = ints[o:o + L] != 0; o += L
    obs_valid = ints[o:o + O] != 0
    f = 0
    cam_pose = floats[f:f + C * 6].reshape(C, 6); f += C * 6
    lm_pos = floats[f:f + L * 3].reshape(L, 3); f += L * 3
    obs_px = floats[f:f + O * 3].reshape(O, 3)
    return BAWindow(cam_pose, cam_valid, lm_pos, lm_base, lm_valid, obs_cam, obs_lm, obs_px,
                    obs_valid)


def packed_plan_arrays(ints: np.ndarray, C: int, L: int, O: int) -> AssemblyPlan:
    """:func:`plan_arrays` of a window from its host ``pack_window`` ints."""
    lm_base, obs_cam, obs_lm = ints[:L], ints[L:L + O], ints[L + O:L + 2 * O]
    obs_valid = ints[L + 2 * O + C + L:] != 0
    return plan_arrays(obs_cam, obs_lm, lm_base, obs_valid, C, L)


def _packed_plan(ints: np.ndarray, C: int, L: int, O: int, device) -> AssemblyPlan:
    """``assembly_plan`` of a window from its host ``pack_window`` ints."""
    return _plan_to(packed_plan_arrays(ints, C, L, O), device)


def result_blob(r: BAResult) -> torch.Tensor:
    """A solve's result as one f32 row ``[cam_pose (C*6) | lm_pos (L*3) |
    cost_init cost_final rmse rmse_stg1]`` (the JAX blob layout)."""
    return torch.cat([r.cam_pose.reshape(-1), r.lm_pos.reshape(-1),
                      torch.stack([r.cost_init, r.cost_final, r.obs_rmse, r.obs_rmse_stg1])])


def optimize_window_packed(ints: torch.Tensor, floats: torch.Tensor, C: int, L: int, O: int,
                           cam: StereoCamera, plan: AssemblyPlan | None = None,
                           **kw) -> BAResult:
    """:func:`optimize_window` of the window packed in ``ints``/``floats``
    (on the device; ``plan`` from the host ints, else read back)."""
    return optimize_window(unpack_window(ints, floats, C, L, O), cam, plan=plan, **kw)


def optimize_window_packed_blob(ints: torch.Tensor, floats: torch.Tensor, C: int, L: int,
                                O: int, cam: StereoCamera, plan: AssemblyPlan | None = None,
                                **kw) -> torch.Tensor:
    """:func:`optimize_window_packed` as one f32 row (:func:`result_blob`)."""
    return result_blob(optimize_window_packed(ints, floats, C, L, O, cam, plan=plan, **kw))


# Windows in a group of the batched window solve: a queued solve waits for
# at most WINDOW_SLOTS - 1 others of its bucket (≙ the JAX package's).
WINDOW_SLOTS = 8
# On a card, a group of window solves (solve_window_group) replays as one
# CUDA-graph program per bucket, valid slots and options; False (tests and
# chip_smoke.py only) solves the valid slots in turn, the same bits.
WBA_GROUP_PROGRAMS = True


def group_upload(ints: np.ndarray, floats: np.ndarray, tables: list, device
                 ) -> tuple[torch.Tensor, tuple]:
    """A group's inputs in one copy to ``device`` (pinned on a card,
    ``cuda_graphs.upload``): the stacked ``pack_window`` ints and floats
    [S, n] and the valid slots' gather tables ``tables`` (a
    :func:`plan_arrays` each), stacked per table [n_valid, rows, width].
    Returns the buffer and its layout (``cuda_graphs.pack``)."""
    # table by table (field after field), the slots' tables stacked
    stacked = [np.stack(t) for t in zip(*([t for field in p for t in field] for p in tables))]
    buf, layout = cuda_graphs.pack([ints, floats, *stacked])
    return cuda_graphs.upload(buf, device), layout


def group_inputs(buf: torch.Tensor, layout: tuple, C: int, L: int, O: int) -> tuple:
    """The inverse of :func:`group_upload` on the device: views of ``buf``,
    ``(ints, floats, plans)``, ``plans`` one :class:`AssemblyPlan` a valid
    slot (views of the stacked tables)."""
    ints, floats, *stacked = cuda_graphs.unpack(buf, layout)
    plans = []
    for j in range(stacked[0].shape[0] if stacked else 0):
        tabs = iter(t[j] for t in stacked)
        plans.append(AssemblyPlan(*([next(tabs) for _ in range(n)]
                                    for n in plan_levels(C, L, O))))
    return ints, floats, plans


def _group_body(buf: torch.Tensor, layout: tuple, valids: tuple, C: int, L: int, O: int,
                cam: StereoCamera, kw: dict, solve) -> torch.Tensor:
    """A group's rows from its uploaded inputs (:func:`group_inputs`): the
    valid slots' one-window solves ``solve`` in turn, each on its own
    tables (a padded slot launches nothing), so each row holds its
    one-window solve's bits; zero for a padded slot (≙ the JAX package's
    default route, ``_VMAP_LO_LIMIT = 0``: a ``lax.scan`` whose
    ``lax.cond`` skips a padded slot; its vmapped lanes are not ported)."""
    ints, floats, plans = group_inputs(buf, layout, C, L, O)
    plans = iter(plans)
    zero = torch.zeros(C * 6 + L * 3 + 4, dtype=torch.float32, device=floats.device)
    return torch.stack([
        result_blob(solve(unpack_window(ints[i], floats[i], C, L, O), cam, plan=next(plans),
                          **kw)) if v else zero for i, v in enumerate(valids)])


def group_key(valids, C: int, L: int, O: int, cam: StereoCamera, kw: dict) -> tuple:
    """The key of a group's program: the bucket, the valid slots, every
    solve option, the camera, and the module settings that shape the LM
    loops (their block length, graphs or eager steps)."""
    return ("window_group", C, L, O, tuple(bool(v) for v in valids),
            tuple(sorted(kw.items())), cam, WBA_EXIT_EVERY, WBA_GRAPHS)


def solve_window_group(ints: np.ndarray, floats: np.ndarray, valids, C: int, L: int, O: int,
                       cam: StereoCamera, device, capture_only: bool = False, solve=None,
                       **kw) -> torch.Tensor | bool:
    """The engine's group of window solves (≙ the JAX package's
    ``optimize_windows_batch_blob``, one jitted program): host
    ``pack_window`` ints and floats [S, n] (a padded slot a copy of a valid
    window), ``valids`` the host's list of the valid slots, the solve
    options ``kw`` of :func:`optimize_window`. The valid slots' gather
    tables are built on the host and go up with the windows in one copy
    (:func:`group_upload`). Returns the [S, C*6 + L*3 + 4] rows on
    ``device`` (:func:`result_blob`, zero for a padded slot), not read.

    On a card (``WBA_GROUP_PROGRAMS``) the group is one replay of its
    program (:func:`group_key`): its valid slots' solves, their LM loops as
    WHILE nodes on the device, the padded rows made in the graph; eager
    otherwise (the one-window solves in turn, the same kernels, the same
    bits). ``capture_only`` captures the program unless it is cached,
    launches nothing, and returns whether it captured (the engine's capture
    ahead; False off the program route). ``solve`` is the one-window solve
    (``optimize_window`` when omitted)."""
    valids = tuple(bool(v) for v in valids)
    device = torch.device(device)
    programs = WBA_GROUP_PROGRAMS and device.type == "cuda"
    if capture_only and not programs:
        return False
    tables = [packed_plan_arrays(ints[i], C, L, O) for i, v in enumerate(valids) if v]
    buf, layout = group_upload(ints, floats, tables, device)

    solve = optimize_window if solve is None else solve

    def body(x):
        return _group_body(x["buf"], layout, valids, C, L, O, cam, kw, solve)

    if programs:
        args = (body, dict(buf=buf), group_key(valids, C, L, O, cam, kw))
        return cuda_graphs.capture(*args) if capture_only else cuda_graphs.program(*args)
    with cuda_graphs.span("eager", device):
        return body(dict(buf=buf))
