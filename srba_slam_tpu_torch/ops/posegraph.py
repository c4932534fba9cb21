"""Global SE(3) pose-graph optimization (the epilogue solver, plain torch).

Counterpart of ``srba_slam_tpu/ops/posegraph.py`` (≙
``mrpt::graphslam::optimize_graph_spa_levmarq`` over the kf2kf graph, reference
src/CSRBAStereoSLAMEstimator.cpp:946-957): given relative-pose constraints
T_uv on edges, find absolute poses minimizing
``Σ_e || log( T_uv^-1 ∘ Q_u^-1 ∘ Q_v ) ||²`` with node 0 as the gauge
anchor. Runs once per sequence, so it favours exactness and simplicity:
the block Jacobian comes from forward-mode AD (``torch.func.jacfwd``)
through the same compose/log code, and the normal equations are solved by
a dense Cholesky, LM-damped with masked accept/reject. The fixed
iteration count of the JAX ``fori_loop`` is a Python loop; nothing in it
reads the device.
"""

from __future__ import annotations

import torch

from srba_slam_tpu_torch.utils import se3


def _apply_delta(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative twist update per node: Q <- exp(delta) ∘ Q."""
    dR = se3.so3_exp(delta[:, :3])
    R, t = se3.exp(poses)
    R_new = torch.einsum("nij,njk->nik", dR, R)
    t_new = torch.einsum("nij,nj->ni", dR, t) + delta[:, 3:]
    return se3.log(R_new, t_new)


def _residuals(poses, eu, ev, rel, edge_w):
    pred = se3.compose(se3.inverse(poses[eu]), poses[ev])   # pose of v in u's frame
    err = se3.compose(se3.inverse(rel), pred)               # ideally identity
    return err * edge_w[:, None]


def optimize_pose_graph(
    poses0: torch.Tensor,      # f32 [N, 6] initial absolute poses
    node_valid: torch.Tensor,  # bool [N]
    eu: torch.Tensor,          # int [E]
    ev: torch.Tensor,          # int [E]
    rel: torch.Tensor,         # f32 [E, 6] measured pose of v in u's frame
    edge_valid: torch.Tensor,  # bool [E]
    max_iters: int = 30,
    init_lambda: float = 1e-4,
):
    """Returns (poses [N,6], cost_init, cost_final, iters)."""
    f32 = torch.float32
    dev = poses0.device
    n = poses0.shape[0]
    eu, ev = eu.long(), ev.long()
    edge_w = edge_valid.to(f32)
    free = node_valid & (torch.arange(n, device=dev) != 0)
    free6 = torch.repeat_interleave(free, 6)
    freef = free[:, None].to(f32)
    eye = torch.eye(n * 6, dtype=f32, device=dev)

    def cost_of(poses):
        r = _residuals(poses, eu, ev, rel, edge_w)
        return torch.sum(r * r)

    def gn_step(poses, lam):
        def r_of_delta(delta_flat):
            delta = delta_flat.reshape(n, 6) * freef
            return _residuals(_apply_delta(poses, delta), eu, ev, rel, edge_w).reshape(-1)

        zero = torch.zeros(n * 6, dtype=f32, device=dev)
        r0 = r_of_delta(zero)
        J = torch.func.jacfwd(r_of_delta)(zero)              # [6E, 6N]
        H = J.T @ J
        g = J.T @ r0
        H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
        H = torch.where(free6[:, None] & free6[None, :], H, 0.0)
        H = H + torch.diag(torch.where(free6, 0.0, 1.0))
        g = torch.where(free6, g, 0.0)
        L, info = torch.linalg.cholesky_ex(H)
        delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = torch.all(torch.isfinite(delta)) & (info == 0)
        delta = torch.where(ok, delta, 0.0).reshape(n, 6) * freef
        return _apply_delta(poses, delta), ok

    poses = poses0
    cost0 = cost_of(poses0)
    cost = cost0
    lam = torch.tensor(init_lambda, dtype=f32, device=dev)
    iters = torch.tensor(0, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        new_poses, ok = gn_step(poses, lam)
        new_cost = cost_of(new_poses)
        accept = ok & (new_cost < cost)
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                          torch.clamp(lam * 8.0, max=1e4))
        iters = iters + accept.to(torch.int32)
    return poses, cost0, cost, iters
