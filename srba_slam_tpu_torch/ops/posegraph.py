"""Global SE(3) pose-graph optimization (the epilogue solver, plain torch).

Counterpart of ``srba_slam_tpu/ops/posegraph.py`` (≙
``mrpt::graphslam::optimize_graph_spa_levmarq`` over the kf2kf graph, reference
src/CSRBAStereoSLAMEstimator.cpp:946-957): given relative-pose constraints
T_uv on edges, find absolute poses minimizing
``Σ_e || log( T_uv^-1 ∘ Q_u^-1 ∘ Q_v ) ||²`` with node 0 as the gauge
anchor. Runs once per sequence, so it favours exactness and simplicity:
the block Jacobian comes from forward-mode AD through the same
compose/log code, and the normal equations are solved by a dense
Cholesky, LM-damped with masked accept/reject.

An edge's residual depends only on the tangents of its two nodes, so each
edge's Jacobian is ``[6, 12]``, forward mode over 12 tangents for all
edges at once (``_edge_jacobian``; ``dense_jacobian``, the ``[6E, 6N]``
form JAX builds, stays for the tests to hold it against). ``H`` and ``g``
are summed from the edge blocks by the window solve's deterministic
gather tables, built on the host once per call from the edge arrays (the
caller's host copies, else read back). The fixed iteration count of
JAX's ``fori_loop`` reads nothing from the device. On a card the whole
call is one replay of a CUDA-graph program per shape and options
(``PG_PROGRAM``, ``ops/cuda_graphs.py`` ``program``; ≙ JAX's one jit),
its iterations one WHILE node counted to ``max_iters``; with
``PG_PROGRAM`` off each iteration is a replay of one CUDA graph
(``PG_GRAPHS``), the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from srba_slam_tpu_torch.ops import cuda_graphs
from srba_slam_tpu_torch.ops.window_ba import segment_sum, segment_tables
from srba_slam_tpu_torch.utils import se3

# On a CUDA device, each iteration replays as one CUDA graph; eager otherwise.
PG_GRAPHS = True
# On a CUDA device, the whole call replays as one CUDA-graph program; False
# (tests and chip_smoke.py only) launches its parts from the host, the same
# bits.
PG_PROGRAM = True


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


def _edge_jacobian(poses, eu, ev, rel, edge_w, freef):
    """Each edge's residual ``[E, 6]`` and its Jacobian ``[E, 6, 12]`` in
    the tangents of its nodes ``(δ_u, δ_v)`` (a frozen node's columns are
    zero): forward mode through ``_apply_delta`` and ``_residuals``, one
    pass over 12 copies of the edges, copy j along basis tangent j."""
    n_e = eu.shape[0]
    m = 12 * n_e
    pair = torch.cat([poses[eu], poses[ev]]).repeat(12, 1)
    free = torch.cat([freef[eu], freef[ev]]).repeat(12, 1)
    u_of = torch.arange(m, device=poses.device)
    u_of = u_of + (u_of // n_e) * n_e            # copy j: u at 2jE + e, v at 2jE + E + e
    rel12, w12 = rel.repeat(12, 1), edge_w.repeat(12)

    def r_of(d):
        d = d.reshape(12, n_e, 12)
        q = _apply_delta(pair, torch.cat([d[..., :6], d[..., 6:]], dim=1).reshape(-1, 6) * free)
        return _residuals(q, u_of, u_of + n_e, rel12, w12)

    basis = torch.eye(12, dtype=poses.dtype, device=poses.device)[:, None, :].expand(12, n_e, 12)
    r0, jac = torch.func.jvp(r_of, (torch.zeros_like(basis),), (basis,))
    return r0[:n_e], jac.reshape(12, n_e, 6).permute(1, 2, 0)


def dense_jacobian(poses, eu, ev, rel, edge_w, freef):
    """The ``[6E, 6N]`` Jacobian of all residuals in all node tangents, by
    forward mode over the 6N tangents (the JAX package's form)."""
    n = poses.shape[0]

    def r_of_delta(delta_flat):
        delta = delta_flat.reshape(n, 6) * freef
        return _residuals(_apply_delta(poses, delta), eu, ev, rel, edge_w).reshape(-1)

    return torch.func.jacfwd(r_of_delta)(poses.new_zeros(n * 6))


def _normal_equations(k: dict, poses):
    """``H [6N, 6N]`` and ``g [6N]`` of the Gauss-Newton step, summed from
    the edge blocks by fixed gather tables."""
    n = poses.shape[0]
    r0, J = _edge_jacobian(poses, k["eu"], k["ev"], k["rel"], k["edge_w"], k["freef"])
    Ju, Jv = J[..., :6], J[..., 6:]
    uu = torch.einsum("eij,eik->ejk", Ju, Ju)
    vv = torch.einsum("eij,eik->ejk", Jv, Jv)
    uv = torch.einsum("eij,eik->ejk", Ju, Jv)
    H = segment_sum(torch.cat([uu, vv, uv, uv.transpose(-1, -2)]), k["h"])
    g = segment_sum(torch.cat([torch.einsum("eij,ei->ej", Ju, r0),
                               torch.einsum("eij,ei->ej", Jv, r0)]), k["g"])
    return H.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(n * 6, n * 6), g.reshape(-1)


def _cost(k: dict, poses):
    r = _residuals(poses, k["eu"], k["ev"], k["rel"], k["edge_w"])
    return torch.sum(r * r)


def _iteration(c: dict, k: dict) -> dict:
    """One LM iteration on the carry (poses, cost, lam, iters). No host read."""
    poses, cost, lam = c["poses"], c["cost"], c["lam"]
    free6 = k["free6"]
    H, g = _normal_equations(k, poses)
    H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * k["eye"]
    H = torch.where(free6[:, None] & free6[None, :], H, 0.0)
    H = H + torch.diag(torch.where(free6, 0.0, 1.0))
    g = torch.where(free6, g, 0.0)
    L, info = torch.linalg.cholesky_ex(H)
    delta = -cuda_graphs.cholesky_solve(L, g)
    ok = torch.all(torch.isfinite(delta)) & (info == 0)
    delta = torch.where(ok, delta, 0.0).reshape(-1, 6) * k["freef"]
    new_poses = _apply_delta(poses, delta)
    new_cost = _cost(k, new_poses)
    accept = ok & (new_cost < cost)
    return dict(poses=torch.where(accept, new_poses, poses),
                cost=torch.where(accept, new_cost, cost),
                lam=torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                                torch.clamp(lam * 8.0, max=1e4)),
                iters=c["iters"] + accept.to(torch.int32))


def edge_tables(eu: np.ndarray, ev: np.ndarray, edge_valid: np.ndarray, n: int) -> tuple:
    """The gather tables of H's N x N blocks and of g's N blocks
    (``segment_tables``), built on the host from the edge arrays (invalid
    edges left out: their residuals are zero)."""
    valid = np.asarray(edge_valid, bool)
    u = np.where(valid, np.asarray(eu, np.int64), -1)
    v = np.where(valid, np.asarray(ev, np.int64), -1)

    def pair(x, y):
        return np.where(x >= 0, x * n + y, -1)

    return (segment_tables(np.concatenate([pair(u, u), pair(v, v), pair(u, v), pair(v, u)]),
                           n * n, fixed=True),
            segment_tables(np.concatenate([u, v]), n, fixed=True))


def _solve(x: dict, layout: tuple, n_h: int, max_iters: int, init_lambda: float):
    """The pose graph on the inputs ``x`` (the tables in one buffer,
    ``layout`` its :func:`cuda_graphs.pack` layout, the first ``n_h`` of
    them H's): the initial cost, then the iterations. No host read."""
    f32 = torch.float32
    poses0 = x["poses0"]
    dev = poses0.device
    n = poses0.shape[0]
    free = x["node_valid"] & (torch.arange(n, device=dev) != 0)
    tables = cuda_graphs.unpack(x["tables"], layout)
    k = dict(eu=x["eu"].long(), ev=x["ev"].long(), rel=x["rel"], edge_w=x["edge_valid"].to(f32),
             freef=free[:, None].to(f32), free6=free[:, None].expand(n, 6).reshape(-1),
             eye=torch.eye(n * 6, dtype=f32, device=dev), h=tables[:n_h], g=tables[n_h:])
    cost0 = _cost(k, poses0)
    c = dict(poses=poses0, cost=cost0, lam=torch.full((), init_lambda, dtype=f32, device=dev),
             iters=torch.zeros((), dtype=torch.int32, device=dev))
    c = cuda_graphs.loop(_iteration, c, k, max_iters, ("posegraph",), PG_GRAPHS)
    return c["poses"], cost0, c["cost"], c["iters"]


def optimize_pose_graph(
    poses0: torch.Tensor,      # f32 [N, 6] initial absolute poses
    node_valid: torch.Tensor,  # bool [N]
    eu: torch.Tensor,          # int [E]
    ev: torch.Tensor,          # int [E]
    rel: torch.Tensor,         # f32 [E, 6] measured pose of v in u's frame
    edge_valid: torch.Tensor,  # bool [E]
    max_iters: int = 30,
    init_lambda: float = 1e-4,
    host_edges: tuple | None = None,
):
    """Returns (poses [N,6], cost_init, cost_final, iters). ``host_edges``
    = (eu, ev, edge_valid) as the caller's numpy arrays, equal to the
    tensors: the gather tables are built from them, and nothing is read
    from the device; without them the three are read back."""
    dev = poses0.device
    n = poses0.shape[0]
    if host_edges is None:
        host_edges = tuple(t.cpu().numpy() for t in (eu, ev, edge_valid))
    h, g = edge_tables(*host_edges, n)
    buf, layout = cuda_graphs.pack(h + g)
    x = dict(poses0=poses0, node_valid=node_valid, eu=eu, ev=ev, rel=rel, edge_valid=edge_valid,
             tables=cuda_graphs.upload(buf, dev))

    def body(x_):
        return _solve(x_, layout, len(h), max_iters, init_lambda)

    if PG_PROGRAM and dev.type == "cuda":
        return cuda_graphs.program(body, x, ("posegraph", n, eu.shape[0], max_iters,
                                             init_lambda, PG_GRAPHS))
    return body(x)
