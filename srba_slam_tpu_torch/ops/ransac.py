"""Batched RANSAC fundamental-matrix estimation (plain torch).

Counterpart of ``srba_slam_tpu/ops/ransac.py`` (≙ ``cv::findFundamentalMat
(FM_RANSAC)`` in the reference's DA filter 3, src/CSRBAStereoSLAMEstimator.cpp
:2015-2055): a fixed batch of 8-point hypotheses solved at once through the
unrolled Gram-Schmidt nullspace ``_nullvec_cgs2``, every hypothesis scoring
every correspondence by the symmetric epipolar distance, over a leading
lane dimension (the DA cascade's candidates run as one batch). The hypothesis
draws come from ``ops/prng.py``, bit-identical to ``jax.random.uniform``,
and the 8 smallest draws per hypothesis are taken by a stable sort, which
orders ties as ``jax.lax.top_k`` does (lower index first).
"""

from __future__ import annotations

import math

import torch

from srba_slam_tpu_torch.ops import prng


def hypotheses_for_prob(fit_prob: float, inlier_ratio: float = 0.7,
                        min_hyp: int = 64, max_hyp: int = 512) -> int:
    """The config's RANSAC confidence as a fixed hypothesis count: the
    standard N = log(1-p) / log(1-w^8) at an assumed post-filter-2 inlier
    ratio, rounded up to a power of two in [min_hyp, max_hyp]."""
    p = min(max(float(fit_prob), 0.5), 1.0 - 1e-9)
    denom = math.log(1.0 - inlier_ratio ** 8)
    n = math.ceil(math.log(1.0 - p) / denom)
    n_hyp = min_hyp
    while n_hyp < n and n_hyp < max_hyp:
        n_hyp *= 2
    return n_hyp


def _nullvec_cgs2(A: torch.Tensor) -> torch.Tensor:
    """Unit nullspace vector of each 8x9 system in ``A`` [NH, 8, 9]:
    classical Gram-Schmidt with reorthogonalization over the 8 rows, then a
    fixed generic vector projected out of their span. Rank-deficient
    samples leave a zero basis row and an arbitrary residual direction
    (that hypothesis just scores few inliers)."""
    nh = A.shape[0]
    Q = torch.zeros((nh, 8, 9), dtype=A.dtype, device=A.device)
    for i in range(8):
        v = A[:, i]
        for _ in range(2):
            c = torch.einsum("hkj,hj->hk", Q, v)
            v = v - torch.einsum("hkj,hk->hj", Q, c)
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = torch.where(n > 1e-12, v / torch.clamp(n, min=1e-30), 0.0)
        Q = torch.cat([Q[:, :i], v[:, None], Q[:, i + 1:]], dim=1)
    g = torch.ones((nh, 9), dtype=A.dtype, device=A.device) \
        + 0.01 * torch.arange(9, dtype=A.dtype, device=A.device)
    for _ in range(2):
        c = torch.einsum("hkj,hj->hk", Q, g)
        g = g - torch.einsum("hkj,hk->hj", Q, c)
    return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True), min=1e-30)


def _normalize_pts(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Hartley normalization (masked) per lane of ``[L, K]``: zero mean,
    mean distance sqrt(2). Returns the normalized points and T [L, 3, 3]."""
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mx = torch.sum(x * w, dim=-1, keepdim=True) / n
    my = torch.sum(y * w, dim=-1, keepdim=True) / n
    d = torch.sqrt((x - mx) ** 2 + (y - my) ** 2)
    s = math.sqrt(2.0) / torch.clamp(torch.sum(d * w, dim=-1, keepdim=True) / n, min=1e-9)
    zero = torch.zeros_like(s[:, 0])
    one = torch.ones_like(zero)
    T = torch.stack([
        torch.stack([s[:, 0], zero, -s[:, 0] * mx[:, 0]], dim=-1),
        torch.stack([zero, s[:, 0], -s[:, 0] * my[:, 0]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return (x - mx) * s, (y - my) * s, T


def sample_indices(valid: torch.Tensor, key: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """8 distinct valid correspondence indices per hypothesis, int64
    [..., n_hyp, 8] for ``valid`` [..., K] and keys [..., 2]: the 8
    smallest of an independent uniform per (hypothesis, correspondence),
    invalid ones pushed to 2.0, ties to the lower index."""
    r = prng.uniform(key, (n_hyp, valid.shape[-1]))
    r = torch.where(valid[..., None, :], r, 2.0)
    return torch.sort(r, dim=-1, stable=True).indices[..., :8]


def ransac_fundamental(x1, y1, x2, y2, valid, key, threshold: float = 2.0,
                       n_hyp: int = 128):
    """Estimate F from correspondences (x1,y1) <-> (x2,y2) under ``valid``;
    ``key`` is an ``ops/prng.py`` key. Every input may carry a leading lane
    dimension (``[L, K]`` points, keys ``[L, 2]``): lane ``j`` is the call
    on its inputs alone. Returns (inliers [K] bool, best_inlier_count
    int32, F [3,3]), each with the lane dimension when given."""
    f32 = torch.float32
    lanes = valid.dim() == 2
    if not lanes:
        x1, y1, x2, y2, valid, key = (a[None] for a in (x1, y1, x2, y2, valid, key))
    n_lanes, k = valid.shape
    w = valid.to(f32)
    x1, y1, x2, y2 = (a.to(f32) for a in (x1, y1, x2, y2))
    nx1, ny1, T1 = _normalize_pts(x1, y1, w)
    nx2, ny2, T2 = _normalize_pts(x2, y2, w)

    idx = sample_indices(valid, key, n_hyp).reshape(n_lanes, n_hyp * 8)
    a_x1, a_y1, a_x2, a_y2 = (torch.gather(a, 1, idx).reshape(n_lanes, n_hyp, 8)
                              for a in (nx1, ny1, nx2, ny2))
    ones = torch.ones_like(a_x1)
    # epipolar constraint p2^T F p1 = 0, row = [x2x1 x2y1 x2 y2x1 y2y1 y2 x1 y1 1]
    A = torch.stack([a_x2 * a_x1, a_x2 * a_y1, a_x2, a_y2 * a_x1, a_y2 * a_y1, a_y2,
                     a_x1, a_y1, ones], dim=-1)
    F = _nullvec_cgs2(A.reshape(n_lanes * n_hyp, 8, 9)).reshape(n_lanes, n_hyp, 3, 3)
    F = torch.einsum("lji,lhjk,lkm->lhim", T2, F, T1)      # F_px = T2^T F T1

    p1 = torch.stack([x1, y1, torch.ones_like(x1)], dim=-1)
    p2 = torch.stack([x2, y2, torch.ones_like(x2)], dim=-1)
    Fp1 = torch.einsum("lhij,lkj->lhki", F, p1)            # lines in image 2
    Ftp2 = torch.einsum("lhji,lkj->lhki", F, p2)           # lines in image 1
    s = torch.einsum("lki,lhki->lhk", p2, Fp1)
    d2a = s ** 2 / torch.clamp(Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2, min=1e-12)
    d2b = s ** 2 / torch.clamp(Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2, min=1e-12)
    d2 = torch.maximum(d2a, d2b)
    inl = (d2 <= threshold * threshold) & valid[:, None, :]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts, dim=-1)  # first best on ties, as jnp.argmax
    lane = torch.arange(n_lanes, device=valid.device)
    out = inl[lane, best], counts[lane, best], F[lane, best]
    return out if lanes else tuple(a[0] for a in out)
