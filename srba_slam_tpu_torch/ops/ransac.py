"""Batched RANSAC fundamental-matrix estimation (plain torch).

Counterpart of ``srba_slam_tpu/ops/ransac.py`` (≙ ``cv::findFundamentalMat
(FM_RANSAC)`` in the reference's DA filter 3, src/CSRBAStereoSLAMEstimator.cpp
:2015-2055): a fixed batch of 8-point hypotheses solved at once through the
unrolled Gram-Schmidt nullspace ``_nullvec_cgs2``, every hypothesis scoring
every correspondence by the symmetric epipolar distance. The hypothesis
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
    """Hartley normalization (masked): zero mean, mean distance sqrt(2)."""
    n = torch.clamp(torch.sum(w), min=1.0)
    mx = torch.sum(x * w) / n
    my = torch.sum(y * w) / n
    d = torch.sqrt((x - mx) ** 2 + (y - my) ** 2)
    s = math.sqrt(2.0) / torch.clamp(torch.sum(d * w) / n, min=1e-9)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, zero, -s * mx]),
        torch.stack([zero, s, -s * my]),
        torch.stack([zero, zero, one]),
    ])
    return (x - mx) * s, (y - my) * s, T


def sample_indices(valid: torch.Tensor, key: torch.Tensor, n_hyp: int) -> torch.Tensor:
    """8 distinct valid correspondence indices per hypothesis, int64
    [n_hyp, 8]: the 8 smallest of an independent uniform per (hypothesis,
    correspondence), invalid ones pushed to 2.0, ties to the lower index."""
    r = prng.uniform(key, (n_hyp, valid.shape[0]))
    r = torch.where(valid[None, :], r, 2.0)
    return torch.sort(r, dim=-1, stable=True).indices[:, :8]


def ransac_fundamental(x1, y1, x2, y2, valid, key, threshold: float = 2.0,
                       n_hyp: int = 128):
    """Estimate F from correspondences (x1,y1) <-> (x2,y2) under ``valid``;
    ``key`` is an ``ops/prng.py`` key. Returns (inliers [K] bool,
    best_inlier_count int32, F [3,3])."""
    f32 = torch.float32
    w = valid.to(f32)
    x1, y1, x2, y2 = (a.to(f32) for a in (x1, y1, x2, y2))
    nx1, ny1, T1 = _normalize_pts(x1, y1, w)
    nx2, ny2, T2 = _normalize_pts(x2, y2, w)

    idx = sample_indices(valid, key, n_hyp)
    a_x1, a_y1 = nx1[idx], ny1[idx]
    a_x2, a_y2 = nx2[idx], ny2[idx]
    ones = torch.ones_like(a_x1)
    # epipolar constraint p2^T F p1 = 0, row = [x2x1 x2y1 x2 y2x1 y2y1 y2 x1 y1 1]
    A = torch.stack([a_x2 * a_x1, a_x2 * a_y1, a_x2, a_y2 * a_x1, a_y2 * a_y1, a_y2,
                     a_x1, a_y1, ones], dim=-1)
    F = _nullvec_cgs2(A).reshape(-1, 3, 3)
    F = torch.einsum("ji,hjk,kl->hil", T2, F, T1)          # F_px = T2^T F T1

    p1 = torch.stack([x1, y1, torch.ones_like(x1)], dim=-1)
    p2 = torch.stack([x2, y2, torch.ones_like(x2)], dim=-1)
    Fp1 = torch.einsum("hij,kj->hki", F, p1)               # lines in image 2
    Ftp2 = torch.einsum("hji,kj->hki", F, p2)              # lines in image 1
    s = torch.einsum("ki,hki->hk", p2, Fp1)
    d2a = s ** 2 / torch.clamp(Fp1[..., 0] ** 2 + Fp1[..., 1] ** 2, min=1e-12)
    d2b = s ** 2 / torch.clamp(Ftp2[..., 0] ** 2 + Ftp2[..., 1] ** 2, min=1e-12)
    d2 = torch.maximum(d2a, d2b)
    inl = (d2 <= threshold * threshold) & valid[None, :]
    counts = torch.sum(inl.to(torch.int32), dim=-1)
    best = torch.argmax(counts)  # first best on ties, as jnp.argmax
    return inl[best], counts[best], F[best]
