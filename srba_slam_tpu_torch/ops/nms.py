"""Non-max suppression and fixed-capacity keypoint selection (plain torch).

Counterpart of ``srba_slam_tpu/ops/nms.py``:

1. local-max NMS: a (2r+1)^2 max-pool of the score keyed by a tiny
   row-major-index tiebreak, so exactly one pixel (the lexically first)
   survives each plateau;
2. grid thinning + top-K: one winner per ``cell``-sized cell, then a global
   top-K over cells into a fixed-capacity, masked keypoint set.

Both keep the JAX package's tie rules bit for bit: the key rounds exactly
as ``score - f32(eps) * f32(y*W + x)``, and the top-K breaks ties toward
the lower cell index as ``jax.lax.top_k`` does (a stable descending sort;
``torch.topk`` gives no such promise).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def nms_eps(h: int, w: int) -> float:
    """The tiebreak step of the NMS key, rounded to float32 as JAX rounds
    the weakly-typed ``1e-3 / (h * w)`` (ops/nms.py in the JAX package)."""
    return float(np.float32(1e-3 / (h * w)))


def local_max_suppress(score: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Zero out pixels of ``score`` [..., H, W] that are not the maximum of
    their (2r+1)^2 window; the window's outside counts as -inf."""
    h, w = score.shape[-2:]
    k = 2 * radius + 1
    ridx = torch.arange(h * w, dtype=torch.int32, device=score.device)
    ridx = ridx.reshape(h, w).to(torch.float32)
    eps = torch.full((), nms_eps(h, w), dtype=torch.float32, device=score.device)
    keyed = score - eps * ridx
    flat = keyed.reshape(-1, 1, h, w)
    pooled = F.max_pool2d(flat, k, stride=1, padding=radius).reshape(keyed.shape)
    return torch.where((keyed >= pooled) & (score > 0.0), score, 0.0)


def grid_topk(score: torch.Tensor, cell: int = 5, k: int = 500):
    """One winner per cell, then the global top-k, for ``score`` [..., H, W].

    Returns (ys, xs, scores, valid), each [..., k]; invalid slots carry
    y = x = 0 and score 0.
    """
    lead = score.shape[:-2]
    h, w = score.shape[-2:]
    gh, gw = h // cell, w // cell
    s = score.reshape(-1, h, w)[:, : gh * cell, : gw * cell]
    b = s.shape[0]
    cells = s.reshape(b, gh, cell, gw, cell).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(b, gh * gw, cell * cell)
    best = torch.amax(cells, dim=-1)            # [B, gh*gw]
    argbest = torch.argmax(cells, dim=-1)       # first index within the cell
    order = torch.sort(best, dim=-1, descending=True, stable=True).indices
    top_cells = order[:, :k]
    top_scores = torch.gather(best, 1, top_cells)
    inner = torch.gather(argbest, 1, top_cells)
    ys = (top_cells // gw) * cell + inner // cell
    xs = (top_cells % gw) * cell + inner % cell
    valid = top_scores > 0.0
    ys = torch.where(valid, ys, 0).to(torch.int32)
    xs = torch.where(valid, xs, 0).to(torch.int32)
    top_scores = torch.where(valid, top_scores, 0.0)
    out_shape = lead + (k,)
    return (ys.reshape(out_shape), xs.reshape(out_shape),
            top_scores.reshape(out_shape), valid.reshape(out_shape))
