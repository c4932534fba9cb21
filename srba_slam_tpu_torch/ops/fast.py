"""FAST-9/16 corner scores as a whole-image tensor program (plain torch).

Counterpart of ``srba_slam_tpu/ops/fast.py``: the 16 Bresenham-circle taps
are 16 shifted views of the image, and the corner score (the largest
threshold at which the pixel stays a corner, OpenCV's nonmax score) is a
rotate-min/max reduction over the 16 contiguous 9-tap arcs. This is the
plain version of kernel K1 (``ops/hopper_fast.py``); every value is the min
or max of one f32 difference, so any device gives the same bits.
"""

from __future__ import annotations

import torch

# The 16 Bresenham circle offsets (dy, dx), clockwise from 12 o'clock,
# matching the classic FAST-9/16 layout.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y+dy, x+dx]; the border wraps, and the
    wrapped ring is discarded by the margin mask downstream."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _window9(x: torch.Tensor, combine) -> torch.Tensor:
    """combine() over all 9-long circular windows of the leading 16-axis:
    out[i] = combine over x[i..i+8 (mod 16)], as w3 = c(x, x+1, x+2) and
    w9 = c(w3, w3+3, w3+6)."""
    def rot(v, k):
        return torch.roll(v, shifts=-k, dims=0)

    w3 = combine(combine(x, rot(x, 1)), rot(x, 2))
    return combine(combine(w3, rot(w3, 3)), rot(w3, 6))


def fast_score_map(img: torch.Tensor, threshold, margin: int = 16) -> torch.Tensor:
    """FAST-9/16 corner score for every pixel of ``img`` [..., H, W].

    Returns f32 scores, 0 where the pixel is no corner (score <= threshold)
    or lies within ``margin`` pixels of a border. ``threshold`` is a float,
    or an f32 tensor with one threshold per image (``img.shape[:-2]``).
    """
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    circle = torch.stack([_shift(img, dy, dx) for (dy, dx) in CIRCLE])
    d = circle - img[None]
    min9 = _window9(d, torch.minimum)
    max9 = _window9(d, torch.maximum)
    bright = torch.amax(min9, dim=0)
    dark = -torch.amin(max9, dim=0)
    score = torch.maximum(bright, dark)
    if isinstance(threshold, torch.Tensor):
        threshold = threshold.reshape(*img.shape[:-2], 1, 1)
    score = torch.where(score > threshold, score, 0.0)
    if margin > 0:
        ys = torch.arange(h, device=img.device)[:, None]
        xs = torch.arange(w, device=img.device)[None, :]
        inside = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
        score = torch.where(inside, score, 0.0)
    return score
