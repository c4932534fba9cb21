"""The plain reference of the stereo frontend, in any floating type.

Written from the reference system's definitions (famoreno/srba-stereo-slam
with its stereo-vo frontend, as the program documents them): the
radial-tangential undistortion map and its bilinear remap; FAST-9/16 corner
scores (OpenCV's score: the largest threshold at which a pixel stays a
corner); a (2r+1)^2 non-maximum suppression keyed by a row-major tiebreak;
one winner per 5x5 cell and the global top K; OpenCV ORB's 7x7 sigma-2
pre-blur and upright 256-bit BRIEF tests of ``bit_pattern_31_``; epipolar
gated stereo matching by Hamming distance, unique per right feature; and
stereo triangulation. Every stage is plain torch on whatever device its
inputs are on, computed in ``dtype`` (float32 as the configurations state;
a lower type for the control). It imports nothing of the program.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))
BIG = 1e9

# OpenCV's bit_pattern_31_ rows (x1, y1, x2, y2), rounded to whole pixels
_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern_opencv.npy"))
PATTERN = np.rint(_PATTERN.astype(np.float64)).astype(np.int64)[:, [1, 0, 3, 2]]  # dy dx dy dx
_G7 = np.exp(-((np.arange(7) - 3.0) ** 2) / (2.0 * 2.0**2))
G7 = [float(v) for v in (_G7 / _G7.sum()).astype(np.float32)]


class Maps(NamedTuple):
    map_y: torch.Tensor
    map_x: torch.Tensor


def build_maps(width, height, fx, fy, cx, cy, dist, device="cpu") -> Maps:
    """For each pinhole pixel, where the distorted (raw) image holds it."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    x, y = (us - cx) / fx, (vs - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return Maps(torch.from_numpy((yd * fy + cy).astype(np.float32)).to(device),
                torch.from_numpy((xd * fx + cx).astype(np.float32)).to(device))


def remap_bilinear(img: torch.Tensor, maps: Maps, dtype=torch.float32) -> torch.Tensor:
    """Bilinear sample of ``img`` [..., H, W] at the maps, the border clamped."""
    img = img.to(dtype)
    h, w = img.shape[-2:]
    y = torch.clamp(maps.map_y.to(dtype), 0.0, h - 1.0)
    x = torch.clamp(maps.map_x.to(dtype), 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    fy, fx = y - y0, x - x0
    flat = img.reshape(*img.shape[:-2], h * w)

    def at(yy, xx):
        return flat[..., yy * w + xx]

    return (at(y0, x0) * (1 - fy) * (1 - fx) + at(y0, x0 + 1) * (1 - fy) * fx
            + at(y0 + 1, x0) * fy * (1 - fx) + at(y0 + 1, x0 + 1) * fy * fx)


def fast_scores(img: torch.Tensor, threshold: torch.Tensor, margin: int = 16,
                dtype=torch.float32) -> torch.Tensor:
    """FAST-9/16 scores of ``img`` [N, H, W]: for each pixel the largest t
    such that 9 contiguous circle pixels are all brighter than it by more
    than t, or all darker; 0 at or below ``threshold`` [N] and in the margin."""
    img = img.to(dtype)
    h, w = img.shape[-2:]
    d = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) for dy, dx in CIRCLE]) - img
    idx = torch.arange(16, device=img.device)
    lo, hi = d, d
    for s in range(1, 9):       # the 16 arcs of 9 contiguous circle pixels
        lo, hi = torch.minimum(lo, d[(idx + s) % 16]), torch.maximum(hi, d[(idx + s) % 16])
    bright = torch.amax(lo, dim=0)
    dark = -torch.amin(hi, dim=0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold.to(dtype)[:, None, None], score, 0.0)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return torch.where(inside, score, 0.0)


def suppress(score: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Keep a pixel where its key, score - eps * (row-major index), is the
    largest of its (2r+1)^2 window; eps = f32(1e-3 / (H W))."""
    n, h, w = score.shape
    eps = torch.tensor(float(np.float32(1e-3 / (h * w))), dtype=score.dtype, device=score.device)
    ridx = torch.arange(h * w, device=score.device, dtype=torch.int32).reshape(h, w).to(score.dtype)
    keyed = score - eps * ridx
    k = 2 * radius + 1
    pooled = F.max_pool2d(keyed[:, None], k, stride=1, padding=radius)[:, 0]
    return torch.where((keyed >= pooled) & (score > 0.0), score, 0.0)


def cell_topk(score: torch.Tensor, cell: int, k: int):
    """The best pixel of each ``cell`` x ``cell`` cell (the first on ties),
    then the k best cells (ties to the lower cell): ys, xs, scores, valid."""
    n, h, w = score.shape
    gh, gw = h // cell, w // cell
    cells = score[:, :gh * cell, :gw * cell].reshape(n, gh, cell, gw, cell)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(n, gh * gw, cell * cell)
    best, arg = torch.amax(cells, -1), torch.argmax(cells, -1)
    top = torch.sort(best, dim=-1, descending=True, stable=True).indices[:, :k]
    sc = torch.gather(best, 1, top)
    inner = torch.gather(arg, 1, top)
    valid = sc > 0
    ys = torch.where(valid, (top // gw) * cell + inner // cell, 0).to(torch.int32)
    xs = torch.where(valid, (top % gw) * cell + inner % cell, 0).to(torch.int32)
    return ys, xs, torch.where(valid, sc, 0.0), valid


def blur7(img: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """OpenCV ORB's GaussianBlur(7, sigma 2), zero-padded, then rounded."""
    x = img.to(dtype)
    h, w = x.shape[-2:]
    g = [torch.tensor(v, dtype=dtype) for v in G7]
    xp = F.pad(x, (0, 0, 3, 3))
    acc = g[0].to(x.device) * xp[..., 0:h, :]
    for i in range(1, 7):
        acc = acc + g[i].to(x.device) * xp[..., i:i + h, :]
    xp = F.pad(acc, (3, 3, 0, 0))
    acc = g[0].to(x.device) * xp[..., :, 0:w]
    for i in range(1, 7):
        acc = acc + g[i].to(x.device) * xp[..., :, i:i + w]
    return torch.round(acc)


def brief(blurred: torch.Tensor, ys, xs, valid) -> torch.Tensor:
    """Upright BRIEF: bit i is 1 where the blurred sample at the pattern's
    first point is darker than at its second (samples clamped into the
    image); 8 int32 words a keypoint, bit i in bit i % 32 of word i // 32."""
    n, h, w = blurred.shape
    k = ys.shape[-1]
    off = torch.as_tensor(PATTERN, device=blurred.device)
    y, x = ys.to(torch.int64)[..., None], xs.to(torch.int64)[..., None]
    flat = blurred.reshape(n, h * w)

    def sample(dy, dx):
        idx = torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1)
        return torch.gather(flat, 1, idx.reshape(n, -1)).reshape(n, k, 256)

    bits = (sample(off[:, 0], off[:, 1]) < sample(off[:, 2], off[:, 3])).to(torch.int64)
    words = torch.sum(bits.reshape(n, k, 8, 32) << torch.arange(32, device=bits.device), -1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    return torch.where(valid[..., None], words, 0)


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distances [..., N, M] of int32 words [..., N, 8] and [..., M, 8]."""
    x = torch.bitwise_xor(a[..., :, None, :], b[..., None, :, :]).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return torch.sum(((x * 0x01010101) >> 24) & 0xFF, -1).to(torch.float32)


def best_unique(dist: torch.Tensor, gate: torch.Tensor, max_dist):
    """Each row's nearest allowed column within ``max_dist``; a column taken
    by several rows stays with the nearest (the lowest row on ties)."""
    n, m = dist.shape
    d = torch.where(gate, dist, BIG)
    j = torch.argmin(d, -1)
    bd = torch.amin(d, -1)
    valid = bd <= max_dist
    key = torch.where(valid, bd * n + torch.arange(n, device=d.device, dtype=torch.float32), BIG)
    col = torch.full((m,), BIG, device=d.device).scatter_reduce(0, j, key, "amin")
    valid = valid & (key == col[j])
    return torch.where(valid, j, 0), valid


class Features(NamedTuple):
    ys_l: torch.Tensor
    xs_l: torch.Tensor
    valid_l: torch.Tensor
    desc_l: torch.Tensor
    ys_r: torch.Tensor
    xs_r: torch.Tensor
    valid_r: torch.Tensor
    desc_r: torch.Tensor
    m_r_idx: torch.Tensor
    m_valid: torch.Tensor
    pts3d: torch.Tensor


def frontend(left, right, cam: dict, fast_th: float, orb_th: float, k: int, maps=None,
             cell: int = 5, max_y_diff: float = 2.0, min_disparity: float = 0.1,
             dtype=torch.float32) -> Features:
    """The features of one stereo pair [H, W] (raw, remapped with ``maps``
    when given): detection, descriptors, stereo matches, 3-D points."""
    imgs = torch.stack([left, right])
    if maps is not None:
        imgs = torch.stack([remap_bilinear(imgs[0], maps[0], dtype),
                            remap_bilinear(imgs[1], maps[1], dtype)])
    th = torch.full((2,), float(fast_th), dtype=torch.float32, device=imgs.device)
    s = suppress(fast_scores(imgs, th, dtype=dtype))
    ys, xs, _sc, valid = cell_topk(s, cell, k)
    desc = brief(blur7(imgs, dtype), ys, xs, valid)
    dy = (ys[0][:, None] - ys[1][None, :]).abs().to(dtype)
    disp = (xs[0][:, None] - xs[1][None, :]).to(dtype)
    gate = valid[0][:, None] & valid[1][None, :] & (dy <= max_y_diff) & (disp > min_disparity)
    idx, mv = best_unique(hamming(desc[0], desc[1]), gate, float(orb_th))
    ul, vl, ur = xs[0].to(dtype), ys[0].to(dtype), xs[1][idx].to(dtype)
    den = cam["fx_l"] * (cam["cx_r"] - ur) + cam["fx_r"] * (ul - cam["cx_l"])
    b_d = torch.full_like(den, cam["baseline"]) / den
    pts = torch.stack([b_d * cam["fx_r"] * (ul - cam["cx_l"]), b_d * cam["fx_r"] * (vl - cam["cy_l"]),
                       b_d * cam["fx_l"] * cam["fx_r"]], -1)
    pts = torch.where(mv[:, None], pts, 0.0)
    return Features(ys[0], xs[0], valid[0], desc[0], ys[1], xs[1], valid[1], desc[1],
                    idx.to(torch.int32), mv, pts)
