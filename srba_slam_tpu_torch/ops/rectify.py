"""Stereo rectification / undistortion as a bilinear remap.

Counterpart of ``srba_slam_tpu/ops/rectify.py``. The reference delegates
rectification to the stereo-vo engine's RECTIFY stage
(cv::initUndistortRectifyMap + remap; the KITTI demo runs with
``rectified_images=true``, raw rigs like EuRoC do not). Here the remap grids
are computed once on the host, in float64, from the radial-tangential
distortion model and the rectifying rotation; every frame is then one
gather-based bilinear warp on the maps' device. The remapped image is
float32 and not integer-valued, so the detector and descriptor kernels
behind it take their f32 routes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RectifyMaps(NamedTuple):
    """Per-eye sampling grids: output pixel (y, x) samples input (map_y, map_x)."""

    map_y: torch.Tensor  # f32 [H, W]
    map_x: torch.Tensor  # f32 [H, W]


def build_maps(width: int, height: int, fx: float, fy: float, cx: float,
               cy: float, dist=(0.0, 0.0, 0.0, 0.0, 0.0), R=None,
               new_fx=None, new_fy=None, new_cx=None, new_cy=None,
               device="cuda") -> RectifyMaps:
    """≙ cv::initUndistortRectifyMap for the radial-tangential (k1 k2 p1 p2
    k3) model with an optional rectifying rotation R (3x3). The maps land on
    ``device``."""
    k1, k2, p1, p2, k3 = (list(dist) + [0.0] * 5)[:5]
    new_fx = new_fx or fx
    new_fy = new_fy or fy
    new_cx = new_cx if new_cx is not None else cx
    new_cy = new_cy if new_cy is not None else cy
    R = np.eye(3) if R is None else np.asarray(R, np.float64)
    Rinv = R.T

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    x = (us - new_cx) / new_fx
    y = (vs - new_cy) / new_fy
    ones = np.ones_like(x)
    # rotate the ideal ray back into the original camera
    pts = np.stack([x, y, ones], axis=-1) @ Rinv.T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    # apply distortion
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return RectifyMaps(
        map_y=torch.from_numpy((yd * fy + cy).astype(np.float32)).to(device),
        map_x=torch.from_numpy((xd * fx + cx).astype(np.float32)).to(device),
    )


def remap_bilinear(img: torch.Tensor, maps: RectifyMaps) -> torch.Tensor:
    """Bilinear warp of ``img`` [H, W] (uint8 or f32) to f32 [H, W];
    out-of-bounds samples clamp to the border. The four products are summed
    left to right, each rounded."""
    img = img.to(torch.float32)
    h, w = img.shape
    y = torch.clamp(maps.map_y, 0.0, h - 1.0)
    x = torch.clamp(maps.map_x, 0.0, w - 1.0)
    # keep the interpolation cell inside the image; at the far edge the
    # fractional weight reaches exactly 1.0 so the last row/col is exact
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    fy = y - y0
    fx = x - x0
    flat = img.reshape(-1)

    def at(yy, xx):
        return flat[yy * w + xx]

    return (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x0 + 1) * (1 - fy) * fx
        + at(y0 + 1, x0) * fy * (1 - fx)
        + at(y0 + 1, x0 + 1) * fy * fx
    )


def rectify_pair(left: torch.Tensor, right: torch.Tensor,
                 maps_l: RectifyMaps, maps_r: RectifyMaps):
    """Rectify both eyes."""
    return remap_bilinear(left, maps_l), remap_bilinear(right, maps_r)
