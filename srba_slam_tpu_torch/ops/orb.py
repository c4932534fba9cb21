"""Upright 256-bit ORB descriptors (plain torch).

Counterpart of ``srba_slam_tpu/ops/orb.py`` on the path the VO frontend
takes: OpenCV's learned ``bit_pattern_31_`` table (``orb_pattern_opencv.npy``,
the same file as the JAX package's), OpenCV's 7x7 sigma=2 Gaussian pre-blur
with integer rounding, and the upright test bit_i = blur(p_i) < blur(q_i) at
fixed integer offsets, packed into 8 int32 words (``ops/bits.py``).

Not ported yet (ROADMAP M11): oriented descriptors (intensity-centroid
steering), the seeded "gaussian" pattern and its box blur.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from srba_slam_tpu_torch.ops.bits import pack_bits

N_BITS = 256


def _load_opencv_pattern() -> np.ndarray:
    """OpenCV bit_pattern_31_ as [256, 2, 2] in (dy, dx) point order (p, q).
    Table rows are (x1, y1, x2, y2)."""
    path = os.path.join(os.path.dirname(__file__), "orb_pattern_opencv.npy")
    t = np.load(path).astype(np.float64)  # [256, 4]
    return np.stack(
        [np.stack([t[:, 1], t[:, 0]], -1), np.stack([t[:, 3], t[:, 2]], -1)], 1
    )


PATTERN_OPENCV = _load_opencv_pattern()

# (dy_p, dx_p, dy_q, dx_q) per test, rounded as the JAX package rounds them
PATTERN_OFFSETS = np.rint(PATTERN_OPENCV).astype(np.int32).reshape(N_BITS, 4)

# OpenCV ORB pre-smoothing: GaussianBlur(ksize=7, sigma=2), fixed-point on
# uint8 images, reproduced as a separable filter + rounding
_G7 = np.exp(-((np.arange(7) - 3.0) ** 2) / (2.0 * 2.0**2))
_G7 = _G7 / _G7.sum()
_G7_F32 = [float(v) for v in _G7.astype(np.float32)]


def gauss_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 sigma=2 Gaussian with zero padding, then rounding, for
    ``img`` [..., H, W].

    Written as shifted multiply-adds in a fixed order rather than conv2d: a
    float32 convolution on the GPU goes through cuDNN in TF32 by default,
    and shifted sums give the same bits on every device. (They still differ
    from the JAX package's XLA convolution by 1 at a few pixels in 10^5.)
    """
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, 3, 3))
    acc = _G7_F32[0] * xp[..., 0:h, :]
    for i in range(1, 7):
        acc = acc + _G7_F32[i] * xp[..., i:i + h, :]
    xp = F.pad(acc, (3, 3, 0, 0))
    acc = _G7_F32[0] * xp[..., :, 0:w]
    for i in range(1, 7):
        acc = acc + _G7_F32[i] * xp[..., :, i:i + w]
    return torch.round(acc)


def upright_descriptors(blurred: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Upright ORB descriptors of keypoints on blurred images.

    ``blurred`` [..., H, W] f32 (``gauss_blur7`` output); ``ys``/``xs``
    [..., K] int32; ``valid`` [..., K] bool. Returns int32 [..., K, 8]; invalid
    keypoints get 0. Each sample coordinate is clipped into the image, as in
    the JAX package's general path, which equals its 33x33-patch fast path
    for keypoints at least 16 px inside the borders. Behind
    :func:`gauss_blur7` it is the plain version of kernel K2
    (``ops/hopper_fast.orb_descriptors``), which blurs inside.
    """
    h, w = blurred.shape[-2:]
    k = ys.shape[-1]
    lead = ys.shape[:-1]
    flat = blurred.reshape(-1, h * w)
    b = flat.shape[0]
    off = torch.as_tensor(PATTERN_OFFSETS, dtype=torch.int64, device=blurred.device)
    y = ys.reshape(b, k, 1).to(torch.int64)
    x = xs.reshape(b, k, 1).to(torch.int64)

    def sample(dy, dx):
        idx = (torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1))
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, k, N_BITS)

    bits = sample(off[:, 0], off[:, 1]) < sample(off[:, 2], off[:, 3])
    desc = pack_bits(bits)
    desc = torch.where(valid.reshape(b, k, 1), desc, 0)
    return desc.reshape(lead + (k, 8))


def describe(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
             valid: torch.Tensor, oriented: bool = False):
    """Descriptors of K keypoints of ``img`` [H, W] (any batch of leading
    dims works too): blur, then :func:`upright_descriptors`, which gives
    the bits of both of the JAX package's upright paths (``patch_safe``
    True or False there).

    Returns (desc int32 [..., K, 8], theta zeros [..., K]).
    """
    if oriented:
        raise NotImplementedError("oriented ORB is not ported yet (ROADMAP M11)")
    desc = upright_descriptors(gauss_blur7(img), ys, xs, valid)
    return desc, torch.zeros(ys.shape, dtype=torch.float32, device=ys.device)
