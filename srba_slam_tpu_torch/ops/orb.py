"""256-bit ORB descriptors, upright and oriented (plain torch).

Counterpart of ``srba_slam_tpu/ops/orb.py``. Per image, three fixed-shape
batched gathers over all K keypoints at once:

1. orientation: intensity-centroid moments over OpenCV's radius-15 disc,
   theta = atan2(m01, m10);
2. steering: the 256 (p, q) test-point pairs are rotated by theta and
   rounded to pixels;
3. test: bit_i = blurred(x + Rp_i) < blurred(x + Rq_i), packed into 8 int32
   words (``ops/bits.py``).

Two test-point patterns:

* ``pattern="opencv"`` (default): OpenCV's learned ``bit_pattern_31_`` table
  (``orb_pattern_opencv.npy``, the same file as the JAX package's) behind
  OpenCV's 7x7 sigma=2 Gaussian pre-blur with integer rounding;
* ``pattern="gaussian"``: a seeded BRIEF-style pattern inside the radius-15
  disc behind a 5x5 box blur; its numpy generator gives the JAX package's
  table.

The upright descriptors at the OpenCV pattern are what the VO frontend
uses; on the card kernel K2 (``ops/hopper_fast.orb_descriptors``) computes
them, with :func:`upright_descriptors` behind :func:`gauss_blur7` as its
plain version. The oriented path has no kernel in the JAX package and is
plain torch on the card too.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from srba_slam_tpu_torch.ops.bits import pack_bits

PATCH_RADIUS = 15
N_BITS = 256


def _make_pattern(seed: int = 7) -> np.ndarray:
    """[256, 2, 2] float64 (pair, point, (dy,dx)) test pattern inside the disc."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = []
    while len(pts) < N_BITS * 2:
        cand = rng.normal(0.0, sigma, size=(N_BITS * 4, 2))
        cand = cand[np.linalg.norm(cand, axis=1) <= PATCH_RADIUS - 1.0]
        pts.extend(cand.tolist())
    pts = np.asarray(pts[: N_BITS * 2], dtype=np.float64)
    return pts.reshape(N_BITS, 2, 2)


PATTERN_GAUSSIAN = _make_pattern()  # float64 [256, 2, 2] in (dy, dx)


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
# host constants copied to a device once: a copy from the host cannot be
# captured into a CUDA graph (``models/vo.py`` ``vo_scan``), so a capture
# finds them there from its warm-up
_CONSTS: dict = {}


def _const(name: str, arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    key = (name, dtype, torch.device(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return _CONSTS[key]


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


def _disc_offsets(radius: int) -> np.ndarray:
    """Integer (dy, dx) offsets of OpenCV ORB's IC_Angle patch: |dx| bounded
    per row by the umax Bresenham table (cv2 orb.cpp), so the intensity
    centroid, and hence the steering angle, matches cv2's."""
    # umax for HALF_PATCH_SIZE=15, including OpenCV's symmetry fix-up
    umax = [15, 15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 8, 6, 3]
    offs = []
    for dy in range(-radius, radius + 1):
        for dx in range(-umax[abs(dy)], umax[abs(dy)] + 1):
            offs.append((dy, dx))
    return np.asarray(offs, np.int32)


_DISC = _disc_offsets(PATCH_RADIUS)  # [D, 2]


def box_blur5(img: torch.Tensor) -> torch.Tensor:
    """5x5 box filter with zero padding for ``img`` [..., H, W] (the
    "gaussian" pattern's smoothing): shifted sums, then one division."""
    x = img.to(torch.float32)
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, 2, 2))
    acc = xp[..., 0:h, :]
    for i in range(1, 5):
        acc = acc + xp[..., i:i + h, :]
    xp = F.pad(acc, (2, 2, 0, 0))
    acc = xp[..., :, 0:w]
    for i in range(1, 5):
        acc = acc + xp[..., :, i:i + w]
    return acc / 25.0


def _gather(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img[..., ys, xs] with clipping: ``img`` [..., H, W]; ``ys``/``xs``
    int64 [..., K, ...] with the same leading dims."""
    h, w = img.shape[-2:]
    flat = img.reshape(-1, h * w)
    b = flat.shape[0]
    idx = torch.clamp(ys, 0, h - 1) * w + torch.clamp(xs, 0, w - 1)
    return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(idx.shape)


def orientations(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (radians) of K keypoints of ``img``
    [..., H, W] f32: ``ys``/``xs`` int32 [..., K] -> f32 [..., K]."""
    dev = img.device
    dy = _const("disc_dy", _DISC[:, 0], torch.int64, dev)
    dx = _const("disc_dx", _DISC[:, 1], torch.int64, dev)
    vals = _gather(img, ys[..., None].to(torch.int64) + dy, xs[..., None].to(torch.int64) + dx)
    m01 = torch.sum(vals * dy.to(torch.float32), dim=-1)
    m10 = torch.sum(vals * dx.to(torch.float32), dim=-1)
    return torch.atan2(m01, m10)


def describe(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
             valid: torch.Tensor, oriented: bool = False, pattern: str = "opencv",
             theta_override: torch.Tensor | None = None):
    """256-bit descriptors of K keypoints of ``img`` [H, W] (a batch
    [N, H, W] with keypoints [N, K] works too).

    ``oriented`` steers the pattern by the intensity-centroid angle (the JAX
    package's ``describe`` defaults to True; here the default is the upright
    descriptor the VO frontend uses). ``theta_override`` [K] steers with the
    given angles instead. ``pattern`` is "opencv" (bit_pattern_31_ behind
    :func:`gauss_blur7`) or "gaussian" (the seeded pattern behind
    :func:`box_blur5`). Every sample coordinate is clipped into the image,
    which is what the JAX package computes for ``patch_safe=False`` and,
    for keypoints at least 16 px inside, for ``patch_safe=True`` as well:
    the port has the one path and no such argument.

    Returns (desc int32 [..., K, 8], theta f32 [..., K]; zeros when upright).
    """
    img = img.to(torch.float32)
    blurred = gauss_blur7(img) if pattern == "opencv" else box_blur5(img)
    if theta_override is None and not oriented and pattern == "opencv":
        desc = upright_descriptors(blurred, ys, xs, valid)
        return desc, torch.zeros(ys.shape, dtype=torch.float32, device=ys.device)

    if theta_override is not None:
        theta = theta_override.to(torch.float32)
    elif oriented:
        theta = orientations(img, ys, xs)
    else:
        theta = torch.zeros(ys.shape, dtype=torch.float32, device=ys.device)
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]   # [..., K, 1, 1]
    pat_np = PATTERN_OPENCV if pattern == "opencv" else PATTERN_GAUSSIAN
    pat = _const(pattern, pat_np, torch.float32, img.device)          # [256, 2, (dy,dx)]
    pdy, pdx = pat[..., 0], pat[..., 1]
    # image coordinates (y down, x right): rotate each offset by theta_k
    rdx = c * pdx - s * pdy                                            # [..., K, 256, 2]
    rdy = s * pdx + c * pdy
    iy = ys[..., None, None].to(torch.int64) + torch.round(rdy).to(torch.int64)
    ix = xs[..., None, None].to(torch.int64) + torch.round(rdx).to(torch.int64)
    samples = _gather(blurred, iy, ix)
    desc = pack_bits(samples[..., 0] < samples[..., 1])
    desc = torch.where(valid[..., None], desc, 0)
    return desc, theta
