"""The frontend's hand-written Hopper kernels and their wrappers.

Counterpart of ``srba_slam_tpu/ops/pallas_fast.py``:

* K1 :func:`fast_nms` (``csrc/fast_nms.cu``) replaces ``fast_nms_pallas``:
  the suppressed FAST score maps of a batch of images;
* K2 :func:`orb_descriptors` (``csrc/orb_describe.cu``) replaces
  ``orb_bitplanes_pallas`` / ``orb_descriptors_pallas`` and the blur in
  front of them: upright ORB descriptors at the keypoints of a batch of
  frames, blurred inside the kernel;
* K3 :func:`fast_score_map` (``csrc/fast_score.cu``) replaces
  ``fast_score_map_pallas``: the FAST score maps without suppression, for
  detector margins under 5, where K1's fused 5x5 window does not fit
  (``models/vo.py`` ``_suppressed_scores``).

K1 and K3 take their threshold as a float for the whole batch or as an
f32 tensor with one threshold per image (a fleet step detects the frames
of sequences whose adaptive thresholds differ). The tensors' device
decides the route: a CUDA tensor launches the kernel
(or the wrapper raises), a CPU tensor takes the kernel's plain torch version
(:func:`fast_nms_plain`; :func:`orb_descriptors_plain`;
``ops/fast.py`` ``fast_score_map``). There is no fallback from one to the
other. Each wrapper counts its kernel launches in a plain integer
attribute, ``fast_nms.launches``, ``orb_descriptors.launches`` and
``fast_score_map.launches``, so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes

import torch

from srba_slam_tpu_torch.ops import cuda_build
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain
from srba_slam_tpu_torch.ops.nms import local_max_suppress, nms_eps
from srba_slam_tpu_torch.ops.orb import _G7_F32, PATTERN_OFFSETS, gauss_blur7, upright_descriptors

KERNEL_NMS_RADII = (0, 1, 2, 3, 4, 5)   # those of fast_nms_pallas; csrc/fast_nms.cu


def _check(t: torch.Tensor, name: str, dtypes, ndim: int, device=None):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _raise_on_error(code: int, kernel: str):
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}")


def _thresholds(threshold, n: int, device) -> tuple[float, int]:
    """The kernels' two threshold arguments: (the batch's float, 0) or
    (0, the address of the f32 [n] per-image tensor on ``device``)."""
    if not isinstance(threshold, torch.Tensor):
        return float(threshold), 0
    _check(threshold, "threshold", (torch.float32,), 1, device)
    if threshold.shape[0] != n:
        raise ValueError(f"threshold: {threshold.shape[0]} values for {n} images")
    return 0.0, threshold.data_ptr()


def fast_nms_plain(imgs: torch.Tensor, threshold, margin: int = 16,
                   radius: int = 2) -> torch.Tensor:
    """Plain torch version of K1: ``local_max_suppress(fast_score_map(...))``
    per image of ``imgs`` [N, H, W]; ``threshold`` a float or f32 [N]."""
    return local_max_suppress(fast_score_map_plain(imgs, threshold, margin=margin),
                              radius=radius)


def fast_nms_launch(n: int, h: int, w: int, radius: int = 2):
    """K1's (grid, block) for ``n`` images of ``h`` x ``w`` at NMS
    ``radius``: one block of 128 x 4 threads per (128 - 2r) x (36 - 2r)
    output tile (csrc/fast_nms.cu; 10 x 12 blocks an image at 370x1226)."""
    tw, th = 128 - 2 * radius, 36 - 2 * radius
    return (-(-w // tw), -(-h // th), n), (128, 4, 1)


def fast_nms(imgs: torch.Tensor, threshold, margin: int = 16,
             radius: int = 2) -> torch.Tensor:
    """Suppressed FAST-9/16 score maps f32 [N, H, W] of ``imgs`` [N, H, W]
    (uint8 or float32), at ``threshold`` (a float, or f32 [N] on the
    images' device: one per image) and NMS ``radius`` 0-5 (the radii of
    the JAX package's ``fast_nms_pallas``); bit-exact
    against :func:`fast_nms_plain`.

    Requires ``margin >= 3 + radius``, so that the circle and the NMS window
    of every surviving pixel stay inside the image."""
    if margin < 3 + radius:
        raise ValueError(f"margin {margin} must cover circle + NMS halo (3 + {radius})")
    if radius not in KERNEL_NMS_RADII:
        raise ValueError(f"NMS radius {radius} not in {KERNEL_NMS_RADII}")
    _check(imgs, "imgs", (torch.uint8, torch.float32), 3)
    n, h, w = imgs.shape
    th, thr = _thresholds(threshold, n, imgs.device)
    if imgs.device.type == "cpu":
        return fast_nms_plain(imgs, threshold, margin, radius)
    if imgs.device.type != "cuda":
        raise ValueError(f"imgs: unsupported device {imgs.device}")
    if h * w >= 1 << 31:
        raise ValueError(f"image of {h}x{w} pixels overflows the kernel's int32 index")
    out = torch.empty((n, h, w), dtype=torch.float32, device=imgs.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = lib.srba_fast_nms(imgs.data_ptr(), int(imgs.dtype == torch.uint8),
                                 out.data_ptr(), n, h, w, th, thr, int(margin),
                                 int(radius), nms_eps(h, w), stream)
    _raise_on_error(code, "fast_nms")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0

_pattern_on: dict[torch.device, torch.Tensor] = {}
_G7_HOST = (ctypes.c_float * 7)(*_G7_F32)


def orb_descriptors_plain(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K2: ``upright_descriptors(gauss_blur7(imgs))``."""
    return upright_descriptors(gauss_blur7(imgs), ys, xs, valid)


def orb_descriptors(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Upright ORB descriptors int32 [N, K, 8] of keypoints ``ys``/``xs``
    int32 [N, K] (``valid`` bool [N, K]) on the frames ``imgs`` [N, H, W]
    (uint8 or float32), blurred by ``gauss_blur7`` inside the kernel;
    bit-exact against :func:`orb_descriptors_plain`.

    The keypoints may lie anywhere in the frame: a sample that falls
    outside is clipped to the border and blurred there, as the plain
    version does (the JAX package leaves its bit-plane kernel for its
    general path below a detector margin of 16; this kernel covers both)."""
    _check(imgs, "imgs", (torch.uint8, torch.float32), 3)
    dev = imgs.device
    _check(ys, "ys", (torch.int32,), 2, dev)
    _check(xs, "xs", (torch.int32,), 2, dev)
    _check(valid, "valid", (torch.bool,), 2, dev)
    n, h, w = imgs.shape
    if ys.shape[0] != n or xs.shape != ys.shape or valid.shape != ys.shape:
        raise ValueError(f"keypoint shapes {tuple(ys.shape)}, {tuple(xs.shape)}, "
                         f"{tuple(valid.shape)} do not match images {n}")
    if dev.type == "cpu":
        return orb_descriptors_plain(imgs, ys, xs, valid)
    if dev.type != "cuda":
        raise ValueError(f"imgs: unsupported device {dev}")
    k = ys.shape[1]
    out = torch.empty((n, k, 8), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    if dev not in _pattern_on:
        _pattern_on[dev] = torch.as_tensor(PATTERN_OFFSETS, device=dev).contiguous()
    pattern = _pattern_on[dev]
    lib = cuda_build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.srba_orb_describe(imgs.data_ptr(), int(imgs.dtype == torch.uint8),
                                     ys.data_ptr(), xs.data_ptr(), valid.data_ptr(),
                                     pattern.data_ptr(), _G7_HOST, out.data_ptr(),
                                     n, k, h, w, stream)
    _raise_on_error(code, "orb_descriptors")
    orb_descriptors.launches += 1
    return out


orb_descriptors.launches = 0


_FAST_SCORE_TILE = (32, 128)       # csrc/fast_score.cu: output rows x columns a block
_FAST_SCORE_BLOCK = (128, 4, 1)    # its threads


def fast_score_launch(n: int, h: int, w: int):
    """K3's (grid, block) for ``n`` images of ``h`` x ``w``: one block per
    32 x 128 output tile (a 370x1226 image: 120 blocks, one an SM of an
    H100; a stereo pair: 240)."""
    th, tw = _FAST_SCORE_TILE
    return (-(-w // tw), -(-h // th), n), _FAST_SCORE_BLOCK


def fast_score_map(imgs: torch.Tensor, threshold, margin: int = 16) -> torch.Tensor:
    """FAST-9/16 score maps f32 of ``imgs`` [H, W] or [N, H, W] (uint8 or
    float32), the shape of ``imgs``: the score where it exceeds
    ``threshold`` (a float, or f32 [N] on the images' device: one per
    image; [1] for one image), else 0, and 0 within ``margin`` of a
    border. Bit-exact against ``ops/fast.py`` ``fast_score_map``.

    Any ``margin >= 0``: under a margin of 3 the circle of a pixel near a
    border wraps to the opposite border, in the kernel as in the plain
    version."""
    if margin < 0:
        raise ValueError(f"margin {margin} must not be negative")
    if imgs.dim() not in (2, 3):
        raise ValueError(f"imgs: expected [H, W] or [N, H, W], got {tuple(imgs.shape)}")
    _check(imgs, "imgs", (torch.uint8, torch.float32), imgs.dim())
    n, h, w = imgs.shape if imgs.dim() == 3 else (1, *imgs.shape)
    th, thr = _thresholds(threshold, n, imgs.device)
    if imgs.device.type == "cpu":
        return fast_score_map_plain(imgs, threshold, margin=margin)
    if imgs.device.type != "cuda":
        raise ValueError(f"imgs: unsupported device {imgs.device}")
    if h * w >= 1 << 31:
        raise ValueError(f"image of {h}x{w} pixels overflows the kernel's int32 index")
    out = torch.empty(imgs.shape, dtype=torch.float32, device=imgs.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = lib.srba_fast_score(imgs.data_ptr(), int(imgs.dtype == torch.uint8),
                                   out.data_ptr(), n, h, w, th, thr, int(margin), stream)
    _raise_on_error(code, "fast_score_map")
    fast_score_map.launches += 1
    return out


fast_score_map.launches = 0
