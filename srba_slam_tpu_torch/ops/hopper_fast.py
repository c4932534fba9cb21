"""The frontend's hand-written Hopper kernels and their wrappers.

Counterpart of ``srba_slam_tpu/ops/pallas_fast.py``:

* K1 :func:`fast_nms` (``csrc/fast_nms.cu``) replaces ``fast_nms_pallas``:
  the suppressed FAST score maps of a batch of images;
* K2 :func:`orb_descriptors` (``csrc/orb_describe.cu``) replaces
  ``orb_bitplanes_pallas`` / ``orb_descriptors_pallas``: upright ORB
  descriptors at the keypoints of a batch of blurred images;
* K3 :func:`fast_score_map` (``csrc/fast_score.cu``) replaces
  ``fast_score_map_pallas``: the FAST score maps without suppression. No
  path of the estimator calls it, as none of the JAX package does.

The tensors' device decides the route: a CUDA tensor launches the kernel
(or the wrapper raises), a CPU tensor takes the kernel's plain torch version
(:func:`fast_nms_plain`; ``ops/orb.py`` :func:`upright_descriptors`;
``ops/fast.py`` ``fast_score_map``). There is no fallback from one to the
other. Each wrapper counts its kernel launches in a plain integer
attribute, ``fast_nms.launches``, ``orb_descriptors.launches`` and
``fast_score_map.launches``, so a run can show that it went through them.
"""

from __future__ import annotations

import torch

from srba_slam_tpu_torch.ops import cuda_build
from srba_slam_tpu_torch.ops.fast import fast_score_map as fast_score_map_plain
from srba_slam_tpu_torch.ops.nms import local_max_suppress, nms_eps
from srba_slam_tpu_torch.ops.orb import PATTERN_OFFSETS, upright_descriptors

_KERNEL_NMS_RADIUS = 2   # the 5x5 window csrc/fast_nms.cu is built for
_FAST_RADIUS = 3         # the FAST circle: the halo csrc/fast_score.cu stages
_ORB_MIN_MARGIN = 16     # keypoints >= 16 px inside: full 31x31 pattern support


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


def fast_nms_plain(imgs: torch.Tensor, threshold: float, margin: int = 16,
                   radius: int = 2) -> torch.Tensor:
    """Plain torch version of K1: ``local_max_suppress(fast_score_map(...))``
    per image of ``imgs`` [N, H, W]."""
    return local_max_suppress(fast_score_map_plain(imgs, threshold, margin=margin),
                              radius=radius)


def fast_nms(imgs: torch.Tensor, threshold: float, margin: int = 16,
             radius: int = 2) -> torch.Tensor:
    """Suppressed FAST-9/16 score maps f32 [N, H, W] of ``imgs`` [N, H, W]
    (uint8 or float32); bit-exact against :func:`fast_nms_plain`.

    Requires ``margin >= 3 + radius``, so that the circle and the NMS window
    of every surviving pixel stay inside the image."""
    if margin < 3 + radius:
        raise ValueError(f"margin {margin} must cover circle + NMS halo (3 + {radius})")
    _check(imgs, "imgs", (torch.uint8, torch.float32), 3)
    if imgs.device.type == "cpu":
        return fast_nms_plain(imgs, threshold, margin, radius)
    if imgs.device.type != "cuda":
        raise ValueError(f"imgs: unsupported device {imgs.device}")
    if radius != _KERNEL_NMS_RADIUS:
        raise NotImplementedError(
            f"the CUDA kernel is built for NMS radius {_KERNEL_NMS_RADIUS}, got {radius}")
    n, h, w = imgs.shape
    if h * w >= 1 << 31:
        raise ValueError(f"image of {h}x{w} pixels overflows the kernel's int32 index")
    out = torch.empty((n, h, w), dtype=torch.float32, device=imgs.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = lib.srba_fast_nms(imgs.data_ptr(), int(imgs.dtype == torch.uint8),
                                 out.data_ptr(), n, h, w, float(threshold),
                                 int(margin), nms_eps(h, w), stream)
    _raise_on_error(code, "fast_nms")
    fast_nms.launches += 1
    return out


fast_nms.launches = 0

_pattern_on: dict[torch.device, torch.Tensor] = {}


def orb_descriptors(blurred: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    valid: torch.Tensor, margin: int = 16) -> torch.Tensor:
    """Upright ORB descriptors int32 [N, K, 8] of keypoints ``ys``/``xs``
    int32 [N, K] (``valid`` bool [N, K]) on ``blurred`` f32 [N, H, W]
    (``gauss_blur7`` output); bit-exact against ``upright_descriptors``.

    ``margin`` is the detector margin the keypoints respect; it must be at
    least 16, as on the JAX package's bit-plane path (models/vo.py there)."""
    if margin < _ORB_MIN_MARGIN:
        raise ValueError(f"margin {margin} < {_ORB_MIN_MARGIN}: keypoints may lack "
                         "full pattern support")
    _check(blurred, "blurred", (torch.float32,), 3)
    dev = blurred.device
    _check(ys, "ys", (torch.int32,), 2, dev)
    _check(xs, "xs", (torch.int32,), 2, dev)
    _check(valid, "valid", (torch.bool,), 2, dev)
    n, h, w = blurred.shape
    if ys.shape[0] != n or xs.shape != ys.shape or valid.shape != ys.shape:
        raise ValueError(f"keypoint shapes {tuple(ys.shape)}, {tuple(xs.shape)}, "
                         f"{tuple(valid.shape)} do not match images {n}")
    if dev.type == "cpu":
        return upright_descriptors(blurred, ys, xs, valid)
    if dev.type != "cuda":
        raise ValueError(f"blurred: unsupported device {dev}")
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
        code = lib.srba_orb_describe(blurred.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                                     valid.data_ptr(), pattern.data_ptr(), out.data_ptr(),
                                     n, k, h, w, stream)
    _raise_on_error(code, "orb_descriptors")
    orb_descriptors.launches += 1
    return out


orb_descriptors.launches = 0


def fast_score_map(imgs: torch.Tensor, threshold: float, margin: int = 16) -> torch.Tensor:
    """FAST-9/16 score maps f32 of ``imgs`` [H, W] or [N, H, W] (uint8 or
    float32), the shape of ``imgs``: the score where it exceeds
    ``threshold``, else 0, and 0 within ``margin`` of a border. Bit-exact
    against ``ops/fast.py`` ``fast_score_map``.

    Requires ``margin >= 3``, so that the circle of every pixel that keeps a
    score lies inside the image."""
    if margin < _FAST_RADIUS:
        raise ValueError(f"margin {margin} must cover the FAST circle ({_FAST_RADIUS})")
    if imgs.dim() not in (2, 3):
        raise ValueError(f"imgs: expected [H, W] or [N, H, W], got {tuple(imgs.shape)}")
    _check(imgs, "imgs", (torch.uint8, torch.float32), imgs.dim())
    if imgs.device.type == "cpu":
        return fast_score_map_plain(imgs, threshold, margin=margin)
    if imgs.device.type != "cuda":
        raise ValueError(f"imgs: unsupported device {imgs.device}")
    n, h, w = imgs.shape if imgs.dim() == 3 else (1, *imgs.shape)
    out = torch.empty(imgs.shape, dtype=torch.float32, device=imgs.device)
    if out.numel() == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        code = lib.srba_fast_score(imgs.data_ptr(), int(imgs.dtype == torch.uint8),
                                   out.data_ptr(), n, h, w, float(threshold), int(margin),
                                   stream)
    _raise_on_error(code, "fast_score_map")
    fast_score_map.launches += 1
    return out


fast_score_map.launches = 0
