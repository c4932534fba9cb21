"""What the port's CUDA kernels compute, checked on the CPU.

* K1's uint8 route scores in packed int16 pairs with Hopper's DPX min/max
  (``csrc/fast_circle.cuh`` ``fast_score_u8``). A numpy model of that
  formulation, lane for lane (each tap as the pair ``(t, -t)``, three-way
  minima over the 3-tap windows and the arcs, the three-way maximum chain
  over the arcs, then the centre subtracted once per lane, which is the
  ``(d, -d)`` formulation with the subtraction moved past the mins and
  maxes it commutes with, and the larger lane), must equal the f32 score of
  ``ops/fast.py`` bit for bit on uint8 images. Tolerance: none.
* K2's CPU route is its plain version ``upright_descriptors(gauss_blur7)``,
  for uint8 and f32 frames; the kernel's patch reach is the pattern's.
* The port's entry points run on the card unless the caller asks for the
  CPU: their ``device`` defaults to ``"cuda"``, and there is no fallback.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch

from srba_slam_tpu_torch import bench
from srba_slam_tpu_torch.models import bow, estimator, keyframe, srba, vo
from srba_slam_tpu_torch.ops import cuda_build, hopper_fast
from srba_slam_tpu_torch.ops.fast import CIRCLE, fast_score_map
from srba_slam_tpu_torch.ops.orb import PATTERN_OFFSETS, gauss_blur7, upright_descriptors
from srba_slam_tpu_torch.parallel import multichip

torch.set_num_threads(1)

_M16 = np.uint32(0xFFFF)


def _pack_pm(img: np.ndarray) -> np.ndarray:
    """pack_pm: v * 0xFFFF0001 mod 2^32, the int16 pair (v, -v)."""
    return (img.astype(np.uint64) * 0xFFFF0001 & 0xFFFFFFFF).astype(np.uint32)


def _lanes(u):
    lo = (u & _M16).astype(np.uint16).view(np.int16)
    hi = (u >> np.uint32(16)).astype(np.uint16).view(np.int16)
    return lo.astype(np.int32), hi.astype(np.int32)


def _pack(lo, hi):
    return (lo.astype(np.uint32) & _M16) | ((hi.astype(np.uint32) & _M16) << np.uint32(16))


def _lanewise(op, *words):
    lanes = [_lanes(w) for w in words]
    return _pack(op([lo for lo, _ in lanes]), op([hi for _, hi in lanes]))


def _vimin3(a, b, c):
    return _lanewise(lambda v: np.minimum(np.minimum(v[0], v[1]), v[2]), a, b, c)


def _vimax3(a, b, c):
    return _lanewise(lambda v: np.maximum(np.maximum(v[0], v[1]), v[2]), a, b, c)


def packed_fast_score_map(img: np.ndarray, threshold: float, margin: int) -> np.ndarray:
    """K1's uint8 scoring, step for step, on ``img`` [H, W] uint8."""
    h, w = img.shape
    s = _pack_pm(img)
    t = [s[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] for dy, dx in CIRCLE]
    w3 = [_vimin3(t[i], t[(i + 1) % 16], t[(i + 2) % 16]) for i in range(16)]
    w9 = [_vimin3(w3[i], w3[(i + 3) % 16], w3[(i + 6) % 16]) for i in range(16)]
    m = _vimax3(w9[0], w9[1], w9[2])
    for i in range(3, 15, 2):
        m = _vimax3(m, w9[i], w9[i + 1])
    m = _vimax3(m, w9[15], w9[15])
    c = _lanes(s[3:h - 3, 3:w - 3])[0]

    lo, hi = _lanes(m)
    score = np.zeros((h, w), np.float32)
    score[3:h - 3, 3:w - 3] = np.maximum(lo - c, hi + c).astype(np.float32)
    score = np.where(score > np.float32(threshold), score, np.float32(0))
    inside = np.zeros((h, w), bool)
    inside[margin:h - margin, margin:w - margin] = True
    return np.where(inside, score, np.float32(0))


def _image(kind: str, rng) -> tuple[np.ndarray, float]:
    h, w = 61, 83
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "random":
        return rng.integers(0, 256, (h, w)).astype(np.uint8), 12.0
    if kind == "checkerboard":             # every difference is +-255 or 0
        return ((yy + xx) % 2 * 255).astype(np.uint8), 20.0
    if kind == "checker_blocks":
        return (((yy // 3 + xx // 2) % 2) * 255).astype(np.uint8), 0.0
    if kind == "negative_threshold":       # negative scores are kept
        return rng.integers(0, 256, (h, w)).astype(np.uint8), -1000.0
    if kind == "binary_noise":
        return (rng.integers(0, 2, (h, w)) * 255).astype(np.uint8), 100.0
    if kind == "flat":
        return np.full((h, w), 77, np.uint8), 0.0
    if kind == "exact_threshold":          # the threshold is a score that occurs
        img = rng.integers(0, 256, (h, w)).astype(np.uint8)
        s = fast_score_map(torch.from_numpy(img), -1e9, margin=3).numpy()
        return img, float(np.median(s[s > 0]))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "checkerboard", "checker_blocks", "binary_noise",
                                  "flat", "exact_threshold", "negative_threshold"])
@pytest.mark.parametrize("margin", [3, 16])
def test_packed_dpx_score_equals_f32_score(kind, margin):
    img, th = _image(kind, np.random.default_rng(5))
    got = packed_fast_score_map(img, th, margin)
    ref = fast_score_map(torch.from_numpy(img), th, margin=margin).numpy()
    np.testing.assert_array_equal(got, ref)
    if kind == "exact_threshold":
        raw = fast_score_map(torch.from_numpy(img), -1e9, margin=margin).numpy()
        assert (raw == th).any() and not (ref == th).any()   # score == th gives 0
    if kind == "binary_noise":
        assert ref.max() == 255.0                             # an arc of d = +-255
    if kind == "negative_threshold":
        assert ref.min() < 0
    if kind == "flat":
        assert not ref.any()


def _keypoints(rng, n, h, w, k):
    """Keypoints anywhere in the image (border ones clip), a few invalid."""
    ys = rng.integers(0, h, (n, k)).astype(np.int32)
    xs = rng.integers(0, w, (n, k)).astype(np.int32)
    valid = rng.random((n, k)) < 0.8
    return torch.from_numpy(ys), torch.from_numpy(xs), torch.from_numpy(valid)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_orb_wrapper_cpu_route_is_blur_then_describe(dtype):
    rng = np.random.default_rng(3)
    n, h, w = 2, 57, 90
    imgs = torch.from_numpy(rng.integers(0, 256, (n, h, w)).astype(np.uint8)).to(dtype)
    if dtype == torch.float32:
        imgs = imgs + torch.from_numpy(rng.random((n, h, w)).astype(np.float32))
    ys, xs, valid = _keypoints(rng, n, h, w, 40)
    before = hopper_fast.orb_descriptors.launches
    got = hopper_fast.orb_descriptors(imgs, ys, xs, valid)
    assert hopper_fast.orb_descriptors.launches == before
    ref = upright_descriptors(gauss_blur7(imgs), ys, xs, valid)
    assert torch.equal(got, ref)
    assert torch.equal(got, hopper_fast.orb_descriptors_plain(imgs, ys, xs, valid))
    assert not got[~valid].any() and got[valid].any()


def test_orb_kernel_reach_is_the_patterns():
    """csrc/orb_describe.cu sizes its patches for the pattern's reach."""
    with open(os.path.join(cuda_build.CSRC_DIR, "orb_describe.cu")) as f:
        reach = int(re.search(r"constexpr int REACH = (\d+);", f.read()).group(1))
    assert int(np.abs(PATTERN_OFFSETS).max()) == reach


ENTRY_POINTS = {
    "SRBAStereoSLAMEstimator": estimator.SRBAStereoSLAMEstimator.__init__,
    "bench_estimator": estimator.bench_estimator,
    "StereoVOEngine": vo.StereoVOEngine,
    "extract_and_match": vo.extract_and_match,
    "SRBAEngine": srba.SRBAEngine.__init__,
    "KeyframeStore": keyframe.KeyframeStore.__init__,
    "KeyframeStore.from_jax_numpy": keyframe.KeyframeStore.from_jax_numpy,
    "BoWDatabase": bow.BoWDatabase.__init__,
    "BoWDatabase.from_jax_numpy": bow.BoWDatabase.from_jax_numpy,
    "entry": multichip.entry,
    "bench.run": bench.run,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def test_default_device_has_no_cpu_fallback():
    """Without a card, the default device raises torch's own error."""
    if torch.cuda.is_available():
        assert keyframe.KeyframeStore(max_kfs=2, capacity=4).arrays.ys_l.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            keyframe.KeyframeStore(max_kfs=2, capacity=4)
