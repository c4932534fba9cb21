"""Rectification in the port against the JAX package, on the CPU.

Tolerances:
* ``build_maps``: host numpy in float64 in both packages, rounded to f32
  once: the maps are equal (held to 1e-6 px).
* ``remap_bilinear``: the four-term bilinear sum is the same f32 expression;
  a compiler may contract its products and sums differently, so the images
  are held to 1e-3 grey levels (2 ulp of 255 is 3e-5) and the differing
  pixels are counted.
* the EuRoC demo configuration (752x480, unrectified, distortion rows)
  initialises on the CPU and steps rendered frames, with the keyframe
  decisions of the JAX package over the same frames.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srba_slam_tpu.models.estimator import SRBAStereoSLAMEstimator as JEstimator
from srba_slam_tpu.ops import rectify as jrectify
from srba_slam_tpu_torch.models.estimator import SRBAStereoSLAMEstimator
from srba_slam_tpu_torch.ops import rectify
from srba_slam_tpu_torch.utils.bench_workload import decisions
from srba_slam_tpu_torch.utils.framesource import SyntheticSource

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EUROC_INI = os.path.join(REPO, "demo", "config_euroc_example.ini")
EUROC = dict(width=752, height=480, fx=458.654, fy=457.296, cx=367.215, cy=248.375)
DIST = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]


def _rot(rx, ry):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    return np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]) @ \
        np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])


@pytest.mark.parametrize("kw", [dict(dist=DIST), dict(dist=DIST, R=_rot(0.01, -0.02)),
                                dict(dist=[0.1, -0.05, 1e-3, -1e-3, 0.01], new_fx=400.0,
                                     new_fy=410.0, new_cx=370.0, new_cy=240.0), dict()],
                         ids=["euroc", "rotated", "new_intrinsics", "identity"])
def test_build_maps_match_jax(kw):
    ref = jrectify.build_maps(**EUROC, **kw)
    got = rectify.build_maps(**EUROC, device="cpu", **kw)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == (480, 752)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    if not kw:      # no distortion: the identity grid
        np.testing.assert_array_equal(got.map_x[0].numpy(), np.arange(752, dtype=np.float32))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_bilinear_close_to_jax(rng, dtype):
    img = rng.integers(0, 256, (480, 752)).astype(dtype)
    if dtype == np.float32:
        img += rng.random((480, 752)).astype(np.float32)
    jmaps = jrectify.build_maps(**EUROC, dist=DIST)
    tmaps = rectify.build_maps(**EUROC, dist=DIST, device="cpu")
    ref = np.asarray(jrectify.remap_bilinear(jnp.asarray(img), jmaps))
    got = rectify.remap_bilinear(torch.from_numpy(img), tmaps)
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - ref)
    print(f"remap_bilinear: {int((diff > 0).sum())} of {diff.size} pixels differ, max {diff.max()}")
    assert diff.max() <= 1e-3
    assert (got.numpy() != np.round(got.numpy())).mean() > 0.9     # not integer-valued
    # samples outside the frame clamp to the border
    far = rectify.RectifyMaps(torch.full((4, 6), -5.0), torch.full((4, 6), 1e4))
    edge = rectify.remap_bilinear(torch.from_numpy(img), far)
    assert edge.shape == (4, 6) and bool((edge == float(img[0, -1])).all())
    pair = rectify.rectify_pair(torch.from_numpy(img), torch.from_numpy(img), tmaps, tmaps)
    assert torch.equal(pair[0], got) and torch.equal(pair[1], got)


def test_euroc_demo_config_initialises_and_steps():
    """The unrectified demo rig: maps from the distortion rows, on the
    estimator's device, and the first frames' decisions as the JAX package's."""
    est = SRBAStereoSLAMEstimator.from_config(EUROC_INI, device="cpu")
    est.initialize()
    jest = JEstimator.from_config(EUROC_INI)
    jest.initialize()
    jest.solve_sync = True
    assert est.vo.rect_maps is not None and jest.vo.rect_maps is not None
    for mine, theirs in zip(est.vo.rect_maps, jest.vo.rect_maps):
        assert mine.map_x.shape == (480, 752) and mine.map_x.device.type == "cpu"
        np.testing.assert_allclose(mine.map_x.numpy(), np.asarray(theirs.map_x), atol=1e-6)
        np.testing.assert_allclose(mine.map_y.numpy(), np.asarray(theirs.map_y), atol=1e-6)
    for left, right in SyntheticSource(est.cam, n_frames=5, step=0.5):
        est.step(left, right)
        jest.step(left, right)
    assert decisions(est.step_log) == decisions(jest.step_log)
    assert est.store.n_kfs == jest.store.n_kfs >= 2
    n = est.store.n_kfs
    np.testing.assert_allclose(est.rba.kf_global[:n], jest.rba.kf_global[:n], atol=1e-3)
