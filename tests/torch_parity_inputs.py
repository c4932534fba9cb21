"""Shared inputs of the port's parity tests: JAX keyframe features of the
small-geometry sequence of tests/test_estimator.py, and their port copies.

Not a test module; the ``test_torch_*`` files import it.
"""

from __future__ import annotations

import functools

import numpy as np

SMALL_CAM = dict(fx_l=180.0, fy_l=180.0, cx_l=160.0, cy_l=100.0, fx_r=180.0, fy_r=180.0,
                 cx_r=160.0, cy_r=100.0, baseline=0.54, width=320, height=200)
CAPACITY = 256


@functools.lru_cache(maxsize=None)
def small_frames(n_frames: int = 30):
    """The rendered frames of SyntheticSource(small cam, 30 frames, seed
    11, step 0.12), as tests/test_estimator.py renders them."""
    from srba_slam_tpu_torch.utils.camera import StereoCamera
    from srba_slam_tpu_torch.utils.framesource import SyntheticSource

    src = SyntheticSource(StereoCamera(**SMALL_CAM), n_frames=n_frames, seed=11, step=0.12)
    return tuple(src), src.gt_poses


@functools.lru_cache(maxsize=None)
def jax_features(frame_ids: tuple) -> tuple:
    """JAX FrameFeatures (host numpy) of the given small-sequence frames."""
    import jax

    from srba_slam_tpu.models import vo as jvo
    from srba_slam_tpu.utils.camera import StereoCamera as JCam

    frames, _ = small_frames()
    cam = JCam(**SMALL_CAM)
    out = []
    for i in frame_ids:
        left, right = frames[i]
        f = jvo.extract_and_match(left, right, cam, 12.0, 60, k=CAPACITY)
        out.append(jax.device_get(f))
    return tuple(out)


def jax_store(feats, max_kfs: int = 8):
    """A JAX KeyframeStore holding ``feats`` as keyframes 0..n-1, with
    match ids ``1000 * kf + feature`` on the valid stereo matches."""
    import jax.numpy as jnp

    from srba_slam_tpu.models.keyframe import KeyframeStore as JStore
    from srba_slam_tpu.models.vo import FrameFeatures as JFeat

    store = JStore(max_kfs=max_kfs, capacity=CAPACITY)
    for i, f in enumerate(feats):
        ids = np.where(np.asarray(f.m_valid), 1000 * i + np.arange(CAPACITY), -1)
        store.append(JFeat(*(jnp.asarray(a) for a in f)), ids.astype(np.int64),
                     np.zeros(6, np.float32))
    return store


def port_store(jstore, device="cpu"):
    import jax

    from srba_slam_tpu_torch.models.keyframe import KeyframeStore

    return KeyframeStore.from_jax_numpy(jax.device_get(jstore.arrays), jstore.n_kfs,
                                        jstore.match_ids, jstore.poses, device)


def port_features(f, device="cpu"):
    from srba_slam_tpu_torch.models.vo import frame_features_from_numpy

    return frame_features_from_numpy(f, device)
